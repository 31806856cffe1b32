"""Percent of the traced window (one batch: simulate and metrics pass)
in which nothing ran on the device."""


def read(rec):
    if rec.driver != "sim" or rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.window_s)
