"""Percent of the traced part of the serving window in which nothing ran
on the device."""


def read(rec):
    if rec.driver != "serve" or rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s() / rec.trace.window_s)
