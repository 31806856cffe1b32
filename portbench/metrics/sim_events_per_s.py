"""Simulated events a second: every event of the batches run in the
window over the window's time, which ends with the last batch's device
synchronisation."""


def read(rec):
    if rec.driver != "sim" or rec.values["window_s"] <= 0:
        return None
    return rec.values["events"] / rec.values["window_s"]
