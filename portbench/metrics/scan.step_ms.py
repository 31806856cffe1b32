"""Milliseconds a step of the scan engine: the simulate calls' time over
the steps they ran, counted as their logs' columns."""


def read(rec):
    if rec.driver != "sim" or not rec.values.get("columns"):
        return None
    return 1e3 * sum(rec.values["simulate_s"]) / sum(rec.values["columns"])
