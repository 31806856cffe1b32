"""Median decision latency in milliseconds over every batch due in the
window, from when it was due to when ``poll`` returned its decision; a
batch that failed counts as infinitely late."""

import math

from portbench.common import nearest_rank


def read(rec):
    if rec.driver != "serve":
        return None
    v = nearest_rank(rec.values["latencies_s"], 50) * 1e3
    return v if math.isfinite(v) else None
