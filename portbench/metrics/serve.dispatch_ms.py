"""Milliseconds of host time a round spends issuing the apply: the self
time of the program's ``serving.dispatch`` spans (one a round), averaged
over the window's rounds."""

from portbench.trace import span_self_s


def read(rec):
    if rec.driver != "serve":
        return None
    n, total = span_self_s(rec.spans, "serving.dispatch")
    return 1e3 * total / n if n else None
