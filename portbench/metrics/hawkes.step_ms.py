"""Milliseconds a step of the Hawkes thinning loop (one proposal of every
source still drawing): the program's ``star.streams.hawkes`` span in the
traced batch over its ``star.hawkes.steps`` counter."""


def read(rec):
    s = rec.values.get("stage_s", {}).get("star.streams.hawkes")
    steps = rec.values.get("counters", {}).get("star.hawkes.steps")
    return 1e3 * s / steps if s and steps else None
