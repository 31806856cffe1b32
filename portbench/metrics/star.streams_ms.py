"""Milliseconds the star engine's wall streams held the traced batch: the
program's ``star.streams`` span, from its start to its end or to the end
of the last device operation launched inside it, whichever is later."""


def read(rec):
    s = rec.values.get("stage_s", {}).get("star.streams")
    return 1e3 * s if s else None
