"""Milliseconds the ``Opt`` fires held the traced batch: the program's
``star.fires`` spans (a second one where the compressed fires overflowed
and ran again uncompressed), each from its start to its end or to the
end of the last device operation launched inside it, whichever is
later, summed."""


def read(rec):
    s = rec.values.get("stage_s", {}).get("star.fires")
    return 1e3 * s if s else None
