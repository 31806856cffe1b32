"""Milliseconds a round waits on durability: the program's
``serving.repl.quorum`` spans and the ``serving.journal.fsync`` spans
inside a round (an fsync on the journal's background flush thread opens
a trace of its own and waits on no round), summed over the window and
divided by its rounds (``serving.dispatch`` spans, one a round)."""


def read(rec):
    if rec.driver != "serve":
        return None
    rounds = waited = 0
    for s in rec.spans:
        if s["name"] == "serving.dispatch":
            rounds += 1
        elif s["name"] == "serving.repl.quorum" or (
                s["name"] == "serving.journal.fsync"
                and s.get("parent") is not None):
            waited += float(s.get("dur", 0.0))
    return 1e3 * waited / rounds if rounds else None
