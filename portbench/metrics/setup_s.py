"""Set-up seconds: from the process's start to the first timed batch
(loading, building and warming up)."""


def read(rec):
    return rec.setup_s
