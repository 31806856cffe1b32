"""The star engine's share of its roofline, in percent: the least time
the traced batch's work needs on the card (``portbench.roofline_star``,
counted from its wall events, posts and sources) over the device time
of every operation inside the program's ``star.simulate_batch`` span."""


def read(rec):
    least = rec.values.get("traced_least_s")
    busy = rec.values.get("traced_batch_device_s")
    if not least or not busy:
        return None
    return 100.0 * least / busy
