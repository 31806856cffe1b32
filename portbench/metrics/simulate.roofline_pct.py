"""The simulate call's share of its roofline, in percent: the least time
the traced batch's events need on the card (``portbench.roofline``,
counted from the events and the component's shape) over the device time
of every operation the simulate call ran."""


def read(rec):
    least = rec.values.get("traced_least_s")
    busy = rec.values.get("traced_simulate_device_s")
    if not least or not busy:
        return None
    return 100.0 * least / busy
