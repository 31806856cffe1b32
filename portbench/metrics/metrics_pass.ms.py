"""Milliseconds a batch of the metrics pass (``feed_metrics_batch`` and
``num_posts``) takes on the host's clock, ending in a device
synchronisation, averaged over the window's batches."""


def read(rec):
    s = rec.values.get("metrics_s") if rec.driver == "sim" else None
    if not s:
        return None
    return 1e3 * sum(s) / len(s)
