"""store_host_ms.search: a query batch's wall time less the device time
inside it (the lock, normalisation, routing, the copies' waits and the
ids, distances and metadata lists), the mean over the window's
batches."""


def read(rec, run):
    if rec is None or rec.busy_s <= 0:
        return None
    spans = rec.busy_within_spans("query")
    if not spans:
        return None
    return 1e3 * sum(wall - busy for wall, busy in spans) / len(spans)
