"""query_roofline: an exact query batch's bound from shapes (the
(Q, D) x (D, N) product against reading the (N, D) corpus once;
harness/cost.py), over the device time inside the batch's span. It
counts the same work whatever implements the top-k."""

from harness import cost


def read(rec, run):
    if rec is None:
        return None
    spans = rec.busy_within_spans("query")
    device_s = sum(busy for _, busy in spans)
    return cost.share_pct(run["info"]["query_bound_s"] * len(spans),
                          device_s)
