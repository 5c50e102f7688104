"""mfu.search: the query step's share of the card's peak. The
(Q, D) x (D, N) product's operations of every batch in the traced
window, over the window's host-clock length and the peak of the
configuration's dtype."""

from harness import cost


def read(rec, run):
    if rec is None or rec.busy_s <= 0:
        return None
    info = run["info"]
    return cost.mfu_pct(info["query_flops"] * info["batches"],
                        run["window_s"], info["dtype"])
