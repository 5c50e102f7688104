"""linear_roofline: the encoder GEMMs' share of their roofline. Each
q/k/v/out/fc1/fc2 product of every batch at its bound from shapes
(harness/cost.py), over the device time of the kernels of group
``linear``."""

from harness import cost


def read(rec, run):
    if rec is None:
        return None
    seconds = rec.group_seconds().get("linear", 0.0)
    info = run["info"]
    return cost.share_pct(info["linear_bound_s"] * info["batches"], seconds)
