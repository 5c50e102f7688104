"""attn_roofline: kernel B's share of its roofline. Every layer's call
a batch at its bound from shapes (q, k, v read once, the output written
once; harness/cost.py), over the device time of the kernels of group
``attn``. Silent where B did not run."""

from harness import cost


def read(rec, run):
    if rec is None:
        return None
    seconds = rec.group_seconds().get("attn", 0.0)
    info = run["info"]
    return cost.share_pct(info["attention_bound_s"] * info["batches"],
                          seconds)
