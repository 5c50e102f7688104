"""mfu.embed: the embed step's share of the card's peak. The analytic
operations of a frame (harness/cost.py) times the frames the engine
returned in the traced window, over the window's host-clock length and
the peak of the configuration's dtype (TF32's 495 TFLOP/s for f32)."""

from harness import cost


def read(rec, run):
    if rec is None or rec.busy_s <= 0:
        return None
    info = run["info"]
    return cost.mfu_pct(info["flops_per_frame"] * run["units"],
                        run["window_s"], info["dtype"])
