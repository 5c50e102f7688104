"""Host uint8 frames through ``EmbeddingEngine.embed_batch``: the pinned
staging and non-blocking copy, kernel A, the encoder with kernel B, the
pooled class token L2-normalised, and the readback to host floats.

Every call embeds the whole pool of distinct frames (several engine
batches, so the engine keeps one batch in flight as it does over a
game). What is compared: from every call a sample of rows drawn from the
seed, and every row of the last call, against the reference's
embeddings of the same frames.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from harness import compare, cost, reference, seeds, traffic, weights
from harness.entries import Clock


def vit_config(cfg: dict):
    """The program's ``ViTConfig`` for a configuration file."""
    from vit_research_tpu_torch.utils.configs import ViTConfig

    return ViTConfig(
        image_size=cost.image_hw(cfg), patch_size=cfg["patch_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        mlp_dim=cfg["intermediate_size"],
        layer_norm_eps=cfg["layer_norm_eps"], pooler=cfg["pooler"],
        gelu_approximate=cfg["hidden_act"] != "gelu", dtype=cfg["dtype"])


class Entry:
    span = "embed_batch"

    def __init__(self, cfg: dict, t: dict, seed: int, device):
        from vit_research_tpu_torch.data.preprocess import PreprocessSpec
        from vit_research_tpu_torch.models.vit import VisionTransformer
        from vit_research_tpu_torch.ops import attention, patch_embed
        from vit_research_tpu_torch.parallel.embed import EmbeddingEngine

        self.cfg, self.t, self.device = cfg, t, torch.device(device)
        clock = Clock()
        self.weights = weights.vit_weights(cfg, seed, self.device)
        clock("weights")
        self.frames = traffic.frames(cost.image_hw(cfg), t, seed, self.device)
        clock("frames")
        # built on the card, its init's draws overwritten below (built on
        # the meta device, it took 7-9 s of an H100 run's set-up)
        with torch.device(self.device):
            model = VisionTransformer(vit_config(cfg))
        clock("model_init")
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(self.weights[name])
        clock("model_load")
        pre = cfg["preprocess"]
        spec = PreprocessSpec(size=cost.image_hw(cfg),
                              rescale=pre["rescale"], mean=tuple(pre["mean"]),
                              std=tuple(pre["std"]),
                              interpolation=pre["interpolation"])
        self.engine = EmbeddingEngine(model, spec, device=self.device,
                                      batch_size=cfg["batch"],
                                      endpoint="pooled", l2_normalize=True)
        clock("engine")
        self._counters = {"kernel_b": attention.multi_head_attention,
                          "kernel_a": patch_embed.fused_patch_embed}
        self._sample = seeds.rng(seed, "sample")
        self.kept, self.last = [], None
        self.engine.embed_batch(self.frames)  # warm-up: the window's call
        clock("warmup")
        self.setup_phases = clock.phases
        self._counts0 = self._counts()

    def _counts(self) -> dict:
        return {k: dict(fn.launches_by_kernel)
                for k, fn in self._counters.items()}

    def call(self) -> tuple:
        """(frames asked for, frames with no embedding returned)."""
        out = self.engine.embed_batch(self.frames)
        n = len(self.frames)
        rows = self._sample.choice(n, min(self.t["sample_rows_per_call"], n),
                                   replace=False)
        self.kept.append((rows, np.array(out[rows])))
        self.last = out
        missing = n if out.ndim != 2 or out.shape[1] != self.cfg[
            "hidden_size"] else max(0, n - out.shape[0])
        return n, missing

    def end_to_end(self, calls: list, start: float) -> dict:
        frames = sum(c[2] for c in calls)
        return {"embed_fps": frames / (calls[-1][1] - start)}

    def run_info(self, calls: list) -> dict:
        batch = self.cfg["batch"]
        now = self._counts()
        launches = {k: {n: c - self._counts0[k].get(n, 0)
                        for n, c in now[k].items()
                        if c - self._counts0[k].get(n, 0)}
                    for k in now}
        return {"batch": batch,
                "batches": sum(-(-c[2] // batch) for c in calls),
                "flops_per_frame": cost.config_flops_per_frame(self.cfg),
                "linear_bound_s": cost.linear_bound_s(self.cfg, batch),
                "attention_bound_s": cost.config_attention_bound_s(
                    self.cfg, batch),
                "dtype": self.cfg["dtype"], "launches": launches}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self) -> dict:
        want = reference.embed_frames(self.weights, self.cfg, self.frames,
                                      self.device)
        return {"embed_gap": self._gap(want)}

    def _gap(self, want: np.ndarray) -> float:
        gaps = [compare.embed_gap(got, want[rows]) for rows, got in self.kept]
        gaps.append(compare.embed_gap(self.last, want))
        return max(gaps)

    def control(self) -> dict:
        """The reference in TF32 in the program's place, held to the same
        comparison."""
        want = reference.embed_frames(self.weights, self.cfg, self.frames,
                                      self.device)
        low = reference.embed_frames(self.weights, self.cfg, self.frames,
                                     self.device, tf32=True)
        return {"embed_gap": compare.embed_gap(low, want)}
