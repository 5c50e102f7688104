"""The fast profile through ``EmbeddingEngine.embed_batch``: ViT-B/16 at
224 with ToMe merging r tokens a block (ops/tome.py; kernel B with the
log-size key bias) and int8 products with static activation scales
(ops/quant.py), the class token L2-normalised, as the CLI runs it under
``VRT_TOME_R`` and ``VRT_GEMM_QUANT=int8-static``.

Set-up calibrates the scales as ``calibrate-int8`` does, one forward of
the engine under ``ops/quant.py::calibration_mode``, on a pool of frames
of its own (drawn from the seed apart from the window's), and builds the
engine with them. The window's traffic is ``embed-b16-f32``'s.

What is compared: first the program's scales, against those
``harness/fast.py`` calibrates on the same frames by the definition
(``scale_gap``, the largest relative gap of a site's scale); then the
rows of ``embed-b16-f32`` (a seeded sample of every call, every row of
the last), against ``harness/fast.py``'s embeddings of the same frames,
on the program's scales where they passed ``scale_gap``'s limit and on
the reference's own where they did not, each row by its Euclidean
distance to the reference's (of two unit rows: sqrt(2 (1 - cos))). int8
rounding decides the number: an activation a rounding apart lands on the
other side of a quantisation step, and in this path every frame has
some, so the largest element gap of a correct row spreads as widely as
that of a coarser computation's (PERF.md §2 gives the readings), where a
row's distance does not.
A frame whose smallest merge-decision margin (the reference's) lies under
``merge_delta`` is held to ``tie_dist``, the others to ``embed_dist``
(the largest distance) and ``mean_dist`` (the mean); ``tie_share`` (no
limit) is the share of compared frames set aside so.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harness import cost, fast, seeds, traffic, weights
from harness.entries import Clock
from harness.entries import embed


class Entry(embed.Entry):
    span = "embed_batch"

    def __init__(self, cfg: dict, t: dict, seed: int, device):
        from vit_research_tpu_torch.data.preprocess import PreprocessSpec
        from vit_research_tpu_torch.models.vit import VisionTransformer
        from vit_research_tpu_torch.ops import (attention, linear,
                                                patch_embed, quant)
        from vit_research_tpu_torch.parallel.embed import EmbeddingEngine

        self.cfg, self.t, self.device = cfg, t, torch.device(device)
        self.r = t["tome_r"]
        vcfg = dataclasses.replace(embed.vit_config(cfg), tome_r=self.r,
                                   gemm_quant="int8-static")
        clock = Clock()
        self.weights = weights.vit_weights(cfg, seed, self.device)
        clock("weights")
        hw = cost.image_hw(cfg)
        self.frames = traffic.frames(hw, t, seed, self.device)
        self.calib = traffic.frames(
            hw, {**t, "pool_frames": t["calibration_frames"]},
            seeds.sub_seed(seed, "calibration"), self.device)
        clock("frames")
        pre = cfg["preprocess"]
        spec = PreprocessSpec(size=hw, rescale=pre["rescale"],
                              mean=tuple(pre["mean"]), std=tuple(pre["std"]),
                              interpolation=pre["interpolation"])

        def engine(c):
            with torch.device(self.device):
                model = VisionTransformer(c)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(self.weights[name])
            return EmbeddingEngine(model, spec, device=self.device,
                                   batch_size=cfg["batch"],
                                   endpoint="pooled", l2_normalize=True)

        with quant.calibration_mode() as scales:
            engine(vcfg).embed_batch(self.calib)
        self.scales = tuple(float(s) for s in scales)
        clock("calibration")
        self.engine = engine(dataclasses.replace(
            vcfg, gemm_quant_scales=self.scales))
        clock("engine")
        self._counters = {"kernel_b": attention.multi_head_attention,
                          "kernel_a": patch_embed.fused_patch_embed,
                          "linear": linear.linear}
        self._sample = seeds.rng(seed, "sample")
        self.kept, self.last = [], None
        self.engine.embed_batch(self.frames)  # warm-up: the window's call
        clock("warmup")
        self.setup_phases = clock.phases
        self._counts0 = self._counts()

    def run_info(self, calls: list) -> dict:
        info = super().run_info(calls)
        batch = self.cfg["batch"]
        info.update(flops_per_frame=fast.flops_per_frame(self.cfg, self.r),
                    attention_bound_s=fast.attention_bound_s(self.cfg, batch,
                                                             self.r),
                    tome_r=self.r, gemm_quant="int8-static")
        # the f32 bound of the products; int8 products can pass it, so no
        # linear_roofline is read in this cell
        info.pop("linear_bound_s")
        return info

    def _reference(self, scales):
        """(``scale_gap`` of ``scales`` to the reference's own
        calibration, the reference's embeddings, its merge margins): on
        ``scales`` where that gap is within its limit, else on its own."""
        own = fast.calibrate(self.weights, self.cfg, self.calib, self.r,
                             self.device)
        gap = fast.scale_gap(scales, own)
        use = scales if gap <= self.t["limits"]["scale_gap"] else own
        want, margins = fast.embed_frames(self.weights, self.cfg,
                                          self.frames, use, self.r,
                                          self.device)
        return gap, want, margins

    def _held(self, got_rows: list, want: np.ndarray,
              margins: np.ndarray) -> dict:
        """``embed_dist`` and ``mean_dist``: the largest and the mean
        distance of a compared row of a frame at or above the margin;
        ``tie_dist``: the largest of one below it; ``tie_share``: the
        share of compared rows below it."""
        tie = margins < self.t["merge_delta"]
        far, near_err = [], []
        n = 0
        for rows, got in got_rows:
            if got.shape != (len(rows), want.shape[1]):
                return {"embed_dist": float("inf"), "mean_dist": float("inf"),
                        "tie_dist": float("inf"), "tie_share": 0.0}
            err = np.linalg.norm(got.astype(np.float64) - want[rows], axis=1)
            err = np.where(np.isfinite(err), err, np.inf)
            near = tie[rows]
            far.append(err[~near])
            near_err.append(err[near])
            n += len(rows)
        far, near_err = np.concatenate(far), np.concatenate(near_err)
        return {"embed_dist": float(far.max(initial=0.0)),
                "mean_dist": float(far.mean()) if len(far) else 0.0,
                "tie_dist": float(near_err.max(initial=0.0)),
                "tie_share": len(near_err) / max(n, 1)}

    def _compared(self) -> list:
        return self.kept + [(np.arange(len(self.frames)), self.last)]

    def checks(self) -> dict:
        gap, want, margins = self._reference(self.scales)
        return {"scale_gap": gap,
                **self._held(self._compared(), want, margins)}

    def control(self) -> dict:
        """The reference computed with the workload's ``control`` setting
        (``tf32``: TF32 in its float products; ``act_bits``: 7-bit
        activations), calibration included, in the program's place, held
        to the same comparison."""
        low_scales = fast.calibrate(self.weights, self.cfg, self.calib,
                                    self.r, self.device, **self.t["control"])
        gap, want, margins = self._reference(low_scales)
        low, _ = fast.embed_frames(self.weights, self.cfg, self.frames,
                                   low_scales, self.r, self.device,
                                   **self.t["control"])
        rows = np.arange(len(self.frames))
        return {"scale_gap": gap, **self._held([(rows, low)], want, margins)}
