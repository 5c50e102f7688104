"""The engine configurations of the walkthroughs, in one place.

Port of examples/_engines.py: the parity engine (the seeded ViT-B/16 @224
in f32 through parallel/embed.py::make_hf_frame_embedder, nothing
downloaded) and the tiny 32 x 32 test ViTs that the JAX walkthroughs use
on the CPU. The JAX file's ``route_platform`` has no counterpart: every
walkthrough takes ``--device``.
"""

from __future__ import annotations

import argparse
import dataclasses

from vit_research_tpu_torch.data.preprocess import PreprocessSpec
from vit_research_tpu_torch.utils.configs import ViTConfig

#: frames the walkthroughs write: the parity engine's input size, and the
#: tiny test ViT's
FULL_FRAME_SIZE = (224, 224)
TINY_FRAME_SIZE = (32, 32)
TINY_SPEC = PreprocessSpec(size=TINY_FRAME_SIZE)


def tiny_vit(hidden_size: int = 64, num_layers: int = 2) -> ViTConfig:
    """A tiny test ViT of the JAX walkthroughs: 32 x 32 frames, patch 8,
    2 heads, an MLP twice the width."""
    return ViTConfig(image_size=TINY_FRAME_SIZE, patch_size=8,
                     hidden_size=hidden_size, num_layers=num_layers,
                     num_heads=2, mlp_dim=2 * hidden_size)


def build_engine(device, *, tiny: ViTConfig | None = None,
                 batch_size: int = 256, tome_r: int = 0,
                 gemm_quant: str | None = None, gemm_quant_scales=()):
    """The parity engine on ``device`` (seed 0), or with ``tiny`` that
    tiny ViT (seed 0); ``tome_r`` and ``gemm_quant`` select the fast
    profile's engines on the same weights."""
    from vit_research_tpu_torch.models.vit import init_vit
    from vit_research_tpu_torch.parallel.embed import (EmbeddingEngine,
                                                       make_hf_frame_embedder)

    if tiny is None:
        return make_hf_frame_embedder(
            device=device, batch_size=batch_size, tome_r=tome_r,
            gemm_quant=gemm_quant, gemm_quant_scales=gemm_quant_scales)
    cfg = dataclasses.replace(tiny, tome_r=tome_r, gemm_quant=gemm_quant,
                              gemm_quant_scales=tuple(gemm_quant_scales))
    return EmbeddingEngine(init_vit(cfg, seed=0, device="cpu"), TINY_SPEC,
                           device=device, batch_size=batch_size)


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the walkthroughs' common switches."""
    ap = argparse.ArgumentParser(
        description=doc.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="where the engine and the heads run (cuda raises "
                         "without a card; cpu runs the plain versions)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test ViT and 32 x 32 frames (the CPU "
                         "tests' size) instead of full width")
    return ap
