"""Single-frame ViT smoke test.

Port of vit_research_tpu/evaluate/smoke.py: build the random-init
patch-32 backbone at 432x768 (``VIT_P32_432x768``), run one seeded frame,
report every endpoint's shape. The frame's uint8 pixels go through the
fused patch embed with the identity affine (the JAX smoke feeds the raw
0..255 values to its model), so on a CUDA device the frame runs kernel A
at P = 32 and kernel B at T = 13 * 24 + 1 = 313, dh = 64.
``python -m vit_research_tpu_torch.evaluate.smoke`` runs it on the card.
"""

from __future__ import annotations

import numpy as np


def smoke_test(config=None, seed: int = 0, verbose: bool = True,
               device="cuda") -> dict:
    import torch

    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.models.vit import init_vit
    from vit_research_tpu_torch.ops.patch_embed import fused_patch_embed
    from vit_research_tpu_torch.utils.configs import VIT_P32_432x768

    dev = resolve_device(device)
    config = config or VIT_P32_432x768
    model = init_vit(config, seed=seed, device=dev).eval()
    frame = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, size=(1, *config.image_size, 3)).astype(np.uint8)).to(dev)
    pe = model.patch_embed
    with torch.no_grad():
        tokens = fused_patch_embed(frame, pe.weight.to(torch.float32),
                                   pe.bias.to(torch.float32),
                                   patch_size=config.patch_size,
                                   out_dtype=model.compute_dtype)
        out = model.encode_patch_tokens(tokens, config.grid)
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if verbose:
        for k, v in shapes.items():
            print(f"{k}: {v}")
    return shapes


if __name__ == "__main__":
    smoke_test()
