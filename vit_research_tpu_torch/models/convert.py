"""Weights between the JAX package's parameter tree and the port.

``params_to_state_dict`` turns the Flax ``VisionTransformer`` tree (a
nested dict of numpy arrays, with or without the outer ``{"params": ...}``)
into a ``state_dict`` for models/vit.py::VisionTransformer, and
``state_dict_to_params`` goes back. Four mappings carry the layout:

- ``patch_embed/kernel`` HWIO (P, P, C, D) -> ``patch_embed.weight``
  (P*P*C, D), rows in (py, px, c) order, as ops/patch_embed.py::patchify;
- ``DenseGeneral`` q/k/v kernels (D, H, dh) -> ``nn.Linear`` (H*dh, D), bias
  (H, dh) -> (H*dh,);
- the ``out`` kernel (H, dh, D) -> (D, H*dh);
- Dense kernels (in, out) -> (out, in); LayerNorm ``scale`` -> ``weight``.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_research_tpu_torch.utils.configs import ViTConfig


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _ln(tree) -> dict:
    return {"weight": _np(tree["scale"]), "bias": _np(tree["bias"])}


def _dense(tree) -> dict:
    return {"weight": _np(tree["kernel"]).T, "bias": _np(tree["bias"])}


def params_to_state_dict(params, config: ViTConfig) -> dict:
    """Flax ViT params -> torch ``state_dict`` (float32 CPU tensors)."""
    p = params.get("params", params)
    d = config.hidden_size
    flat: dict[str, np.ndarray] = {
        "cls": _np(p["cls"]),
        "pos_embedding": _np(p["pos_embedding"]),
        "patch_embed.weight": _np(p["patch_embed"]["kernel"]).reshape(-1, d),
        "patch_embed.bias": _np(p["patch_embed"]["bias"]),
    }
    for k, v in _ln(p["encoder_norm"]).items():
        flat[f"encoder_norm.{k}"] = v
    for i in range(config.num_layers):
        blk = p[f"block_{i}"]
        pre = f"blocks.{i}."
        for name in ("ln1", "ln2"):
            for k, v in _ln(blk[name]).items():
                flat[f"{pre}{name}.{k}"] = v
        for name in ("query", "key", "value"):
            kern = _np(blk["attn"][name]["kernel"])  # (D, H, dh)
            flat[f"{pre}attn.{name}.weight"] = kern.reshape(d, -1).T
            flat[f"{pre}attn.{name}.bias"] = \
                _np(blk["attn"][name]["bias"]).reshape(-1)
        out = _np(blk["attn"]["out"]["kernel"])  # (H, dh, D)
        flat[f"{pre}attn.out.weight"] = out.reshape(-1, d).T
        flat[f"{pre}attn.out.bias"] = _np(blk["attn"]["out"]["bias"])
        for name in ("fc1", "fc2"):
            for k, v in _dense(blk["mlp"][name]).items():
                flat[f"{pre}mlp.{name}.{k}"] = v
    if config.representation_size is not None:
        for k, v in _dense(p["pre_logits"]).items():
            flat[f"pre_logits.{k}"] = v
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in flat.items()}


def state_dict_to_params(state_dict, config: ViTConfig) -> dict:
    """torch ``state_dict`` -> Flax ViT params ``{"params": {...}}`` of
    float32 numpy arrays (the inverse of :func:`params_to_state_dict`)."""
    def t(name):
        return state_dict[name].detach().to("cpu", torch.float32).numpy()

    d = config.hidden_size
    h = config.num_heads
    ps = config.patch_size

    def ln(pre):
        return {"scale": t(pre + ".weight"), "bias": t(pre + ".bias")}

    def dense(pre):
        return {"kernel": t(pre + ".weight").T.copy(),
                "bias": t(pre + ".bias")}

    p = {
        "cls": t("cls"),
        "pos_embedding": t("pos_embedding"),
        "patch_embed": {
            "kernel": t("patch_embed.weight").reshape(ps, ps, -1, d),
            "bias": t("patch_embed.bias"),
        },
        "encoder_norm": ln("encoder_norm"),
    }
    for i in range(config.num_layers):
        pre = f"blocks.{i}."
        attn = {}
        for name in ("query", "key", "value"):
            attn[name] = {
                "kernel": t(f"{pre}attn.{name}.weight").T.reshape(d, h, -1)
                .copy(),
                "bias": t(f"{pre}attn.{name}.bias").reshape(h, -1),
            }
        attn["out"] = {
            "kernel": t(f"{pre}attn.out.weight").T.reshape(h, -1, d).copy(),
            "bias": t(f"{pre}attn.out.bias"),
        }
        p[f"block_{i}"] = {
            "ln1": ln(pre + "ln1"), "ln2": ln(pre + "ln2"), "attn": attn,
            "mlp": {"fc1": dense(pre + "mlp.fc1"),
                    "fc2": dense(pre + "mlp.fc2")},
        }
    if config.representation_size is not None:
        p["pre_logits"] = dense("pre_logits")
    return {"params": p}
