"""Seeded ViT weights, made on the device in one draw.

No checkpoint is in the repository and none is fetched: a run's weights
come from ``--seed``. One standard-normal draw of every parameter at once
(a ``torch.Generator`` on the card), then each tensor is a scaled slice
of it: dense and patch kernels LeCun-normal (std 1/sqrt(fan_in)),
biases, class token and position table N(0, 0.02^2), LayerNorm gains
1 + N(0, 0.05^2) and shifts N(0, 0.02^2). Biases and LayerNorm
parameters are not left at 0 and 1, so a program that dropped one would
fail the comparison.

The names are the port's ``state_dict`` keys, so an entry can load them;
the plain reference reads the same dict (:mod:`harness.reference`).
Dense kernels are (out, in), the patch kernel is (P*P*C, D) with its rows
in (py, px, c) order.
"""

from __future__ import annotations

import math

import torch

from harness import cost, seeds


def vit_shapes(cfg: dict) -> list:
    """(name, shape, kind) of every parameter, kind being what sets its
    scale: ``("dense", fan_in)``, ``"small"`` or ``"gain"``."""
    d = cfg["hidden_size"]
    mlp = cfg["intermediate_size"]
    k = cfg["patch_size"] ** 2 * cfg["num_channels"]
    n_tok = cost.tokens(cfg)
    out = [("patch_embed.weight", (k, d), ("dense", k)),
           ("patch_embed.bias", (d,), "small"),
           ("cls", (1, 1, d), "small"),
           ("pos_embedding", (1, n_tok, d), "small")]
    for i in range(cfg["num_hidden_layers"]):
        b = f"blocks.{i}."
        out += [(b + "ln1.weight", (d,), "gain"), (b + "ln1.bias", (d,),
                                                   "small")]
        for name in ("query", "key", "value", "out"):
            out += [(b + f"attn.{name}.weight", (d, d), ("dense", d)),
                    (b + f"attn.{name}.bias", (d,), "small")]
        out += [(b + "ln2.weight", (d,), "gain"),
                (b + "ln2.bias", (d,), "small"),
                (b + "mlp.fc1.weight", (mlp, d), ("dense", d)),
                (b + "mlp.fc1.bias", (mlp,), "small"),
                (b + "mlp.fc2.weight", (d, mlp), ("dense", mlp)),
                (b + "mlp.fc2.bias", (d,), "small")]
    out += [("encoder_norm.weight", (d,), "gain"),
            ("encoder_norm.bias", (d,), "small")]
    return out


@torch.no_grad()
def vit_weights(cfg: dict, seed: int, device) -> dict:
    """Every parameter of ``cfg``'s ViT, f32 on ``device``, from ``seed``."""
    shapes = vit_shapes(cfg)
    total = sum(math.prod(s) for _, s, _ in shapes)
    flat = torch.randn(total, generator=seeds.generator(seed, "weights",
                                                        device),
                       device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in shapes:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if kind == "gain":
            out[name] = 1.0 + 0.05 * x
        elif kind == "small":
            out[name] = 0.02 * x
        else:
            out[name] = x * (1.0 / math.sqrt(kind[1]))
    return out
