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

``side_mlp_to_state_dict`` / ``side_mlp_to_params`` do the same for the
side classifier (segment/clustering.py::SideMLP), whose Flax tree is also
the format of its ``.npz`` files (train/checkpoint.py), and
``chunk_encoder_to_state_dict`` / ``chunk_encoder_to_params`` for the
stage-1 ``ChunkEncoder`` (models/heads.py), whose blocks are the
backbone's; ``projection_head_to_state_dict`` / ``projection_head_to_params``
for ``ProjectionHead`` (768 -> 768 and 2304 -> 768), and
``rag_head_to_state_dict`` / ``rag_head_to_params`` and
``ratt_head_to_state_dict`` / ``ratt_head_to_params`` for ``RAGHead`` and
``RATTHead``, and ``ratt_v2_to_state_dict`` for stage 2's ``RATTHeadV2``
(models/ratt_v2.py); ``temporal_head_to_state_dict`` /
``temporal_head_to_params`` for the segmentation ``TemporalHead``
(models/temporal_head.py: flax Conv kernels (k, in, out) -> Conv1d
weights (out, in, k)), whose flax tree is the format of its
``temporal_head.npz``; and ``rag_vit_to_state_dict`` /
``rag_vit_to_params`` for ``RAGVisionTransformer`` (models/rag_vit.py).
"""

from __future__ import annotations

import numpy as np
import torch

from vit_research_tpu_torch.utils.configs import ChunkEncoderConfig, ViTConfig


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _ln(tree) -> dict:
    return {"weight": _np(tree["scale"]), "bias": _np(tree["bias"])}


def _dense(tree) -> dict:
    return {"weight": _np(tree["kernel"]).T, "bias": _np(tree["bias"])}


def _block_to_flat(blk, pre: str, d: int) -> dict:
    """One flax ``EncoderBlock`` tree -> flat ``state_dict`` entries under
    ``pre``."""
    flat = {}
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
    return flat


def _tensors(flat: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in flat.items()}


def _getter(state_dict):
    def t(name):
        return state_dict[name].detach().to("cpu", torch.float32).numpy()
    return t


def _block_to_tree(t, pre: str, d: int, h: int) -> dict:
    """The inverse of :func:`_block_to_flat` (``t``: name -> numpy)."""
    def ln(name):
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    def dense(name):
        return {"kernel": t(name + ".weight").T.copy(),
                "bias": t(name + ".bias")}

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
    return {"ln1": ln(pre + "ln1"), "ln2": ln(pre + "ln2"), "attn": attn,
            "mlp": {"fc1": dense(pre + "mlp.fc1"),
                    "fc2": dense(pre + "mlp.fc2")}}


def _check_jax_expressible(config: ViTConfig) -> None:
    """The JAX package's ViT has a class token and no ``map`` pooler: a
    configuration without the one or with the other (SigLIP's) has no
    parameter tree there to convert to or from. ``config`` may be either
    package's ``ViTConfig`` (the JAX package's has no ``class_token``)."""
    if not getattr(config, "class_token", True) or config.pooler == "map":
        raise ValueError(
            "the JAX package has no ViT without a class token or with the "
            "'map' pooler (SigLIP's vision tower): its weights come from "
            "models/hf_import.py::siglip_state_dict_to_port, not through "
            "models/convert.py")


def params_to_state_dict(params, config: ViTConfig) -> dict:
    """Flax ViT params -> torch ``state_dict`` (float32 CPU tensors)."""
    _check_jax_expressible(config)
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
        flat.update(_block_to_flat(p[f"block_{i}"], f"blocks.{i}.", d))
    if config.representation_size is not None:
        for k, v in _dense(p["pre_logits"]).items():
            flat[f"pre_logits.{k}"] = v
    return _tensors(flat)


def state_dict_to_params(state_dict, config: ViTConfig) -> dict:
    """torch ``state_dict`` -> Flax ViT params ``{"params": {...}}`` of
    float32 numpy arrays (the inverse of :func:`params_to_state_dict`)."""
    _check_jax_expressible(config)
    t = _getter(state_dict)
    d = config.hidden_size
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
        p[f"block_{i}"] = _block_to_tree(t, f"blocks.{i}.", d,
                                         config.num_heads)
    if config.representation_size is not None:
        p["pre_logits"] = dense("pre_logits")
    return {"params": p}


_SIDE_MLP_LAYERS = ("fc1", "fc2", "out")


def side_mlp_to_state_dict(params) -> dict:
    """The JAX package's Flax ``SideMLP`` params (numpy, with or without
    the outer ``{"params": ...}``) -> ``state_dict`` of
    segment/clustering.py::SideMLP (Dense kernels (in, out) -> (out, in))."""
    p = params.get("params", params)
    return {f"{name}.{k}": torch.from_numpy(np.array(v, np.float32))
            for name in _SIDE_MLP_LAYERS
            for k, v in _dense(p[name]).items()}


def side_mlp_to_params(state_dict) -> dict:
    """``SideMLP`` ``state_dict`` -> the Flax tree ``{"params": {"fc1":
    {"kernel", "bias"}, ...}}`` of float32 numpy arrays (the inverse of
    :func:`side_mlp_to_state_dict`)."""
    def t(name):
        return state_dict[name].detach().to("cpu", torch.float32).numpy()

    return {"params": {
        name: {"kernel": t(f"{name}.weight").T.copy(),
               "bias": t(f"{name}.bias").copy()}
        for name in _SIDE_MLP_LAYERS}}


def chunk_encoder_to_state_dict(params) -> dict:
    """The JAX package's flax ``ChunkEncoder`` params (numpy, with or
    without the outer ``{"params": ...}``) -> ``state_dict`` of
    models/heads.py::ChunkEncoder (float32 CPU tensors)."""
    p = params.get("params", params)
    d = _np(p["cls_token"]).shape[-1]
    flat = {"cls_token": _np(p["cls_token"]),
            "pos_embedding": _np(p["pos_embedding"])}
    for k, v in _ln(p["norm"]).items():
        flat[f"norm.{k}"] = v
    n_blocks = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_blocks):
        flat.update(_block_to_flat(p[f"block_{i}"], f"blocks.{i}.", d))
    for name in ("fc", "logit"):
        for k, v in _dense(p["class_head"][name]).items():
            flat[f"class_head.{name}.{k}"] = v
    return _tensors(flat)


def chunk_encoder_to_params(state_dict,
                            config: ChunkEncoderConfig) -> dict:
    """``ChunkEncoder`` ``state_dict`` -> the flax tree ``{"params":
    {...}}`` of float32 numpy arrays (the inverse of
    :func:`chunk_encoder_to_state_dict`; ``config`` gives the head count)."""
    t = _getter(state_dict)
    d = config.embed_dim
    p = {"cls_token": t("cls_token"), "pos_embedding": t("pos_embedding"),
         "norm": {"scale": t("norm.weight"), "bias": t("norm.bias")},
         "class_head": {name: {"kernel": t(f"class_head.{name}.weight").T
                               .copy(),
                               "bias": t(f"class_head.{name}.bias")}
                        for name in ("fc", "logit")}}
    for i in range(config.num_layers):
        p[f"block_{i}"] = _block_to_tree(t, f"blocks.{i}.", d,
                                         config.num_heads)
    return {"params": p}


_PROJECTION_LAYERS = ("d1", "d2", "out")


def projection_head_to_state_dict(params) -> dict:
    """The JAX package's flax ``ProjectionHead`` params (numpy, with or
    without the outer ``{"params": ...}``) -> ``state_dict`` of
    models/heads.py::ProjectionHead."""
    p = params.get("params", params)
    return _tensors({f"{name}.{k}": v for name in _PROJECTION_LAYERS
                     for k, v in _dense(p[name]).items()})


def projection_head_to_params(state_dict) -> dict:
    """``ProjectionHead`` ``state_dict`` -> the flax tree ``{"params":
    {"d1": {"kernel", "bias"}, "d2": ..., "out": ...}}`` (the inverse of
    :func:`projection_head_to_state_dict`)."""
    t = _getter(state_dict)
    return {"params": {name: {"kernel": t(f"{name}.weight").T.copy(),
                              "bias": t(f"{name}.bias")}
                       for name in _PROJECTION_LAYERS}}


def _head_to_flat(p, mlps: tuple) -> dict:
    """The parts RAGHead and RATTHead share: type embeddings, position
    table, blocks, final LayerNorm and the classifier MLPs ``mlps``."""
    d = _np(p["cls_type"]).shape[-1]
    flat = {name: _np(p[name])
            for name in ("cls_type", "ret_type", "pos_embedding")}
    for k, v in _ln(p["norm"]).items():
        flat[f"norm.{k}"] = v
    n_blocks = sum(1 for k in p if k.startswith("block_"))
    for i in range(n_blocks):
        flat.update(_block_to_flat(p[f"block_{i}"], f"blocks.{i}.", d))
    for mlp in mlps:
        if mlp in p:
            for name in ("fc", "logit"):
                for k, v in _dense(p[mlp][name]).items():
                    flat[f"{mlp}.{name}.{k}"] = v
    return flat


def _head_to_tree(state_dict, config, mlps: tuple) -> dict:
    t = _getter(state_dict)
    p = {name: t(name) for name in ("cls_type", "ret_type", "pos_embedding")}
    p["norm"] = {"scale": t("norm.weight"), "bias": t("norm.bias")}
    for i in range(config.num_layers):
        p[f"block_{i}"] = _block_to_tree(t, f"blocks.{i}.", config.embed_dim,
                                         config.num_heads)
    for mlp in mlps:
        if f"{mlp}.fc.weight" in state_dict:
            p[mlp] = {name: {"kernel": t(f"{mlp}.{name}.weight").T.copy(),
                             "bias": t(f"{mlp}.{name}.bias")}
                      for name in ("fc", "logit")}
    return p


def rag_head_to_state_dict(params) -> dict:
    """The JAX package's flax ``RAGHead`` params -> ``state_dict`` of
    models/heads.py::RAGHead (float32 CPU tensors)."""
    p = params.get("params", params)
    flat = _head_to_flat(p, ("classifier",))
    flat["pooler.retrieval_queries"] = _np(
        p["pooler"]["retrieval_queries"])
    return _tensors(flat)


def rag_head_to_params(state_dict, config) -> dict:
    """``RAGHead`` ``state_dict`` -> the flax tree ``{"params": {...}}``
    (the inverse of :func:`rag_head_to_state_dict`; ``config``, a
    ``HeadConfig``, gives the layer and head counts)."""
    p = _head_to_tree(state_dict, config, ("classifier",))
    p["pooler"] = {"retrieval_queries":
                   _getter(state_dict)("pooler.retrieval_queries")}
    return {"params": p}


def ratt_head_to_state_dict(params) -> dict:
    """The JAX package's flax ``RATTHead`` params (with or without the
    relevance head) -> ``state_dict`` of models/heads.py::RATTHead."""
    p = params.get("params", params)
    return _tensors(_head_to_flat(p, ("class_head", "relevance_head")))


def ratt_head_to_params(state_dict, config) -> dict:
    """``RATTHead`` ``state_dict`` -> the flax tree ``{"params": {...}}``
    (the inverse of :func:`ratt_head_to_state_dict`)."""
    return {"params": _head_to_tree(state_dict, config,
                                    ("class_head", "relevance_head"))}


def ratt_v2_to_state_dict(params) -> dict:
    """The JAX package's flax ``RATTHeadV2`` params (numpy, with or without
    the outer ``{"params": ...}``) -> ``state_dict`` of
    models/ratt_v2.py::RATTHeadV2: ``query_proj``, the three branch
    projections' ``fc1``/``fc2``, ``transformer_block_{i}`` ->
    ``blocks.{i}``, ``norm``, ``classifier_fc``, ``classifier_logit`` and
    the twelve (1, 1, D) tokens."""
    from vit_research_tpu_torch.models.ratt_v2 import BRANCHES, TOKENS

    p = params.get("params", params)
    d = _np(p["cls_token"]).shape[-1]
    flat = {name: _np(p[name]) for name in TOKENS}
    for name in ("query_proj", "classifier_fc", "classifier_logit"):
        for k, v in _dense(p[name]).items():
            flat[f"{name}.{k}"] = v
    for branch in BRANCHES:
        for fc in ("fc1", "fc2"):
            for k, v in _dense(p[branch][fc]).items():
                flat[f"{branch}.{fc}.{k}"] = v
    for k, v in _ln(p["norm"]).items():
        flat[f"norm.{k}"] = v
    n_blocks = sum(1 for k in p if k.startswith("transformer_block_"))
    for i in range(n_blocks):
        flat.update(_block_to_flat(p[f"transformer_block_{i}"],
                                   f"blocks.{i}.", d))
    return _tensors(flat)


_TEMPORAL_LAYERS = ("conv_0", "conv_1", "conv_2", "conv_3", "conv_out")


def temporal_head_to_state_dict(params) -> dict:
    """The JAX package's flax ``TemporalHead`` params (numpy, with or
    without the outer ``{"params": ...}``) -> ``state_dict`` of
    models/temporal_head.py::TemporalHead: each Conv kernel (k, in, out)
    -> a Conv1d weight (out, in, k)."""
    p = params.get("params", params)
    return _tensors({f"{name}.{k}": v for name in _TEMPORAL_LAYERS
                     for k, v in (
                         ("weight", _np(p[name]["kernel"]).transpose(2, 1, 0)),
                         ("bias", _np(p[name]["bias"])))})


def temporal_head_to_params(state_dict) -> dict:
    """``TemporalHead`` ``state_dict`` -> the flax tree ``{"params":
    {"conv_0": {"kernel", "bias"}, ...}}`` of float32 numpy arrays (the
    inverse of :func:`temporal_head_to_state_dict`)."""
    t = _getter(state_dict)
    return {"params": {
        name: {"kernel": t(f"{name}.weight").transpose(2, 1, 0).copy(),
               "bias": t(f"{name}.bias")}
        for name in _TEMPORAL_LAYERS}}


def rag_vit_to_state_dict(params, config: ViTConfig) -> dict:
    """The JAX package's flax ``RAGVisionTransformer`` params (numpy, with
    or without the outer ``{"params": ...}``) -> ``state_dict`` of
    models/rag_vit.py::RAGVisionTransformer: the ViT's mapping (the
    ``patch_embed`` Conv's HWIO kernel -> ``PatchEmbed.weight``) plus the
    retrieval pooler's queries and ``ret_type``."""
    p = params.get("params", params)
    sd = params_to_state_dict(p, config)
    sd["retrieval_pooler.retrieval_queries"] = torch.from_numpy(_np(
        p["retrieval_pooler"]["retrieval_queries"]).copy())
    sd["ret_type"] = torch.from_numpy(_np(p["ret_type"]).copy())
    return sd


def rag_vit_to_params(state_dict, config: ViTConfig) -> dict:
    """``RAGVisionTransformer`` ``state_dict`` -> the flax tree
    ``{"params": {...}}`` (the inverse of :func:`rag_vit_to_state_dict`)."""
    t = _getter(state_dict)
    p = state_dict_to_params(state_dict, config)["params"]
    p["retrieval_pooler"] = {
        "retrieval_queries": t("retrieval_pooler.retrieval_queries")}
    p["ret_type"] = t("ret_type")
    return {"params": p}
