"""HuggingFace ViT weights into the port's backbone.

Port of vit_research_tpu/models/hf_import.py. The reference's frozen
frame embedder is the torch ``google/vit-base-patch16-224``
(nba_proj/train/training.py:37-39,
nba_proj/db_maintainence/build_embeddings_store.py:32-35). A
``transformers.ViTModel`` state dict maps first onto the JAX package's
parameter tree (:func:`hf_state_dict_to_params`, the same numpy tree the
JAX function yields, leaf for leaf), then through
models/convert.py::params_to_state_dict onto models/vit.py: one mapping
into the port's modules, not two. Nothing here downloads:
:func:`load_hf_vit` returns None without transformers or cached weights,
and an offline caller passes a locally built ``ViTModel`` to
:func:`vit_from_torch_model`.

SigLIP's vision tower (``transformers.SiglipVisionModel``, e.g.
``google/siglip-so400m-patch14-384``) has no counterpart in the JAX
package: :func:`siglip_state_dict_to_port` maps its state dict straight
onto the port's keys, the attention-pooling head's packed in-projection
split into the port's separate q/k/v.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vit_research_tpu_torch.utils.configs import ViTConfig

#: google/vit-base-patch16-224 as a ViTConfig.
HF_VIT_B16_224 = ViTConfig(
    image_size=(224, 224), patch_size=16, hidden_size=768, num_layers=12,
    num_heads=12, mlp_dim=3072, layer_norm_eps=1e-12, gelu_approximate=False,
    pooler="token",
)


#: google/siglip-so400m-patch14-384's vision tower as a ViTConfig: 27
#: layers of 1,152 wide, 16 heads of 72, a tanh-GELU MLP of 4,304, patch
#: 14 at 384 (a 27 x 27 grid, T = 729, no class token), LayerNorm eps
#: 1e-6, the attention-pooling head.
SIGLIP_SO400M_P14_384 = ViTConfig(
    image_size=(384, 384), patch_size=14, hidden_size=1152, num_layers=27,
    num_heads=16, mlp_dim=4304, layer_norm_eps=1e-6, gelu_approximate=True,
    pooler="map", class_token=False,
)


def hf_config_to_vit_config(hf_cfg) -> ViTConfig:
    return ViTConfig(
        image_size=(hf_cfg.image_size, hf_cfg.image_size),
        patch_size=hf_cfg.patch_size,
        hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        mlp_dim=hf_cfg.intermediate_size,
        layer_norm_eps=hf_cfg.layer_norm_eps,
        gelu_approximate=False,
        pooler="token",
    )


def hf_state_dict_to_params(state_dict, config: ViTConfig) -> dict:
    """``ViTModel`` state dict (torch tensors or numpy arrays) -> the JAX
    package's ``{"params": ...}`` tree of numpy arrays."""

    def t(name):
        v = state_dict[name]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                          else v)

    d = config.hidden_size
    h = config.num_heads
    dh = d // h
    params = {
        "cls": t("embeddings.cls_token"),
        "pos_embedding": t("embeddings.position_embeddings"),
        "patch_embed": {
            # torch conv (D, C, P, P) -> HWIO (P, P, C, D)
            "kernel": t("embeddings.patch_embeddings.projection.weight")
            .transpose(2, 3, 1, 0),
            "bias": t("embeddings.patch_embeddings.projection.bias"),
        },
        "encoder_norm": {
            "scale": t("layernorm.weight"),
            "bias": t("layernorm.bias"),
        },
    }
    for i in range(config.num_layers):
        pre = f"encoder.layer.{i}."
        blk = {
            "ln1": {"scale": t(pre + "layernorm_before.weight"),
                    "bias": t(pre + "layernorm_before.bias")},
            "ln2": {"scale": t(pre + "layernorm_after.weight"),
                    "bias": t(pre + "layernorm_after.bias")},
            "attn": {},
            "mlp": {
                "fc1": {"kernel": t(pre + "intermediate.dense.weight").T,
                        "bias": t(pre + "intermediate.dense.bias")},
                "fc2": {"kernel": t(pre + "output.dense.weight").T,
                        "bias": t(pre + "output.dense.bias")},
            },
        }
        for name in ("query", "key", "value"):
            wk = t(pre + f"attention.attention.{name}.weight")  # (D, D)
            bk = t(pre + f"attention.attention.{name}.bias")  # (D,)
            blk["attn"][name] = {
                "kernel": wk.T.reshape(d, h, dh),
                "bias": bk.reshape(h, dh),
            }
        wo = t(pre + "attention.output.dense.weight")  # (D, D): out x in
        blk["attn"]["out"] = {
            "kernel": wo.T.reshape(h, dh, d),
            "bias": t(pre + "attention.output.dense.bias"),
        }
        params[f"block_{i}"] = blk
    if config.representation_size is not None and \
            "pooler.dense.weight" in state_dict:
        params["pre_logits"] = {
            "kernel": t("pooler.dense.weight").T,
            "bias": t("pooler.dense.bias"),
        }
    return {"params": params}


def hf_state_dict_to_state_dict(state_dict, config: ViTConfig) -> dict:
    """``ViTModel`` state dict -> the port's ``state_dict`` for
    models/vit.py::VisionTransformer (what
    parallel/embed.py::make_hf_frame_embedder loads)."""
    from vit_research_tpu_torch.models.convert import params_to_state_dict

    return params_to_state_dict(hf_state_dict_to_params(state_dict, config),
                                config)


def vit_from_torch_model(hf_model):
    """Transplant an in-memory ``transformers.ViTModel`` (any size):
    returns (model, config), the model on the CPU in eval mode. With HF's
    pooler, the port's ``pre_logits`` endpoint is HF's
    ``pooler_output``."""
    from vit_research_tpu_torch.models.vit import VisionTransformer

    config = hf_config_to_vit_config(hf_model.config)
    if getattr(hf_model, "pooler", None) is not None:
        config = dataclasses.replace(
            config, representation_size=config.hidden_size)
    model = VisionTransformer(config)
    model.load_state_dict(hf_state_dict_to_state_dict(hf_model.state_dict(),
                                                      config))
    return model.eval(), config


def load_hf_vit(model_name: str = "google/vit-base-patch16-224", **kwargs):
    """(model, config) from a HF checkpoint when transformers and its
    weights are on this machine, else None (nothing is downloaded here
    unless ``from_pretrained`` finds the network; pass
    ``local_files_only=True`` to pin a cached checkpoint)."""
    try:
        from transformers import ViTModel

        hf = ViTModel.from_pretrained(model_name, **kwargs)
    except Exception:
        return None
    return vit_from_torch_model(hf)


def siglip_state_dict_to_port(state_dict, config: ViTConfig) -> dict:
    """``SiglipVisionModel`` state dict (keys with or without the
    ``vision_model.`` prefix; torch tensors or numpy arrays) -> the port's
    ``state_dict`` for models/vit.py::VisionTransformer with
    ``config`` (float32 CPU tensors): the conv patch kernel (D, C, P, P)
    as (P*P*C, D) rows in (py, px, c) order, the position table as
    (1, N, D), the head's packed in-projection (3D, D) split into q, k, v
    in that order (``nn.MultiheadAttention``'s)."""
    import torch

    def t(name):
        v = state_dict.get(name, state_dict.get("vision_model." + name))
        if v is None:
            raise KeyError(f"{name!r} is not in the SigLIP state dict")
        return torch.as_tensor(np.asarray(
            v.detach().cpu().numpy() if hasattr(v, "detach") else v,
            np.float32))

    d = config.hidden_size
    out = {
        "patch_embed.weight": t("embeddings.patch_embedding.weight")
        .permute(2, 3, 1, 0).reshape(-1, d),
        "patch_embed.bias": t("embeddings.patch_embedding.bias"),
        "pos_embedding": t("embeddings.position_embedding.weight")[None],
        "encoder_norm.weight": t("post_layernorm.weight"),
        "encoder_norm.bias": t("post_layernorm.bias"),
        "head.probe": t("head.probe"),
        "head.norm.weight": t("head.layernorm.weight"),
        "head.norm.bias": t("head.layernorm.bias"),
        "head.out.weight": t("head.attention.out_proj.weight"),
        "head.out.bias": t("head.attention.out_proj.bias"),
    }
    w_in = t("head.attention.in_proj_weight")
    b_in = t("head.attention.in_proj_bias")
    for j, name in enumerate(("query", "key", "value")):
        out[f"head.{name}.weight"] = w_in[j * d:(j + 1) * d]
        out[f"head.{name}.bias"] = b_in[j * d:(j + 1) * d]
    for fc in ("fc1", "fc2"):
        for k in ("weight", "bias"):
            out[f"head.mlp.{fc}.{k}"] = t(f"head.mlp.{fc}.{k}")
    names = {"ln1": "layer_norm1", "ln2": "layer_norm2",
             "attn.query": "self_attn.q_proj", "attn.key": "self_attn.k_proj",
             "attn.value": "self_attn.v_proj",
             "attn.out": "self_attn.out_proj", "mlp.fc1": "mlp.fc1",
             "mlp.fc2": "mlp.fc2"}
    for i in range(config.num_layers):
        for port, hf in names.items():
            for k in ("weight", "bias"):
                out[f"blocks.{i}.{port}.{k}"] = t(
                    f"encoder.layers.{i}.{hf}.{k}")
    return {k: v.contiguous() for k, v in out.items()}

