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
