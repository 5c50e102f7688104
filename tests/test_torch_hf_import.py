"""The port's HF weight import (models/hf_import.py) against the JAX
package's and against HuggingFace's own forward, on a locally built,
seeded ``transformers.ViTModel`` (nothing is downloaded).

Tolerances: the mapped parameter trees are exact copies (equal leaf for
leaf). Forwards of the same weights in three libraries with TF32 off: the
port's CLS token and pooler output within 1e-5 of HF's and of the JAX
package's model.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.models import hf_import as jax_hf
from vit_research_tpu_torch.models import hf_import
from vit_research_tpu_torch.parallel import embed
from vit_research_tpu_torch.data.preprocess import PreprocessSpec

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=1e-5, rtol=1e-5)


def _hf_model(pooler: bool, seed: int = 0, image_size: int = 32):
    cfg = transformers.ViTConfig(
        image_size=image_size, patch_size=8, hidden_size=48,
        num_hidden_layers=2, num_attention_heads=3, intermediate_size=96)
    hf = transformers.ViTModel(cfg, add_pooling_layer=pooler).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            base = 1.0 if name.endswith("layernorm.weight") or (
                "layernorm_" in name and name.endswith("weight")) else 0.0
            p.copy_(torch.from_numpy(
                base + rng.normal(0, 0.1, p.shape).astype(np.float32)))
    return hf


def _images(seed=1, n=3, size=32):
    return np.random.default_rng(seed).normal(
        scale=0.5, size=(n, size, size, 3)).astype(np.float32)


def test_hf_vit_b16_config_is_the_jax_packages():
    assert hf_import.HF_VIT_B16_224.to_dict() == \
        jax_hf.HF_VIT_B16_224.to_dict()
    assert embed.HF_VIT_B16_224 is hf_import.HF_VIT_B16_224


@pytest.mark.parametrize("pooler", [False, True])
def test_config_and_params_equal_the_jax_mapping(pooler):
    hf = _hf_model(pooler)
    cfg = hf_import.hf_config_to_vit_config(hf.config)
    assert cfg.to_dict() == \
        jax_hf.hf_config_to_vit_config(hf.config).to_dict()
    if pooler:
        cfg = dataclasses.replace(cfg, representation_size=cfg.hidden_size)
    sd = hf.state_dict()
    got = hf_import.hf_state_dict_to_params(sd, cfg)
    want = jax_hf.hf_state_dict_to_params(sd, cfg)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    # numpy state dicts (chip_smoke builds one) map the same way
    np_sd = {k: v.numpy() for k, v in sd.items()}
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           hf_import.hf_state_dict_to_params(np_sd, cfg),
                           want)


@pytest.mark.parametrize("pooler", [False, True])
def test_transplanted_forward_matches_hf_and_jax(pooler):
    hf = _hf_model(pooler, seed=2)
    model, cfg = hf_import.vit_from_torch_model(hf)
    assert (cfg.representation_size is not None) == pooler
    x = _images()
    with torch.no_grad():
        ref = hf(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out["pooled"].numpy(),
                               ref.last_hidden_state[:, 0].numpy(), **TOL)
    np.testing.assert_allclose(out["encoded_tokens"].numpy(),
                               ref.last_hidden_state.numpy(), **TOL)
    if pooler:
        np.testing.assert_allclose(out["pre_logits"].numpy(),
                                   ref.pooler_output.numpy(), **TOL)
    jmodel, jparams, jcfg = jax_hf.vit_from_torch_model(hf)
    assert jcfg.to_dict() == cfg.to_dict()
    jout = jmodel.apply(jparams, jnp.asarray(x))
    for key in ("pooled", "pre_logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   **TOL)


def test_mapped_state_dict_loads_into_the_engine():
    hf = _hf_model(False, seed=3)
    cfg = hf_import.hf_config_to_vit_config(hf.config)
    sd = hf_import.hf_state_dict_to_state_dict(hf.state_dict(), cfg)
    model, _ = hf_import.vit_from_torch_model(hf)
    eng = embed.EmbeddingEngine(model, PreprocessSpec(size=(32, 32)),
                                device="cpu", batch_size=4)
    frames = np.random.default_rng(4).integers(0, 256, (5, 32, 32, 3),
                                               dtype=np.uint8)
    x = (frames.astype(np.float32) / 255 - 0.5) / 0.5
    with torch.no_grad():
        ref = hf(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want = ref.last_hidden_state[:, 0].numpy()
    want /= np.linalg.norm(want, axis=-1, keepdims=True)
    np.testing.assert_allclose(eng.embed_batch(frames), want, **TOL)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v)


def test_load_hf_vit_returns_none_offline(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    assert hf_import.load_hf_vit(local_files_only=True,
                                 cache_dir=str(tmp_path)) is None
