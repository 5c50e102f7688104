"""The port's ViT backbone, weight converter and embedding engine against
the JAX package, at the tiny test sizes (1 and 2 layers, width 32/64).

Weights come from the JAX seeded init and are converted
(models/convert.py); inputs are drawn with numpy from fixed seeds. The
JAX side runs its Pallas kernels in interpret mode. Tolerances: both
sides compute in f32 on the CPU; they differ in summation order and in
LayerNorm's variance formula (flax: E[x^2] - E[x]^2), ~1e-6 per layer on
values of order 1, so endpoints are held to 1e-5 (abs and rel) and
L2-normalised embeddings to 1e-5 abs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.data.preprocess import PreprocessSpec, to_grayscale_3ch
from vit_research_tpu.models import hf_import
from vit_research_tpu.models import vit as jax_vit
from vit_research_tpu.parallel import embed as jax_embed
from vit_research_tpu.utils.configs import ViTConfig
from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.models import vit as tvit
from vit_research_tpu_torch.parallel import embed as tembed

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)

TINY_1 = ViTConfig(image_size=(32, 32), patch_size=8, hidden_size=32,
                   num_layers=1, num_heads=2, mlp_dim=64,
                   use_flash_attention=True)
TINY_2 = dataclasses.replace(TINY_1, hidden_size=64, num_layers=2,
                             mlp_dim=128)
SPEC = PreprocessSpec(size=(32, 32))


def _pair(cfg, seed=0):
    """(JAX model, JAX params, torch model) with equal weights."""
    model, params = jax_vit.init_vit(cfg, seed=seed, interpret_pallas=True)
    tm = tvit.VisionTransformer(cfg)
    tm.load_state_dict(convert.params_to_state_dict(params, cfg))
    return model, params, tm.eval()


def _frames(n, seed, size=(32, 32)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, *size, 3), dtype=np.uint8)


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            _assert_tree_equal(a[key], b[key])
        else:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))


# --------------------------------------------------------------- convert


@pytest.mark.parametrize("cfg", [
    TINY_2, dataclasses.replace(TINY_1, representation_size=16)])
def test_convert_round_trip(cfg):
    _, params = jax_vit.init_vit(cfg, seed=3)
    sd = convert.params_to_state_dict(params, cfg)
    tm = tvit.VisionTransformer(cfg)
    assert set(sd) == set(tm.state_dict())
    for name, t in tm.state_dict().items():
        assert sd[name].shape == t.shape, name
    back = convert.state_dict_to_params(sd, cfg)
    _assert_tree_equal(back, jax.tree_util.tree_map(np.asarray, params))


def test_patch_embed_weight_layout_matches_patchify():
    """(P, P, C, D) HWIO -> (P*P*C, D) rows line up with patchify's
    (py, px, c) columns: the matmul equals the VALID strided conv."""
    model, params, tm = _pair(TINY_1)
    images = np.random.default_rng(4).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    conv = model.apply(params, jnp.asarray(images),
                       method=lambda m, x: m.patch_embed(x))
    got = tm.patch_embed(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(conv).reshape(2, 16, 32), **TOL)


# -------------------------------------------------------------- backbone


@pytest.mark.parametrize("cfg", [TINY_1, TINY_2])
def test_endpoints_match_jax(cfg):
    model, params, tm = _pair(cfg)
    images = np.random.default_rng(5).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(images))
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


def _record_attention_inputs(monkeypatch):
    """Wraps the backbone's attention call; returns the list of the
    (q, k, v) it was handed."""
    seen = []
    real = tvit.attn_ops.multi_head_attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tvit.attn_ops, "multi_head_attention", spy)
    return seen


def test_attention_without_copies_matches_jax(monkeypatch):
    """MultiHeadSelfAttention hands the attention op the projections'
    (B, T, H, dh) tensors as (B, H, T, dh) views, no copy, and still
    equals the JAX module (its Pallas kernel in interpret mode)."""
    d, h, t = 64, 4, 17
    jm = jax_vit.MultiHeadSelfAttention(num_heads=h, use_pallas=True,
                                        interpret_pallas=True)
    x = np.random.default_rng(6).standard_normal((3, t, d)).astype(
        np.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))["params"]
    want, _ = jm.apply({"params": params}, jnp.asarray(x))
    tm = tvit.MultiHeadSelfAttention(d, h).eval()
    sd = {}
    for name in ("query", "key", "value"):
        sd[f"{name}.weight"] = params[name]["kernel"].reshape(d, d).T
        sd[f"{name}.bias"] = params[name]["bias"].reshape(d)
    sd["out.weight"] = params["out"]["kernel"].reshape(d, d).T
    sd["out.bias"] = params["out"]["bias"]
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in sd.items()})
    seen = _record_attention_inputs(monkeypatch)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x))
    (q, k, v), = seen
    for a in (q, k, v):
        assert a.shape == (3, h, t, d // h) and not a.is_contiguous()
        assert a.transpose(1, 2).is_contiguous()  # projection order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cfg", [TINY_1, TINY_2])
def test_encoder_block_without_copies_matches_jax(monkeypatch, cfg):
    model, params, tm = _pair(cfg)
    x = np.random.default_rng(7).standard_normal(
        (2, cfg.num_patches + 1, cfg.hidden_size)).astype(np.float32)
    want, _ = model.apply(params, jnp.asarray(x),
                          method=lambda m, y: m.blocks[0](y))
    seen = _record_attention_inputs(monkeypatch)
    with torch.no_grad():
        got, _ = tm.blocks[0](torch.from_numpy(x))
    assert len(seen) == 1
    assert all(a.transpose(1, 2).is_contiguous() for a in seen[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_other_resolution_interpolates_pos_embedding():
    # trained grid 4x4 -> 5x9 (40x72 input, VALID crop of the remainder)
    model, params, tm = _pair(TINY_1)
    images = np.random.default_rng(6).standard_normal(
        (2, 40, 72, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(images))
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    assert got["encoded_tokens"].shape == (2, 46, 32)
    for key in ("tokens_before_encoder", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("grid_from,grid_to", [((4, 4), (5, 9)),
                                               ((6, 6), (3, 4))])
def test_interpolate_pos_embedding_matches_jax(grid_from, grid_to):
    pos = np.random.default_rng(7).standard_normal(
        (1, grid_from[0] * grid_from[1] + 1, 8)).astype(np.float32)
    want = jax_vit.interpolate_pos_embedding(jnp.asarray(pos), grid_from,
                                             grid_to)
    got = tvit.interpolate_pos_embedding(torch.from_numpy(pos), grid_from,
                                         grid_to)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gap_pooler_pre_logits_and_scores_match_jax():
    cfg = dataclasses.replace(TINY_2, pooler="gap", representation_size=16,
                              output_attention_scores=True)
    model, params, tm = _pair(cfg)
    images = np.random.default_rng(8).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want = model.apply(params, jnp.asarray(images))
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
    assert got["attention_scores"].shape == (2, 2, 2, 17, 17)
    for key in ("pooled", "pre_logits", "attention_scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


def test_seeded_init_is_deterministic_with_reference_initialisers():
    a = tvit.init_vit(TINY_2, seed=0, device="cpu")
    b = tvit.init_vit(TINY_2, seed=0, device="cpu")
    c = tvit.init_vit(TINY_2, seed=1, device="cpu")
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a.pos_embedding, c.pos_embedding)
    assert torch.count_nonzero(a.cls) == 0
    assert a.pos_embedding.abs().max() <= 0.04
    w = a.blocks[0].mlp.fc1.weight  # lecun-normal, fan_in = 64
    assert abs(w.std().item() - 64 ** -0.5) < 0.02
    assert torch.all(a.blocks[0].ln1.weight == 1)


def test_unported_options_are_refused():
    # every option of the reference is ported now (remat and 'bthd':
    # tests/test_torch_precision.py); what stays refused is what the
    # reference refuses
    for kw in (dict(remat=True), dict(attn_layout="bthd")):
        tvit.VisionTransformer(dataclasses.replace(TINY_1, **kw))
    with pytest.raises(ValueError, match="attn_layout"):
        tvit.VisionTransformer(dataclasses.replace(TINY_1,
                                                   attn_layout="bhdt"))
    with pytest.raises(ValueError, match="incompatible with remat"):
        tvit.VisionTransformer(dataclasses.replace(TINY_1, tome_r=2,
                                                   remat=True))


def test_hf_config_matches_reference():
    # the port keeps its own ViTConfig class, with the reference's fields
    assert tembed.HF_VIT_B16_224.to_dict() == \
        hf_import.HF_VIT_B16_224.to_dict()


# ---------------------------------------------------------------- engine


def test_grayscale_matches_host_oracle_bit_for_bit():
    frames = _frames(8, seed=9, size=(32, 64))
    got = tembed.grayscale_u8(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, to_grayscale_3ch(frames))


@pytest.mark.parametrize("grayscale", [False, True])
def test_engine_matches_jax_engine(grayscale):
    cfg = TINY_2
    model, params, tm = _pair(cfg)
    spec = dataclasses.replace(SPEC, grayscale=grayscale)
    jeng = jax_embed.EmbeddingEngine(model, params, spec, batch_size=4,
                                     use_fused_patch_embed=True,
                                     interpret_pallas=True)
    teng = tembed.EmbeddingEngine(tm, spec, device="cpu", batch_size=4)
    frames = _frames(10, seed=10)  # three batches, ragged tail of 2
    want = jeng.embed_batch(frames)
    got = teng.embed_batch(frames)
    assert got.shape == want.shape == (10, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_engine_fused_matches_unfused_and_host_gray():
    _, _, tm = _pair(TINY_1)
    frames = _frames(5, seed=11)
    gray = tembed.EmbeddingEngine(
        tm, dataclasses.replace(SPEC, grayscale=True), device="cpu",
        batch_size=2)
    fused = tembed.EmbeddingEngine(tm, SPEC, device="cpu", batch_size=2)

    def unfused(u8):
        # host normalisation + the model's own patch projection
        x = torch.from_numpy(u8).to(torch.float32) * SPEC.rescale
        x = (x - torch.tensor(SPEC.mean)) / torch.tensor(SPEC.std)
        with torch.no_grad():
            emb = tm(x)["pooled"]
        return (emb / torch.linalg.vector_norm(emb, dim=-1,
                                               keepdim=True)).numpy()

    emb = fused.embed_batch(frames)
    np.testing.assert_allclose(emb, unfused(frames), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gray.embed_batch(frames),
                               unfused(to_grayscale_3ch(frames)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-6)
    assert fused.embed_batch(frames[:0]).shape == (0, 32)


def test_engine_endpoint_shapes():
    _, _, tm = _pair(TINY_1)
    eng = tembed.EmbeddingEngine(tm, SPEC, device="cpu",
                                 endpoint="encoded_tokens",
                                 l2_normalize=False)
    assert eng.out_trailing == (17, 32)
    assert eng.embed_batch(_frames(2, seed=12)).shape == (2, 17, 32)
    eng.warmup()  # one full zero batch through the same forward


def test_embed_paths_matches_embed_batch(tmp_path):
    from PIL import Image

    from vit_research_tpu.data.preprocess import load_frames

    frames = _frames(7, seed=13)
    paths = []
    for i, f in enumerate(frames):
        p = str(tmp_path / f"vid1_frame_{i + 1}.png")
        Image.fromarray(f).save(p)
        paths.append(p)
    _, _, tm = _pair(TINY_1)
    eng = tembed.EmbeddingEngine(tm, SPEC, device="cpu", batch_size=3)
    want = eng.embed_batch(load_frames(paths, SPEC))
    np.testing.assert_array_equal(eng.embed_paths(paths, num_workers=2),
                                  want)
    np.testing.assert_array_equal(eng.embed_paths(paths, prefetch=0), want)


def test_embed_paths_surfaces_decode_errors(tmp_path):
    _, _, tm = _pair(TINY_1)
    eng = tembed.EmbeddingEngine(tm, SPEC, device="cpu", batch_size=2)
    with pytest.raises(FileNotFoundError):
        eng.embed_paths([str(tmp_path / "missing.jpg")] * 3)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _, _, tm = _pair(TINY_1)
    with pytest.raises(RuntimeError, match="cuda"):
        tembed.EmbeddingEngine(tm, SPEC, device="cuda")
