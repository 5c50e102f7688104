"""Kernel gradients (ops/attention.py, ops/patch_embed.py), the ChunkEncoder
and the small heads (models/heads.py) of the port against the JAX package.

Kernels A and B sit inside ``torch.autograd.Function``s whose backward is
the plain version's VJP, as the JAX package's ``custom_vjp`` takes the VJP
of its XLA version; the JAX side runs its Pallas kernels in interpret mode
through those ``custom_vjp``s. Weights come from the flax seeded init and
are converted (models/convert.py); inputs are drawn with numpy from fixed
seeds. Tolerances: both sides compute in f32 on the CPU and differ in
summation order (and flax's LayerNorm variance, E[x^2] - E[x]^2), ~1e-6
per layer on values of order 1: outputs and gradients are held to 1e-5
(abs and rel), the 2-layer encoder's outputs to 2e-5.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vit_research_tpu.models import heads as jax_heads
from vit_research_tpu.ops import attention as jax_attn
from vit_research_tpu.ops import patch_embed as jax_pe
from vit_research_tpu.utils.configs import ChunkEncoderConfig as JaxCEConfig
from vit_research_tpu_torch.models import convert, heads
from vit_research_tpu_torch.ops import attention as attn
from vit_research_tpu_torch.ops import patch_embed as pe
from vit_research_tpu_torch.utils.configs import (ChunkEncoderConfig,
                                                  HeadConfig)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
ENC_TOL = dict(rtol=2e-5, atol=2e-5)
HF_AFFINE = dict(rescale=1 / 255, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
# head width 96 as at the real width (768 / 8), at a small embedding
SMALL = ChunkEncoderConfig(embed_dim=192, num_layers=2, num_heads=2,
                           mlp_dim=384, max_len=8, dropout_rate=0.0)
CSRC = Path(attn.__file__).resolve().parent.parent / "csrc"


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _qkv(rng, b, h, t, d):
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(3)]


# ------------------------------------------------------- kernel B gradients


@pytest.mark.parametrize("t,dh", [(9, 96), (25, 96), (9, 64)])
def test_attention_function_grads_match_jax_custom_vjp(t, dh):
    """Forward and q/k/v gradients through ``_Attention`` against
    ``jax.vjp`` of the JAX ``_pallas_attention`` (interpret mode): the
    custom_vjp path, whose backward is the VJP of ``xla_attention``."""
    rng = np.random.default_rng(t + dh)
    q, k, v = _qkv(rng, 2, 2, t, dh)
    g = rng.standard_normal((2, 2, t, dh)).astype(np.float32)
    scale = dh ** -0.5
    want, vjp = jax.vjp(
        lambda q, k, v: jax_attn._pallas_attention(q, k, v, scale, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))

    tq, tk, tv = (_t(x, True) for x in (q, k, v))
    got = attn.multi_head_attention(tq, tk, tv)
    assert type(got.grad_fn).__name__ == "_AttentionBackward"
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for x, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL)


def test_attention_key_bias_grad_matches_jax_vjp():
    """The key bias's gradient (ToMe's log sizes, when they require grad)
    against ``jax.vjp`` of the JAX package's biased XLA attention."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 2, 9, 96)
    bias = rng.standard_normal((2, 9)).astype(np.float32)
    g = rng.standard_normal((2, 2, 9, 96)).astype(np.float32)

    def jax_biased(q, k, v, bias):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * (96 ** -0.5)
        s = s + bias[:, None, None, :]
        p = jax.nn.softmax(s.astype(jnp.float32), axis=-1)
        return jnp.einsum("bhqk,bhkd->bhqd", p, v)

    want, vjp = jax.vjp(jax_biased, *(jnp.asarray(x) for x in (q, k, v,
                                                                 bias)))
    want_grads = vjp(jnp.asarray(g))
    inputs = [_t(x, True) for x in (q, k, v, bias)]
    got = attn.multi_head_attention(*inputs[:3], key_bias=inputs[3])
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for x, w in zip(inputs, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL)


def test_attention_backward_does_not_need_the_forward_graph(monkeypatch):
    """The kernel fills a fresh tensor outside autograd; the Function's
    backward must carry the gradient all the same. A forward that, like
    the kernel, detaches its result stands in for it here."""
    launches = []

    def kernel_like(q, k, v, scale, key_bias):
        launches.append(1)
        with torch.no_grad():
            out = torch.empty_like(q)
            out.copy_(attn.attention_plain(q, k, v, scale=scale,
                                           key_bias=key_bias))
        return out

    monkeypatch.setattr(attn, "_forward", kernel_like)
    rng = np.random.default_rng(2)
    q, k, v = (_t(x, True) for x in _qkv(rng, 1, 2, 9, 96))
    ref = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    attn.multi_head_attention(q, k, v).sum().backward()
    attn.attention_plain(*ref).sum().backward()
    assert launches == [1]
    for x, r in zip((q, k, v), ref):
        np.testing.assert_allclose(x.grad.numpy(), r.grad.numpy(), **TOL)
    # without grad the direct call stays (and counts no Function node)
    with torch.no_grad():
        out = attn.multi_head_attention(q, k, v)
    assert out.grad_fn is None and launches == [1, 1]


def test_attention_grads_with_an_inference_mode_key_bias():
    """A key bias made under inference_mode (it takes no grad) beside q,
    k, v that do: the Function keeps it off save_for_backward."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(x, True) for x in _qkv(rng, 2, 2, 9, 96))
    with torch.inference_mode():
        bias = _t(rng.standard_normal((2, 9)).astype(np.float32)) * 1.0
    attn.multi_head_attention(q, k, v, key_bias=bias).sum().backward()
    ref = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    attn.attention_plain(*ref, key_bias=bias.clone()).sum().backward()
    for x, r in zip((q, k, v), ref):
        np.testing.assert_allclose(x.grad.numpy(), r.grad.numpy(), **TOL)


def test_kernel_head_dims_match_the_cuda_dispatch():
    """The widths the wrapper lets through are the widths compiled into
    both of the CUDA source's dispatch switches (96 for the chunk
    encoder's 768 / 8 heads, 192 for the RAG/RATT heads' 768 / 4)."""
    src = (CSRC / "attention.cu").read_text()
    bf16 = sorted(int(d) for d in re.findall(
        r"case (\d+): return launch_bf16<\1>", src))
    f32 = sorted(int(d) for d in re.findall(
        r"case (\d+): return launch_f32<\1>", src))
    assert bf16 == f32 == sorted(attn.KERNEL_HEAD_DIMS)
    assert 96 in attn.KERNEL_HEAD_DIMS and 192 in attn.KERNEL_HEAD_DIMS
    assert SMALL.embed_dim // SMALL.num_heads == 96
    full = ChunkEncoderConfig()
    assert full.embed_dim // full.num_heads in attn.KERNEL_HEAD_DIMS
    head_cfg = HeadConfig()
    assert head_cfg.embed_dim // head_cfg.num_heads == 192


# ------------------------------------------------------- kernel A gradients


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_patch_embed_function_grads_match_jax_custom_vjp(dtype):
    """w and bias gradients through ``_PatchEmbed`` against ``jax.vjp`` of
    the JAX ``_rows_project`` (its custom_vjp) with the Pallas kernel in
    TPU interpret mode on the CPU."""
    rng = np.random.default_rng(3)
    shape, patch, dim = (2, 32, 32, 3), 8, 32
    if dtype == "uint8":
        images = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
        images = rng.uniform(0, 255, size=shape).astype(np.float32)
    k = patch * patch * 3
    w = (rng.standard_normal((k, dim)) * k ** -0.5).astype(np.float32)
    bias = rng.standard_normal(dim).astype(np.float32)
    g = rng.standard_normal((2, 16, dim)).astype(np.float32)

    rows = np.asarray(jax_pe.patchify(jnp.asarray(images), patch)) \
        .reshape(-1, k)
    a_vec, b_vec = jax_pe.fold_affine(patch, 3, **HF_AFFINE)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(
            lambda w, bias: jax_pe._rows_project(
                jnp.asarray(rows), w, jnp.asarray(a_vec),
                jnp.asarray(b_vec), bias),
            jnp.asarray(w), jnp.asarray(bias))
        want_w, want_b = vjp(jnp.asarray(g.reshape(-1, dim)))

    tw, tb = _t(w, True), _t(bias, True)
    got = pe.fused_patch_embed(_t(images), tw, tb, patch_size=patch,
                               **HF_AFFINE)
    assert type(got.grad_fn.next_functions[0][0]).__name__ == \
        "_PatchEmbedBackward"
    got.backward(_t(g))
    np.testing.assert_allclose(got.detach().numpy().reshape(-1, dim),
                               np.asarray(want), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_b), **TOL)


def test_patch_embed_backward_does_not_need_the_forward_graph(monkeypatch):
    """As for kernel B: a detached forward (what the kernel gives) still
    yields the plain version's gradients of w and bias."""
    def kernel_like(images, w, bias, a_vec, b_vec, patch_size, out_dtype):
        with torch.no_grad():
            return pe.patch_embed_plain(images, w, bias, a_vec, b_vec,
                                        patch_size=patch_size,
                                        out_dtype=out_dtype).clone()

    monkeypatch.setattr(pe, "_forward", kernel_like)
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.integers(0, 256, size=(2, 16, 16, 3),
                                           dtype=np.uint8))
    w = torch.from_numpy(rng.standard_normal((192, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    got_w, got_b = (x.clone().requires_grad_(True) for x in (w, b))
    ref_w, ref_b = (x.clone().requires_grad_(True) for x in (w, b))
    pe.fused_patch_embed(images, got_w, got_b, patch_size=8,
                         **HF_AFFINE).square().sum().backward()
    a_vec, b_vec = pe.fold_affine(8, 3, **HF_AFFINE)
    pe.patch_embed_plain(images, ref_w, ref_b, torch.from_numpy(a_vec),
                         torch.from_numpy(b_vec),
                         patch_size=8).square().sum().backward()
    np.testing.assert_allclose(got_w.grad.numpy(), ref_w.grad.numpy(), **TOL)
    np.testing.assert_allclose(got_b.grad.numpy(), ref_b.grad.numpy(), **TOL)


def test_patch_embed_grads_after_an_inference_mode_call():
    """The engine embeds under inference_mode, which leaves the cached
    affine vectors inference tensors; a later training call through the
    Function still takes gradients (it saves none of them)."""
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, size=(1, 16, 16, 3),
                                           dtype=np.uint8))
    w = torch.from_numpy(rng.standard_normal((192, 8)).astype(np.float32))
    b = torch.zeros(8)
    affine = dict(rescale=1 / 255, mean=(0.25, 0.5, 0.75),
                  std=(0.5, 0.25, 0.5))  # a cache entry of this test's own
    with torch.inference_mode():
        want = pe.fused_patch_embed(images, w, b, patch_size=8, **affine)
    w.requires_grad_(True)
    got = pe.fused_patch_embed(images, w, b, patch_size=8, **affine)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), **TOL)
    assert w.grad is not None and w.grad.shape == w.shape


# ------------------------------------------------------------ ChunkEncoder


def _jax_encoder(cfg: ChunkEncoderConfig, t: int, seed: int = 0):
    model = jax_heads.ChunkEncoder(JaxCEConfig(**dataclasses.asdict(cfg)))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, t, cfg.embed_dim)))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_encoder(cfg, params):
    model = heads.ChunkEncoder(cfg)
    model.load_state_dict(convert.chunk_encoder_to_state_dict(params))
    return model.eval()


@pytest.mark.parametrize("t", [8, 5])
def test_chunk_encoder_matches_flax(t):
    """Embedding, logit and per-layer attention probabilities of the
    port's encoder (converted weights) against the flax ChunkEncoder, at
    head width 96; the full chunk and a shorter one (a slice of the
    position table)."""
    jmodel, params = _jax_encoder(SMALL, SMALL.max_len)
    x = np.random.default_rng(t).standard_normal(
        (3, t, SMALL.embed_dim)).astype(np.float32)
    want_emb, want_logit, want_scores = jax.jit(
        lambda p, x: jmodel.apply(p, x, return_attention=True))(
            params, jnp.asarray(x))
    model = _port_encoder(SMALL, params)
    with torch.no_grad():
        emb, logit = model(_t(x))
        emb2, logit2, scores = model(_t(x), return_attention=True)
    for got in (emb, emb2):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_emb),
                                   **ENC_TOL)
    for got in (logit, logit2):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_logit),
                                   **ENC_TOL)
    assert len(scores) == SMALL.num_layers == len(want_scores)
    for got, want in zip(scores, want_scores):
        assert got.shape == (3, SMALL.num_heads, t + 1, t + 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENC_TOL)


def test_chunk_encoder_train_mode_grads_match_flax_at_dropout_0():
    """With dropout 0 (config and class head) the train-mode forward takes
    kernel B's Function; its loss gradients equal flax's."""
    jmodel, params = _jax_encoder(SMALL, SMALL.max_len, seed=1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 8, SMALL.embed_dim)).astype(np.float32)
    y = np.asarray([0, 1, 1, 0], np.float32)

    class NoDrop(jax_heads.ClassifierMLP):
        dropout_rate: float = 0.0

    def jax_loss(p):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_heads, "ClassifierMLP", NoDrop)
            _, logits = jmodel.apply(p, jnp.asarray(x), train=True,
                                     rngs={"dropout": jax.random.PRNGKey(0)})
        z = logits.reshape(-1)
        return jnp.mean(-(y * jax.nn.log_sigmoid(z)
                          + (1 - y) * jax.nn.log_sigmoid(-z)))

    want_grads = convert.chunk_encoder_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jax.grad(jax_loss)(params)))
    model = _port_encoder(SMALL, params).train()
    model.class_head.dropout.p = 0.0
    _, logits = model(_t(x))
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        logits.reshape(-1), _t(y))
    loss.backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_chunk_encoder_refuses_long_chunks_and_wrong_width():
    model = heads.ChunkEncoder(SMALL).eval()
    with pytest.raises(ValueError, match="max_len is 8"):
        model(torch.zeros(1, 9, SMALL.embed_dim))
    with pytest.raises(ValueError, match="expected dim 192"):
        model(torch.zeros(1, 4, 64))
    # bf16 is a compute dtype, not a refusal: the checks hold there too
    bf16 = heads.ChunkEncoder(dataclasses.replace(SMALL, dtype="bfloat16"))
    with pytest.raises(ValueError, match="max_len is 8"):
        bf16.eval()(torch.zeros(1, 9, SMALL.embed_dim))


def test_chunk_encoder_params_round_trip():
    """state_dict -> flax tree -> state_dict is the identity, and the
    port's own seeded init has the flax tree's shapes."""
    _, params = _jax_encoder(SMALL, SMALL.max_len)
    sd = convert.chunk_encoder_to_state_dict(params)
    back = convert.chunk_encoder_to_params(sd, SMALL)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    fresh = heads.ChunkEncoder(
        SMALL, generator=torch.Generator().manual_seed(0)).state_dict()
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


# -------------------------------------------------------------- small heads


def test_classifier_mlp_matches_flax():
    x = np.random.default_rng(6).standard_normal((5, 24)).astype(np.float32)
    jm = jax_heads.ClassifierMLP(hidden_dim=16)
    p = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    m = heads.ClassifierMLP(24, hidden_dim=16).eval()
    m.load_state_dict({f"{n}.{k}": v for n in ("fc", "logit")
                       for k, v in {"weight": _t(p["params"][n]["kernel"].T),
                                    "bias": _t(p["params"][n]["bias"])}
                       .items()})
    with torch.no_grad():
        got = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(p, x)),
                               **TOL)


def test_projection_head_matches_flax():
    x = np.random.default_rng(7).standard_normal((4, 24)).astype(np.float32)
    jm = jax_heads.ProjectionHead(input_dim=24, hidden_dim=20, proj_dim=12)
    p = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    m = heads.ProjectionHead(24, hidden_dim=20, proj_dim=12)
    m.load_state_dict({f"{n}.{k}": v for n in ("d1", "d2", "out")
                       for k, v in {"weight": _t(p["params"][n]["kernel"].T),
                                    "bias": _t(p["params"][n]["bias"])}
                       .items()})
    with torch.no_grad():
        got = m(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(p, x)),
                               **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-6)


def test_retrieval_pooler_matches_flax():
    r = np.random.default_rng(8).standard_normal((3, 7, 16)).astype(
        np.float32)
    jm = jax_heads.RetrievalMultiQueryPooler(hidden_size=16, num_queries=4)
    p = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(r)))
    m = heads.RetrievalMultiQueryPooler(16, 4)
    m.load_state_dict({"retrieval_queries":
                       _t(p["params"]["retrieval_queries"])})
    with torch.no_grad():
        got = m(_t(r))
    assert got.shape == (3, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(p, r)),
                               **TOL)
    # the seeded init draws xavier-uniform within its bound
    q = heads.RetrievalMultiQueryPooler(
        16, 4, generator=torch.Generator().manual_seed(0)).retrieval_queries
    assert float(q.detach().abs().max()) <= np.sqrt(6 / 20)
