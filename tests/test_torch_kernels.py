"""The port's kernel modules (ops/patch_embed.py, ops/attention.py) against
the JAX package's Pallas kernels run in interpret mode on the CPU, and the
kernel build's cache key.

Inputs are drawn with numpy from fixed seeds and fed to both sides.
Tolerances: both sides compute in f32 on the CPU and differ only in the
order of the K-long (patch embed) or T-long (attention) sums, so values of
order 1 agree to about 1e-6; the bound is 1e-5 (abs and rel). The uint8
kernel's arithmetic (the affine folded into W, W split into three bf16
pieces, every pixel x piece product exact, f32 sums) is held to the f32
kernel's card bound, 1e-4. The kernels themselves are checked on a card by
tests/test_torch_cuda.py.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.ops import attention as jax_attn
from vit_research_tpu.ops import patch_embed as jax_pe
from vit_research_tpu_torch.ops import _build
from vit_research_tpu_torch.ops import attention as attn
from vit_research_tpu_torch.ops import patch_embed as pe

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
HF_AFFINE = dict(rescale=1 / 255, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))


def _images(rng, shape, dtype):
    if dtype == "uint8":
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    return rng.uniform(0, 255, size=shape).astype(np.float32)


def _weights(rng, k, d):
    w = (rng.standard_normal((k, d)) * k ** -0.5).astype(np.float32)
    return w, rng.standard_normal(d).astype(np.float32)


# ------------------------------------------------------------ patch embed


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shape,patch,dim", [
    ((3, 32, 32, 3), 8, 32),    # the tiny configuration
    ((2, 40, 72, 3), 16, 48),   # VALID crop: 40 % 16 and 72 % 16 != 0
])
def test_patch_embed_matches_pallas_interpret(dtype, shape, patch, dim):
    rng = np.random.default_rng(0)
    images = _images(rng, shape, dtype)
    w, bias = _weights(rng, patch * patch * 3, dim)
    want = jax_pe.fused_patch_embed(
        jnp.asarray(images), jnp.asarray(w), jnp.asarray(bias),
        patch_size=patch, use_pallas=True, interpret=True, **HF_AFFINE)
    got = pe.fused_patch_embed(torch.from_numpy(images), torch.from_numpy(w),
                               torch.from_numpy(bias), patch_size=patch,
                               **HF_AFFINE)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patchify_and_fold_affine_match_reference():
    rng = np.random.default_rng(1)
    images = _images(rng, (2, 40, 72, 3), "uint8")
    np.testing.assert_array_equal(
        pe.patchify(torch.from_numpy(images), 16).numpy(),
        np.asarray(jax_pe.patchify(jnp.asarray(images), 16)))
    for got, want in zip(pe.fold_affine(16, **HF_AFFINE),
                         jax_pe.fold_affine(16, **HF_AFFINE)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,patch,dim", [
    ((2, 32, 48, 3), 16, 768),   # K = 768, D = 768 (ViT-B/16's widths)
    ((1, 64, 64, 3), 32, 768),   # P = 32: K = 3072
    ((2, 40, 72, 3), 16, 200),   # VALID crop, D not a multiple of 8
])
def test_fold_split_weight_matches_pallas_interpret(shape, patch, dim):
    """What the uint8 kernel computes, in f32 on the CPU: the pixel rows
    times each bf16 piece of the folded weight, plus the folded bias."""
    rng = np.random.default_rng(6)
    images = _images(rng, shape, "uint8")
    w, bias = _weights(rng, patch * patch * 3, dim)
    want = jax_pe.fused_patch_embed(
        jnp.asarray(images), jnp.asarray(w), jnp.asarray(bias),
        patch_size=patch, use_pallas=True, interpret=True, **HF_AFFINE)
    a_vec, b_vec = (torch.from_numpy(x)
                    for x in pe.fold_affine(patch, **HF_AFFINE))
    pieces, c = pe.fold_split_weight(torch.from_numpy(w),
                                     torch.from_numpy(bias), a_vec, b_vec)
    assert pieces.dtype == torch.bfloat16 and c.dtype == torch.float32
    assert pieces.shape == (3, w.shape[0], -(-dim // 8) * 8)
    rows = pe.patchify(torch.from_numpy(images), patch)
    rows = rows.reshape(-1, rows.shape[-1]).to(torch.float32)
    got = sum(rows @ pieces[i, :, :dim].float() for i in range(3)) + c
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(got.shape),
                               rtol=0, atol=1e-4)


def test_fold_split_pieces_hold_the_folded_weight():
    rng = np.random.default_rng(7)
    w, bias = _weights(rng, 192, 13)
    a_vec, b_vec = (torch.from_numpy(x) for x in pe.fold_affine(8, **HF_AFFINE))
    pieces, c = pe.fold_split_weight(torch.from_numpy(w),
                                     torch.from_numpy(bias), a_vec, b_vec)
    folded = a_vec.double()[:, None] * torch.from_numpy(w).double()
    total = pieces.double().sum(0)
    assert torch.all(total[:, 13:] == 0)
    # 24 significand bits: within an f32 rounding of the folded weight
    assert torch.all((total[:, :13] - folded).abs()
                     <= folded.abs() * 2 ** -23)
    # hi carries the bf16 rounding of W'; mid and lo are ever smaller
    for i in (1, 2):
        assert torch.all(pieces[i].double().abs()
                         <= pieces[i - 1].double().abs() * 2 ** -7)
    want_c = torch.from_numpy(bias).double() - (
        b_vec.double()[:, None] * torch.from_numpy(w).double()).sum(0)
    torch.testing.assert_close(c.double(), want_c, rtol=0, atol=1e-6)


def test_build_key_covers_sources_and_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert os.path.exists(csrc / "tc_gemm.cuh")
    assert _build.build_key(str(csrc)) == _build.build_key()
    for name in ("tc_gemm.cuh", "fused_ln.cu"):
        before = _build.build_key(str(csrc))
        with open(csrc / name, "a") as fh:
            fh.write("\n// edited\n")
        assert _build.build_key(str(csrc)) != before, name


def test_patch_embed_bf16_output_is_rounded_f32():
    rng = np.random.default_rng(2)
    images = torch.from_numpy(_images(rng, (2, 32, 32, 3), "uint8"))
    w, bias = (torch.from_numpy(a) for a in _weights(rng, 192, 32))
    f32 = pe.fused_patch_embed(images, w, bias, patch_size=8, **HF_AFFINE)
    bf16 = pe.fused_patch_embed(images, w, bias, patch_size=8,
                                out_dtype=torch.bfloat16, **HF_AFFINE)
    assert bf16.dtype == torch.bfloat16
    torch.testing.assert_close(bf16, f32.to(torch.bfloat16), rtol=0, atol=0)


def test_patch_embed_rejects_bad_inputs():
    images = torch.zeros(1, 32, 32, 3, dtype=torch.uint8)
    w, b = torch.zeros(192, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="P\\*P\\*C"):
        pe.fused_patch_embed(images, torch.zeros(100, 8), b, patch_size=8)
    with pytest.raises(TypeError, match="uint8 or float32"):
        pe.fused_patch_embed(images.to(torch.int32), w, b, patch_size=8)
    with pytest.raises(TypeError, match="out_dtype"):
        pe.fused_patch_embed(images, w, b, patch_size=8,
                             out_dtype=torch.float16)


def test_cpu_tensors_never_count_a_launch():
    rng = np.random.default_rng(3)
    before = (pe.fused_patch_embed.launches,
              attn.multi_head_attention.launches)
    images = torch.from_numpy(_images(rng, (1, 32, 32, 3), "uint8"))
    pe.fused_patch_embed(images, torch.zeros(192, 8), torch.zeros(8),
                         patch_size=8)
    q = torch.zeros(1, 2, 5, 16)
    attn.multi_head_attention(q, q, q)
    assert (pe.fused_patch_embed.launches,
            attn.multi_head_attention.launches) == before


# -------------------------------------------------------------- attention


# (9, 96), (25, 96), (5, 192): the chunk encoder's and the RAGHead's f32
# shapes, which the short variant takes on the card
@pytest.mark.parametrize("t,dh", [(17, 16), (65, 32), (197, 64), (9, 96),
                                  (25, 96), (5, 192)])
def test_attention_matches_pallas_interpret(t, dh):
    rng = np.random.default_rng(t)
    q, k, v = (rng.standard_normal((2, 3, t, dh)).astype(np.float32)
               for _ in range(3))
    want = jax_attn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), use_pallas=True,
        interpret=True)
    got = attn.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,dh", [(17, 16), (65, 32), (197, 64), (9, 96),
                                  (25, 96), (5, 192)])
def test_attention_projection_order_views_match_pallas_interpret(t, dh):
    # The backbone passes q/k/v as (B, H, T, dh) views of the projections'
    # (B, T, H, dh) tensors; the JAX side gets the same values contiguous.
    rng = np.random.default_rng(t + 1)
    q, k, v = (rng.standard_normal((2, t, 3, dh)).astype(np.float32)
               for _ in range(3))
    want = jax_attn.multi_head_attention(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
        use_pallas=True, interpret=True)
    views = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    assert not any(x.is_contiguous() for x in views)
    got = attn.multi_head_attention(*views)
    assert got.shape == (2, 3, t, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,dh", [(9, 96), (5, 192)])
@pytest.mark.parametrize("layout", ["contiguous", "projection_order"])
def test_attention_key_bias_matches_jax_einsum(t, dh, layout):
    """f32 with a key bias at the chunk encoder's and the RAGHead's shapes
    (the short variant's on the card) against the JAX package's einsum
    attention with the bias added to the scores (its ToMe path; the Pallas
    kernel takes no bias)."""
    rng = np.random.default_rng(t + dh)
    shape = (2, 4, t, dh) if layout == "contiguous" else (2, t, 4, dh)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    log_size = np.log(rng.integers(1, 9, (2, t))).astype(np.float32)
    if layout == "contiguous":
        qj, kj, vj = (jnp.asarray(a) for a in (q, k, v))
        views = [torch.from_numpy(a) for a in (q, k, v)]
    else:
        qj, kj, vj = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
        views = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    s = jnp.einsum("bhqd,bhkd->bhqk", qj, kj) * dh ** -0.5 \
        + jnp.asarray(log_size)[:, None, None, :]
    want = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), vj)
    got = attn.multi_head_attention(*views,
                                    key_bias=torch.from_numpy(log_size))
    assert got.shape == (2, 4, t, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _flat_view(shape, dtype, offset=0, order=(0, 1, 2, 3)):
    """A (B, H, T, dh) view starting ``offset`` elements into a flat
    buffer laid out in ``order`` (the dims from slowest to fastest)."""
    n = int(np.prod(shape))
    flat = torch.zeros(n + 64, dtype=dtype)
    base = flat[(-flat.data_ptr() // flat.element_size()) % 16:]  # aligned
    laid = base[offset:offset + n].reshape([shape[i] for i in order])
    return laid.permute([order.index(i) for i in range(4)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_strides_take_contiguous_and_projection_order(dtype):
    x = _flat_view((2, 3, 5, 16), dtype)
    assert attn._kernel_strides(x) == (3 * 5 * 16, 5 * 16, 16)
    # (B, T, H, dh) storage seen as (B, H, T, dh): the backbone's views
    x = _flat_view((2, 3, 5, 16), dtype, order=(0, 2, 1, 3))
    assert attn._kernel_strides(x) == (5 * 3 * 16, 16, 3 * 16)
    # a dim of size 1 is never stepped over: its stride does not matter
    x = _flat_view((1, 1, 1, 32), dtype).as_strided((1, 1, 1, 32),
                                                    (7, 3, 5, 1))
    assert attn._kernel_strides(x) == (0, 0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,match", [
    ("last_dim_stride", "stride 1 on its last dim"),
    ("misaligned_base", "16-byte aligned"),
    ("token_stride", "multiples of 16 bytes"),
    ("not_4d", "must be"),
])
def test_kernel_strides_refuse_what_16_byte_loads_cannot_take(dtype, case,
                                                              match):
    if case == "last_dim_stride":  # (B, H, dh, T) storage: dh strided
        x = _flat_view((2, 3, 8, 16), dtype, order=(0, 1, 3, 2))
    elif case == "misaligned_base":  # one element into an aligned buffer
        x = _flat_view((2, 3, 8, 16), dtype, offset=1)
    elif case == "token_stride":  # rows of 17 elements, 16 of them used
        x = _flat_view((2, 3, 8, 17), dtype)[..., :16]
    else:
        x = _flat_view((2, 3, 8, 16), dtype)[0]
    with pytest.raises(ValueError, match=match):
        attn._kernel_strides(x, "q")


def _jax_bf16_attention(q, k, v, log_size=None, scale=None):
    """The JAX package's bf16 attention of numpy q, k, v (B, H, T, d):
    ``xla_attention``, or with a (B, T) key bias the einsum path of its
    ``MultiHeadSelfAttention`` (the bias added to the bf16 scores in their
    dtype). Returns the output and the bf16 scores it took its softmax
    of, both as f32 numpy."""
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = jnp.einsum("bhqd,bhkd->bhqk", qj, kj) * scale
    if log_size is None:
        out = jax_attn.xla_attention(qj, kj, vj, scale=scale)
    else:
        s = s + jnp.asarray(log_size)[:, None, None, :].astype(s.dtype)
        probs = jax.nn.softmax(s.astype(jnp.float32), axis=-1)
        out = jnp.einsum("bhqk,bhkd->bhqd", probs.astype(qj.dtype), vj)
    return np.asarray(out, np.float32), np.asarray(s, np.float32)


def _hold_to_jax_bf16(got, want, s, q, k):
    """``got`` within 2^-9 of max|want| in every query row where torch
    and XLA agree on the bf16 rounding of q k^T and of the probabilities
    of the reference's own scores ``s``. Where a sum or an f32 exp straddles a bf16 rounding
    boundary the two libraries round it apart (~15 probabilities in a
    million at T = 197); such rows, at most 5%, are held to 2^-8 of
    max|want|."""
    e_jax = np.asarray(jnp.einsum("bhqd,bhkd->bhqk",
                                  *(jnp.asarray(a, jnp.bfloat16)
                                    for a in (q, k))), np.float32)
    e_torch = torch.einsum("bhqd,bhkd->bhqk", *(
        torch.from_numpy(a).to(torch.bfloat16) for a in (q, k))).float()
    p_jax = np.asarray(jax.nn.softmax(jnp.asarray(s), axis=-1).astype(
        jnp.bfloat16), np.float32)
    p_torch = torch.softmax(torch.from_numpy(s), dim=-1).to(
        torch.bfloat16).float().numpy()
    apart = ((e_torch.numpy() != e_jax) | (p_torch != p_jax)).any(-1)
    assert apart.mean() <= 0.05
    err = np.abs(got - want)
    scale = np.abs(want).max()
    assert err[~apart].max() <= 2 ** -9 * scale
    assert err.max() <= 2 ** -8 * scale


@pytest.mark.parametrize("dh", [16, 64, 96, 192])
@pytest.mark.parametrize("t", [5, 9, 21, 197])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_plain_matches_xla_reference_bf16(dh, t, with_bias):
    """bf16 inputs at the heads' scale (q and k with std 1.8: max|S| 8
    to 18): scores, their product with the scale rounded to bf16 (JAX's
    weakly typed Python float), the key bias in bf16 and P round at the
    same places on both sides. The parent, which scaled bf16 scores by
    the f32 scale, was up to 6.47e-3 / 1.12e-2 / 1.81e-2 of the outputs'
    scale away at dh = 192 and T = 5 / 9 / 21 (dh = 96: 2.40e-3 / 1.00e-2
    / 1.85e-2), beyond 2^-9 = 1.95e-3 in 15 of the 16 dh = 96 and 192
    cases; at dh = 16 and 64 the scale is a power of two and nothing
    changed."""
    rng = np.random.default_rng(dh + t)
    q, k, v = ((rng.standard_normal((2, 4, t, dh)) * 1.8).astype(np.float32)
               for _ in range(3))
    log_size = np.log(rng.integers(1, 9, (2, t))).astype(np.float32) \
        if with_bias else None
    want, s = _jax_bf16_attention(q, k, v, log_size)
    got = attn.attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        key_bias=None if log_size is None else torch.from_numpy(log_size))
    assert got.dtype == torch.bfloat16
    _hold_to_jax_bf16(got.float().numpy(), want, s, q, k)


def test_attention_plain_rounds_a_callers_scale_like_jax():
    """A scale bf16 cannot hold (-0.3 -> -0.30078125 in bf16) multiplies
    bf16 scores as JAX's weakly typed float does. The parent, which kept
    the f32 -0.3, was 1.64e-2 of the outputs' scale away."""
    rng = np.random.default_rng(11)
    q, k, v = ((rng.standard_normal((2, 4, 9, 96)) * 1.8).astype(np.float32)
               for _ in range(3))
    want, s = _jax_bf16_attention(q, k, v, scale=-0.3)
    got = attn.attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        scale=-0.3)
    _hold_to_jax_bf16(got.float().numpy(), want, s, q, k)
    assert attn.weak_scalar(-0.3, torch.bfloat16) == -0.30078125
    assert attn.weak_scalar(-0.3, torch.float32) == float(np.float32(-0.3))


def test_attention_rejects_mismatched_shapes():
    q = torch.zeros(1, 2, 5, 16)
    with pytest.raises(ValueError, match="share one"):
        attn.multi_head_attention(q, torch.zeros(1, 2, 6, 16), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attn.multi_head_attention(q.double(), q.double(), q.double())


# ------------------------------------------- attention head widths (F4)


def test_kernel_head_dim_takes_every_width_up_to_192():
    """A compiled width runs as it is, any other width up to 192 at the
    next compiled one (zero-padded), and a wider head is not taken."""
    assert attn.KERNEL_HEAD_DIMS == (16, 32, 64, 96, 128, 192)
    for d in range(1, 257):
        w = attn.kernel_head_dim(d)
        if d > 192:
            assert w is None, d
            continue
        assert w in attn.KERNEL_HEAD_DIMS and w >= d, d
        assert all(c < d for c in attn.KERNEL_HEAD_DIMS if c < w), d
    assert [attn.kernel_head_dim(d) for d in (48, 80, 128, 150)] == \
        [64, 96, 128, 192]


@pytest.mark.parametrize("dh", [8, 48, 80, 100, 150])
@pytest.mark.parametrize("with_bias", [False, True])
def test_padded_attention_equals_the_unpadded_one(dh, with_bias):
    """The computation _launch makes for a width between two compiled
    ones, run on the plain version: q, k, v zero-padded to the next
    width, the true width's scale, the first dh columns. Equal to the
    unpadded attention within 1e-6 (zero columns add exact zeros to
    q k^T; only the einsums' blocking may differ)."""
    rng = np.random.default_rng(dh)
    b, t, h = 2, 21, 3
    q, k, v = (torch.from_numpy(
        rng.standard_normal((b, t, h, dh)).astype(np.float32))
        .transpose(1, 2) for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32)) \
        if with_bias else None
    width = attn.kernel_head_dim(dh)
    padded = [attn.pad_head_dim(x, width) for x in (q, k, v)]
    for x, p in zip((q, k, v), padded):
        assert p.shape == (b, h, t, width)
        assert torch.equal(p[..., :dh], x) and not p[..., dh:].any()
        attn._kernel_strides(p)  # a layout the kernel takes
    got = attn.attention_plain(*padded, scale=dh ** -0.5,
                               key_bias=bias)[..., :dh]
    want = attn.attention_plain(q, k, v, key_bias=bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_launch_refuses_heads_wider_than_192():
    """The kernel's own contract: a width it does not take raises before
    anything launches (the wrapper never hands it to the plain version)."""
    q = torch.zeros(1, 2, 5, 256)
    with pytest.raises(ValueError, match="up to 192, got 256"):
        attn._launch(q, q, q, 256 ** -0.5, None)


@pytest.mark.parametrize("dim,heads,kernel", [
    (160, 2, True),    # dh = 80: padded to 96
    (256, 2, True),    # dh = 128
    (384, 2, True),    # dh = 192
    (512, 2, False),   # dh = 256: the plain route
    (780, 3, False),   # dh = 260
])
def test_attention_routing_by_head_width(dim, heads, kernel, monkeypatch):
    """MultiHeadSelfAttention (eval, dropout 0, no scores) hands every
    head width up to 192 to ops/attention.py and a wider one to the plain
    path by its named rule (models/vit.py::head_too_wide_for_kernel); the
    two routes compute one function."""
    from vit_research_tpu_torch.models import vit

    calls = []
    real = attn.multi_head_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[-1])
        return real(*a, **kw)

    torch.manual_seed(0)
    mhsa = vit.MultiHeadSelfAttention(dim, heads).eval()
    x = torch.randn(2, 7, dim)
    monkeypatch.setattr(attn, "multi_head_attention", spy)
    with torch.no_grad():
        out, _ = mhsa(x)
        ref, scores = mhsa(x, output_scores=True)  # always the plain path
    assert vit.head_too_wide_for_kernel(dim // heads) is not kernel
    assert calls == ([dim // heads] if kernel else [])
    assert scores.shape == (2, heads, 7, 7)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
