"""Kernel B's f32 wgmma variant (csrc/attention_f32_wg.cu) modelled on the
CPU: its arithmetic in torch, held to the plain version and to the JAX
package's f32 attention.

The kernel splits every f32 operand x into two TF32 pieces, hi = rna(x)
and lo = rna(x - hi) (rna: round to nearest, ties away from zero, to 10
explicit significand bits: cvt.rna.tf32.f32, which the kernel computes by
integer arithmetic on the bits, as ``ops/fused_ln.py::tf32_round`` does
on the host), and forms each product as lo hi + hi lo
+ hi hi summed in f32. Its softmax is online over stages of 64 keys:
scores in log2 units (q k^T times scale * log2 e, plus the key bias times
log2 e), a running max and sum, O = O * 2^(m_old - m_new) + P V with P V
formed from 0 each stage. The model takes each TF32 product exactly and
rounds its sum to f32 (what the tensor cores approximate), so it tests
the design's arithmetic, not the card's rounding inside a wgmma; the card
tests (tests/test_torch_cuda.py) hold the kernel itself.

One TF32 pass (hi hi alone, what torch.backends.cuda.matmul.allow_tf32
would give) misses the f32 bound at the backbone's shape, so a split that
silently lost its lo pieces fails here.

The encoder linears' GEMM (csrc/gemm_f32_wg.cu, ops/linear.py) splits x
and W the same way and takes each stage of 32 k as 12 TF32 wgmma (lo hi,
hi lo, hi hi over four k-steps of 8) summed from 0, then adds that to its
f32 accumulator with a rounded add. Its model takes each k-step's 8
products exactly and adds them to the running sum truncated toward zero,
as the tensor cores' accumulator adds truncate (the drift that made kernel
C flush, csrc/tc_gemm.cuh); without the per-stage flush the same model
drifts past f32's own error at the backbone's K.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_research_tpu.ops import attention as jax_attention
from vit_research_tpu_torch.ops import attention as attn
from vit_research_tpu_torch.ops.fused_ln import tf32_round as tf32_rna

#: kernel B's f32 bound against its plain version (chip_smoke.py's
#: ATTN_BOUND[float32]): the kernel and the plain version sum the same
#: products in other orders, ~1e-6 on outputs of order 1
BOUND = 1e-5
STAGE = 64  # keys a stage (and query rows a tile)
LOG2E = 1.4426950408889634


def split(x: torch.Tensor) -> tuple:
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of TF32 values, each product and the sum exact (float64),
    rounded once to f32."""
    return (a.double() @ b.double()).float()


def split_matmul(a: torch.Tensor, b: torch.Tensor, passes: int = 3):
    """a @ b on split operands: lo hi + hi lo + hi hi in f32, that order
    (passes=3); hi hi alone (passes=1) is one TF32 pass."""
    ah, al = split(a)
    bh, bl = split(b)
    if passes == 1:
        return _exact(ah, bh)
    return (_exact(al, bh) + _exact(ah, bl)) + _exact(ah, bh)


def model_attention(q, k, v, *, scale=None, key_bias=None, passes=3):
    """The kernel's arithmetic on (B, H, T, 64) f32 tensors: split-operand
    products, the online softmax over 64-key stages, -inf past T."""
    b, h, t, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    sl = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    bias = torch.zeros(b, t) if key_bias is None else \
        key_bias.float() * torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full((b, h, t, 1), -math.inf)
    l = torch.zeros(b, h, t, 1)
    o = torch.zeros(b, h, t, d)
    for k0 in range(0, t, STAGE):
        ks, vs = k[:, :, k0:k0 + STAGE], v[:, :, k0:k0 + STAGE]
        s = split_matmul(q, ks.transpose(-1, -2), passes)
        x = s * sl + bias[:, None, None, k0:k0 + STAGE]
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        r = torch.exp2(m - m_new)
        e = torch.exp2(x - m_new)
        l = l * r + e.sum(-1, keepdim=True)
        o = o * r + split_matmul(e, vs, passes)
        m = m_new
    return o / l


def _inputs(b, h, t, seed, bias=False):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, 64)).astype(
        np.float32)) for _ in range(3))
    # ToMe's key bias: the log of each token's size (1 to 4 merged)
    kb = torch.from_numpy(np.log(rng.integers(1, 5, size=(b, t))).astype(
        np.float32)) if bias else None
    return q, k, v, kb


def test_tf32_rna_rounds_to_nearest_ties_away():
    """The kernel's bit trick (hop::tf32_rna in csrc/hopper.cuh; on the
    host tf32_round) is cvt.rna.tf32.f32: against a float64 rounding of
    the significand to 11 bits, ties away from zero, on ties, neighbours
    of ties, a carry into the exponent, signed zeros, subnormals and
    random values; the low 13 bits of every result are 0."""
    rng = np.random.default_rng(0)
    special = np.array([1.0, 1 + 2 ** -11, 1 + 2 ** -11 + 2 ** -23,
                        1 + 2 ** -11 - 2 ** -23, 1 + 3 * 2 ** -11,
                        2 - 2 ** -12, 2 - 2 ** -23, 0.0, -0.0, 2.0 ** -140,
                        -(1 + 2 ** -11), 3.4e38, -7.25e-39],
                       dtype=np.float32)
    xs = np.concatenate([special, rng.standard_normal(4096).astype(
        np.float32) * 10.0 ** rng.integers(-20, 20, 4096)]).astype(np.float32)
    got = tf32_rna(torch.from_numpy(xs)).numpy()
    mant, exp = np.frexp(xs.astype(np.float64))  # |mant| in [0.5, 1)
    # subnormal f32 keep the normal TF32 step of their exponent range
    step_exp = np.maximum(exp, -125)
    scaled = np.abs(mant) * 2.0 ** (exp - step_exp) * 2 ** 11
    want = np.sign(xs) * np.floor(scaled + 0.5) * 2.0 ** (step_exp - 11)
    assert np.array_equal(got.astype(np.float64), want)
    assert not (torch.from_numpy(got).view(torch.int32) & 0x1FFF).any()


def test_split_pieces_sum_to_the_operand():
    """hi + lo equals x to 2^-21 of |x| (lo's own rounding), and both are
    TF32 values (low 13 bits 0)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        10_000).astype(np.float32))
    hi, lo = split(x)
    for piece in (hi, lo):
        assert not (piece.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()
    assert ((hi.double() - x.double()).abs() <= 2.0 ** -11 *
            x.double().abs()).all()


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("t", [21, 64, 65, 197, 313])
def test_model_holds_the_plain_version(t, bias):
    """Split operands and 64-key stages reach the f32 plain version within
    the bound at ToMe's shortest block (21), one stage exactly (64), a
    second stage of one key (65), the backbone (197) and smoke's frame
    (313), with and without ToMe's key bias."""
    q, k, v, kb = _inputs(2, 2, t, seed=t, bias=bias)
    got = model_attention(q, k, v, key_bias=kb)
    want = attn.attention_plain(q, k, v, key_bias=kb)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= BOUND


@pytest.mark.parametrize("t", [21, 64, 65, 197, 313])
def test_model_holds_the_jax_packages_attention(t):
    """The model against the JAX package's f32 attention (its Pallas
    kernel in interpret mode) on the same inputs."""
    q, k, v, _ = _inputs(1, 2, t, seed=100 + t)
    got = model_attention(q, k, v)
    want = jax_attention.multi_head_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), use_pallas=True,
        interpret=True)
    assert (got - torch.from_numpy(np.array(want))).abs().max().item() \
        <= BOUND


def test_one_tf32_pass_misses_the_bound_at_the_backbones_shape():
    """T = 197, dh = 64 (ViT-B/16 @224), a few heads: hi hi alone misses
    the f32 bound by far, the three passes hold it, on the same inputs."""
    q, k, v, _ = _inputs(2, 3, 197, seed=7)
    want = attn.attention_plain(q, k, v)
    one = (model_attention(q, k, v, passes=1) - want).abs().max().item()
    three = (model_attention(q, k, v) - want).abs().max().item()
    assert three <= BOUND < 10 * BOUND < one


def test_stages_rescale_as_one_softmax():
    """The online softmax over stages equals one softmax over the row:
    with exact products (float64 inputs rounded to TF32 already) the model
    and a direct softmax of the same split products agree to f32."""
    q, k, v, kb = _inputs(1, 2, 197, seed=9, bias=True)
    q, k, v = (tf32_rna(x) for x in (q, k, v))  # lo pieces vanish
    got = model_attention(q, k, v, key_bias=kb)
    s = _exact(q, k.transpose(-1, -2)) * (64 ** -0.5)
    p = torch.softmax(s.double() + kb.double()[:, None, None, :], -1)
    want = (p @ v.double()).float()
    assert (got - want).abs().max().item() <= BOUND


GEMM_STAGE = 32  # k a stage of csrc/gemm_f32_wg.cu (ops/linear.py's BK)
GEMM_KSTEP = 8   # k of one TF32 wgmma


def _truncated_add(acc: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """acc + d (d exact in float64) rounded toward zero to f32."""
    s = acc.double() + d
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def model_gemm(x, w, *, passes=3, flush=True):
    """x (M, K) @ w (N, K)^T as gemm_f32_wg forms it: split operands, each
    k-step's products exact and added truncated, a stage's 12 products from
    0 and added to the f32 accumulator rounded (flush), or every product
    truncated into the accumulator (flush=False); passes=1: hi hi alone."""
    xh, xl = split(x)
    wh, wl = split(w)
    terms = [(xh, wh)] if passes == 1 else [(xl, wh), (xh, wl), (xh, wh)]
    acc = torch.zeros(x.shape[0], w.shape[0])
    for k0 in range(0, x.shape[1], GEMM_STAGE):
        part = torch.zeros_like(acc) if flush else acc
        for a, b in terms:
            for kk in range(k0, k0 + GEMM_STAGE, GEMM_KSTEP):
                ks = slice(kk, kk + GEMM_KSTEP)
                part = _truncated_add(part, a[:, ks].double()
                                      @ b[:, ks].double().t())
        acc = acc + part if flush else part
    return acc


def _gemm_errors(k, seed, **kw):
    """(model's, plain f32 product's) largest gap to the float64 product,
    on x (32, K) and an nn.Linear-scaled W (64, K)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((32, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((64, k)) * k ** -0.5).astype(
        np.float32))
    want = x.double() @ w.double().t()
    got = (model_gemm(x, w, **kw).double() - want).abs().max().item()
    f32 = ((x @ w.t()).double() - want).abs().max().item()
    return got, f32


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("k", [768, 3072])
def test_gemm_model_holds_f32s_own_error(k, seed):
    """At the backbone's K (q/k/v/out and fc1: 768; fc2: 3072) split
    operands with a per-stage flush sit within twice the plain f32
    product's own gap to the float64 product."""
    got, f32 = _gemm_errors(k, seed)
    assert got <= 2 * f32


@pytest.mark.parametrize("k", [768, 3072])
@pytest.mark.parametrize("kw", [dict(passes=1), dict(flush=False)],
                         ids=["one_tf32_pass", "no_flush"])
def test_gemm_model_fails_without_the_split_or_the_flush(k, kw):
    """One TF32 pass misses f32's own error by far (over 100x); the three
    passes with every product truncated into one accumulator drift past
    it (over 5x): the lo pieces and the flush are both needed."""
    got, f32 = _gemm_errors(k, seed=2, **kw)
    assert got > (100 if kw.get("passes") == 1 else 5) * f32
