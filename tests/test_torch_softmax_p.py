"""Kernel B's bf16 P against the reference softmax's (fault F10): the
bf16 kernels form P = bf16(exp(s - max) / sum) with the arithmetic of
torch.softmax on the f32 scores, as attention_plain calls it, so that
where the scores agree P agrees to the bit (csrc/attention.cu, before
``quotient``).

On the CPU, numpy emulations of the kernel's steps: its quotient (the
correctly rounded reciprocal, one product and one FMA correction) equal to
IEEE division, and its row sums (each thread's sums by lane residue, then
the butterfly) equal to the order of the reference softmax's warp kernel;
and chip_smoke.py's P probe (the plain P it reads, and how it sorts a
difference by cause). On the card (``cuda``, skipped here): the draws on
which F10 showed, within ATTN_BOUND by the tie-aware check
(tests/test_torch_bf16_ties.py), and the probe's P equal to the plain P
at the backbone's shape, but where the scores differ.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from vit_research_tpu_torch.ops import attention as attn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


# ---- the quotient


def _fma(a, b, c):
    """f32 fma(a, b, c), rounded once: a * b is exact in f64; a + b in f64
    with its exact error (TwoSum), and a sum that lands on a midpoint
    between two f32 values rounded toward the error's side."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(F32)
    r64 = r.astype(np.float64)
    down = np.where(r64 > s, np.nextafter(r, F32(-np.inf)), r)
    up = np.where(r64 < s, np.nextafter(r, F32(np.inf)), r)
    tie = (down != up) & (s == (down.astype(np.float64)
                                + up.astype(np.float64)) / 2) & (err != 0)
    return np.where(tie & (err > 0), up, np.where(tie & (err < 0), down, r))


def _kernel_quotient(e, l):
    """csrc/attention.cu::quotient in numpy: r = 1 / l correctly rounded,
    q = e * r, q + (e - q l) r by two FMAs; IEEE division below 2^-64."""
    r = F32(1) / l
    q = (e * r).astype(F32)
    out = _fma(_fma(-q, l, e), r, q)
    return np.where(e < F32(2.0 ** -64), e / l, out)


def test_kernel_quotient_is_ieee_division():
    rng = np.random.default_rng(0)
    n = 250_000
    for t in (5, 69, 197, 704, 1536):
        l = rng.uniform(1, t, 2 * n).astype(F32)
        # exps over (0, 1]: uniform, and log-uniform down to 2^-70 (past the
        # FMA route's 2^-64, into the division's)
        e = np.concatenate([rng.uniform(0, 1, n),
                            np.exp2(-rng.uniform(0, 70, n))]).astype(F32)
        e = np.maximum(e, F32(2.0 ** -149))
        np.testing.assert_array_equal(_kernel_quotient(e, l), e / l)
    # the edges: e = 1 (the row's max), l = 1 (a row of one key)
    l = rng.uniform(1, 197, n).astype(F32)
    ones = np.ones(n, F32)
    np.testing.assert_array_equal(_kernel_quotient(ones, l), ones / l)
    e = rng.uniform(0, 1, n).astype(F32)
    np.testing.assert_array_equal(_kernel_quotient(e, ones), e)
    # without the correction the product alone rounds apart
    r = F32(1) / l
    assert ((e * r).astype(F32) != e / l).any()


# ---- the row sums


def _reference_order(e):
    """Row sums (R, T) -> (R,) as the reference softmax's warp kernel takes
    them: key j to lane j % 32, lanes add their keys in order from 0, then
    a butterfly over lane offsets 16, 8, 4, 2, 1."""
    r, t = e.shape
    pad = -t % 32
    lanes = np.concatenate([e, np.zeros((r, pad), F32)], 1) \
        .reshape(r, -1, 32)
    acc = np.zeros((r, 32), F32)
    for it in range(lanes.shape[1]):
        acc = acc + lanes[:, it]
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, np.arange(32) ^ off]
    return acc[:, 0]


def _kernel_order(e):
    """The same sums as csrc/attention.cu's RowSums take them: key 64 t + 8
    n + 2 c + e to thread c of the row (n = a + 4 h), one sum for each (a,
    e) in the order of t, then h; row_total adds a's bits, then c's across
    threads (offsets 2, 1), then e."""
    r, t = e.shape
    pad = -t % 64
    keys = np.concatenate([e, np.zeros((r, pad), F32)], 1) \
        .reshape(r, -1, 2, 4, 4, 2)  # (R, t, h, a, c, e)
    acc = np.zeros((r, 4, 4, 2), F32)  # (R, a, c, e)
    for tile in range(keys.shape[1]):
        for h in range(2):
            acc = acc + keys[:, tile, h]
    x = (acc[:, 0] + acc[:, 2]) + (acc[:, 1] + acc[:, 3])  # (R, c, e)
    x = x + x[:, [2, 3, 0, 1]]
    x = x + x[:, [1, 0, 3, 2]]
    total = x[..., 0] + x[..., 1]
    assert (total == total[:, :1]).all()  # the row's four threads agree
    return total[:, 0]


@pytest.mark.parametrize("t", [1, 5, 9, 16, 21, 25, 33, 64, 69, 149, 197,
                               704, 1024])
def test_kernel_row_sums_take_the_reference_order(t):
    rng = np.random.default_rng(t)
    # exps of scores less the row's max: one 1, the rest spread over decades
    e = np.exp(-rng.exponential(3.0, size=(512, t))).astype(F32)
    e[:, rng.integers(0, t)] = 1
    want = _reference_order(e)
    np.testing.assert_array_equal(_kernel_order(e), want)
    if t >= 64:  # a plain left-to-right sum rounds apart somewhere
        seq = np.zeros(512, F32)
        for j in range(t):
            seq = seq + e[:, j]
        assert (seq != want).any()


# ---- the probe (chip_smoke.py)


@pytest.mark.parametrize("with_bias", [False, True])
def test_probe_reads_attention_plains_p(smoke, with_bias):
    """chip_smoke.plain_softmax's P is the one attention_plain takes: its
    product with v equals attention_plain's output to the bit."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 3, 37, 16, generator=g).to(torch.bfloat16)
               for _ in range(3))
    bias = torch.log(torch.randint(1, 9, (2, 37), generator=g).float()) \
        if with_bias else None
    s, p32 = smoke.plain_softmax(q, k, bias)
    got = torch.einsum("bhqk,bhkd->bhqd", p32.to(torch.bfloat16), v)
    assert torch.equal(got, attn.attention_plain(q, k, v, key_bias=bias))


def test_p_probe_reads_p_through_one_hot_v(smoke):
    """On the CPU multi_head_attention runs attention_plain, so the probe
    reads the plain P itself back through one-hot V: every value equal,
    over three blocks of dh keys in projection order, with a key bias."""
    g = torch.Generator().manual_seed(4)
    q, k = (torch.randn(3, 70, 2, 32, generator=g).to(torch.bfloat16)
            .transpose(1, 2) for _ in range(2))
    bias = torch.log(torch.randint(1, 9, (3, 70), generator=g).float())
    pk = smoke.kernel_probs(q, k, bias)
    _, p32 = smoke.plain_softmax(q.contiguous(), k.contiguous(), bias)
    assert torch.equal(pk, p32.to(torch.bfloat16))
    assert smoke.p_probe(q, k, bias, chunk=2) == dict(
        n_p=3 * 2 * 70 * 70, differ=0, s=0, p=0, other=0, largest=0.0)
    v = torch.randn(3, 70, 2, 32, generator=g).to(torch.bfloat16) \
        .transpose(1, 2)
    worst = smoke.explain_worst(q, k, v, bias)
    assert worst["err"] == 0 and worst["keys"] == []


@pytest.mark.parametrize("dh", [64, 192])
@pytest.mark.parametrize("top", [8, 64])
def test_grid_scores_are_exact_in_any_order(smoke, dh, top):
    """grid_qk's q k^T in f32 equals the exact (f64) sum, so every f32
    summation order gives it: the kernel's scores and the plain version's
    are the same. At top = 64 rows spread past 44 (scale dh^-0.5), where
    exps fall below 2^-64."""
    q, k = smoke.grid_qk(2, 50, 3, dh, torch.Generator().manual_seed(5),
                         torch.device("cpu"), top)
    exact = q.double() @ k.double().transpose(-1, -2)
    assert torch.equal((q.float() @ k.float().transpose(-1, -2)).double(),
                       exact)
    spread = (exact.amax(-1) - exact.amin(-1)) * dh ** -0.5
    assert spread.min() > (44 if top == 64 else 4)


def _next_bf16(x):
    return (x.float().view(torch.int32) + 65536).view(torch.float32) \
        .to(torch.bfloat16)


def test_p_causes_sorts_a_score_and_a_rounding(smoke):
    """A score moved by one bf16 step counts under ``s`` (every P of its
    row that moves), and so does a P moved by a step far from any
    midpoint (no rounding of P explains it, only another score); a P
    rounded to the other side of a midpoint it sits on counts under
    ``p``."""
    g = torch.Generator().manual_seed(2)
    s = (torch.randn(1, 1, 64, 197, generator=g) * 2).to(torch.bfloat16)
    p32 = torch.softmax(s.float(), -1)
    pk = p32.to(torch.bfloat16)
    assert smoke.p_causes(pk, s, p32)["differ"] == 0
    # row 0: key 5's score one step up (|s| >= 1 there)
    s[0, 0, 0, 5] = 1.5
    s1 = s.clone()
    s1[0, 0, 0, 5] = _next_bf16(s[0, 0, 0, 5])
    p32 = torch.softmax(s.float(), -1)
    pk = p32.to(torch.bfloat16)
    pk[0, 0, 0] = torch.softmax(s1[0, 0, 0].float(), -1).to(torch.bfloat16)
    moved = int((pk[0, 0, 0] != p32[0, 0, 0].to(torch.bfloat16)).sum())
    assert moved >= 1
    # the P nearest a bf16 midpoint (rows 1 on), rounded the other way
    bits = p32.view(torch.int32)
    mid = ((bits & -65536) | 32768).view(torch.float32)
    rel = ((p32 - mid).abs() / p32)[0, 0, 1:]
    i, j = divmod(int(rel.argmin()), 197)
    assert rel[i, j] <= smoke.P_MIDPOINT
    i += 1
    other = mid[0, 0, i, j] * 2 - pk[0, 0, i, j].float()
    pk[0, 0, i, j] = other.to(torch.bfloat16)
    # the P farthest from a midpoint (rows 2 on, not i), one step up
    far = ((p32 - mid).abs() / p32)[0, 0]
    far[:2] = far[i] = 0
    fi, fj = divmod(int(far.argmax()), 197)
    pk[0, 0, fi, fj] = _next_bf16(pk[0, 0, fi, fj])
    got = smoke.p_causes(pk, s, p32)
    assert got == dict(n_p=64 * 197, differ=moved + 2, s=moved + 1, p=1,
                       other=0, largest=got["largest"])


# ---- on the card


# F10's rows on the card (chip_smoke.py --kernel-b): (b, h, i) and the key
# whose near-tie score the kernel rounds otherwise than cuBLAS. T = 149:
# exact q k^T 26.56250238, 1.9e-5 of a bf16 step above the midpoint 26.5625
# (the kernel rounds up, correctly); T = 69: 19.5625017 (cuBLAS rounds up,
# correctly).
F10_ROWS = {149: ((59, 7, 94), 120), 69: ((117, 10, 16), 64)}


@pytest.mark.cuda
def test_f10_draws_are_within_the_bound(cuda, smoke):
    """The draws of ``chip_smoke.py --kernel-b`` on which F10 showed
    (ToMe's bf16 blocks at T = 149 and 69, seed 7, with the key bias):
    beyond ATTN_BOUND strictly (1.367e-2 and 1.953e-2), and within it by
    the tie check, which accepts exactly one row of each through its
    near-tie key, within a few f32 ulps of the bf16 midpoint."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(7)
    biases = smoke._tome_sizes(smoke.BATCH, 197, smoke.TOME_R, 12, cuda)
    found = {}
    for t, bias, q, k, v in smoke.tome_bias_draws(torch.bfloat16, g, biases,
                                                  cuda):
        if t in F10_ROWS:
            got = attn.multi_head_attention(q, k, v, key_bias=bias)
            found[t] = smoke.bf16_tie_check(
                got, q, k, v, bias, bound=smoke.ATTN_BOUND[torch.bfloat16])
    assert list(found) == [149, 69]
    for t, res in found.items():
        assert res["ok"], (t, res["rejected"])
        assert res["err"] > smoke.ATTN_BOUND[torch.bfloat16]
        row, key = F10_ROWS[t]
        [acc] = res["accepted"]
        assert (acc["b"], acc["h"], acc["i"]) == row
        assert [x["key"] for x in acc["keys"]] == [key]
        assert acc["keys"][0]["ulps"] <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("b,t,h,dh,top", [
    (16, 197, 12, 64, 8),   # the backbone: the held variant
    (16, 197, 12, 64, 64),  # scores spread past the FMA quotient's reach
    (16, 64, 12, 64, 8),    # one key tile
    (16, 64, 12, 64, 64),
    (2, 705, 12, 64, 8),    # past the held limit at dh = 64: two passes
    (2, 705, 12, 64, 64),
    (32, 9, 8, 96, 8),      # the chunk encoder
    (8, 5, 4, 192, 8),      # the RAG head
    (8, 130, 4, 192, 8)])   # held at dh = 192
def test_kernel_p_is_the_plain_p(cuda, smoke, with_bias, b, t, h, dh, top):
    """Where the scores agree (grid_qk: q k^T exact in every order) the
    kernel's P, read through one-hot V, equals the plain version's to the
    bit in every bf16 variant: P's exp, sum and quotient are the reference
    softmax's, also where exps fall below 2^-64 (top = 64)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    q, k = smoke.grid_qk(b, t, h, dh, g, cuda, top)
    bias = torch.log(torch.randint(1, 9, (b, t), generator=g).float()) \
        .to(cuda) if with_bias else None
    got = smoke.p_probe(q, k, bias, chunk=8)
    assert got["n_p"] == b * h * t * t
    assert got["differ"] == 0, got
