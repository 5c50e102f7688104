"""chip_smoke.py's tie-aware bf16 comparison of kernel B (F10), on the CPU.

The bf16 plain version rounds each q k^T and each output P V, f32 sums,
to bf16, and the JAX package's bf16 attention (``xla_attention``; with
ToMe's bias as ``models/vit.py`` adds it) does so in orders XLA does not
fix. Where an exact sum lies within that sum's rounding error of a bf16
midpoint, either neighbour is what the reference computes.
``bf16_tie_check`` accepts a row beyond the bound only where rounding
such near ties the other way brings the whole row within the same bound.

Here the plain version stands in for the kernel. The draws are planted
with numpy from a seed: in row (0, 1, 3) key 5's exact q k^T is 20.0625 +
2^-20, half an f32 ulp above a bf16 midpoint (every f32 order ties to the
midpoint and rounds to 20.0, where S* is 20.125), with a P near 0.5 and
|v| = 2.5; in row (1, 0, 7) key 2's is 20.03125, half a bf16 step from
any midpoint, with the same P and v; in row (1, 1, 12) key 3's is
20.0625 + 2^-19, one f32 ulp above the midpoint, which a sum from the
left rounds to 20.0 and a pairwise sum to 20.125.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.ops import attention as jax_attn
from vit_research_tpu_torch.ops import attention as attn

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
BOUND = 1e-2  # chip_smoke.ATTN_BOUND[torch.bfloat16], checked below
TIE_ROW, TIE_KEY = (0, 1, 3), 5
FAR_ROW, FAR_KEY = (1, 0, 7), 2
ORDER_ROW, ORDER_KEY = (1, 1, 12), 3
SCALE = 16 ** -0.5


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.ATTN_BOUND[BF16] == BOUND
    return mod


def _planted(with_bias: bool, seed: int = 0):
    """bf16 q, k, v (2, 2, 16, 16) and a ToMe-like key bias (log sizes) or
    None, with the near tie and the far score of the module docstring."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, 2, 16, 16)) * 0.5 for _ in range(3))
    for (b, h, i), j, tail, other in (
            (TIE_ROW, TIE_KEY, [0.0625, 2.0 ** -20], 9),
            (FAR_ROW, FAR_KEY, [0.03125], 11),
            (ORDER_ROW, ORDER_KEY, [0.0625, 2.0 ** -20, 2.0 ** -20], 8)):
        # the rival key scores 20 exactly
        q[b, h, i] = 0
        q[b, h, i, :1 + len(tail)] = [20, *tail]
        k[b, h, :, :4] *= 0.05
        k[b, h, j] = 0
        k[b, h, j, :1 + len(tail)] = 1
        k[b, h, other] = 0
        k[b, h, other, 0] = 1
        v[b, h, j, 0], v[b, h, other, 0] = 2.5, -2.5
    bias = None
    if with_bias:
        bias = np.log(rng.integers(1, 9, (2, 16))).astype(np.float32)
        bias[0, [TIE_KEY, 9]] = bias[1, [FAR_KEY, 11]] = np.log(3)
        bias = torch.from_numpy(bias)
    return (*(torch.from_numpy(x.astype(np.float32)).to(BF16)
              for x in (q, k, v)), bias)


def _from_scores(smoke, raw, v, bias):
    """attention_plain from given bf16 q k^T: what a kernel that rounded
    those scores so would return."""
    _, p32 = smoke.scores_softmax(raw, bias, SCALE)
    return torch.einsum("bhqk,bhkd->bhqd", p32.to(BF16), v)


def _flipped(smoke, q, k, v, bias, row, key):
    """The plain output with q k^T at (row, key) rounded to the exact
    sum's other bf16 neighbour."""
    raw = torch.einsum("bhqd,bhkd->bhqk", q, k)
    assert torch.equal(_from_scores(smoke, raw, v, bias),
                       attn.attention_plain(q, k, v, key_bias=bias))
    at = (*row, key)
    up = smoke.exact_scores(q, k)["exact"][at] > raw[at].double()
    bits = raw[at].float().view(torch.int32) + (65536 if up else -65536)
    raw[at] = bits.view(torch.float32).to(BF16)
    return _from_scores(smoke, raw, v, bias)


@pytest.mark.parametrize("with_bias", [False, True])
def test_a_flip_at_a_near_tie_is_accepted_through_its_key(smoke, with_bias):
    q, k, v, bias = _planted(with_bias)
    ex = smoke.exact_scores(q, k)
    at = (*TIE_ROW, TIE_KEY)
    assert ex["exact"][at].item() == 20.0625 + 2.0 ** -20
    assert ex["s"][at].item() == 20.125
    assert torch.einsum("bhqd,bhkd->bhqk", q, k)[at].item() == 20.0
    assert ex["near"][at] and ex["ulps"][at].item() == 0.5
    got = _flipped(smoke, q, k, v, bias, TIE_ROW, TIE_KEY)
    res = smoke.bf16_tie_check(got, q, k, v, bias, bound=BOUND)
    assert res["err"] > BOUND and res["over_rows"] == 1
    assert res["ok"] and res["rejected"] is None
    [row] = res["accepted"]
    assert (row["b"], row["h"], row["i"]) == TIE_ROW
    assert row["err"] == res["err"] and row["tie_err"] <= BOUND
    [key] = row["keys"]
    assert key["key"] == TIE_KEY and key["ulps"] == 0.5
    assert (key["plain"], key["tie"]) == (20.0, 20.125)
    assert key["p_plain"] > 0.1 and key["max_v"] == 2.5
    assert "accepted by a tie" in smoke.tie_text(res)
    # a list of outputs (two layouts) holds each
    res2 = smoke.bf16_tie_check([got, got], q, k, v, bias, bound=BOUND)
    assert res2["ok"] and [r["out"] for r in res2["accepted"]] == [0, 1]


@pytest.mark.parametrize("with_bias", [False, True])
def test_the_same_flip_away_from_a_tie_is_rejected(smoke, with_bias):
    q, k, v, bias = _planted(with_bias)
    ex = smoke.exact_scores(q, k)
    at = (*FAR_ROW, FAR_KEY)
    assert ex["exact"][at].item() == 20.03125 and not ex["near"][at]
    got = _flipped(smoke, q, k, v, bias, FAR_ROW, FAR_KEY)
    res = smoke.bf16_tie_check(got, q, k, v, bias, bound=BOUND)
    assert res["err"] > BOUND and not res["ok"] and res["accepted"] == []
    assert (res["rejected"]["b"], res["rejected"]["h"],
            res["rejected"]["i"]) == FAR_ROW


@pytest.mark.parametrize("with_bias", [False, True])
def test_an_off_row_without_a_near_tie_is_rejected(smoke, with_bias):
    q, k, v, bias = _planted(with_bias)
    near = smoke.exact_scores(q, k)["near"].any(-1)
    b, h, i = (int(x) for x in torch.nonzero(~near)[0])
    got = attn.attention_plain(q, k, v, key_bias=bias).clone()
    got[b, h, i, 4] += 3 * BOUND
    res = smoke.bf16_tie_check(got, q, k, v, bias, bound=BOUND)
    assert not res["ok"]
    rej = res["rejected"]
    assert (rej["n_ties"], rej["b"], rej["h"], rej["i"]) == (0, b, h, i)
    assert rej["err"] == res["err"] and rej["tie_err"] > BOUND
    # within the bound it passes strictly
    got[b, h, i, 4] -= 2.5 * BOUND
    res = smoke.bf16_tie_check(got, q, k, v, bias, bound=BOUND)
    assert res["ok"] and res["over_rows"] == 0 and res["err"] <= BOUND


@pytest.mark.parametrize("with_bias", [False, True])
def test_a_near_tie_row_off_at_another_column_is_rejected(smoke, with_bias):
    q, k, v, bias = _planted(with_bias)
    got = _flipped(smoke, q, k, v, bias, TIE_ROW, TIE_KEY)
    got[(*TIE_ROW, 7)] += 3 * BOUND
    res = smoke.bf16_tie_check(got, q, k, v, bias, bound=BOUND)
    assert not res["ok"] and res["accepted"] == []
    rej = res["rejected"]
    assert (rej["b"], rej["h"], rej["i"]) == TIE_ROW
    assert rej["n_ties"] >= 1 and rej["tie_err"] > BOUND


@pytest.mark.parametrize("case", ["planted", "planted_bias", "backbone"])
def test_the_f32_score_semantics_is_rejected(smoke, case):
    """attention_f32_scores (F8's fault: f32 scores) differs from the bf16
    plain version at every score, not only at near ties: rejected on the
    planted draws and at the backbone's head shape (H = 12, T = 197, dh =
    64) with the scores of trained heads, while the plain version itself
    passes."""
    if case == "backbone":
        g = torch.Generator().manual_seed(6)
        q, k, v = (torch.randn(2, 12, 197, 64, generator=g) * s
                   for s in (smoke.LARGE_QK, smoke.LARGE_QK, 1.0))
        q, k, v = (x.to(BF16) for x in (q, k, v))
        bias = None
    else:
        q, k, v, bias = _planted(case == "planted_bias")
    old = smoke.attention_f32_scores(q, k, v, bias)
    res = smoke.bf16_tie_check(old, q, k, v, bias, bound=BOUND)
    assert res["err"] > BOUND and not res["ok"]
    plain = attn.attention_plain(q, k, v, key_bias=bias)
    res = smoke.bf16_tie_check(plain, q, k, v, bias, bound=BOUND)
    assert res["ok"] and res["err"] == 0 and res["accepted"] == []
    errs = smoke.bf16_attention_errs(plain, q, k, v, bias, bound=BOUND,
                                     tells_apart=True)
    assert not errs["f32_ties"]["ok"]
    smoke.check_bf16_attention(errs, case)


def _output_tie(mean_gap: float):
    """bf16 q, k, v (1, 1, 16, 16) whose row 2 puts P = 1/2 (in bf16) on
    keys 4 and 11 (scores 30 after the scale) and some 1e-13 on each other
    key: output column 0 is (3 + (3 + mean_gap)) / 2 plus a sum of 1e-13
    terms. With ``mean_gap`` 2^-6 (one bf16 step at 3) it lies on a bf16
    midpoint, where any f32 order rounds to 3.0 by ties to even; with 2^-5
    it is the bf16 value 3.015625, far from any midpoint."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 1, 16, 16)) * 0.5 for _ in range(3))
    q[0, 0, 2] = 0
    q[0, 0, 2, 0] = 12
    k[0, 0, :, 0] *= 0.05
    k[0, 0, [4, 11]] = 0
    k[0, 0, [4, 11], 0] = 10
    v[0, 0, 4, 0], v[0, 0, 11, 0] = 3.0, 3.0 + mean_gap
    return [torch.from_numpy(x.astype(np.float32)).to(BF16)
            for x in (q, k, v)]


@pytest.mark.parametrize("tie", [True, False])
def test_an_output_moved_by_one_ulp(smoke, tie):
    """The same holds for the second rounding, P V to bf16: an output whose
    exact sum lies at a bf16 midpoint, rounded to its other neighbour (one
    ulp, 2^-6 at 3, beyond 1e-2), is accepted through that output alone
    (no score moved); one ulp away from a value far from any midpoint is
    rejected."""
    q, k, v = _output_tie(2.0 ** -6 if tie else 2.0 ** -5)
    plain = attn.attention_plain(q, k, v)
    eo = smoke.exact_outputs(
        smoke.scores_softmax(torch.einsum("bhqd,bhkd->bhqk", q, k), None,
                             SCALE)[1].to(BF16), v)
    at = (0, 0, 2, 0)
    assert bool(eo["near"][at]) == tie
    assert plain[at].item() == (3.0 if tie else 3.015625)
    got = plain.clone()
    got[at] = 3.015625 if tie else 3.03125
    res = smoke.bf16_tie_check(got, q, k, v, bound=BOUND)
    assert res["err"] == 2.0 ** -6 > BOUND
    assert res["ok"] == tie
    if tie:
        [row] = res["accepted"]
        assert (row["b"], row["h"], row["i"], row["keys"]) == (0, 0, 2, [])
        [col] = row["cols"]
        assert col["col"] == 0 and col["ulps"] < 1
        assert (col["lo"], col["hi"]) == (3.0, 3.015625)
    else:
        assert res["rejected"]["i"] == 2


def test_exact_scores_round_correctly(smoke):
    """S* is the correctly rounded bf16 value of the exact sum: on values
    that f32 holds exactly (one factor 1, dh = 1) it equals torch's
    round-to-nearest-even of the f32 value, midpoints and signs
    included."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(4000) * 30,
                        rng.uniform(-1e-3, 1e-3, 1000)]).astype(np.float32)
    mids = np.array([20.0625, 20.1875, -20.0625, -20.1875, 1.00390625,
                     -1.01171875, 255.5, 0.0], np.float32)
    x = torch.from_numpy(np.concatenate([x, mids]))
    q = x.reshape(1, 1, -1, 1)
    ex = smoke.exact_scores(q, torch.ones(1, 1, 1, 1))
    s = ex["s"][..., 0]
    assert torch.equal(s.flatten().to(BF16), x.to(BF16))
    assert ((ex["lo"] <= ex["s"]) & (ex["s"] <= ex["hi"])).all()
    assert torch.equal(ex["near"], ex["lo"] != ex["hi"])
    assert ex["near"][..., 0].flatten()[-8:-1].all()  # on a midpoint
    assert (ex["ulps"][..., 0].flatten()[-8:-1] == 0).all()


@pytest.mark.parametrize("b,h,t,dh,qk", [
    (2, 12, 197, 64, 1.0), (2, 12, 149, 64, 2.0), (4, 8, 9, 96, 2.0),
    (2, 4, 130, 192, 2.0), (3, 2, 65, 16, 4.0)])
def test_the_self_check_holds_on_the_cpus_einsum(smoke, b, h, t, dh, qk):
    """The CPU's own bf16 einsum (the plain version's q k^T here) equals S*
    off the near-tie set and a neighbour on it: the check raises nothing,
    and passes the plain version itself with nothing over the bound."""
    g = torch.Generator().manual_seed(t + dh)
    q, k, v = (torch.randn(b, h, t, dh, generator=g) * s
               for s in (qk, qk, 1.0))
    q, k, v = (x.to(BF16) for x in (q, k, v))
    bias = torch.log(torch.randint(1, 9, (b, t), generator=g).float())
    ex = smoke.exact_scores(q, k)
    raw = torch.einsum("bhqd,bhkd->bhqk", q, k).double()
    assert torch.equal(raw[~ex["near"]], ex["s"][~ex["near"]])
    assert ((ex["lo"] <= raw) & (raw <= ex["hi"])).all()
    res = smoke.bf16_tie_check(attn.attention_plain(q, k, v, key_bias=bias),
                               q, k, v, bias, bound=BOUND)
    assert res["ok"] and res["over_rows"] == 0 and res["err"] == 0
    assert res["n_scores"] == b * h * t * t and 0 < res["near_ties"]


def test_the_self_check_raises_where_delta_is_too_small(smoke, monkeypatch):
    """With an empty near-tie set the planted score, which the CPU's f32
    sum rounds to 20.0 where S* is 20.125, fails the self-check."""
    q, k, v, bias = _planted(False)
    exact = smoke.exact_scores

    def no_ties(q, k):
        ex = exact(q, k)
        ex["near"] = torch.zeros_like(ex["near"])
        return ex

    monkeypatch.setattr(smoke, "exact_scores", no_ties)
    with pytest.raises(AssertionError, match=r"plain scores are neither .*"
                       r"\(0, 1, 3, 5\): plain 20.0"):
        smoke.bf16_tie_check(attn.attention_plain(q, k, v), q, k, v,
                             bound=BOUND)


def _jax_bf16_attention(q, k, v, bias):
    """The JAX package's bf16 attention on the CPU: ``xla_attention``, or
    with a key bias its einsum path as models/vit.py writes it (the bias
    cast to the scores' dtype and added before the f32 softmax)."""
    q, k, v = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
               for x in (q, k, v))
    if bias is None:
        out = jax_attn.xla_attention(q, k, v)
    else:
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * (q.shape[-1] ** -0.5)
        s = s + jnp.asarray(bias.numpy())[:, None, None, :].astype(s.dtype)
        p = jax.nn.softmax(s.astype(jnp.float32), axis=-1)
        out = jnp.einsum("bhqk,bhkd->bhqd", p.astype(q.dtype), v)
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(BF16)


@pytest.mark.parametrize("with_bias", [False, True])
def test_the_jax_packages_bf16_attention_is_accepted(smoke, with_bias):
    """The reference's own bf16 attention on the planted draws passes the
    check against the port's plain version: what the check accepts holds
    what the JAX package computes. XLA on the CPU sums row (1, 1, 12)'s
    planted q k^T otherwise than torch's einsum and rounds it to 20.125
    where the plain version has 20.0, so the strict check fails on the
    reference itself; the tie check accepts it through that key alone."""
    q, k, v, bias = _planted(with_bias)
    got = _jax_bf16_attention(q, k, v, bias)
    res = smoke.bf16_tie_check(got, q, k, v, bias, bound=BOUND)
    assert res["ok"], res
    assert res["err"] > BOUND
    [row] = res["accepted"]
    assert (row["b"], row["h"], row["i"]) == ORDER_ROW
    [key] = row["keys"]
    assert (key["key"], key["ulps"], key["plain"], key["tie"]) == (
        ORDER_KEY, 1.0, 20.0, 20.125)
