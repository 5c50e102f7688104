"""bf16 arithmetic of the port's heads and attention against the JAX
package's on the CPU, op by op, where a bf16 tensor meets a Python scalar
or an op that torch rounds otherwise.

JAX (XLA on the CPU) computes a bf16 op and rounds its result to bf16 op
by op, and a Python float that meets a bf16 array is first rounded to
bf16 (a weakly typed scalar). torch keeps a Python scalar in f32 for a
bf16 tensor's arithmetic, and ``F.gelu`` and ``torch.softmax`` compute a
bf16 input in f32 and round once. The sites checked:

- the attention scale ``dh ** -0.5`` (``attention_plain``, the plain
  branch of ``MultiHeadSelfAttention``; here and in test_torch_kernels.py)
  and Dropout's ``x / (1 - p)``: Python floats, rounded as JAX rounds
  them (``ops/attention.py::weak_scalar``), bit-equal;
- GELU and softmax in bf16: one rounding against XLA's op by op, within
  an ulp;
- ToMe: the merge (sizes and the weighted mean in f32 on both sides) and
  its metric, the keys' mean;
- the classifiers: ReLU and Dense, whose only scalar is their Dropout's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.models import vit as jax_vit
from vit_research_tpu.ops import tome as jax_tome
from vit_research_tpu_torch.models import vit as tvit
from vit_research_tpu_torch.ops import attention as attn
from vit_research_tpu_torch.ops import tome

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.mark.parametrize("x", [16 ** -0.5, 48 ** -0.5, 80 ** -0.5,
                               96 ** -0.5, 128 ** -0.5, 192 ** -0.5, -0.3,
                               0.9, 0.8, 0.7])
def test_weak_scalar_is_the_value_jax_multiplies_by(x):
    """A Python float meeting a bf16 (f32) array in JAX acts as its bf16
    (f32) rounding: dh = 96 multiplies by 0.10205078125, not 0.10206."""
    for dtype, jdtype in ((BF16, jnp.bfloat16), (torch.float32,
                                                 jnp.float32)):
        assert attn.weak_scalar(x, dtype) == float(
            jnp.asarray(1, jdtype) * x)


def _mhsa_pair(dh: int, h: int = 2, seed: int = 0):
    """The JAX and the port's MultiHeadSelfAttention, bf16 compute over
    f32 weights, with the same weights (h heads of width dh)."""
    d = h * dh
    jm = jax_vit.MultiHeadSelfAttention(num_heads=h, dtype=jnp.bfloat16)
    x0 = jnp.zeros((1, 3, d), jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), x0))["params"]
    tm = tvit.MultiHeadSelfAttention(d, h, dtype=BF16).eval()
    sd = {}
    for name in ("query", "key", "value"):
        sd[f"{name}.weight"] = params[name]["kernel"].reshape(d, d).T
        sd[f"{name}.bias"] = params[name]["bias"].reshape(d)
    sd["out.weight"] = params["out"]["kernel"].reshape(d, d).T
    sd["out.bias"] = params["out"]["bias"]
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in sd.items()})
    return jm, params, tm


@pytest.mark.parametrize("dh", [96, 192])
@pytest.mark.parametrize("with_bias", [False, True])
def test_mhsa_bf16_scores_match_jax(dh, with_bias):
    """``MultiHeadSelfAttention(dtype=bf16)``'s returned scores (its plain
    branch) against the JAX module's at the heads' widths, inputs scaled
    so that a row's scores spread over 10 or more: probabilities of the
    same bf16 scores, equal but for the f32 exp's last bits (2^-20). The
    parent, which scaled the bf16 scores by the f32 dh ** -0.5, was
    7.44e-4 / 1.72e-4 away at dh = 96 (without / with the bias) and
    7.81e-3 / 7.66e-3 at dh = 192."""
    jm, params, tm = _mhsa_pair(dh)
    rng = np.random.default_rng(dh)
    x = (rng.standard_normal((2, 9, 2 * dh)) * 2.5).astype(np.float32)
    log_size = np.log(rng.integers(1, 9, (2, 9))).astype(np.float32) \
        if with_bias else None
    want_out, want = jm.apply(
        {"params": params}, jnp.asarray(x), output_scores=True,
        log_size=None if log_size is None else jnp.asarray(log_size))
    with torch.no_grad():
        got_out, got = tm(torch.from_numpy(x), output_scores=True,
                          log_size=None if log_size is None
                          else torch.from_numpy(log_size))
    assert got.dtype == torch.float32 and got_out.dtype == BF16
    s = np.log(np.maximum(np.asarray(want), 1e-30))
    assert (s.max(-1) - s.min(-1)).max() >= 10  # the scores' spread
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2 ** -20)
    np.testing.assert_allclose(_np(got_out), _np(want_out), rtol=0,
                               atol=2 ** -8 * np.abs(_np(want_out)).max())


@pytest.mark.parametrize("p", [0.1, 0.2, 0.3, 0.5])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_dropout_scales_kept_values_as_flax(p, dtype):
    """A kept value is ``x / (1 - p)`` with ``1 - p`` rounded to x's dtype,
    as flax's ``inputs / keep_prob``: bit-equal. The parent divided bf16
    values by the f32 0.9 / 0.8 / 0.7: 66% / 86% / 80% of them equal."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((64, 256)) * 3).astype(
        np.float32)).to(dtype)
    drop = tvit.Dropout(p).train()
    drop.generator = torch.Generator().manual_seed(0)
    got = drop(x)
    assert got.dtype == dtype
    kept = (got != 0).numpy() & (x != 0).numpy()
    assert abs(kept.mean() - (1 - p)) < 0.02
    jdtype = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = _np(jnp.asarray(_np(x), jdtype) / (1 - p))
    np.testing.assert_array_equal(_np(got)[kept], want[kept])


@pytest.mark.parametrize("op", ["gelu_tanh", "gelu", "softmax"])
def test_bf16_gelu_and_softmax_within_an_ulp_of_jax(op):
    """GELU (tanh in the heads' blocks, exact in RATTHeadV2's) and softmax
    in bf16 (the RAGHead's retrieval pooler, a bf16 ``softmax_dtype``):
    torch computes a bf16 input in f32 and rounds once, XLA on the CPU
    rounds each op of ``jax.nn.gelu`` / ``jax.nn.softmax`` to bf16 (57-59%
    / 32% of values equal). The port keeps torch's one rounding, within
    2^-8 of the largest value of JAX's (following XLA op by op doubled
    the bf16 heads' card-vs-CPU gap and moved the bf16 stage-1 run past
    its bound from the f32 run)."""
    rng = np.random.default_rng(4)
    if op == "softmax":
        x = (rng.standard_normal((256, 4, 16)) * 4).astype(np.float32)
        want = _np(jax.nn.softmax(jnp.asarray(x, jnp.bfloat16), axis=-1))
        got = torch.softmax(_bf16(x), dim=-1)
    else:
        x = (rng.standard_normal((512, 64)) * 3).astype(np.float32)
        tanh = op == "gelu_tanh"
        want = _np(jax.nn.gelu(jnp.asarray(x, jnp.bfloat16),
                               approximate=tanh))
        got = torch.nn.functional.gelu(
            _bf16(x), approximate="tanh" if tanh else "none")
    assert got.dtype == BF16
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=2 ** -8 * np.abs(want).max())


def test_tome_merge_and_metric_follow_jax_in_bf16():
    """ToMe on bf16 tokens: the merge computes sizes and the weighted mean
    in f32 on both sides (sizes equal; tokens within one bf16 ulp, the
    scatter adds in another order), and its metric, the keys' mean over
    heads, accumulates in f32 and rounds once on both sides (equal)."""
    rng = np.random.default_rng(8)
    b, t, d, r = 4, 33, 64, 8
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    metric = rng.standard_normal((b, t, d)).astype(np.float32)
    sizes = rng.integers(1, 5, (b, t)).astype(np.float32)
    jx, js = jax_tome.bipartite_merge(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(metric, jnp.bfloat16),
        jnp.asarray(sizes), r)
    tx, ts = tome.bipartite_merge(_bf16(x), _bf16(metric),
                                  torch.from_numpy(sizes), r)
    assert tx.dtype == BF16
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(_np(tx), _np(jx), rtol=2 ** -8, atol=0)
    k = rng.standard_normal((b, t, 12, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(_bf16(k).mean(dim=2)),
        _np(jnp.asarray(k, jnp.bfloat16).mean(axis=2)))
