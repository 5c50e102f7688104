"""The port's fused LayerNorm + projection (ops/fused_ln.py) against the
JAX package's Pallas kernel run in interpret mode on the CPU, forward and
gradients.

Inputs are drawn with numpy from fixed seeds and fed to both sides.
Tolerances: f32 weights 1e-5 (abs and rel): both sides compute in f32 and
differ in the order of the K-long sums and in the erf (the Pallas kernel's
polynomial has |err| < 1.5e-7, torch's erf is exact to an ulp). bf16
weights: both sides round the LN output to bf16 before the product, so a
row whose pre-rounding values differ by an ulp can round apart; the bound
is 2^-6 relative to the output's scale. Gradients: 1e-4, the reference
test's own bound. The kernel's f32-weight arithmetic, 3xTF32, is emulated
here (TF32 rounding as cvt.rna.tf32.f32 does it, f32 sums of exact
products) and held to the f32 bound, 1e-5 of the output's scale, which a
single TF32 pass misses. The CUDA kernel is checked on a card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.ops import fused_ln as jax_fused_ln
from vit_research_tpu_torch.ops import fused_ln

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(m, k, n, w_dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    gamma = rng.normal(1.0, 0.1, size=(k,)).astype(np.float32)
    beta = rng.normal(0.0, 0.1, size=(k,)).astype(np.float32)
    w = rng.normal(0, 0.05, size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, gamma, beta, w, b


def _jax(arrays, w_dtype, **kw):
    x, gamma, beta, w, b = (jnp.asarray(a) for a in arrays)
    if w_dtype == "bfloat16":
        w = w.astype(jnp.bfloat16)
    return jax_fused_ln.ln_matmul(x, gamma, beta, w, b, interpret=True, **kw)


def _torch(arrays, w_dtype, **kw):
    x, gamma, beta, w, b = (torch.from_numpy(a) for a in arrays)
    if w_dtype == "bfloat16":
        w = w.to(torch.bfloat16)
    return fused_ln.ln_matmul(x, gamma, beta, w, b, **kw)


@pytest.mark.parametrize("m,k,n", [(256, 256, 128), (300, 128, 384),
                                   (64, 768, 256)])
@pytest.mark.parametrize("act", [None, "gelu", "gelu_tanh"])
def test_ln_matmul_matches_pallas_interpret(m, k, n, act):
    arrays = _case(m, k, n)
    want = _jax(arrays, "float32", activation=act)
    got = _torch(arrays, "float32", activation=act)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_matmul_bf16_weights_match_pallas_interpret(act):
    arrays = _case(128, 256, 128, seed=1)
    want = np.asarray(_jax(arrays, "bfloat16", activation=act), np.float32)
    got = _torch(arrays, "bfloat16", activation=act)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -6 * scale)
    # and with f32 out: the product of bf16-rounded values in f32
    want32 = np.asarray(_jax(arrays, "bfloat16", activation=act,
                             out_dtype=jnp.float32))
    got32 = _torch(arrays, "bfloat16", activation=act,
                   out_dtype=torch.float32)
    np.testing.assert_allclose(got32.numpy(), want32, rtol=0,
                               atol=2 ** -6 * scale)


def test_ln_matmul_leading_dims_and_no_bias():
    x, gamma, beta, w, _ = _case(8 * 32, 128, 128, seed=2)
    x3 = x.reshape(8, 32, 128)
    want = jax_fused_ln.ln_matmul(jnp.asarray(x3), jnp.asarray(gamma),
                                  jnp.asarray(beta), jnp.asarray(w),
                                  interpret=True)
    got = fused_ln.ln_matmul(torch.from_numpy(x3), torch.from_numpy(gamma),
                             torch.from_numpy(beta), torch.from_numpy(w))
    assert got.shape == (8, 32, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", [None, "gelu", "gelu_tanh"])
def test_ln_matmul_gradients_match_jax(act):
    arrays = _case(64, 128, 96, seed=3)
    g = np.random.default_rng(4).normal(size=(64, 96)).astype(np.float32)

    def loss(*a):
        out = jax_fused_ln.ln_matmul(*a, activation=act, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fused_ln.ln_matmul(*leaves, activation=act)
    out.backward(torch.from_numpy(g))
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)


def test_ln_matmul_gradient_of_some_inputs_only():
    x, gamma, beta, w, b = (torch.from_numpy(a)
                            for a in _case(16, 32, 8, seed=5))
    x.requires_grad_()
    fused_ln.ln_matmul(x, gamma, beta, w, b, activation="gelu").sum() \
        .backward()
    assert x.grad is not None and x.grad.shape == x.shape
    assert gamma.grad is None and w.grad is None


def test_ln_matmul_rejects_what_it_does_not_take():
    x, gamma, beta, w, b = (torch.from_numpy(a) for a in _case(4, 16, 8))
    with pytest.raises(ValueError, match="K = 16"):
        fused_ln.ln_matmul(x, gamma, beta, w.T.contiguous(), b)
    with pytest.raises(ValueError, match="activation"):
        fused_ln.ln_matmul(x, gamma, beta, w, b, activation="relu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_ln.ln_matmul(x.double(), gamma, beta, w, b)
    with pytest.raises(ValueError, match="bias"):
        fused_ln.ln_matmul(x, gamma, beta, w, b[:4])


def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    vals = [1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
            1 + 1.5 * ulp, 2 - ulp / 2, 3.0e-30, 0.0, -0.0]
    want = [1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 2.0]
    got = fused_ln.tf32_round(torch.tensor(vals, dtype=torch.float32))
    assert got[:6].tolist() == want
    # 10 explicit significand bits left at any scale; zeros stay zeros
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[6].item() - 3.0e-30) <= 3.0e-30 * 2 ** -11
    assert got[7].item() == 0.0 and got[8].item() == 0.0


def test_tf32_split_holds_the_weight_and_pads():
    w = torch.from_numpy(np.random.default_rng(9).normal(
        size=(32, 13)).astype(np.float32))
    pieces = fused_ln.tf32_split(w, 16)
    assert pieces.shape == (2, 32, 16) and torch.all(pieces[:, :, 13:] == 0)
    hi, lo = pieces[0, :, :13], pieces[1, :, :13]
    assert torch.equal(hi, fused_ln.tf32_round(w))
    assert torch.equal(lo, fused_ln.tf32_round(w - hi))
    # 22 significand bits: the pieces' sum is within 2^-21 of W
    assert torch.all((hi.double() + lo.double() - w.double()).abs()
                     <= w.double().abs() * 2 ** -21)


def _tf32_product(arrays, activation, passes, eps=1e-6):
    """The kernel's f32-W arithmetic on the CPU: LN in f32, then y and W
    split into TF32 pieces and y_hi W_lo + y_lo W_hi + y_hi W_hi (3
    passes) or y_hi W_hi (1 pass), each product exact in f32."""
    x, gamma, beta, w, b = (torch.from_numpy(a) for a in arrays)
    y = fused_ln.layer_norm_rows(x, gamma, beta, eps)
    y_hi = fused_ln.tf32_round(y)
    y_lo = fused_ln.tf32_round(y - y_hi)
    w_hi, w_lo = fused_ln.tf32_split(w)
    out = y_hi @ w_hi
    if passes == 3:
        out = (y_hi @ w_lo + y_lo @ w_hi) + out
    out = out + b
    if activation == "gelu":
        out = torch.nn.functional.gelu(out)
    return out


@pytest.mark.parametrize("activation", [None, "gelu"])
def test_3xtf32_matches_pallas_interpret_and_one_pass_does_not(activation):
    arrays = _case(64, 768, 3072, seed=10)
    want = np.asarray(_jax(arrays, "float32", activation=activation))
    scale = np.abs(want).max()
    three = _tf32_product(arrays, activation, passes=3).numpy()
    one = _tf32_product(arrays, activation, passes=1).numpy()
    np.testing.assert_allclose(three, want, rtol=0, atol=1e-5 * scale)
    assert np.abs(one - want).max() > 1e-5 * scale


def test_cpu_input_never_counts_a_launch():
    before = fused_ln.ln_matmul.launches
    fused_ln.ln_matmul(*(torch.from_numpy(a) for a in _case(4, 16, 8)))
    assert fused_ln.ln_matmul.launches == before
