"""The port's kernel modules (ops/patch_embed.py, ops/attention.py) against
the JAX package's Pallas kernels run in interpret mode on the CPU.

Inputs are drawn with numpy from fixed seeds and fed to both sides.
Tolerances: both sides compute in f32 on the CPU and differ only in the
order of the K-long (patch embed) or T-long (attention) sums, so values of
order 1 agree to about 1e-6; the bound is 1e-5 (abs and rel). The kernels
themselves are checked on a card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_research_tpu.ops import attention as jax_attn
from vit_research_tpu.ops import patch_embed as jax_pe
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


@pytest.mark.parametrize("t,dh", [(17, 16), (65, 32), (197, 64)])
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


def test_attention_plain_matches_xla_reference_bf16():
    # bf16 inputs: scores and the product with v round to bf16 at the same
    # places on both sides; the bound is two bf16 ulps of values < 4.
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 2, 33, 16)).astype(np.float32)
               for _ in range(3))
    want = jax_attn.xla_attention(*(jnp.asarray(a, jnp.bfloat16)
                                    for a in (q, k, v)))
    got = attn.attention_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                                 for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2 * 2 ** -6)


def test_attention_rejects_mismatched_shapes():
    q = torch.zeros(1, 2, 5, 16)
    with pytest.raises(ValueError, match="share one"):
        attn.multi_head_attention(q, torch.zeros(1, 2, 6, 16), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attn.multi_head_attention(q.double(), q.double(), q.double())
