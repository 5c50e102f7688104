"""The port's CUDA kernels and engine on a card, against their plain
PyTorch versions. Every test carries the ``cuda`` marker and skips where
there is no card. This file imports no JAX (the card's machine has none),
so it also runs there without the JAX test harness:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances. f32: the kernels and the plain versions sum the same products
in other orders, ~1e-6 on outputs of order 1. bf16 patch embed: one bf16
rounding of outputs < 8 (2^-5). bf16 attention: the kernel keeps f32
scores and probabilities where the plain version rounds them to bf16
(outputs < 4: 1e-2). Fused LN + projection: f32 1e-5 relative to the
output's scale; with bf16 weights or output 2^-6 of it (a bf16 rounding of
the LN output or the result can fall apart between two summation
orders). The int8 store query: exact integer scores on both devices; the
L2 normalisation before quantizing may differ by an ulp, which moves a
score by at most ~1e-4 (tie-aware ids, distances to 1e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vit_research_tpu_torch.data.preprocess import (PreprocessSpec,
                                                    to_grayscale_3ch)
from vit_research_tpu_torch.models.vit import init_vit
from vit_research_tpu_torch.ops import attention as attn
from vit_research_tpu_torch.ops import fused_ln
from vit_research_tpu_torch.ops import patch_embed as pe
from vit_research_tpu_torch.ops import topk
from vit_research_tpu_torch.parallel import embed
from vit_research_tpu_torch.store.vector_store import Collection
from vit_research_tpu_torch.utils.configs import ViTConfig

pytestmark = pytest.mark.cuda

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HF_AFFINE = dict(rescale=1 / 255, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
TINY = ViTConfig(image_size=(32, 32), patch_size=8, hidden_size=32,
                 num_layers=2, num_heads=2, mlp_dim=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("in_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shape,patch,dim", [
    ((4, 224, 224, 3), 16, 768), ((2, 432, 768, 3), 32, 768),
    ((2, 40, 72, 3), 16, 48), ((3, 32, 32, 3), 8, 32)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_patch_embed_kernel_matches_plain(cuda, in_dtype, shape, patch, dim,
                                          out_dtype):
    rng = np.random.default_rng(0)
    if in_dtype == "uint8":
        host = rng.integers(0, 256, size=shape, dtype=np.uint8)
    else:
        host = rng.uniform(0, 255, size=shape).astype(np.float32)
    images = torch.from_numpy(host).to(cuda)
    k = patch * patch * 3
    w = torch.from_numpy((rng.standard_normal((k, dim)) * k ** -0.5)
                         .astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.standard_normal(dim).astype(
        np.float32)).to(cuda)
    before = pe.fused_patch_embed.launches
    got = pe.fused_patch_embed(images, w, bias, patch_size=patch,
                               out_dtype=out_dtype, **HF_AFFINE)
    assert pe.fused_patch_embed.launches == before + 1
    a, b = (torch.from_numpy(x).to(cuda)
            for x in pe.fold_affine(patch, **HF_AFFINE))
    want = pe.patch_embed_plain(images, w, bias, a, b, patch_size=patch,
                                out_dtype=out_dtype).reshape(got.shape)
    assert got.dtype == out_dtype
    atol = 1e-4 if out_dtype == torch.float32 else 2 ** -5
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("t,dh", [(17, 16), (65, 32), (197, 64), (325, 64),
                                  (1297, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(cuda, t, dh, dtype):
    g = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn(2, 12, t, dh, generator=g).to(cuda, dtype)
               for _ in range(3))
    before = attn.multi_head_attention.launches
    got = attn.multi_head_attention(q, k, v)
    assert attn.multi_head_attention.launches == before + 1
    want = attn.attention_plain(q.float(), k.float(), v.float())
    assert got.dtype == dtype
    atol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.float(), want, rtol=0, atol=atol)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 128, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attn.multi_head_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        attn.multi_head_attention(q, q, q)
    images = torch.zeros(1, 32, 32, 3, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="images on"):
        pe.fused_patch_embed(images, torch.zeros(192, 8), torch.zeros(8),
                             patch_size=8)


def test_grayscale_on_card_matches_host_oracle(cuda):
    frames = np.random.default_rng(1).integers(0, 256, size=(8, 32, 64, 3),
                                               dtype=np.uint8)
    got = embed.grayscale_u8(torch.from_numpy(frames).to(cuda)).cpu()
    np.testing.assert_array_equal(got.numpy(), to_grayscale_3ch(frames))


@pytest.mark.parametrize("grayscale", [False, True])
def test_engine_on_card_matches_cpu(cuda, grayscale):
    """The tiny engine through both kernels on the card vs the same
    weights' plain forward on the CPU (L2-normalised embeddings, 1e-5)."""
    spec = PreprocessSpec(size=(32, 32), grayscale=grayscale)
    frames = np.random.default_rng(2).integers(0, 256, size=(11, 32, 32, 3),
                                               dtype=np.uint8)
    host = embed.EmbeddingEngine(init_vit(TINY, seed=0, device="cpu"), spec,
                                 device="cpu", batch_size=4)
    want = host.embed_batch(frames)
    card = embed.EmbeddingEngine(init_vit(TINY, seed=0, device="cpu"), spec,
                                 device=cuda, batch_size=4)
    launches = (pe.fused_patch_embed.launches,
                attn.multi_head_attention.launches)
    got = card.embed_batch(frames)
    assert (pe.fused_patch_embed.launches - launches[0],
            attn.multi_head_attention.launches - launches[1]) == (3, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bf16_engine_on_card_is_close_to_f32(cuda):
    frames = np.random.default_rng(3).integers(0, 256, size=(6, 32, 32, 3),
                                               dtype=np.uint8)
    spec = PreprocessSpec(size=(32, 32))
    f32 = embed.EmbeddingEngine(init_vit(TINY, seed=0, device="cpu"), spec,
                                device=cuda).embed_batch(frames)
    bf16_cfg = dataclasses.replace(TINY, dtype="bfloat16")
    bf16 = embed.EmbeddingEngine(init_vit(bf16_cfg, seed=0, device="cpu"),
                                 spec, device=cuda).embed_batch(frames)
    # bf16 keeps ~3 significant digits through 2 layers: cosine > 0.999
    assert np.min(np.sum(f32 * bf16, axis=1)) > 0.999


@pytest.mark.parametrize("m,k,n", [(197, 768, 768), (300, 64, 200),
                                   (1, 40, 3072)])
@pytest.mark.parametrize("act", [None, "gelu", "gelu_tanh"])
@pytest.mark.parametrize("x_dtype,w_dtype,out_dtype", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32)])
def test_ln_matmul_kernel_matches_plain(cuda, m, k, n, act, x_dtype,
                                        w_dtype, out_dtype):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda, x_dtype)
    gamma, beta = (torch.from_numpy(rng.normal(mu, 0.1, size=k).astype(
        np.float32)).to(cuda) for mu in (1.0, 0.0))
    w = torch.from_numpy((rng.normal(size=(k, n)) * k ** -0.5).astype(
        np.float32)).to(cuda, w_dtype)
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    before = fused_ln.ln_matmul.launches
    got = fused_ln.ln_matmul(x, gamma, beta, w, bias, activation=act,
                             out_dtype=out_dtype)
    assert fused_ln.ln_matmul.launches == before + 1
    want = fused_ln.ln_matmul_plain(x, gamma, beta, w, bias, eps=1e-6,
                                    activation=act, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (m, n)
    scale = want.float().abs().max().item()
    exact = (x_dtype, w_dtype, out_dtype) == (torch.float32,) * 3
    atol = (1e-5 if exact else 2 ** -6) * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def test_ln_matmul_kernel_gradients_are_the_plain_vjp(cuda):
    rng = np.random.default_rng(7)
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda).requires_grad_()
            for a in (rng.normal(size=(2, 9, 64)), rng.normal(1, .1, 64),
                      rng.normal(0, .1, 64), rng.normal(size=(64, 48)) / 8,
                      rng.normal(size=48))]
    fused_ln.ln_matmul(*args, activation="gelu").square().sum().backward()
    got = [a.grad.clone() for a in args]
    for a in args:
        a.grad = None
    fused_ln.ln_matmul_plain(args[0].reshape(-1, 64), *args[1:], eps=1e-6,
                             activation="gelu", out_dtype=torch.float32) \
        .square().sum().backward()
    for g, a in zip(got, args):
        torch.testing.assert_close(g, a.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,q", [(517, 40), (4096, 5)])
def test_int8_device_query_matches_cpu(cuda, n, q):
    rng = np.random.default_rng(n)
    embs = rng.standard_normal((n, 64)).astype(np.float32)
    queries = rng.standard_normal((q, 64)).astype(np.float32)
    ids = [str(i) for i in range(n)]
    answers = []
    for device in (cuda, "cpu"):
        col = Collection("c", space="cosine", device=device,
                         device_quant="int8")
        col.upsert(ids, embs)
        assert n * q >= 1 << 14  # the device route
        answers.append(col.query(queries, n_results=10,
                                 include=("distances",)))
    got, want = answers
    for gi, gd, wi, wd in zip(got["ids"], got["distances"], want["ids"],
                              want["distances"]):
        np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-3)
        for i in set(gi) ^ set(wi):
            d = gd[gi.index(i)] if i in gi else wd[wi.index(i)]
            assert abs(d - wd[-1]) <= 1e-3


def test_int8_dot_pads_to_int_mm_shapes(cuda):
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.integers(-127, 128, (3, 20), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (13, 20), dtype=np.int8))
    got = topk._int8_dot(a.to(cuda), b.to(cuda)).cpu()
    torch.testing.assert_close(got, topk._int8_dot(a, b), rtol=0, atol=0)
