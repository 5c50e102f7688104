"""The port's CUDA kernels and engine on a card, against their plain
PyTorch versions. Every test carries the ``cuda`` marker and skips where
there is no card. This file imports no JAX (the card's machine has none),
so it also runs there without the JAX test harness:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances. f32: the kernels and the plain versions sum the same products
in other orders, ~1e-6 on outputs of order 1. bf16 patch embed: one bf16
rounding of outputs < 8 (2^-5). bf16 attention, against the bf16 plain
version of the same inputs (the JAX package's bf16 attention: S, S *
bf16(scale), + bf16(bias) and P each rounded to bf16): the two sum q k^T
and P V in other orders (P itself takes the same arithmetic, see
tests/test_torch_softmax_p.py), so an output falls apart by one bf16 ulp
(below 1e-2 for outputs under 2; 2^-8 max|v| where averages of few values
are not small), held tie-aware by chip_smoke.py's bf16_tie_check: a row
beyond the bound passes only where rounding near ties (an exact q k^T or
P V within an f32 sum's rounding error of a bf16 midpoint) the other way
brings the whole row within it (F10). Fused LN + projection: f32 1e-5
relative to the output's scale; with bf16 weights or output 2^-6 of it
(a bf16 rounding of the LN output or the result can fall apart between
two summation orders). The int8 store query: exact integer scores on
both devices; the L2 normalisation before quantizing may differ by an
ulp, which moves a score by at most ~1e-4 (tie-aware ids, distances to
1e-3).
"""

import dataclasses
import functools
import importlib.util
import os

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
from vit_research_tpu_torch.ops.tome import merged_token_counts
from vit_research_tpu_torch.parallel import embed
from vit_research_tpu_torch.store.vector_store import Collection
from vit_research_tpu_torch.utils.configs import ViTConfig

pytestmark = pytest.mark.cuda

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    ((2, 40, 72, 3), 16, 48), ((3, 32, 32, 3), 8, 32),
    # 588 rows (not a multiple of the 128-row tile), D = 200 and 48 (not
    # multiples of the 128-column tile), K = 3072 (P = 32)
    ((3, 224, 224, 3), 16, 200), ((1, 64, 96, 3), 32, 48)])
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


def _attention_inputs(b, h, t, dh, dtype, layout, device, seed):
    """q, k, v as (B, H, T, dh): contiguous, or the (B, H, T, dh) views of
    (B, T, H, dh) tensors that the backbone's projections give."""
    g = torch.Generator().manual_seed(seed)
    shape = (b, h, t, dh) if layout == "contiguous" else (b, t, h, dh)
    xs = [torch.randn(*shape, generator=g).to(device, dtype)
          for _ in range(3)]
    return xs if layout == "contiguous" else [x.transpose(1, 2) for x in xs]


def _plain(q, k, v, dtype, **kw):
    """The kernel's reference in ``dtype``: the plain version on the same
    values in that dtype (bf16: the JAX package's bf16 attention)."""
    return attn.attention_plain(*(x.to(dtype) for x in (q, k, v)), **kw)


@functools.cache
def _smoke():
    """chip_smoke.py as a module (it imports no JAX): the tie-aware bf16
    check."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_ties(got, q, k, v, atol, **kw):
    """The bf16 kernel output ``got`` against the bf16 plain version of
    (q, k, v, key_bias, scale) within ``atol``, tie-aware
    (chip_smoke.bf16_tie_check); the check's result."""
    return _smoke().bf16_tie_check(got, q, k, v, kw.get("key_bias"),
                                   bound=atol, scale=kw.get("scale"))


def _assert_close(got, q, k, v, dtype, atol, **kw):
    """f32: within ``atol`` of the plain version; bf16: tie-aware."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, _plain(q, k, v, dtype, **kw),
                                   rtol=0, atol=atol)
    else:
        res = _bf16_ties(got, q, k, v, atol, **kw)
        assert res["ok"], (res["err"], res["rejected"])


def _f32_scores(q, k, v, key_bias=None):
    """bf16 attention with f32 scores (the bf16 kernel's semantics before
    it rounded S): S of the bf16 values in f32, P and the output rounded to
    bf16. The bf16 checks must tell it from the bf16 plain version."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if key_bias is not None:
        s = s + key_bias[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(torch.bfloat16)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(),
                        v.float()).to(torch.bfloat16)


@pytest.mark.parametrize("t", [1, 16, 17, 63, 64, 65, 197, 325, 1297])
@pytest.mark.parametrize("dh", [16, 32, 64])
@pytest.mark.parametrize("layout", ["contiguous", "projection_order"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(cuda, t, dh, layout, dtype):
    q, k, v = _attention_inputs(2, 12, t, dh, dtype, layout, cuda, t + dh)
    before = attn.multi_head_attention.launches
    got = attn.multi_head_attention(q, k, v)
    assert attn.multi_head_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, 12, t, dh)
    # written in projection order: (B, T, H, dh) contiguous underneath
    assert got.transpose(1, 2).is_contiguous()
    atol = 1e-5 if dtype == torch.float32 else 1e-2
    _assert_close(got, q, k, v, dtype, atol)


@pytest.mark.parametrize("scale", [-0.3, 0.0, 2.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_takes_any_scale(cuda, scale, dtype):
    q, k, v = _attention_inputs(2, 3, 65, 32, dtype, "projection_order",
                                cuda, 5)
    got = attn.multi_head_attention(q, k, v, scale=scale)
    # bf16: the scale rounded to bf16 on both sides (-0.3 -> -0.30078125)
    atol = 1e-5 if dtype == torch.float32 else 1e-2
    _assert_close(got, q, k, v, dtype, atol, scale=scale)


def test_attention_kernel_takes_a_transposed_view(cuda):
    # (B, T, H, dh) storage seen as (B, H, T, dh), as the backbone passes it
    q = torch.randn(1, 8, 2, 64, device=cuda).transpose(1, 2)
    got = attn.multi_head_attention(q, q, q)
    torch.testing.assert_close(got, attn.attention_plain(q, q, q), rtol=0,
                               atol=1e-5)


def test_kernels_refuse_what_they_do_not_take(cuda):
    # every width up to 192 is taken (dh = 128 natively since F4's
    # repair, others zero-padded); a wider one is not
    q = torch.zeros(1, 2, 8, 256, device=cuda)
    with pytest.raises(ValueError, match="head_dim up to 192"):
        attn.multi_head_attention(q, q, q)
    q = torch.zeros(1, 2, 64, 8, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="stride 1 on its last dim"):
        attn.multi_head_attention(q, q, q)
    q = torch.zeros(1 * 2 * 8 * 64 + 1, device=cuda)[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attn.multi_head_attention(q, q, q)
    before = attn.multi_head_attention.launches
    q = torch.zeros(1, 2, 8, 66, device=cuda)[..., :64]  # 264-byte rows
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        attn.multi_head_attention(q, q, q)
    assert attn.multi_head_attention.launches == before
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
                                   (1, 40, 3072), (588, 3072, 48),
                                   (588, 768, 200)])
@pytest.mark.parametrize("act", [None, "gelu", "gelu_tanh"])
@pytest.mark.parametrize("x_dtype,w_dtype,out_dtype", [
    (torch.float32, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.bfloat16)])
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
    # bf16 x converts exactly: f32 W and out keep the f32 bound
    exact = (w_dtype, out_dtype) == (torch.float32,) * 2
    atol = (1e-5 if exact else 2 ** -6) * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernels_choose_their_own_precision(cuda, out_dtype):
    """A and C split their operands for the tensor cores themselves: the
    results do not depend on torch's TF32 switch."""
    rng = np.random.default_rng(11)
    images = torch.from_numpy(rng.integers(0, 256, size=(2, 224, 224, 3),
                                           dtype=np.uint8)).to(cuda)
    w_pe = torch.from_numpy((rng.standard_normal((768, 768)) / 28).astype(
        np.float32)).to(cuda)
    x = torch.from_numpy(rng.normal(size=(394, 768)).astype(np.float32)) \
        .to(cuda)
    gamma, beta = (torch.from_numpy(rng.normal(mu, 0.1, size=768).astype(
        np.float32)).to(cuda) for mu in (1.0, 0.0))
    w_ln = torch.from_numpy((rng.normal(size=(768, 3072)) / 28).astype(
        np.float32)).to(cuda)
    bias = torch.zeros(3072, device=cuda)
    results = []
    flag = torch.backends.cuda.matmul.allow_tf32
    try:
        for allow in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = allow
            results.append((
                pe.fused_patch_embed(images, w_pe, bias[:768], patch_size=16,
                                     out_dtype=out_dtype, **HF_AFFINE),
                fused_ln.ln_matmul(x, gamma, beta, w_ln, bias,
                                   activation="gelu", out_dtype=out_dtype)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    for off, on in zip(*results):
        assert torch.equal(off, on)


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


def _session_world(seed=0, d=64, n_corpus=600, noise=0.4):
    """A labelled corpus around three class centres and a game of
    possessions drawn the same way, with an ambiguous stretch."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, d)).astype(np.float32) * 2.0
    labels = np.repeat(np.arange(3), n_corpus // 3)
    corpus = centers[labels] + noise * rng.standard_normal((len(labels), d))
    probs = np.full((len(labels), 3), 0.05, np.float32)
    probs[np.arange(len(labels)), labels] = 0.9
    sides = np.repeat([2, 0, 2, 1, 2, 0, 2], [40, 200, 40, 180, 30, 150, 60])
    frames = centers[sides] + noise * rng.standard_normal((len(sides), d))
    frames[470:500] = (centers[1] + centers[2]) / 2  # near the 2/1 line
    return ({"embeddings": corpus.astype(np.float32), "labels": labels,
             "probs": probs}, frames.astype(np.float32),
            [f"vid4_frame_{i + 1}.jpg" for i in range(len(sides))])


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_stream_session_on_card_matches_cpu(cuda, metric):
    """The live session ranks on the card; its clips, forced commits and
    write-backs equal the CPU session's (no near-ties in this world)."""
    from vit_research_tpu_torch.segment.pipeline import KnnHmmStreamSession

    corpus, frames, names = _session_world()
    runs = []
    for device in (cuda, "cpu"):
        col = Collection("c", space=metric, device=device)
        s = KnnHmmStreamSession(corpus, device=device, k=25, min_len=60,
                                pad=10, max_lag=24, drain_every=8,
                                collection=col, vid=4, metric=metric)
        clips, i, j = [], 0, 0
        while i < len(frames):  # ragged pushes
            n = (37, 64, 128, 1)[j % 4]
            clips += s.push_batch(names[i:i + n], frames[i:i + n])
            i, j = i + n, j + 1
        clips += s.finish()
        runs.append((clips, s.forced, col.get(limit=10 ** 6)))
    (got, g_forced, g_col), (want, w_forced, w_col) = runs
    assert got == want and len(got) == 3
    assert g_forced == w_forced
    assert g_col["ids"] == w_col["ids"] and len(g_col["ids"]) > 400
    assert g_col["metadatas"] == w_col["metadatas"]


def test_coalescer_on_card(cuda):
    """Concurrent requests merge into one ragged engine batch on the card;
    each request's rows match the CPU engine within 1e-4, and the kernels
    launch once (A) and once per layer (B) per engine batch."""
    import threading

    from vit_research_tpu_torch.serve import EmbedServer

    model = init_vit(TINY, seed=0, device="cpu")
    spec = PreprocessSpec(size=(32, 32))
    host = embed.EmbeddingEngine(model, spec, device="cpu", batch_size=8)
    frames = np.random.default_rng(3).integers(0, 256, (6, 32, 32, 3),
                                               dtype=np.uint8)
    want = host.embed_batch(frames)
    eng = embed.EmbeddingEngine(init_vit(TINY, seed=0, device="cpu"), spec,
                                device=cuda, batch_size=8)
    eng.warmup()
    srv = EmbedServer(eng, coalesce_ms=300.0)
    before = (pe.fused_patch_embed.launches,
              attn.multi_head_attention.launches)
    out, threads = {}, []
    try:
        for i in range(3):
            threads.append(threading.Thread(target=lambda i=i: out.update(
                {i: srv._coalescer.embed(frames[2 * i:2 * i + 2])})))
            threads[-1].start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        batches = srv._coalescer.batches_run
        assert batches < 3  # merged
        assert (pe.fused_patch_embed.launches - before[0],
                attn.multi_head_attention.launches - before[1]) == \
            (batches, TINY.num_layers * batches)
        for i in range(3):
            np.testing.assert_allclose(out[i], want[2 * i:2 * i + 2],
                                       rtol=0, atol=1e-4)
    finally:
        srv.stop()


# ---- the labelling and clip-curation path (self-label, finalize,
# clustering, fresh-test, write-embeddings, the native decoder) ----------


def test_two_pass_self_label_on_card_matches_cpu(cuda):
    """Both passes rank on the card (the enlarged corpus is built there);
    labels, probabilities and pass-1 acceptance equal the CPU run's (no
    near-ties in this world)."""
    from vit_research_tpu_torch.segment.knn import two_pass_self_label

    corpus, frames, _ = _session_world(seed=1)
    runs = [two_pass_self_label(frames, corpus["embeddings"],
                                corpus["labels"], device=device, k=25,
                                min_votes=20)
            for device in (cuda, "cpu")]
    for g, w in zip(*runs):
        np.testing.assert_array_equal(g, w)
    assert runs[0][2].any() and (~runs[0][2]).any()


@pytest.mark.parametrize("t", [300, 8192])
def test_finalize_clip_routes_on_card(cuda, t):
    """Below 8192 frames the decode is the host's (equal to the CPU run),
    from there the log-depth scan on the card (equal on these votes)."""
    from vit_research_tpu_torch.segment import hmm
    from vit_research_tpu_torch.segment.clips import finalize_clip

    rng = np.random.default_rng(t)
    probs = rng.multinomial(5, [0.6, 0.2, 0.2], size=t) / 5
    got = finalize_clip(probs, "left", device=cuda)
    np.testing.assert_array_equal(got,
                                  finalize_clip(probs, "left", device="cpu"))
    assert (t >= hmm._PARALLEL_THRESHOLD) == (t == 8192)


def test_side_classifier_trains_on_card_like_cpu(cuda):
    from vit_research_tpu_torch.segment.clustering import (
        SideMLP, classify_sides, train_side_classifier)

    rng = np.random.default_rng(5)
    y = np.arange(192) % 3
    x = rng.normal(size=(192, 32)).astype(np.float32)
    x[:, :3] += 3.0 * np.eye(3, dtype=np.float32)[y]
    runs = []
    for device in (cuda, "cpu"):
        model, hist = train_side_classifier(x, y, num_epochs=3,
                                            batch_size=64, seed=0,
                                            device=device)
        assert isinstance(model, SideMLP)
        runs.append((model.to("cpu").state_dict(), hist,
                     classify_sides(model, x, device=device)))
    (g_sd, g_hist, g_pred), (w_sd, w_hist, w_pred) = runs
    for k in w_sd:
        torch.testing.assert_close(g_sd[k], w_sd[k], rtol=1e-4, atol=1e-5)
    for g, w in zip(g_hist, w_hist):
        assert abs(g["loss"] - w["loss"]) < 1e-4
    np.testing.assert_array_equal(g_pred, w_pred)


def _jpeg_game(root, n=24, size=(32, 32)):
    """``vid1_frame_{i}.jpg`` frames: left halves bright for the first
    half of the game, right halves for the rest."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(6)
    paths = []
    for i in range(1, n + 1):
        img = rng.integers(60, 120, size=(*size, 3)).astype(np.int32)
        half = slice(0, size[1] // 2) if i <= n // 2 else \
            slice(size[1] // 2, None)
        img[:, half] += 100
        p = os.path.join(root, f"vid1_frame_{i}.jpg")
        Image.fromarray(np.minimum(img, 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def test_engine_use_native_on_card_matches_cpu(cuda, tmp_path):
    from vit_research_tpu_torch import native

    if not native.is_available():
        pytest.skip(f"native decoder unavailable: "
                    f"{native.unavailable_reason()}")
    paths = _jpeg_game(str(tmp_path / "f"), n=11)
    spec = PreprocessSpec(size=(32, 32))
    runs = [embed.EmbeddingEngine(init_vit(TINY, seed=0, device="cpu"),
                                  spec, device=device, batch_size=4)
            .embed_paths(paths, use_native=True) for device in (cuda, "cpu")]
    np.testing.assert_allclose(runs[0], runs[1], rtol=0, atol=1e-5)


def test_curation_verbs_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """write-frame-db, self-label, finalize-clips, write-embeddings,
    clustering and fresh-test through the port's CLI with the tiny engine
    on the card, against the same verbs with --device cpu."""
    import contextlib
    import io
    import shutil

    from vit_research_tpu_torch import cli

    monkeypatch.setenv("VRT_TINY", "1")
    for key in ("VRT_TOME_R", "VRT_GEMM_QUANT", "VRT_GRAYSCALE"):
        monkeypatch.delenv(key, raising=False)
    frames = os.path.dirname(_jpeg_game(str(tmp_path / "frames"))[0])
    with open(tmp_path / "manual.csv", "w") as f:
        f.write("left_start,left_end,right_start,right_end,none_start,"
                "none_end\nvid1_1,vid1_12,vid1_13,vid1_24,,\n")
    clip = tmp_path / "clips" / "vid1_clip_1_left"
    clip.mkdir(parents=True)
    for i in range(1, 16):
        shutil.copy(os.path.join(frames, f"vid1_frame_{i}.jpg"), clip)
    outs = {}
    for device in ("cuda", "cpu"):
        d = tmp_path / device
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            for argv in (
                    ["write-frame-db", frames, "--manual-csv",
                     str(tmp_path / "manual.csv"), "--db", str(d / "db"),
                     "--collection", "c", "--batch-size", "8"],
                    ["self-label", frames, "--db", str(d / "db"),
                     "--collection", "c", "--out", str(d / "labels.csv"),
                     "--k", "5", "--min-votes", "5"],
                    ["finalize-clips", "--clips", str(tmp_path / "clips"),
                     "--db", str(d / "db"), "--collection", "c", "--out",
                     str(d / "fin")],
                    ["write-embeddings", frames, "--manual-csv",
                     str(tmp_path / "manual.csv"), "--out-template",
                     str(d / "{cls}.npz")],
                    ["clustering", "--db", str(d / "db"), "--collection",
                     "c", "--out", str(d / "side.npz"), "--epochs", "3",
                     "--batch-size", "8"],
                    ["fresh-test", frames, "--params", str(d / "side.npz"),
                     "--out", str(d / "fresh")]):
                cli.main(argv + ["--device", device])
        with open(d / "labels.csv") as f:
            labels_csv = f.read()
        with np.load(d / "left.npz") as z:
            left = z["embeddings"]
        outs[device] = dict(
            labels=labels_csv, left=left,
            fin=sorted(os.listdir(d / "fin" / "vid1_clip_1_left")),
            fresh={s: sorted(os.listdir(d / "fresh" / s))
                   for s in ("left", "right", "none")})
    got, want = outs["cuda"], outs["cpu"]
    assert got["labels"] == want["labels"]
    np.testing.assert_allclose(got["left"], want["left"], rtol=0, atol=1e-4)
    assert got["fin"] == want["fin"] and got["fin"]
    assert got["fresh"] == want["fresh"]


# ---------------------------------------------------------- fast profile


def _key_bias(b, t, seed):
    """A ToMe-like key bias: log of token sizes in [1, 8]."""
    g = torch.Generator().manual_seed(seed)
    return torch.log(torch.randint(1, 9, (b, t), generator=g).float())


@pytest.mark.parametrize("t", [21, 197, 325])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_with_key_bias_matches_plain(cuda, t, dh, dtype):
    q, k, v = _attention_inputs(3, 12, t, dh, dtype, "projection_order",
                                cuda, t + dh + 1)
    bias = _key_bias(3, t, t).to(cuda)
    before = attn.multi_head_attention.launches
    got = attn.multi_head_attention(q, k, v, key_bias=bias)
    assert attn.multi_head_attention.launches == before + 1
    want = _plain(q, k, v, dtype, key_bias=bias).float()
    atol = 1e-5 if dtype == torch.float32 else 1e-2
    _assert_close(got, q, k, v, dtype, atol, key_bias=bias)
    # the bias moves the result: the unbiased kernel is further off
    plain = attn.multi_head_attention(q, k, v)
    assert (plain.float() - want).abs().max() > 10 * atol
    # a row view with a batch stride (rows of a wider tensor)
    wide = torch.zeros(3, t + 5, device=cuda)
    wide[:, :t] = bias
    got = attn.multi_head_attention(q, k, v, key_bias=wide[:, :t])
    _assert_close(got, q, k, v, dtype, atol, key_bias=bias)


def test_attention_key_bias_refusals(cuda):
    q = torch.zeros(2, 3, 8, 64, device=cuda)
    before = attn.multi_head_attention.launches
    for bias, msg in ((torch.zeros(2, 7, device=cuda), r"\(B, T\)"),
                      (torch.zeros(2, 8, device=cuda, dtype=torch.float64),
                       "float32"),
                      (torch.zeros(2, 8), "is on cpu"),
                      (torch.zeros(8, 2, device=cuda).T, "stride 1"),
                      ([0.0] * 16, "tensor")):
        with pytest.raises(ValueError, match=msg):
            attn.multi_head_attention(q, q, q, key_bias=bias)
    assert attn.multi_head_attention.launches == before


@pytest.mark.parametrize("rows", [1, 5, 17])
def test_int8_gemm_pads_rows_for_int_mm(cuda, rows):
    from vit_research_tpu_torch.ops import quant

    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows, 768), np.float32))
    w = torch.from_numpy(rng.standard_normal((3072, 768), np.float32))
    want = quant.int8_dot_general(x, w)
    got = quant.int8_dot_general(x.to(cuda), w.to(cuda)).cpu()
    # the same int8 values and exact s32 products on both devices
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    static = quant.StaticInt8DotGeneral([0.02])
    want = static(x, w)
    static.reset()
    torch.testing.assert_close(static(x.to(cuda), w.to(cuda)).cpu(), want,
                               rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(tome_r=2), dict(gemm_quant="int8"),
                                dict(tome_r=4, gemm_quant="int8")])
def test_fast_profile_engine_on_card_matches_cpu(cuda, kw):
    """The tiny ToMe / int8 engine on the card (kernel B with the key
    bias, the int8 GEMMs on _int_mm) against the same weights on the CPU:
    equal token sizes, embeddings within 1e-5 (f32 ToMe) or a per-frame
    cosine of 0.9999 (int8: an ulp in a pre-GEMM activation can move one
    int8 value by one step)."""
    cfg = dataclasses.replace(TINY, **kw)
    frames = np.random.default_rng(3).integers(0, 256, size=(9, 32, 32, 3),
                                               dtype=np.uint8)
    spec = PreprocessSpec(size=(32, 32))
    host = embed.EmbeddingEngine(init_vit(cfg, seed=0, device="cpu"), spec,
                                 device="cpu", batch_size=4,
                                 endpoint="encoded_tokens",
                                 l2_normalize=False)
    card = embed.EmbeddingEngine(init_vit(cfg, seed=0, device="cpu"), spec,
                                 device=cuda, batch_size=4)
    before = attn.multi_head_attention.launches
    got = card.embed_batch(frames)
    assert attn.multi_head_attention.launches - before == 6  # 3 batches
    want = embed.EmbeddingEngine(host.model, spec, device="cpu",
                                 batch_size=4).embed_batch(frames)
    if "gemm_quant" in kw:
        assert np.sum(got * want, axis=1).min() >= 0.9999
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if "tome_r" in kw:
        t = merged_token_counts(17, kw["tome_r"], 2)[-1]
        sizes = card.model.encode_patch_tokens(
            torch.zeros(2, 16, 32, device=cuda), (4, 4))["token_sizes"]
        assert sizes.shape == (2, t) and host.out_trailing == (t, 32)
        assert torch.all(sizes.sum(dim=1) == 17)


# ---- stage 1: kernel B at dh = 96, the kernels' gradients, train-stage1


@pytest.mark.parametrize("t", [9, 25, 197])
@pytest.mark.parametrize("layout", ["contiguous", "projection_order"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_kernel_dh96_matches_plain(cuda, t, layout, dtype,
                                             with_bias):
    """The stage-1 chunk encoder's head width (768 / 8 heads). bf16,
    against the bf16 plain version: an output that falls apart by one ulp
    (2^-8 of |o| <= max|v|; averages of 9 values are not small)."""
    q, k, v = _attention_inputs(4, 8, t, 96, dtype, layout, cuda, t + 96)
    bias = _key_bias(4, t, t).to(cuda) if with_bias else None
    before = attn.multi_head_attention.launches
    got = attn.multi_head_attention(q, k, v, key_bias=bias)
    assert attn.multi_head_attention.launches == before + 1
    atol = 1e-5 if dtype == torch.float32 else \
        2 ** -8 * v.float().abs().max().item()
    _assert_close(got, q, k, v, dtype, atol, key_bias=bias)


@pytest.mark.parametrize("dh,t", [(64, 197), (96, 9), (96, 25), (192, 5),
                                  (192, 130), (96, 129), (64, 1297)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_grads_on_card(cuda, dh, t, dtype):
    """A CUDA input that requires grad launches the kernel once and gets
    an output with a grad_fn; the q/k/v and key-bias gradients are
    torch.autograd's of the plain version (the Function's backward is
    that VJP at the same inputs: equal to rounding)."""
    g = torch.Generator(device=cuda).manual_seed(dh + t)
    leaves = [torch.randn(2, 8, t, dh, generator=g, device=cuda).to(dtype)
              .requires_grad_(True) for _ in range(3)]
    bias = torch.randn(2, t, generator=g, device=cuda).requires_grad_(True)
    gout = torch.randn(2, 8, t, dh, generator=g, device=cuda).to(dtype)
    before = attn.multi_head_attention.launches
    got = attn.multi_head_attention(*leaves, key_bias=bias)
    assert attn.multi_head_attention.launches == before + 1
    assert got.grad_fn is not None
    grads = torch.autograd.grad(got, [*leaves, bias], gout)
    ref = [x.detach().clone().requires_grad_(True) for x in (*leaves, bias)]
    want = torch.autograd.grad(
        attn.attention_plain(*ref[:3], key_bias=ref[3]), ref, gout)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    for x, y in zip(grads, want):
        assert x is not None
        scale = y.float().abs().max().item()
        torch.testing.assert_close(x.float(), y.float(), rtol=0,
                                   atol=tol * scale)


def test_patch_embed_function_grads_on_card(cuda):
    """w and bias gradients through kernel A's Function equal
    torch.autograd's of the plain patch embed (uint8 images take none)."""
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (3, 224, 224, 3),
                                           dtype=np.uint8)).to(cuda)
    w = (torch.randn(768, 768, device=cuda) / 768 ** 0.5).requires_grad_(True)
    bias = torch.randn(768, device=cuda).requires_grad_(True)
    before = pe.fused_patch_embed.launches
    got = pe.fused_patch_embed(images, w, bias, patch_size=16, **HF_AFFINE)
    assert pe.fused_patch_embed.launches == before + 1
    assert got.grad_fn is not None
    gout = torch.randn_like(got)
    grads = torch.autograd.grad(got, [w, bias], gout)
    a_vec, b_vec = (torch.from_numpy(x).to(cuda)
                    for x in pe.fold_affine(16, 3, **HF_AFFINE))
    ref = [x.detach().clone().requires_grad_(True) for x in (w, bias)]
    want = torch.autograd.grad(
        pe.patch_embed_plain(images, *ref, a_vec, b_vec, patch_size=16),
        ref, gout.reshape(-1, 768))
    for x, y in zip(grads, want):
        torch.testing.assert_close(x, y, rtol=0,
                                   atol=1e-5 * y.abs().max().item())


def test_train_stage1_and_write_ratt_db_on_card(cuda, tmp_path, capsys):
    """train-stage1 --device cuda for one epoch on a small full-width store
    (768 wide: kernel B at dh = 96 in every validation batch), then
    write-ratt-db --device cuda; the rows equal the CPU forward of the
    restored encoder within 1e-4."""
    from vit_research_tpu_torch import cli
    from vit_research_tpu_torch.db.frame_store import (
        FrameStore, build_chunk_index, gather_chunk_embedding_batch,
        load_chunk_index)
    from vit_research_tpu_torch.models.heads import ChunkEncoder
    from vit_research_tpu_torch.store.vector_store import PersistentClient
    from vit_research_tpu_torch.train.checkpoint import CheckpointManager
    from vit_research_tpu_torch.train.train_chunk_encoder import (
        make_encode_fn)
    from vit_research_tpu_torch.utils.configs import ChunkEncoderConfig

    rng = np.random.default_rng(6)
    paths, chunks = [], []
    for clip in range(4):
        frames = [f"/c{clip}/f{i}.jpg" for i in range(24)]
        paths += frames
        for s in range(0, 17, 2):
            chunks.append(dict(vid=1 + clip % 2, clip=clip, start_idx=s,
                               end_idx=s + 7, side="left", label=clip % 2,
                               status_id=0, t_center=s / 24, t_width=0.2,
                               frames=frames[s:s + 8]))
    embs = rng.standard_normal((len(paths), 768)).astype(np.float32)
    root = str(tmp_path / "store")
    store = FrameStore.build(paths, lambda ps: embs[[paths.index(p)
                                                     for p in ps]], root)
    build_chunk_index(chunks, store, root)
    n = len(chunks)
    n_val = n - int(n * 0.8)
    ck, db = str(tmp_path / "ckpt"), str(tmp_path / "db")
    before = attn.multi_head_attention.launches
    cli.main(["train-stage1", "--store", root, "--ckpt", ck, "--epochs",
              "1", "--batch-size", "8", "--run-id", "s1", "--device",
              "cuda"])
    assert attn.multi_head_attention.launches - before == \
        3 * -(-n_val // 8)
    cli.main(["write-ratt-db", "--store", root, "--ckpt", ck, "--db", db,
              "--run-id", "s1", "--device", "cuda"])
    assert f"wrote {n} chunk embeddings" in capsys.readouterr().out
    got = PersistentClient(db, device="cpu").get_collection("ratt_db").get(
        ids=[f"chunk_{i}" for i in range(n)], include=("embeddings",))
    encode = make_encode_fn(ChunkEncoder(ChunkEncoderConfig(max_len=8)),
                            CheckpointManager(ck, "s1").restore_best()
                            ["params"])
    want, _ = encode(gather_chunk_embedding_batch(
        FrameStore(root).open(), load_chunk_index(root), np.arange(n)))
    want = want / (np.linalg.norm(want, axis=1, keepdims=True) + 1e-8)
    np.testing.assert_allclose(np.asarray(got["embeddings"]), want, rtol=0,
                               atol=1e-4)


# ---- the retrieval heads: kernel B at dh = 192, train-rag


@pytest.mark.parametrize("b,t", [(8, 5), (256, 5), (4, 65), (4, 130)])
@pytest.mark.parametrize("layout", ["contiguous", "projection_order"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_kernel_dh192_matches_plain(cuda, b, t, layout, dtype,
                                              with_bias):
    """The RAG/RATT heads' head width (768 / 4 heads) at their T = 5 and
    at T = 65 and 130 (a full key tile and a partial one; f32 streams the
    second and third tile through its one K/V buffer). Tolerances as at
    dh = 96."""
    q, k, v = _attention_inputs(b, 4, t, 192, dtype, layout, cuda, t + 192)
    bias = _key_bias(b, t, t).to(cuda) if with_bias else None
    before = attn.multi_head_attention.launches
    got = attn.multi_head_attention(q, k, v, key_bias=bias)
    assert attn.multi_head_attention.launches == before + 1
    assert got.transpose(1, 2).is_contiguous()
    atol = 1e-5 if dtype == torch.float32 else \
        2 ** -8 * v.float().abs().max().item()
    _assert_close(got, q, k, v, dtype, atol, key_bias=bias)


@pytest.mark.parametrize("b,h,t,dh,qk", [
    (256, 12, 197, 64, 1.0),  # the backbone (ViT-B/16 @224)
    (8, 4, 5, 192, 2.0), (256, 4, 5, 192, 2.0),  # RAGHead
    (8, 4, 21, 192, 2.0),  # RATTHead / RATTHeadV2
    (32, 8, 9, 96, 2.0), (256, 8, 9, 96, 2.0),  # the chunk encoder
    (128, 12, 325, 64, 1.0)])  # the held variant past 197 keys
@pytest.mark.parametrize("with_bias", [False, True])
def test_bf16_attention_tells_f32_scores_apart(cuda, b, h, t, dh, qk,
                                               with_bias):
    """At the backbone's shape and at the heads' shapes with the scores of
    trained heads (q and k scaled: max|S| >= 10), the bf16 kernel passes
    the tie-aware check against the bf16 plain version and the f32-score
    semantics fails it: the check sees the difference that rounding S
    makes (a score's bf16 rounding moves its probability by up to 2^-9
    |S|), at every score and not only at near ties."""
    q, k, v = _attention_inputs(b, h, t, dh, torch.float32,
                                "projection_order", cuda, b + t + dh)
    q, k, v = (x.to(torch.bfloat16) for x in (q * qk, k * qk, v))
    bias = _key_bias(b, t, t + 1).to(cuda) if with_bias else None
    got = attn.multi_head_attention(q, k, v, key_bias=bias)
    old = _f32_scores(q, k, v, bias)
    atol = 1e-2 if dh == 64 else 2 ** -8 * v.float().abs().max().item()
    if dh != 64:
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        assert s.abs().max() * dh ** -0.5 >= 10
    res = _bf16_ties(got, q, k, v, atol, key_bias=bias)
    assert res["ok"], (res["err"], res["rejected"])
    res = _bf16_ties(old, q, k, v, atol, key_bias=bias)
    assert res["err"] > atol and not res["ok"]


def test_tie_check_self_check_on_the_card(cuda):
    """The tie check's self-check on a backbone-shaped draw (B = 256, H =
    12, T = 197, dh = 64, bf16, projection order, ToMe-like key bias):
    cuBLAS's bf16 q k^T, as attention_plain computes it, equals S* (the
    exact f64 sum correctly rounded) off the near-tie set and lies in its
    range on it, and the kernel passes the check."""
    smoke = _smoke()
    q, k, v = _attention_inputs(256, 12, 197, 64, torch.bfloat16,
                                "projection_order", cuda, 17)
    bias = _key_bias(256, 197, 18).to(cuda)
    raw = torch.einsum("bhqd,bhkd->bhqk", q.contiguous(),
                       k.contiguous()).double()
    near = 0
    for b0 in range(0, 256, 32):
        ex = smoke.exact_scores(q[b0:b0 + 32], k[b0:b0 + 32])
        part = raw[b0:b0 + 32]
        assert torch.equal(part[~ex["near"]], ex["s"][~ex["near"]])
        assert ((ex["lo"] <= part) & (part <= ex["hi"])).all()
        near += int(ex["near"].sum())
    got = attn.multi_head_attention(q, k, v, key_bias=bias)
    res = _bf16_ties(got, q, k, v, 1e-2, key_bias=bias)
    assert res["ok"], (res["err"], res["rejected"])
    assert res["near_ties"] == near > 0
    assert res["n_scores"] == 256 * 12 * 197 * 197


# ---- bf16 past one key tile: the held variant and the two-pass kernel


def _held_limit(dh, bias):
    return 64 * attn.held_max_tiles(attn.kernel_head_dim(dh), bias)


def _t_of(t, dh, bias):
    return {"limit": _held_limit(dh, bias),
            "limit+1": _held_limit(dh, bias) + 1}.get(t, t)


@pytest.mark.parametrize("t", [65, 128, 129, 149, 197, 325, "limit",
                               "limit+1", 1297])
@pytest.mark.parametrize("dh", [64, 96, 128, 192, 80, 48])
@pytest.mark.parametrize("with_bias", [False, True])
def test_bf16_held_and_two_pass_match_plain(cuda, t, dh, with_bias):
    """bf16 past one key tile on projection-order views: the held variant
    up to its limit, the two-pass kernel one key past it and at T = 1297,
    each counted under its own name, against the bf16 plain version
    within the existing bounds (1e-2 at dh = 64; 2^-8 max|v| at the other
    widths, as their tests), tie-aware."""
    t = _t_of(t, dh, with_bias)
    width = attn.kernel_head_dim(dh)
    q, k, v = _attention_inputs(2, 4, t, dh, torch.bfloat16,
                                "projection_order", cuda, t + dh)
    bias = _key_bias(2, t, t).to(cuda) if with_bias else None
    name = attn.kernel_name(torch.bfloat16, t, width, with_bias)
    assert name.endswith("/held" if t <= _held_limit(dh, with_bias)
                         else "/2pass")
    before = attn.multi_head_attention.launches_by_kernel[name]
    got = attn.multi_head_attention(q, k, v, key_bias=bias)
    assert attn.multi_head_attention.launches_by_kernel[name] == before + 1
    assert got.shape == (2, 4, t, dh)
    atol = 1e-2 if dh == 64 else 2 ** -8 * v.float().abs().max().item()
    _assert_close(got, q, k, v, torch.bfloat16, atol, key_bias=bias)


@pytest.mark.parametrize("t", [65, 197, "limit"])
@pytest.mark.parametrize("dh", [64, 96, 128, 192])
@pytest.mark.parametrize("with_bias", [False, True])
def test_bf16_held_equals_two_pass(cuda, t, dh, with_bias):
    """The held variant against the two-pass kernel on the same inputs:
    the two-pass kernel runs them with keys appended up to one past the
    held limit, each with a key bias of -1e4 (bf16 -9984: exp 0 in f32, so
    the rows' max, sums and P are those of the T live keys; a bias of 0
    adds exactly 0 to a bf16 score). The held variant takes the two-pass
    kernel's arithmetic in its order (the same S, online max and sum, P
    and P V), so the two are equal to the bit."""
    t = _t_of(t, dh, with_bias)
    pad = _held_limit(dh, with_bias) + 1
    q, k, v = _attention_inputs(2, 4, pad, dh, torch.bfloat16,
                                "projection_order", cuda, t + 2 * dh)
    bias = _key_bias(2, t, t).to(cuda) if with_bias else None
    held = attn.multi_head_attention(q[:, :, :t], k[:, :, :t], v[:, :, :t],
                                     key_bias=bias).float()
    masked = torch.full((2, pad), -1e4, device=cuda)
    masked[:, :t] = bias if with_bias else 0.0
    before = attn.multi_head_attention.launches_by_kernel.copy()
    two = attn.multi_head_attention(q, k, v, key_bias=masked)
    assert attn.multi_head_attention.launches_by_kernel - before == \
        {attn.kernel_name(torch.bfloat16, pad, dh, True): 1}
    assert torch.equal(held, two[:, :, :t].float())


@pytest.mark.parametrize("case", ["last_dim", "misaligned", "token_stride",
                                  "k_dtype", "k_device", "bias_shape"])
def test_bf16_held_shape_refusals(cuda, case):
    """At a held shape (B = 2, T = 197, dh = 64, bf16) every layout the
    wrapper refused before still raises, and nothing launches."""
    q, k, v = _attention_inputs(2, 4, 197, 64, torch.bfloat16,
                                "projection_order", cuda, 3)
    bias = None
    if case == "last_dim":
        q = torch.zeros(2, 4, 64, 197, dtype=torch.bfloat16,
                        device=cuda).transpose(2, 3)
        match = "stride 1 on its last dim"
    elif case == "misaligned":
        n = 2 * 4 * 197 * 64
        q = torch.zeros(n + 1, dtype=torch.bfloat16,
                        device=cuda)[1:].view(2, 4, 197, 64)
        match = "16-byte aligned"
    elif case == "token_stride":
        q = torch.zeros(2, 4, 197, 66, dtype=torch.bfloat16,
                        device=cuda)[..., :64]
        match = "multiples of 16 bytes"
    elif case == "k_dtype":
        k = k.float()
        match = "k is torch.float32"
    elif case == "k_device":
        k = k.cpu()
        match = "k is torch.bfloat16 on cpu"
    else:
        bias = torch.zeros(2, 196, device=cuda)
        match = r"\(B, T\)"
    before = attn.multi_head_attention.launches
    with pytest.raises(ValueError, match=match):
        attn.multi_head_attention(q, k, v, key_bias=bias)
    assert attn.multi_head_attention.launches == before


@pytest.mark.parametrize("kind,dh", [("chunk", 96), ("rag", 192)])
def test_bf16_attention_on_the_heads_inputs(cuda, kind, dh, monkeypatch):
    """Kernel B on the q/k/v that the bf16 ChunkEncoder
    (ChunkEncoderConfig(): 768 wide, 8 heads) and RAGHead (HeadConfig():
    4 heads) hand it, their query and key weights doubled so that max|S|
    >= 10, the scale of trained heads: each call within 2^-8 max|v| of
    the bf16 plain version (tie-aware), and the f32-score semantics failing
    that check in at least one call."""
    from vit_research_tpu_torch.models import heads
    from vit_research_tpu_torch.utils.configs import (ChunkEncoderConfig,
                                                      HeadConfig)

    g = torch.Generator().manual_seed(dh)
    if kind == "chunk":
        model = heads.ChunkEncoder(ChunkEncoderConfig(dtype="bfloat16"),
                                   generator=g)
        inputs = [torch.randn(32, 8, 768, generator=g)]
    else:
        model = heads.RAGHead(HeadConfig(dtype="bfloat16"), generator=g)
        inputs = [torch.randn(8, 768, generator=g),
                  torch.randn(8, 10, 768, generator=g)]
    with torch.no_grad():
        for block in model.blocks:
            block.attn.query.weight *= 2
            block.attn.key.weight *= 2
    model = model.to(cuda).eval()
    calls = []
    launch = attn._launch

    def recording(q, k, v, scale, key_bias):
        out = launch(q, k, v, scale, key_bias)
        calls.append((q, k, v, key_bias, out))
        return out

    monkeypatch.setattr(attn, "_launch", recording)
    with torch.no_grad():
        model(*(x.to(cuda) for x in inputs))
    assert len(calls) == len(model.blocks)
    olds = []
    for q, k, v, bias, out in calls:
        assert q.dtype == torch.bfloat16 and q.shape[-1] == dh
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        assert s.abs().max() * dh ** -0.5 >= 10
        atol = 2 ** -8 * v.float().abs().max().item()
        res = _bf16_ties(out, q, k, v, atol, key_bias=bias)
        assert res["ok"], (res["err"], res["rejected"])
        olds.append(_bf16_ties(_f32_scores(q, k, v, bias), q, k, v, atol,
                               key_bias=bias)["ok"])
    assert not all(olds)


def test_rag_head_on_card_matches_cpu(cuda):
    """RAGHead at HeadConfig()'s full width (768, 2 layers, 4 heads:
    kernel B at dh = 192, T = 5) on the card against the CPU plain
    forward of the same weights, in eval and in a dropout-0 training
    step's gradients (through B's Function)."""
    from vit_research_tpu_torch.models.heads import RAGHead
    from vit_research_tpu_torch.utils.configs import HeadConfig

    cfg = HeadConfig(classifier_dropout=0.0)
    host = RAGHead(cfg, generator=torch.Generator().manual_seed(0))
    card = RAGHead(cfg).to(cuda)
    card.load_state_dict(host.state_dict())
    g = torch.Generator().manual_seed(1)
    cls = torch.randn(8, 768, generator=g)
    ret = torch.randn(8, 5, 768, generator=g)
    host.eval()
    card.eval()
    before = attn.multi_head_attention.launches
    with torch.no_grad():
        got = card(cls.to(cuda), ret.to(cuda))
    assert attn.multi_head_attention.launches == before + 2
    want = host(cls, ret)
    for x, y in zip(got, want):
        torch.testing.assert_close(x.cpu(), y, rtol=0, atol=1e-4)
    card.train()
    host.train()
    grads = []
    for model, dev in ((card, cuda), (host, torch.device("cpu"))):
        logits, _ = model(cls.to(dev), ret.to(dev))
        grads.append(torch.autograd.grad(logits.sum(),
                                         list(model.parameters())))
    for x, y in zip(*grads):
        scale = y.abs().max().item()
        torch.testing.assert_close(x.cpu(), y, rtol=0,
                                   atol=1e-4 * max(scale, 1e-3))


def test_ratt_v2_and_live_scorer_on_card_match_cpu(cuda, tmp_path):
    """RATTHeadV2 at HeadConfig()'s full width (768, 2 layers, 4 heads, k
    = 6/6/4: T = 21, plain attention, so no launch) on the card against
    the CPU; then a LiveEventScorer of one stage-1 and one stage-2 run on
    the card against the same runs on the CPU: one encoder batch a clip
    (kernel B at dh = 96, 3 launches), the same rows within 1e-4."""
    from vit_research_tpu_torch.evaluate import scoring
    from vit_research_tpu_torch.models.heads import ChunkEncoder
    from vit_research_tpu_torch.models.ratt_v2 import RATTHeadV2
    from vit_research_tpu_torch.train.checkpoint import CheckpointManager
    from vit_research_tpu_torch.utils.configs import (ChunkEncoderConfig,
                                                      HeadConfig)

    cfg = HeadConfig(classifier_dropout=0.0)
    host = RATTHeadV2(cfg, generator=torch.Generator().manual_seed(0))
    card = RATTHeadV2(cfg).to(cuda)
    card.load_state_dict(host.state_dict())
    g = torch.Generator().manual_seed(1)
    x = [torch.randn(8, *s, 768, generator=g) for s in ((), (6,), (6,),
                                                        (4,))]
    before = attn.multi_head_attention.launches
    with torch.no_grad():
        got = card.eval()(*(t.to(cuda) for t in x))
        want = host.eval()(*x)
    assert attn.multi_head_attention.launches == before
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-4)
    for a, b in zip(got[2]["attn_scores"], want[2]["attn_scores"]):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)

    ck = str(tmp_path / "ck")
    encoder = ChunkEncoder(ChunkEncoderConfig(max_len=8),
                           generator=torch.Generator().manual_seed(2))
    for run, sd in (("s1", encoder.state_dict()), ("s2", host.state_dict())):
        mngr = CheckpointManager(ck, run)
        mngr.save(0, {"params": sd, "step": 0})
        mngr.maybe_update_best(0, 1.0)
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((300, 768)).astype(np.float32)
    table = {f"vid1_frame_{i}.jpg": rng.standard_normal(768).astype(
        np.float32) for i in range(1, 41)}
    rows_out = {}
    for dev in ("cuda", "cpu"):
        col = Collection("ratt_db", space="cosine", device=dev)
        col.upsert([f"r{i}" for i in range(300)], rows, [
            {"vid_num": 7, "clip_num": i // 30, "side": "left" if i % 2
             else "right", "label": i % 3 % 2, "t_center": (i % 30) / 30,
             "t_width": 0.1, "start_idx": i % 30, "end_idx": i % 30 + 7}
            for i in range(300)])
        scorer = scoring.make_live_scorer(
            lambda ps: np.stack([table[os.path.basename(p)] for p in ps]),
            dim=768, ckpt=ck, stage1_run_id="s1", stage2_run_id="s2",
            collection=col, chunk_size=8, chunk_stride=2, device=dev,
            k_sim=6, k_contrast=6, k_temporal=4)
        before = attn.multi_head_attention.launches
        rows_out[dev] = scorer.score_clip(
            [f"/c/vid1_frame_{i}.jpg" for i in range(1, 41)], side="left",
            clip_num=1, vid=1)
        launched = attn.multi_head_attention.launches - before
        assert launched == (3 if dev == "cuda" else 0)
    a, b = rows_out["cuda"], rows_out["cpu"]
    assert a["num_chunks"] == b["num_chunks"] == 17
    np.testing.assert_allclose(a["prob_sequence"], b["prob_sequence"],
                               rtol=0, atol=1e-4)
    assert [c["chunk_start_idx"] for c in a["topk_chunks"]] == \
        [c["chunk_start_idx"] for c in b["topk_chunks"]]


# ------------------------------------------------- head widths (F4)


@pytest.mark.parametrize("dh", [48, 80, 100, 128, 150])
@pytest.mark.parametrize("t", [9, 65, 197])
@pytest.mark.parametrize("layout", ["contiguous", "projection_order"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_takes_every_width_to_192(cuda, dh, t, layout,
                                                   dtype):
    """dh = 128 natively, other widths zero-padded to the next compiled
    one (counted in padded_launches), each against the plain version at
    the true width's scale; the output holds dh columns."""
    q, k, v = _attention_inputs(2, 4, t, dh, dtype, layout, cuda, t + dh)
    bias = _key_bias(2, t, dh).to(cuda)
    launches = attn.multi_head_attention.launches
    padded = attn.multi_head_attention.padded_launches
    got = attn.multi_head_attention(q, k, v, key_bias=bias)
    assert attn.multi_head_attention.launches == launches + 1
    assert attn.multi_head_attention.padded_launches == \
        padded + int(dh not in attn.KERNEL_HEAD_DIMS)
    assert got.shape == (2, 4, t, dh)
    atol = 1e-5 if dtype == torch.float32 else \
        2 ** -8 * v.float().abs().max().item()
    _assert_close(got, q, k, v, dtype, atol, key_bias=bias)


def test_attention_kernel_refuses_heads_wider_than_192(cuda):
    q = torch.zeros(1, 2, 5, 256, device=cuda)
    launches = attn.multi_head_attention.launches
    with pytest.raises(ValueError, match="up to 192"):
        attn.multi_head_attention(q, q, q)
    assert attn.multi_head_attention.launches == launches


@pytest.mark.parametrize("dim,heads", [(160, 2), (256, 2), (512, 2)])
def test_encoder_block_at_other_head_widths_on_card(cuda, dim, heads):
    """EncoderBlock at dh = 80 (padded), 128 (native) and 256 (the plain
    route of models/vit.py::head_too_wide_for_kernel) on the card against
    the CPU, in eval; B launches for the first two only."""
    from vit_research_tpu_torch.models.vit import EncoderBlock

    torch.manual_seed(0)
    host = EncoderBlock(dim, heads, 2 * dim).eval()
    card = EncoderBlock(dim, heads, 2 * dim).to(cuda).eval()
    card.load_state_dict(host.state_dict())
    x = torch.randn(3, 197, dim)
    launches = attn.multi_head_attention.launches
    with torch.no_grad():
        got = card(x.to(cuda))[0].cpu()
        want = host(x)[0]
    assert attn.multi_head_attention.launches == \
        launches + int(dim // heads <= 192)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# ------------------------------------------ temporal head, joint step


def test_temporal_head_on_card_is_f32_under_a_tf32_default(cuda):
    """The TemporalHead forward and 20 training epochs on the card against
    the CPU with cuDNN's global TF32 flag on: the head's own scope keeps
    the convolutions in f32 (TF32 would miss these bounds by ~1e-3). The
    losses within 1e-5 relative, the trained weights within lr an epoch
    (Adam turns the rounding noise of a near-zero gradient into a step of
    up to lr: 10% of conv_0's weights end 1e-6 to 1.3e-5 apart, which
    moves the probabilities by ~4e-4), and the card's probabilities of the
    card-trained weights within 1e-5 of the CPU's for the same weights."""
    from vit_research_tpu_torch.models import convert
    from vit_research_tpu_torch.models.temporal_head import TemporalHead
    from vit_research_tpu_torch.train.train_temporal import (
        predict_probs, train_temporal_head)

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((400, 768)).astype(np.float32)
    labels = rng.integers(-1, 3, size=400)
    head = TemporalHead(768, generator=torch.Generator().manual_seed(0))
    init = convert.temporal_head_to_params(head.state_dict())
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card, card_losses = train_temporal_head(emb, labels, epochs=20,
                                                init_params=init,
                                                device="cuda")
        assert torch.backends.cudnn.allow_tf32  # restored
        got = predict_probs(card, emb)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    host, host_losses = train_temporal_head(emb, labels, epochs=20,
                                            init_params=init, device="cpu")
    np.testing.assert_allclose(card_losses, host_losses, rtol=1e-5, atol=0)
    for (name, a), b in zip(card.state_dict().items(),
                            host.state_dict().values()):
        assert (a.cpu() - b).abs().max() <= 1e-5 * 20, name
    same = TemporalHead(768)
    same.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    np.testing.assert_allclose(got, predict_probs(same, emb), rtol=0,
                               atol=1e-5)


def test_joint_train_step_on_card_matches_cpu(cuda):
    """Two joint steps (ViT + ProjectionHead + RAGHead) on the card against
    the CPU from one set of weights: B runs forward and backward through
    its Function in the ViT blocks (dh = 16 here) and RAGHead's."""
    from vit_research_tpu_torch.models.heads import ProjectionHead, RAGHead
    from vit_research_tpu_torch.models.vit import VisionTransformer
    from vit_research_tpu_torch.train.optim import Optimizer
    from vit_research_tpu_torch.train.train_step import \
        make_joint_train_step
    from vit_research_tpu_torch.utils.configs import HeadConfig

    g = torch.Generator().manual_seed(0)
    cfg = ViTConfig(image_size=(32, 32), patch_size=8, hidden_size=64,
                    num_layers=2, num_heads=4, mlp_dim=128)
    hcfg = HeadConfig(embed_dim=64, num_layers=1, num_heads=2, mlp_dim=32,
                      num_queries=2)
    mods = {}
    for dev in ("cpu", "cuda"):
        gen = torch.Generator().manual_seed(1)
        ms = (VisionTransformer(cfg, generator=gen),
              ProjectionHead(64, hidden_dim=64, proj_dim=64, generator=gen),
              RAGHead(hcfg, generator=gen))
        mods[dev] = [m.to(dev) for m in ms]
    frames = torch.randn(2, 2, 32, 32, 3, generator=g)
    retrieved = torch.randn(2, 3, 64, generator=g)
    labels = torch.tensor([0.0, 1.0])
    losses = {}
    for dev, ms in mods.items():
        opt = Optimizer([p for m in ms for p in m.parameters()], lr=1e-3,
                        eps=1e-8)
        step = make_joint_train_step(*ms, opt)
        before = attn.multi_head_attention.launches
        losses[dev] = [float(step(frames.to(dev), retrieved.to(dev),
                                  labels.to(dev))) for _ in range(2)]
        launched = attn.multi_head_attention.launches - before
        assert launched == (2 * (2 + 1) if dev == "cuda" else 0)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for a, b in zip(mods["cuda"], mods["cpu"]):
        for (name, p), q in zip(a.state_dict().items(),
                                b.state_dict().values()):
            assert (p.cpu() - q).abs().max() <= 2e-3, name


# bf16 heads on the card, kernel B (attn_bf16 through _Attention) against
# the same module with B's launch swapped for the plain version: both
# round the scores, the scale, the bias and P to bf16 at the same places,
# one key tile at these T, so they differ only where a sum in another
# order straddles a bf16 rounding boundary. Outputs are held to one ulp
# of their scale (2^-8) and the f32 parameters' gradients (the plain VJP
# on both sides) to a relative L2 error of 2^-8 over all of them (the key
# biases, whose true gradient is zero, left out): a wrong head, layout,
# rounding or VJP moves them by far more. (While the kernel kept f32
# scores, both bounds were 2^-3.)
BF16_OUT, BF16_GRAD = 2 ** -8, 2 ** -8


@pytest.mark.parametrize("kind,dh", [("chunk", 96), ("rag", 192)])
def test_bf16_head_grads_through_attention_on_card(cuda, kind, dh,
                                                    monkeypatch):
    from vit_research_tpu_torch.models import heads
    from vit_research_tpu_torch.utils.configs import (ChunkEncoderConfig,
                                                      HeadConfig)

    d = 2 * dh
    g = torch.Generator().manual_seed(0)
    if kind == "chunk":
        model = heads.ChunkEncoder(ChunkEncoderConfig(
            embed_dim=d, num_layers=2, num_heads=2, mlp_dim=2 * d,
            max_len=8, dtype="bfloat16", dropout_rate=0.0), generator=g)
        model.class_head.dropout.p = 0.0  # the reference's fixed 0.2
        inputs = [torch.randn(6, 8, d, generator=g)]
    else:
        model = heads.RAGHead(HeadConfig(
            embed_dim=d, num_layers=2, num_heads=2, dtype="bfloat16",
            dropout_rate=0.0, classifier_dropout=0.0), generator=g)
        inputs = [torch.randn(6, d, generator=g),
                  torch.randn(6, 10, d, generator=g)]
    model = model.to(cuda).train()

    def run():
        model.zero_grad()
        xs = [x.to(cuda).requires_grad_(True) for x in inputs]
        outs = model(*xs)
        sum(o.float().sum() for o in outs).backward()
        return ([o.detach().float() for o in outs],
                {n: p.grad.clone() for n, p in model.named_parameters()})

    before = dict(attn.multi_head_attention.launches_by_kernel)
    kernel_out, kernel_grad = run()
    key = f"attn_bf16<{dh}>"
    assert attn.multi_head_attention.launches_by_kernel[key] == \
        before.get(key, 0) + 2
    monkeypatch.setattr(attn, "_launch", lambda q, k, v, scale, bias:
                        attn.attention_plain(q, k, v, scale=scale,
                                             key_bias=bias))
    plain_out, plain_grad = run()
    for a, b in zip(kernel_out, plain_out):
        assert (a - b).abs().max() <= BF16_OUT * b.abs().max()
    names = [n for n in plain_grad if not n.endswith("attn.key.bias")]
    a = torch.cat([kernel_grad[n].ravel() for n in names])
    b = torch.cat([plain_grad[n].ravel() for n in names])
    assert (a - b).norm() <= BF16_GRAD * b.norm()


def test_sharded_topk_on_a_4_entry_mesh_matches_flat(cuda):
    """The corpus split over 4 entries of the one card: the flat device
    path's answers (the same indices, scores within 1e-5), f32 and int8,
    with and without a mask."""
    from vit_research_tpu_torch.ops import sharded_topk as st
    from vit_research_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * 4)
    g = torch.Generator(device=cuda).manual_seed(0)
    c = topk.l2_normalize(torch.randn(5003, 64, device=cuda, generator=g))
    q = topk.l2_normalize(torch.randn(33, 64, device=cuda, generator=g))
    mask = torch.rand(33, 5003, device=cuda, generator=g) > 0.3
    cq, cs = topk.quantize_int8(c)
    qq, qs = topk.quantize_int8(q)
    for m in (None, mask):
        cases = [(st.sharded_masked_topk(q, c, m, k=20, mesh=mesh,
                                         metric="ip"),
                  topk.masked_topk(q, c, m, k=20, metric="ip")),
                 (st.sharded_masked_topk_int8(qq, qs, cq, cs, m, k=20,
                                              mesh=mesh),
                  topk.masked_topk_int8(qq, qs, cq, cs, m, k=20))]
        for (gs, gi), (ws, wi) in cases:
            assert gs.device.type == "cuda"
            torch.testing.assert_close(gs, ws, rtol=0, atol=1e-5)
            assert torch.equal(gi, wi)


def test_mesh_engine_on_card_matches_single_device(cuda):
    """A 2-entry mesh engine on the one card: kernels A and B launch once
    a share, and the embeddings equal the single-device engine's."""
    from vit_research_tpu_torch.parallel.mesh import make_mesh

    model = init_vit(TINY, seed=0, device="cpu")
    spec = PreprocessSpec(size=(32, 32))
    single = embed.EmbeddingEngine(model, spec, device=cuda, batch_size=8)
    eng = embed.EmbeddingEngine(model, spec,
                                mesh=make_mesh(devices=["cuda:0"] * 2),
                                batch_size=8)
    frames = np.random.default_rng(0).integers(0, 256, (13, 32, 32, 3),
                                               dtype=np.uint8)
    want = single.embed_batch(frames)
    a0 = pe.fused_patch_embed.launches
    got = eng.embed_batch(frames)
    assert pe.fused_patch_embed.launches == a0 + 4  # 8 = 4 + 4, 5 = 3 + 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
