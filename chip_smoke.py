"""Smoke run of the PyTorch port on one CUDA card: builds the kernels, holds
each against its plain PyTorch version, then drives the kNN+HMM main path
and the vector-store path through the port's CLI at full ViT-B/16 @224
width and checks the results.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises, so the exit code is not 0):
  1. the card (nvidia-smi name and power limit, torch and CUDA versions)
     and the kernel build from vit_research_tpu_torch/csrc/;
  2. the patch-embed kernel against its plain version (uint8 frames,
     B=64 and B=256 @224 P=16, B=16 @432x768 P=32; f32 and bf16 out),
     and the nearest library call, F.conv2d over the normalised batch;
  3. the attention kernel against its plain version (T = 197, 325, 1297,
     dh = 64; f32 and bf16), and F.scaled_dot_product_attention;
  3b. the fused LayerNorm + projection kernel, driven through its public
     entry ``ln_matmul`` at ViT-B shapes (M = 256*197, K = 768, N = 768
     and 3072 with exact GELU; x and W f32, and x f32 with W bf16), then
     against its plain version and the library pair F.layer_norm +
     F.linear (+ F.gelu);
  4. the main path: two synthetic games of 224x224 JPEG frames, one
     labelled corpus (write-frame-db) and one query (segment --method
     knn-hmm), through ``vit_research_tpu_torch.cli`` on the card, with
     the kernels' launch counts, a reference check of 8 frames against the
     CPU plain forward of the same weights, the planted possessions
     recovered, and the embed rate in f32 and bf16;
  5. the store path through the CLI on phase 4's clips and corpus:
     build-frame-store (store rows = frames in the clips) and search of
     32 query frames against the 512-row corpus on the device route (the
     neighbours' labels match the frames' planted sides), with the
     kernels' launch counts;
  6. a game-sized store: a seeded 200,000 x 768 cosine collection queried
     with 256 queries, k = 50, on the card in f32 and in int8, each held
     against the CPU answer of the same rows, and timed;
  7. one JSON line of kernel summaries, then the result line.

Bounds (``bound_ms``) are the larger of the bytes a kernel must move
over the H100 SXM's 3.35 TB/s and its operations over the peak of the
units the work may use (67 TFLOP/s f32 on the CUDA cores, 989 TFLOP/s
bf16 on the tensor cores): NVIDIA's data-sheet figures, not measured.

    python3 chip_smoke.py --profile

builds the kernels, then profiles the engine's forward (torch.profiler
over steady batches of ViT-B/16 @224: f32 B=256 and bf16 B=512; device
time by kernel and the device's idle share) and times the sequential
against the log-depth Viterbi decode on the card at several game lengths.

Times are CUDA-event medians on this card unless a line says otherwise;
the nvidia-smi line says which card and power limit they belong to. The
script imports only the port (``vit_research_tpu_torch``), torch, numpy
and PIL.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vit_research_tpu_torch import cli
from vit_research_tpu_torch.cli import common
from vit_research_tpu_torch.db.frame_store import FrameStore
from vit_research_tpu_torch.ops import _build
from vit_research_tpu_torch.ops import attention as attn
from vit_research_tpu_torch.ops import fused_ln
from vit_research_tpu_torch.ops import patch_embed as pe
from vit_research_tpu_torch.ops import topk
from vit_research_tpu_torch.parallel import embed
from vit_research_tpu_torch.segment import hmm
from vit_research_tpu_torch.store.vector_store import Collection

SPEC = embed.HF_VIT_SPEC
HF_AFFINE = dict(rescale=SPEC.rescale, mean=SPEC.mean, std=SPEC.std)
# Tolerances. f32: the kernels and the plain versions sum the same
# products in other orders, ~1e-6 on outputs of order 1. bf16 patch embed:
# one bf16 rounding of outputs < 8 (2^-5). bf16 attention: the kernel
# keeps f32 scores/probabilities where the plain version rounds them to
# bf16 (outputs < 4: 1e-2).
PE_BOUND = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}
ATTN_BOUND = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# 8 frames through 12 f32 layers on the card vs on the CPU: different
# kernels and summation orders; L2-normalised embeddings.
EMBED_BOUND = 1e-4
# Fused LN + projection, relative to the output's scale: f32 sums in
# other orders (1e-5); a bf16 rounding of the LN output or of the result
# can fall apart between the two (2^-6).
LN_BOUND = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# Store queries against the CPU answer: f32 scores from two matmul
# libraries (1e-4); int8 scores are exact integers on both, but the L2
# normalisation before quantizing may differ by an ulp and move an int8
# value by one (1e-3).
STORE_BOUND = {"f32": 1e-4, "int8": 1e-3}
# H100 SXM data-sheet peaks (not measured).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}

CORPUS_SEGMENTS = [("none", 40), ("left", 160), ("none", 40), ("right", 160),
                   ("none", 40), ("left", 60), ("none", 12)]
QUERY_SEGMENTS = [("none", 50), ("left", 180), ("none", 45), ("right", 210),
                  ("none", 40), ("left", 140), ("none", 103)]
MIN_LEN, PAD, BOUNDARY_SLACK = 100, 10, 5
BATCH = 256
SIDES = ("left", "right", "none")
CLIP_RE = re.compile(r"^vid\d+_clip_(\d+)_(left|right|none)$")
FRAME_RE = re.compile(r"^vid\d+_frame_(\d+)\.jpg$")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5, n: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``n`` back-to-back calls,
    by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n)
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak: str) -> dict:
    """The least time the card could take: bytes over HBM bandwidth
    against operations over the peak of ``peak``'s units."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[peak] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] card: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda} | python "
        f"{sys.version.split()[0]}")
    t0 = time.monotonic()
    _build.library()
    log(f"[1] built {len(_build.sources())} kernel sources with nvcc in "
        f"{time.monotonic() - t0:.1f} s")
    return smi


def phase_patch_embed(smi: str) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    summary = None
    for b, h, w, p in ((64, 224, 224, 16), (BATCH, 224, 224, 16),
                       (16, 432, 768, 32)):
        k = p * p * 3
        images = torch.from_numpy(rng.integers(
            0, 256, size=(b, h, w, 3), dtype=np.uint8)).to(dev)
        wt = torch.from_numpy((rng.standard_normal((k, 768)) * k ** -0.5)
                              .astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.standard_normal(768).astype(
            np.float32)).to(dev)
        a_vec, b_vec = (torch.from_numpy(x).to(dev)
                        for x in pe.fold_affine(p, **HF_AFFINE))
        for out_dtype in (torch.float32, torch.bfloat16):
            def kernel():
                return pe.fused_patch_embed(images, wt, bias, patch_size=p,
                                            out_dtype=out_dtype, **HF_AFFINE)

            def plain():
                return pe.patch_embed_plain(images, wt, bias, a_vec, b_vec,
                                            patch_size=p, out_dtype=out_dtype)

            got = kernel()
            want = plain().reshape(got.shape)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            bound_err = PE_BOUND[out_dtype]
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            name = str(out_dtype).split(".")[-1]
            log(f"[2] patch_embed u8 B={b} {h}x{w} P={p} out={name}: "
                f"max|err| {err:.3e} (bound {bound_err:.1e}) | kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms | {smi}")
            if not err <= bound_err:
                raise AssertionError(f"patch_embed kernel disagrees: {err}")
            if (b, p, out_dtype) == (BATCH, 16, torch.float32):
                m = got.shape[0] * got.shape[1]
                summary = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    **bound(images.numel() + wt.numel() * 4 + 768 * 4
                            + m * 768 * 4, 2 * m * k * 768, "f32"),
                    library_ms=_conv_patch_embed_ms(
                        images, wt, bias, a_vec, b_vec, p, want, smi))
    return summary


def _conv_patch_embed_ms(images, wt, bias, a_vec, b_vec, p, want,
                         smi) -> float:
    """No single PyTorch call takes uint8 NHWC through the affine and the
    projection; the nearest is F.conv2d (stride = kernel = P, f32, TF32
    off) over the already-normalised f32 NCHW batch, timed here."""
    import torch.nn.functional as F

    c = images.shape[-1]
    nchw = (images.float() * a_vec[:c] - b_vec[:c]).permute(0, 3, 1, 2) \
        .contiguous()
    cw = wt.reshape(p, p, c, -1).permute(3, 2, 0, 1).contiguous()

    def conv():
        return F.conv2d(nchw, cw, bias, stride=p)

    err = (conv().flatten(2).transpose(1, 2).reshape(want.shape) - want) \
        .abs().max().item()
    if not err <= PE_BOUND[torch.float32]:
        raise AssertionError(f"conv2d computes another function: {err}")
    ms = cuda_ms(conv)
    log(f"[2] library: F.conv2d over the normalised f32 NCHW batch (no "
        f"single call takes uint8 NHWC): {ms:.4f} ms | {smi}")
    del nchw
    return ms


def phase_attention(smi: str) -> dict:
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    summary = None
    for b, t in ((BATCH, 197), (BATCH, 325), (32, 1297)):
        q32, k32, v32 = (torch.randn(b, 12, t, 64, generator=g).to(dev)
                         for _ in range(3))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            got = attn.multi_head_attention(q, k, v)
            want = attn.attention_plain(q.float(), k.float(), v.float())
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            del want
            bound_err = ATTN_BOUND[dtype]
            ms = cuda_ms(lambda: attn.multi_head_attention(q, k, v))
            plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v))
            name = str(dtype).split(".")[-1]
            log(f"[3] attention B={b} H=12 T={t} dh=64 {name}: max|err| "
                f"{err:.3e} (bound {bound_err:.1e}) | kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms | {smi}")
            if not err <= bound_err:
                raise AssertionError(f"attention kernel disagrees: {err}")
            if t == 197:
                sdpa_ms = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v))
                lim = bound(4 * q.numel() * q.element_size(),
                            4 * b * 12 * t * t * 64,
                            "f32" if dtype == torch.float32 else "bf16")
                log(f"[3] library: F.scaled_dot_product_attention B={b} "
                    f"T={t} {name}: {sdpa_ms:.4f} ms; bound "
                    f"{lim['bound_ms']:.4f} ms ({lim['bound_by']}) | {smi}")
                if dtype == torch.float32:
                    summary = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                   library_ms=sdpa_ms, **lim)
        del q32, k32, v32, q, k, v
        torch.cuda.empty_cache()
    return summary


LN_CASES = [(768, None, torch.float32), (3072, "gelu", torch.float32),
            (768, None, torch.bfloat16), (3072, "gelu", torch.bfloat16)]


def phase_ln_matmul(smi: str) -> dict:
    """Kernel C at ViT-B shapes. Its path is its public entry: the counts
    are zeroed, ``ln_matmul`` is driven once per case and the count read;
    then each case is held against the plain version and timed against it
    and the library pair."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    m, k, eps = BATCH * 197, 768, 1e-12
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    gamma, beta = (torch.from_numpy(rng.normal(mu, 0.1, size=k).astype(
        np.float32)).to(dev) for mu in (1.0, 0.0))
    cases = []
    for n, act, w_dtype in LN_CASES:
        w = torch.from_numpy((rng.normal(size=(k, n)) * k ** -0.5).astype(
            np.float32)).to(dev, w_dtype)
        bias = torch.from_numpy(rng.normal(size=n).astype(np.float32)) \
            .to(dev)
        cases.append((n, act, w, bias))

    fused_ln.ln_matmul.launches = 0
    outs = [fused_ln.ln_matmul(x, gamma, beta, w, bias, eps=eps,
                               activation=act) for _, act, w, bias in cases]
    torch.cuda.synchronize()
    launches = fused_ln.ln_matmul.launches
    log(f"[3b] ln_matmul driven at M={m} K={k}: {launches} launches for "
        f"{len(cases)} calls")
    if launches != len(cases):
        raise AssertionError(f"ln_matmul launched {launches} times, want "
                             f"{len(cases)}")

    summary = None
    for (n, act, w, bias), got in zip(cases, outs):
        def kernel():
            return fused_ln.ln_matmul(x, gamma, beta, w, bias, eps=eps,
                                      activation=act)

        def plain():
            return fused_ln.ln_matmul_plain(x, gamma, beta, w, bias, eps=eps,
                                            activation=act,
                                            out_dtype=w.dtype)

        wt, lib_bias = w.t().contiguous(), bias.to(w.dtype)

        def library():
            y = F.linear(F.layer_norm(x, (k,), gamma, beta, eps).to(w.dtype),
                         wt, lib_bias)
            return F.gelu(y) if act == "gelu" else y

        want = plain()
        scale = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (library().float() - want.float()).abs().max().item()
        bound_err = LN_BOUND[w.dtype] * scale
        ms, plain_ms, lib_ms = cuda_ms(kernel), cuda_ms(plain), \
            cuda_ms(library)
        w_name = str(w.dtype).split(".")[-1]
        lim = bound(x.numel() * 4 + w.numel() * w.element_size()
                    + (2 * k + n) * 4 + m * n * w.element_size(),
                    2 * m * k * n,
                    "f32" if w.dtype == torch.float32 else "bf16")
        log(f"[3b] ln_matmul M={m} K={k} N={n} act={act} x=float32 "
            f"W={w_name}: max|err| {err:.3e} (bound {bound_err:.1e}) | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"layer_norm+linear{'+gelu' if act else ''} {lib_ms:.4f} ms "
            f"(max|err| {lib_err:.3e}); bound {lim['bound_ms']:.4f} ms "
            f"({lim['bound_by']}) | {smi}")
        if not err <= bound_err:
            raise AssertionError(f"ln_matmul kernel disagrees: {err}")
        if (n, w.dtype) == (3072, torch.float32):
            summary = dict(launches=launches, max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms, **lim)
        del want
    del x, cases, outs
    torch.cuda.empty_cache()
    return summary


def synth_frame(side: str, size, rng) -> np.ndarray:
    """One frame of the repo's synthetic world (data/synthetic.py): noise
    with the side shown as a brighter half and a channel tint (red = left,
    blue = right)."""
    h, w = size
    img = rng.integers(60, 120, size=(h, w, 3), dtype=np.uint8).astype(
        np.int32)
    if side == "left":
        img[:, :w // 2] += 100
        img[:, :, 0] += 50
    elif side == "right":
        img[:, w // 2:] += 100
        img[:, :, 2] += 50
    return np.minimum(img, 255).astype(np.uint8)


def _write_game(root, vid, segments):
    """JPEG frames ``vid{vid}_frame_{n}.jpg`` and the manual-interval CSV
    that labels them, in the formats the CLI reads. Returns (frames dir,
    CSV path, planted possessions [(side, first, last)])."""
    from PIL import Image

    frames_dir = os.path.join(root, f"frames_vid{vid}")
    os.makedirs(frames_dir)
    rng = np.random.default_rng(vid)
    intervals = {side: [] for side in SIDES}
    planted, fnum = [], 1
    for side, n in segments:
        for f in range(fnum, fnum + n):
            Image.fromarray(synth_frame(side, (224, 224), rng)).save(
                os.path.join(frames_dir, f"vid{vid}_frame_{f}.jpg"),
                quality=90)
        intervals[side].append((f"vid{vid}_{fnum}", f"vid{vid}_{fnum + n - 1}"))
        if side != "none" and n >= MIN_LEN:
            planted.append((side, fnum, fnum + n - 1))
        fnum += n
    csv_path = os.path.join(root, f"manual_vid{vid}.csv")
    with open(csv_path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow([f"{s}_{k}" for s in SIDES for k in ("start", "end")])
        for i in range(max(len(v) for v in intervals.values())):
            w.writerow([x for s in SIDES for x in (
                intervals[s][i] if i < len(intervals[s]) else ("", ""))])
    return frames_dir, csv_path, planted


def _clip_ranges(out_dir):
    """Clip directories -> [(side, first frame, last frame)] in clip order."""
    got = []
    for clip, side, d in sorted(
            (int(m.group(1)), m.group(2), d) for d in os.listdir(out_dir)
            if (m := CLIP_RE.match(d))):
        nums = [int(FRAME_RE.match(f).group(1))
                for f in os.listdir(os.path.join(out_dir, d))]
        got.append((side, min(nums), max(nums)))
    return got


def _embed_rate(dtype: str, batch: int, iters: int = 16) -> float:
    """bench.py's method: device-resident random uint8 batches (8 staged
    buffers), the engine's forward per batch, one checksum readback per
    batch, timed on the host clock after a warm-up batch."""
    eng = embed.make_hf_frame_embedder(device="cuda", batch_size=batch,
                                       dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bufs = [torch.randint(0, 256, (batch, 224, 224, 3), generator=gen,
                          device="cuda", dtype=torch.uint8) for _ in range(8)]
    float(eng._forward(bufs[0])[:, :8].sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = [eng._forward(bufs[i % 8])[:, :8].sum() for i in range(iters)]
    _ = [float(s) for s in sums]
    return batch * iters / (time.perf_counter() - t0)


def phase_main_path(smi: str, root: str) -> dict:
    t0 = time.monotonic()
    corpus_dir, corpus_csv, _ = _write_game(root, 1, CORPUS_SEGMENTS)
    query_dir, _, planted = _write_game(root, 2, QUERY_SEGMENTS)
    n_corpus = sum(n for _, n in CORPUS_SEGMENTS)
    n_query = sum(n for _, n in QUERY_SEGMENTS)
    log(f"[4] wrote {n_corpus} corpus + {n_query} query JPEG frames "
        f"(224x224) in {time.monotonic() - t0:.1f} s")
    db = os.path.join(root, "db")
    out = os.path.join(root, "clips")

    pe.fused_patch_embed.launches = 0
    attn.multi_head_attention.launches = 0
    t0 = time.monotonic()
    cli.main(["write-frame-db", corpus_dir, "--manual-csv", corpus_csv,
              "--db", db, "--collection", "corpus", "--batch-size",
              str(BATCH), "--device", "cuda"])
    cli.main(["segment", query_dir, "--method", "knn-hmm", "--db", db,
              "--corpus-collection", "corpus", "--k", "50", "--out", out,
              "--vid", "2", "--min-len", str(MIN_LEN), "--pad", str(PAD),
              "--batch-size", str(BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"patch_embed": pe.fused_patch_embed.launches,
                "attention": attn.multi_head_attention.launches}
    batches = math.ceil(n_corpus / BATCH) + math.ceil(n_query / BATCH)
    log(f"[4] CLI write-frame-db + segment on the card: {wall:.1f} s "
        f"wall (includes engine init and JPEG decode); launches "
        f"{launches} for {batches} engine batches")
    if launches != {"patch_embed": batches, "attention": 12 * batches}:
        raise AssertionError(f"unexpected kernel launches {launches}, "
                             f"want {batches} and {12 * batches}")

    _, col, corpus = common.load_corpus(db, "corpus", "cuda")
    embs = corpus["embeddings"]
    want_labels = np.repeat([SIDES.index(s) for s, _ in CORPUS_SEGMENTS],
                            [n for _, n in CORPUS_SEGMENTS])
    if embs.shape != (n_corpus, 768) or not np.isfinite(embs).all():
        raise AssertionError(f"corpus embeddings {embs.shape} not "
                             "finite (N, 768)")
    if not np.array_equal(np.sort(corpus["labels"]), np.sort(want_labels)):
        raise AssertionError("corpus labels differ from the manual CSV")
    log(f"[4] corpus collection: {embs.shape} finite, labels as "
        f"written, profile {col.embedding_profile!r}")

    # Reference: 8 query frames through the card engine (kernels) vs
    # the plain forward of the same seeded weights on the CPU.
    paths = [os.path.join(query_dir, f"vid2_frame_{f}.jpg")
             for f in range(1, n_query + 1, 97)][:8]
    card = embed.make_hf_frame_embedder(device="cuda", batch_size=BATCH)
    got = card.embed_paths(paths)
    host = embed.EmbeddingEngine(card.model.to("cpu"), card.spec,
                                 device="cpu", batch_size=8)
    want = host.embed_paths(paths)
    err = float(np.abs(got - want).max())
    log(f"[4] 8 frames card vs CPU plain forward: max|err| {err:.3e} "
        f"(bound {EMBED_BOUND:.0e})")
    if not (np.isfinite(got).all() and err <= EMBED_BOUND):
        raise AssertionError(f"card embeddings disagree with the CPU "
                             f"reference: {err}")

    clips = _clip_ranges(out)
    log(f"[4] clips {clips}; planted possessions {planted} "
        f"(pad {PAD}, slack {BOUNDARY_SLACK})")
    if len(clips) != len(planted) or any(
            side != p_side
            or abs(s - max(1, p_s - PAD)) > BOUNDARY_SLACK
            or abs(e - min(n_query, p_e + PAD)) > BOUNDARY_SLACK
            for (side, s, e), (p_side, p_s, p_e) in zip(clips, planted)):
        raise AssertionError("decoded clips miss the planted "
                             "possessions")
    for dtype, batch in (("float32", BATCH), ("bfloat16", 512)):
        rate = _embed_rate(dtype, batch)
        log(f"[4] embed rate ViT-B/16 @224 {dtype} B={batch}: {rate:.1f} "
            f"frames/s | {smi}")
        torch.cuda.empty_cache()
    return dict(launches=launches, db=db, out=out, query_dir=query_dir,
                n_query=n_query)


def _query_sides() -> list:
    """The planted side of every query-game frame, frame 1 first."""
    return [side for side, n in QUERY_SEGMENTS for _ in range(n)]


def phase_store_path(smi: str, root: str, main: dict) -> dict:
    """build-frame-store over phase 4's clips, then search of 32 query
    frames against the 512-row corpus, through the CLI on the card."""
    store = os.path.join(root, "store")
    clip_frames = sum(len(os.listdir(os.path.join(main["out"], d)))
                      for d in os.listdir(main["out"]) if CLIP_RE.match(d))
    sides = _query_sides()
    picks = [int(f) for f in np.linspace(1, main["n_query"], 32)]
    queries = [os.path.join(main["query_dir"], f"vid2_frame_{f}.jpg")
               for f in picks]

    pe.fused_patch_embed.launches = 0
    attn.multi_head_attention.launches = 0
    t0 = time.monotonic()
    cli.main(["build-frame-store", "--clip-root", main["out"], "--vids",
              "2", "--out", store, "--batch-size", str(BATCH), "--device",
              "cuda"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["search", *queries, "--db", main["db"], "--collection",
                  "corpus", "--k", "10", "--batch-size", str(BATCH),
                  "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"patch_embed": pe.fused_patch_embed.launches,
                "attention": attn.multi_head_attention.launches}
    batches = sum(math.ceil(min(1024, clip_frames - s) / BATCH)
                  for s in range(0, clip_frames, 1024)) \
        + math.ceil(len(queries) / BATCH)
    log(f"[5] CLI build-frame-store + search on the card: {wall:.1f} s "
        f"wall; launches {launches} for {batches} engine batches")
    if launches != {"patch_embed": batches, "attention": 12 * batches}:
        raise AssertionError(f"unexpected kernel launches {launches}, want "
                             f"{batches} and {12 * batches}")

    fs = FrameStore(store).open()
    if fs.n != clip_frames or fs.dim != 768:
        raise AssertionError(f"store holds {fs.n}x{fs.dim}, the clips "
                             f"{clip_frames} frames")
    emb = fs.gather(np.arange(fs.n))
    if not np.isfinite(emb).all():
        raise AssertionError("store embeddings are not finite")
    log(f"[5] frame store: {fs.n} rows = frames in the clips, finite, "
        f"profile {fs.embedding_profile!r}")

    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    if [r["query"] for r in lines] != queries:
        raise AssertionError("search printed other queries than asked")
    agree = [n["metadata"]["label"] == sides[f - 1]
             for r, f in zip(lines, picks) for n in r["neighbors"]]
    share = sum(agree) / len(agree)
    log(f"[5] search 32 frames x 512 corpus rows (2^14: device route), "
        f"k=10: {100 * share:.1f}% of neighbours carry the frame's planted "
        f"side")
    if len(agree) != 320 or share < 0.8:
        raise AssertionError(f"search neighbours disagree with the planted "
                             f"sides: {share:.3f} of {len(agree)}")
    return launches


def _same_neighbours(got_ids, got_s, want_ids, want_s, tol) -> int:
    """Rank-by-rank scores within ``tol`` and any id in one answer but not
    the other within ``tol`` of the last kept score; returns how many
    queries differ in their id sets."""
    differ = 0
    for gi, gs, wi, ws in zip(got_ids, got_s, want_ids, want_s):
        if not np.allclose(gs, ws, rtol=0, atol=tol):
            raise AssertionError(f"scores differ beyond {tol}")
        extra = set(gi) ^ set(wi)
        differ += bool(extra)
        for i in extra:
            s = gs[list(gi).index(i)] if i in gi else ws[list(wi).index(i)]
            if abs(s - ws[-1]) > tol:
                raise AssertionError(f"id {i} ({s}) is not a near-tie of "
                                     f"the last neighbour ({ws[-1]})")
    return differ


def _timed_query(col, q, k) -> tuple:
    """(answer, first-call ms (corpus upload included), median ms of 3
    more calls), host clock, as a caller sees it."""
    t0 = time.perf_counter()
    col.query(q, n_results=k, include=("distances",))
    first = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = col.query(q, n_results=k, include=("distances",))
        times.append((time.perf_counter() - t0) * 1e3)
    return got, first, statistics.median(times)


def phase_game_store(smi: str, n: int = 200_000, d: int = 768,
                     n_q: int = 256, k: int = 50) -> None:
    """A game's worth of frames as a seeded cosine collection, queried on
    the card in f32 and int8 and held against the CPU answers."""
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((n, d), dtype=np.float32)
    q = rng.standard_normal((n_q, d), dtype=np.float32)
    ids = [f"vid9_frame_{i}.jpg" for i in range(n)]
    col = Collection("game", space="cosine", device="cuda")
    col.upsert(ids, embs)
    log(f"[6] game store {n} x {d} f32 cosine ({embs.nbytes / 1e6:.1f} MB), "
        f"{n_q} queries, k={k}")

    got, first, ms = _timed_query(col, q, k)
    corpus, qd = col._device_corpus(), topk.l2_normalize(
        torch.from_numpy(q).cuda())
    dev_ms = cuda_ms(lambda: topk.masked_topk(qd, corpus, None, k=k,
                                              metric="ip"), reps=3, n=3)
    t0 = time.perf_counter()
    want_s, want_i = topk.masked_topk(
        topk.l2_normalize(torch.from_numpy(q)),
        topk.l2_normalize(torch.from_numpy(embs)), None, k=k, metric="ip")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    got_ids = [[int(i.split("_")[-1].split(".")[0]) for i in row]
               for row in got["ids"]]
    got_s = 1.0 - np.asarray(got["distances"])
    differ = _same_neighbours(got_ids, got_s, want_i.numpy().tolist(),
                              want_s.numpy(), STORE_BOUND["f32"])
    err = float(np.abs(got_s - want_s.numpy()).max())
    log(f"[6] f32 device query: {ms:.1f} ms (first, with the corpus "
        f"upload: {first:.1f} ms; masked_topk on the card {dev_ms:.2f} ms "
        f"by CUDA events); vs the CPU masked_topk ({cpu_ms:.0f} ms): "
        f"max|score err| {err:.2e} (bound {STORE_BOUND['f32']:.0e}), "
        f"{differ} of {n_q} queries differ only in near-ties | {smi}")
    del corpus, qd

    col.set_device_quantization("int8")
    got8, first8, ms8 = _timed_query(col, q, k)
    cpu = Collection("game", space="cosine", device="cpu",
                     device_quant="int8")
    cpu.upsert(ids, embs)
    t0 = time.perf_counter()
    want8 = cpu.query(q, n_results=k, include=("distances",))
    cpu8_ms = (time.perf_counter() - t0) * 1e3
    s8, w8 = (1.0 - np.asarray(a["distances"]) for a in (got8, want8))
    differ8 = _same_neighbours(got8["ids"], s8, want8["ids"], w8,
                               STORE_BOUND["int8"])
    err8 = float(np.abs(s8 - w8).max())
    log(f"[6] int8 device query: {ms8:.1f} ms (first, with the corpus "
        f"upload and quantization: {first8:.1f} ms); vs the CPU int8 path "
        f"({cpu8_ms:.0f} ms): max|score err| {err8:.2e} (bound "
        f"{STORE_BOUND['int8']:.0e}), {differ8} of {n_q} queries differ "
        f"only in near-ties | {smi}")
    del col, cpu
    torch.cuda.empty_cache()


def profile_forward(smi: str, dtype: str, batch: int, steps: int = 3,
                    top: int = 10) -> None:
    """torch.profiler over ``steps`` steady batches of the engine's forward
    on device-resident uint8 frames: device time per batch by kernel, and
    the idle share 1 - kernel time / wall time of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = embed.make_hf_frame_embedder(device="cuda", batch_size=batch,
                                       dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randint(0, 256, (batch, 224, 224, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    for _ in range(2):
        eng._forward(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng._forward(frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    log(f"[profile] ViT-B/16 @224 {dtype} B={batch}: {busy_ms:.1f} ms/batch "
        f"of kernels, {wall_ms:.1f} ms/batch wall, idle "
        f"{100 * max(0.0, 1 - busy_ms / wall_ms):.1f}% | {smi}")
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3 / steps
        log(f"[profile]   {ms:8.2f} ms {100 * ms / busy_ms:5.1f}% "
            f"x{e.count // steps:<3d} {e.key[:90]}")
    del eng, frames
    torch.cuda.empty_cache()


def time_viterbi(smi: str, lengths=(512, 2048, 8192, 32768, 131072)) -> None:
    """Sequential vs log-depth Viterbi through smooth_probabilities on the
    card (host clock, upload and readback included), one warm-up and one
    timed call each, and whether the two paths agree."""
    rng = np.random.default_rng(0)
    for t in lengths:
        probs = rng.dirichlet(np.full(3, 0.3), size=t).astype(np.float32)
        row, paths = [], []
        for parallel in (False, True):
            hmm.smooth_probabilities(probs, parallel=parallel, device="cuda")
            t0 = time.perf_counter()
            paths.append(hmm.smooth_probabilities(probs, parallel=parallel,
                                                  device="cuda"))
            row.append((time.perf_counter() - t0) * 1e3)
        log(f"[viterbi] T={t}: sequential {row[0]:.1f} ms, log-depth "
            f"{row[1]:.1f} ms, paths equal "
            f"{bool(np.array_equal(*paths))} | {smi}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the forward and the Viterbi decoders "
                    "instead of the smoke phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    if args.profile:
        profile_forward(smi, "float32", BATCH)
        profile_forward(smi, "bfloat16", 512)
        time_viterbi(smi)
        return 0
    pe_summary = phase_patch_embed(smi)
    attn_summary = phase_attention(smi)
    ln_summary = phase_ln_matmul(smi)
    with tempfile.TemporaryDirectory(prefix="vrt_chip_smoke_") as root:
        main_path = phase_main_path(smi, root)
        store_launches = phase_store_path(smi, root, main_path)
    phase_game_store(smi)
    launches = main_path["launches"]
    kernels = [
        dict(name="patch_embed", route="cuda",
             source="vit_research_tpu_torch/csrc/patch_embed.cu",
             replaces="vit_research_tpu/ops/patch_embed.py:65",
             launches=launches["patch_embed"],
             launches_by_path={"segment": launches["patch_embed"],
                               "store": store_launches["patch_embed"]},
             library_call="none; nearest F.conv2d over the normalised "
                          "f32 NCHW batch", **pe_summary),
        dict(name="attention", route="cuda",
             source="vit_research_tpu_torch/csrc/attention.cu",
             replaces="vit_research_tpu/ops/attention.py:51",
             launches=launches["attention"],
             launches_by_path={"segment": launches["attention"],
                               "store": store_launches["attention"]},
             library_call="F.scaled_dot_product_attention", **attn_summary),
        dict(name="ln_matmul", route="cuda",
             source="vit_research_tpu_torch/csrc/fused_ln.cu",
             replaces="vit_research_tpu/ops/fused_ln.py:62",
             launches_by_path={"ln_matmul": ln_summary["launches"]},
             library_call="F.layer_norm + F.linear + F.gelu", **ln_summary),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
