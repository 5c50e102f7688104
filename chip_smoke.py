"""Smoke run of the PyTorch port on one CUDA card: builds the kernels, holds
each against its plain PyTorch version, then drives the kNN+HMM main path
through the port's CLI at full ViT-B/16 @224 width and checks the result.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises, so the exit code is not 0):
  1. the card (nvidia-smi name and power limit, torch and CUDA versions)
     and the kernel build from vit_research_tpu_torch/csrc/;
  2. the patch-embed kernel against its plain version (uint8 frames,
     B=64 and B=256 @224 P=16, B=16 @432x768 P=32; f32 and bf16 out);
  3. the attention kernel against its plain version (T = 197, 325, 1297,
     dh = 64; f32 and bf16);
  4. the main path: two synthetic games of 224x224 JPEG frames, one
     labelled corpus (write-frame-db) and one query (segment --method
     knn-hmm), through ``vit_research_tpu_torch.cli`` on the card, with
     the kernels' launch counts, a reference check of 8 frames against the
     CPU plain forward of the same weights, the planted possessions
     recovered, and the embed rate in f32 and bf16;
  5. one JSON line per kernel summary, then the result line.

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
import csv
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
from vit_research_tpu_torch.ops import _build
from vit_research_tpu_torch.ops import attention as attn
from vit_research_tpu_torch.ops import patch_embed as pe
from vit_research_tpu_torch.parallel import embed
from vit_research_tpu_torch.segment import hmm

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
            bound = PE_BOUND[out_dtype]
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            name = str(out_dtype).split(".")[-1]
            log(f"[2] patch_embed u8 B={b} {h}x{w} P={p} out={name}: "
                f"max|err| {err:.3e} (bound {bound:.1e}) | kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms | {smi}")
            if not err <= bound:
                raise AssertionError(f"patch_embed kernel disagrees: {err}")
            if (b, p, out_dtype) == (BATCH, 16, torch.float32):
                summary = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return summary


def phase_attention(smi: str) -> dict:
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
            bound = ATTN_BOUND[dtype]
            ms = cuda_ms(lambda: attn.multi_head_attention(q, k, v))
            plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v))
            name = str(dtype).split(".")[-1]
            log(f"[3] attention B={b} H=12 T={t} dh=64 {name}: max|err| "
                f"{err:.3e} (bound {bound:.1e}) | kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms | {smi}")
            if not err <= bound:
                raise AssertionError(f"attention kernel disagrees: {err}")
            if (t, dtype) == (197, torch.float32):
                summary = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del q32, k32, v32, q, k, v
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


def phase_main_path(smi: str) -> dict:
    with tempfile.TemporaryDirectory(prefix="vrt_chip_smoke_") as root:
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

        _, col, corpus = cli.load_corpus(db, "corpus")
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
    return launches


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
    launches = phase_main_path(smi)
    kernels = [
        dict(name="patch_embed", route="cuda",
             source="vit_research_tpu_torch/csrc/patch_embed.cu",
             replaces="vit_research_tpu/ops/patch_embed.py:65",
             launches=launches["patch_embed"], **pe_summary),
        dict(name="attention", route="cuda",
             source="vit_research_tpu_torch/csrc/attention.cu",
             replaces="vit_research_tpu/ops/attention.py:51",
             launches=launches["attention"], **attn_summary),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
