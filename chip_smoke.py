"""Smoke run of the PyTorch port on one CUDA card: builds the kernels, holds
each against its plain PyTorch version, then drives the kNN+HMM main path,
the vector-store, serving, labelling and fast-profile paths, stage-1
training and the retrieval trainers through the port's CLI at full width
and checks the results.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises, so the exit code is not 0):
  1. the card (nvidia-smi name and power limit, torch and CUDA versions)
     and the kernel build from vit_research_tpu_torch/csrc/, with ptxas's
     registers, shared memory and spills of every kernel;
  2. the patch-embed kernel against its plain version (uint8 frames,
     B=64 and B=256 @224 P=16, B=16 @432x768 P=32, f32 and bf16 out; and
     the bf16 engine's shape, B=512 @224 with bf16 out), and the nearest
     library call, F.conv2d over the normalised f32 batch;
  3. the attention kernel against its plain version in the same dtype
     (T = 197, 325, 1297, dh = 64; f32 and bf16), on contiguous (B, H, T,
     dh) inputs and on the (B, H, T, dh) views of (B, T, H, dh) tensors
     that the backbone's projections give, and
     F.scaled_dot_product_attention; every bf16 check also prints the
     error of f32 scores (``attention_f32_scores``) and of the f32 plain
     version, and at B = 256, T = 197 the f32 scores must fail the tie
     check;
     the T > 64 residual with large scores; each bf16 row names the
     variant it launched (``launches_by_kernel``'s name: the held variant
     at T = 197 and 325, the two-pass kernel at T = 1297);
  3c. the attention kernel at the stage-1 chunk encoder's shapes (dh = 96,
     H = 8, B = 256, T = 9 and 25; f32 and bf16, contiguous and
     projection order) against its plain version, SDPA and its bound, and
     at T = 9 with large scores (max|S| >= 10), where f32 scores must fail
     the tie check; then
     the kernels' gradients: B's q/k/v and key-bias gradients through its
     autograd Function on the card (dh = 64 and 96, f32 and bf16) and A's
     w and bias gradients, against torch.autograd of the plain versions;
     and the head widths of F4's repair: B at dh = 128 (its own
     instantiation) and at dh = 80 and 48 (zero-padded to 96 and 64;
     ``padded_launches``), f32 and bf16, B = 32, T = 9 and 197, against
     its plain version, SDPA and its bound, with the padding's copy time;
     and an EncoderBlock at dh = 256 (the plain route) against the CPU;
  3d. the attention kernel at the RAG/RATT heads' dh = 192 (H = 4; B = 8
     and 256 at T = 5, B = 32 at T = 65 and 130; f32 and bf16, with and
     without a key bias, contiguous and projection order) against its
     plain version, the plain version's time, SDPA (with the bias as a
     float mask) and its bound; with large scores at T = 5 and 21 (f32
     scores must fail the bound) and the T > 64 residual at T = 65 and
     130; gradients through its Function against
     the plain VJP; ptxas's registers and spills of the dh = 192 kernels;
  3b. the fused LayerNorm + projection kernel, driven through its public
     entry ``ln_matmul`` at ViT-B shapes (M = 256*197, K = 768, N = 768
     and 3072 with exact GELU; x and W f32, and x f32 with W bf16), then
     against its plain version and the library pair F.layer_norm +
     F.linear (+ F.gelu), with TF32 off;
  4. the main path: two synthetic games of 224x224 JPEG frames (written,
     with phase 5b's CPU reference forward, on a thread while phase 1
     builds the kernels and phases 2-3b run), one
     labelled corpus (write-frame-db) and one query (segment --method
     knn-hmm), through ``vit_research_tpu_torch.cli`` on the card, with
     the kernels' launch counts, a reference check of 8 frames against the
     CPU plain forward of the same weights, the planted possessions
     recovered, and the embed rate in f32 and bf16;
  4b. F10 on the backbone's own activations: one bf16 forward of the
     seeded ViT-B/16 (B = 256) on phase 4's query frames, each of its 12
     kernel B calls held to the bf16 plain version by the tie check
     (``bf16_tie_check``): per block the strict error, the near-tie set,
     the rows over the bound and those a tie accepts;
  5. the store path through the CLI on phase 4's clips and corpus:
     build-frame-store (store rows = frames in the clips) and search of
     32 query frames against the 512-row corpus on the device route (the
     neighbours' labels match the frames' planted sides), with the
     kernels' launch counts;
  5b. the serve path on phase 4's corpus: ``cli serve --warmup`` on a
     thread of this process, then embed requests (JSON paths and
     frames_b64, binary raw_u8 and jpeg; 1, 16 and 256 frames) held to the
     CPU plain forward, 8 concurrent clients merged by the coalescer, a
     query, a live segment session in ragged pushes whose clips equal
     phase 4's offline clips, ``segment --follow --socket`` and the
     in-process ``segment --follow`` writing phase 4's clip directories,
     the stats counts, ``serve-ctl reload`` and ``shutdown``; the
     kernels' launches equal the engine batches the daemon ran, and the
     request latencies are printed;
  5c. the labelling path on phase 4's world, through the CLI on the card:
     self-label (labels and probabilities against a float64 numpy
     two-pass on the same card embeddings, tie-aware; --upsert adds only
     the pass-1 frames), finalize-clips on phase 4's clips (each kept mask
     against a host sequential decode of the card's 5-NN votes; the
     decodes' routes), merge-clips (the merged ranges against
     merge_clip_ranges and the planted possessions), write-embeddings
     (every row against the engine's), clustering and fresh-test (the
     buckets against a CPU classification with the saved npz, tie-aware;
     the k-means route), with the kernels' launch counts; then a
     ViTModel-shaped state dict through the HF import at full width (card
     vs the CPU plain forward), and the native JPEG decoder (whether it
     built, against PIL, and both decoders' frames/s at 1080p -> 224);
  5d. the fast profile on phase 4's world: the attention kernel with
     ToMe's key bias at every ToMe T of ViT-B/16 at r = 16 (197 ... 21;
     f32 and bf16, B = 256) against its plain version, timed against the
     plain version and SDPA with the bias as a float mask;
     bipartite_merge on the card against the CPU; the ToMe r=16, int8 and
     int8-static engines against the CPU forward of the same model (8
     frames; token sizes, and the merge-score margin wherever the card
     merged otherwise); calibrate-int8, then write-frame-db and ``segment
     --frame-stride 4 --stride-refine auto`` under ``VRT_TOME_R=16
     VRT_GEMM_QUANT=int8-static`` through the CLI (the clips against the
     planted possessions, the kernels' launches, the collection's
     profile); the profile fence and the stride refusals; ``serve
     --warmup`` under the fast env (a binary embed and a live session);
     and the embed rates of the parity, ToMe, int8, ToMe + int8-static
     and ToMe bf16 engines side by side;
  5e. stage 1 on phase 5's frame store (labelled left 1 / right 0):
     train-stage1 for 2 epochs and --resume for a third, then
     write-ratt-db, through the CLI on the card at full width (768, 3
     layers, 8 heads: dh = 96); the resumed step, every ratt_db row
     against a CPU plain forward of the restored best encoder (1e-4),
     search of 8 stored rows (each ranks first), B's launches (3 a
     validation or encode batch), a dropout-0 trajectory of 20 steps on
     the card against the CPU from one state (and the same card run with
     a planted fault, dq zeroed, which the check must catch), the step
     and eval-batch times, and write_ratt_chunk_db's rows/s on a seeded
     game-sized store (200,000 frames, ~100,000 chunks);
  5f. the retrieval trainers on phase 4's world: a two-game frame store
     (phase 4's segment clips and the corpus game's possessions),
     write-rag-db (rows equal the store's), write-ratt-db with phase 5e's
     run, train-rag 2 epochs with --rebuild sync --rebuild-every 1 and
     --resume for a third through the CLI on the card at full width
     (RAGHead 768 x 2, 4 heads: B at dh = 192; its launches, 2 a training
     step and a validation batch, counted as the path ``rag``), the synced
     and rebuild-db --run-id rows against a CPU ProjectionHead (1e-5),
     train-ratt with --rebuild sync (rows against a CPU projection) and
     with --attention-losses (no kernel launches), the card
     FrameRetriever against a float64 host top-k (tie-aware), a dropout-0
     train_rag trajectory on the card against the CPU (and the same run
     with dq zeroed, which must fail it), a preset-rag train step's time,
     launches and idle share, and a FrameRetriever batch of 8 queries
     against a seeded 200,000 x 768 frame collection;
  5h. the last verb and modules on phase 5f's store and phase 5e's run:
     train-cached (the bin cache built, 2 epochs, --resume for a third;
     B at dh = 96 encodes every anchor and batch) with the card's cache
     against a CPU build of the same rows (tie-aware) and a dropout-0
     card vs CPU trajectory; ``segment --method temporal`` (the default,
     3000 epochs) on phase 4's corpus game, its temporal_head.npz read on
     the CPU (probabilities, decoded paths), 50 epochs card vs CPU, an
     epoch at 20,000 frames under the profiler; the joint ViT-B/16 +
     RAGHead train step card vs CPU (and with B's dq zeroed, which must
     fail), then its time at 4 chunks x 8 frames; RAG-ViT at full width
     card vs CPU;
  5i. the last modules (phase 6's rows feed its mesh part): bf16 heads,
     a ChunkEncoder at ChunkEncoderConfig() width from phase 5e's run on
     phase 5's store chunks (B = 32; kernel B's attn_bf16<96>) and a
     RAGHead (768 x 2, 4 heads; attn_bf16<192>) on phase 5f's store rows
     (B = 8), 2 dropout-0 training steps each on the card against the same
     steps on the CPU (and with B's first head zeroed, which must fail),
     their step times beside the f32 heads' (the path ``bf16``); remat:
     the joint ViT-B/16 step at 4 chunks x 8 frames and a training-mode
     backbone step at dropout 0.1 (the dropout generator's masks
     replayed), each with remat against without (losses and parameters
     within 1e-6), peak memory and ms of both; the mesh: make_mesh() over
     the visible cards, sharded_masked_topk and its int8 twin over 4
     entries of cuda:0 against the flat path on phase 6's rows (with and
     without a mask, tie-aware, both timed), the sharded Collection
     against the unsharded one, a 2-entry mesh engine against the
     single-device engine on phase 4's frames (the path ``mesh``),
     ``serve --shard-device`` answering query as an unsharded daemon;
     attn_layout 'bthd' against 'bhtd' on the card; and S2's bisection of
     the bf16 heads' card-vs-CPU gap (the forward at step 0, one plain
     SGD step, one AdamW step, from equal weights and inputs; the forward
     fails the run above 2^-6 of scale, or where B moves it from its plain
     version on the card by over 2^-8);
  5j. the walkthroughs of vit_research_tpu_torch/examples/ at full width
     on the card, each through its ``main`` in this process (the path
     ``examples``): full_pipeline (the planted sides in every game's
     clips, a row for every validation clip), live_segmentation (streamed
     clips = offline = daemon), serving (daemon embeddings against the
     engine, both --follow --socket followers), sharded_search (8 entries
     of cuda:0 against the flat path), pod_embedding (two processes over
     gloo on the one card against one process's engine) and the quality
     dossier at its default size (every JAX key, parity's clip F1 1.0,
     the unstrided int8-static rows' fidelity >= 0.999; each row printed);
     then the IVF spill of phase 6's rows, loaded back and searched out of
     core, against the in-RAM IVF;
  6. a game-sized store: a seeded 200,000 x 768 cosine collection queried
     with 256 queries, k = 50, on the card in f32 and in int8, each held
     against the CPU answer of the same rows, and timed (run before 5i's
     mesh part, which takes its rows);
  7. one JSON line of kernel summaries (``launches`` sums the kernel's
     launches over the paths of phases 4-5f, ``launches_by_path`` lists
     them, ``fast`` being phase 5d's write-frame-db and segment,
     ``stage1`` phase 5e's verbs and ``rag`` phase 5f's train-rag and
     train-ratt, ``cached``, ``temporal``, ``joint`` and ``rag_vit``
     phase 5h's, ``bf16`` and ``mesh`` phase 5i's, ``examples`` phase
     5j's; the attention entry's
     ``key_bias``
     holds phase 5d's rows, ``stage1_dh96`` phase 3c's, ``grad_rel_err``
     the gradient checks and ``stage1_path`` phase 5e's numbers,
     ``rag_dh192`` phase 3d's rows and ``rag_path`` phase 5f's), then the
     result line.

Bounds (``bound_ms``) are the larger of the bytes a kernel must move
over the H100 SXM's 3.35 TB/s and its operations over the peak of the
units the work may use: the tensor cores (989 TFLOP/s bf16, 495 TF32)
for kernels A and C, whose split operands reach f32 accuracy there, and
for B in bf16; the CUDA cores (67 TFLOP/s f32) for B in f32. NVIDIA's
data-sheet figures, not measured. Beside A's and C's bounds:
``design_floor_ms`` (the same with the operations times the design's
tensor-core passes: 3 for A, 3 for C with f32 W) and
``f32_cuda_core_bound_ms`` (the operations at 67 TFLOP/s, the bound of
earlier versions, kept for comparison).

    python3 chip_smoke.py --profile

builds the kernels, then profiles the engine's forward (torch.profiler
over steady batches of ViT-B/16 @224: f32 B=256, bf16 B=512, and the
fast profile's ToMe r=16 + int8-static f32 B=256, calibrated on the
profiled frames; device time by kernel and the device's idle share) and
times the offline Viterbi
decoders at several game lengths: the host numpy loop, the log-depth scan
on the card, and a per-frame torch loop on the card; then profiles a
stage-1 training step of the full-width ChunkEncoder (B = 32, dropout 0.1
and 0).

    python3 chip_smoke.py --kernel-b

builds the kernels, then reads kernel B's bf16 P through one-hot V on
ToMe's bf16 draws and counts where it differs from the plain version's,
by cause (``probe_p``), and times kernel B where its bf16 variants and its
launch path act (``measure_kernel_b``): bf16 past one key tile at the
backbone's and other shapes beside SDPA and the bound, a sweep over T by
head width, the T <= 25 rows with host microseconds a call beside
CUDA-event and device times (and the host cost by step), the bf16 forward
at B = 512 and the bf16 engine's frames/s, and last ToMe's biased blocks,
each within ATTN_BOUND or accepted by a tie, or the run fails. Beside
the P probe's lines, each draw's tie check ("tie check T=...": the
strict error and the near-tie counts) and every tie-accepted row on a
line of its own ("accepted by a tie": its (b, h, i), strict and tie
errors, each key the tie moves with its distance from the bf16 midpoint
in f32 ulps of the sum, and each output column at a tie); one JSON line
``{"kernel_b": ...}``. Copied into another checkout of the port, it
times that checkout's kernels the same way, so two checkouts compare in
one call.

Kernel B in bf16 is held to its bf16 plain version by one tie-aware
check, ``bf16_tie_check``, each place within its own bound (ATTN_BOUND
or 2^-8 max|v|): the strict max|err| is always logged; a row beyond the
bound passes only where rounding near ties (an exact q k^T, or an exact
P V, within an f32 sum's rounding error of a bf16 midpoint) to their
other neighbour brings the whole row within the bound. The f32 checks
stay strict.

Host microseconds a call (``host_us``) stand beside the CUDA-event and
device times of every T <= 25 row of phases 3c, 3d and 5g, and the
kernels line's attention entry carries ``launches_by_kernel``: kernel B's
main-path launches by instantiation and variant.

Times are CUDA-event medians on this card unless a line says otherwise;
the nvidia-smi line says which card and power limit they belong to. The
script imports only the port (``vit_research_tpu_torch``), torch, numpy
and PIL.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import base64
import collections
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from vit_research_tpu_torch import cli, native, serve
from vit_research_tpu_torch.cli import common
from vit_research_tpu_torch.data.preprocess import load_frames
from vit_research_tpu_torch.db.builders import write_ratt_chunk_db
from vit_research_tpu_torch.db.frame_store import (
    FrameStore, gather_chunk_embedding_batch, load_chunk_index)
from vit_research_tpu_torch.models import convert, heads, hf_import
from vit_research_tpu_torch.models import vit as vit_mod
from vit_research_tpu_torch.ops import _build
from vit_research_tpu_torch.ops import attention as attn
from vit_research_tpu_torch.ops import fused_ln
from vit_research_tpu_torch.ops import patch_embed as pe
from vit_research_tpu_torch.ops import quant, tome
from vit_research_tpu_torch.ops import topk
from vit_research_tpu_torch.ops import viterbi as viterbi_ops
from vit_research_tpu_torch.parallel import embed
from vit_research_tpu_torch.segment import clips as clips_mod
from vit_research_tpu_torch.segment import clustering, hmm, knn
from vit_research_tpu_torch.store.vector_store import (Collection,
                                                       PersistentClient)
from vit_research_tpu_torch.train import checkpoint
from vit_research_tpu_torch.train import train_chunk_encoder as tce
from vit_research_tpu_torch.utils.configs import ChunkEncoderConfig
from vit_research_tpu_torch.utils.metrics import read_metrics

SPEC = embed.HF_VIT_SPEC
HF_AFFINE = dict(rescale=SPEC.rescale, mean=SPEC.mean, std=SPEC.std)
# Tolerances. f32: the kernels and the plain versions sum the same
# products in other orders, ~1e-6 on outputs of order 1. bf16 patch embed:
# one bf16 rounding of outputs < 8 (2^-5). bf16 attention, against the
# bf16 plain version of the same inputs (the JAX package's bf16 attention:
# S, S * bf16(scale), + bf16(bias) and P each rounded to bf16): the kernel
# forms P with the plain version's softmax arithmetic, so the two differ
# where q k^T or P V, summed in another order, rounds to the other bf16
# neighbour: an output falls apart by one bf16 ulp (below 1e-2 for outputs
# under 2, beyond it from 2 on), or further where a near-tie score
# carries a large P (F10); bf16_tie_check accepts a row beyond the bound
# only through such near ties.
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
# Rounds of the serve phase's embed requests (every form at every size).
EMBED_ROUNDS = 3
# H100 SXM data-sheet peaks (not measured).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12}

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


def attention_f32_scores(q, k, v, key_bias=None) -> torch.Tensor:
    """bf16 attention with f32 scores: S = q k^T * scale (+ bias) of the
    bf16 values in f32, the f32 softmax, P and the output rounded to bf16.
    Kernel B's bf16 path computed this before it rounded S as the JAX
    package does; each bf16 check of B computes it too, to show that the
    check tells it from the bf16 plain version."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    if key_bias is not None:
        s = s + key_bias[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(torch.bfloat16)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(),
                        v.float()).to(torch.bfloat16)


def bf16_attention_errs(got, q, k, v, key_bias=None, *, bound: float,
                        tells_apart: bool = False) -> dict:
    """bf16_tie_check of ``got`` (the kernel's bf16 output, or a list of
    them) against the bf16 plain version of (q, k, v, key_bias) within
    ``bound`` (``ties``; ``err`` is its strict max|err|), max|err| of
    :func:`attention_f32_scores` (``f32_scores``) and of the f32 plain
    version (``f32_plain``), with max|v| and max|S|; with ``tells_apart``
    also the tie check of the f32-score semantics (``f32_ties``)."""
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    ties = bf16_tie_check(got, qc, kc, vc, key_bias, bound=bound)
    want = attn.attention_plain(qc, kc, vc, key_bias=key_bias).float()

    def err(x):
        return (x.float() - want).abs().max().item()

    old = attention_f32_scores(qc, kc, vc, key_bias)
    s = torch.einsum("bhqd,bhkd->bhqk", qc.float(), kc.float())
    out = dict(err=ties["err"], bound=bound, ties=ties,
               f32_scores=err(old),
               f32_plain=err(attn.attention_plain(
                   qc.float(), kc.float(), vc.float(), key_bias=key_bias)),
               max_v=vc.float().abs().max().item(),
               max_s=(s.abs().max() * q.shape[-1] ** -0.5).item())
    if tells_apart:
        out["f32_ties"] = bf16_tie_check(old, qc, kc, vc, key_bias,
                                         bound=bound)
    return out


def check_bf16_attention(errs: dict, what: str, *, full: bool = True) -> str:
    """Raise unless the tie check of the kernel's bf16 output passed
    (every row within the bound of the bf16 plain version, or accepted by
    a tie) and, where bf16_attention_errs ran it (``tells_apart``), the
    f32-score semantics failed it; the log text of the errors and the
    ties (``full``: with the kernel's strict error and the bound)."""
    ties = errs["ties"]
    text = "; ".join([tie_text(ties)] + [tie_row_text(row)
                                         for row in ties["accepted"]])
    text += (f"; f32 scores {errs['f32_scores']:.3e}, f32 plain "
             f"{errs['f32_plain']:.3e}; max|S| {errs['max_s']:.1f}")
    if full:
        text = (f"max|err| {errs['err']:.3e} (bound {errs['bound']:.2e}; "
                f"{text})")
    if not ties["ok"]:
        raise AssertionError(f"bf16 attention {what}: {text}; rejected "
                             f"{ties['rejected']}")
    if "f32_ties" in errs and errs["f32_ties"]["ok"]:
        raise AssertionError(f"bf16 attention {what}: the check cannot tell "
                             f"f32 scores apart: {text}")
    return text


# The tie-aware bf16 comparison (F10). The bf16 plain version rounds each
# q k^T, an f32 sum, to bf16, and each output, the f32 sum P V, to bf16;
# the JAX package's bf16 attention does the same without fixing the order
# of either sum. Where an exact sum lies within its f32 sum's rounding
# error of a bf16 rounding midpoint (a near tie), either neighbour is what
# the reference computes. A kernel row beyond the bound is accepted only
# where some choice among those neighbours, for its near-tie scores and
# for its outputs, brings every column of the row within the same bound.
U_F32, U_F64 = 2.0 ** -24, 2.0 ** -53
# near-tie keys a row enumerates (2^TIE_CAP choices): the row's most
# influential ones (the plain P at the key times the score's range); the
# others keep the plain score. delta is a worst-case bound: at dh = 64
# some 6% of unit-normal scores are near ties, 12 in a row of 197 keys.
TIE_CAP = 12


def _gamma(n: int, u: float) -> float:
    """The relative error bound of a sum of n terms in any order at unit
    roundoff u (Higham's gamma_n)."""
    return n * u / (1 - n * u)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f64 ``x`` correctly rounded to bf16 (nearest, ties to even), in
    f64. (torch converts f64 to bf16 through f32: a double rounding.)"""
    _, e = torch.frexp(x)  # x = m 2^e, 1/2 <= |m| < 1
    step = torch.ldexp(torch.ones_like(x), e - 8)  # bf16: 8 bits
    lo = torch.floor(x / step) * step
    mid = lo + step / 2
    even = torch.remainder(lo / step, 2) == 0
    return torch.where(x > mid, lo + step, torch.where(
        x < mid, lo, torch.where(even, lo, lo + step)))


def _f32_sum_range(exact, mag, n: int) -> dict:
    """What an f32 sum of n exact products (bf16 times bf16), summing to
    ``exact`` (f64) with sum|products| ``mag``, may round to in bf16 in
    any order: ``s`` (the correctly rounded exact sum), ``lo`` <= s <=
    ``hi``, the roundings of exact -+ delta, and ``near``, where they
    differ (a near tie: a bf16 rounding midpoint lies within delta of the
    exact sum; lo and hi are then its two neighbours, or, for a sum that
    cancels to below delta's scale, the ends of the values it may round
    to), with ``ulps``, |exact - (lo + hi) / 2| in f32 ulps of the sum."""
    # An f32 sum of n terms in any order lies within gamma_n sum|terms| of
    # the exact sum. Tensor cores accumulate by truncation, not by
    # round-to-nearest: an add may lose a whole ulp, not half of one, hence
    # twice the bound. The f64 sum's own error is added to it.
    delta = (2 * _gamma(n, U_F32) + _gamma(n, U_F64)) * mag
    lo, hi = _bf16_round(exact - delta), _bf16_round(exact + delta)
    _, e = torch.frexp(exact)
    return dict(exact=exact, s=_bf16_round(exact), lo=lo, hi=hi,
                near=lo != hi, ulps=(exact - (lo + hi) / 2).abs()
                / torch.ldexp(torch.ones_like(exact), e - 24))


def exact_scores(q, k) -> dict:
    """q k^T of bf16 (B, H, T, dh) q and k, exactly (f64), and what an f32
    sum of it may round to in bf16 (_f32_sum_range; ``s`` is S*); all f64
    (B, H, T, T)."""
    qd, kd = q.double(), k.double()
    return _f32_sum_range(torch.einsum("bhqd,bhkd->bhqk", qd, kd),
                          torch.einsum("bhqd,bhkd->bhqk", qd.abs(),
                                       kd.abs()), q.shape[-1])


def exact_outputs(p, v) -> dict:
    """P V of bf16 P (B, H, T, T) and v (B, H, T, dh), exactly (f64), and
    what an f32 sum of it may round to in bf16 (_f32_sum_range); all f64
    (B, H, T, dh)."""
    pd, vd = p.double(), v.double()
    return _f32_sum_range(torch.einsum("bhqk,bhkd->bhqd", pd, vd),
                          torch.einsum("bhqk,bhkd->bhqd", pd.abs(),
                                       vd.abs()), p.shape[-1])


def scores_softmax(s, key_bias, scale: float) -> tuple:
    """attention_plain from its bf16 q k^T ``s`` (B, H, T, T) on: s *
    bf16(scale) and + bf16(key_bias), each rounded to bf16, and the f32
    softmax, before attention_plain rounds it to P."""
    s = s * attn.weak_scalar(scale, s.dtype)
    if key_bias is not None:
        s = s + key_bias[:, None, None, :].to(s.dtype)
    return s, torch.softmax(s.to(torch.float32), dim=-1)


def _self_check(what: str, plain, ex: dict, b0: int) -> None:
    """The plain version's bf16 sums (``plain``) against their ranges:
    equal to the correctly rounded sum off the near-tie set, within [lo,
    hi] on it; else delta or the exact sum is wrong, and this raises."""
    plain = plain.double()
    off = torch.where(ex["near"], (plain < ex["lo"]) | (plain > ex["hi"]),
                      plain != ex["s"])
    if off.any():
        at = tuple(int(x) for x in torch.nonzero(off)[0])
        raise AssertionError(
            f"tie check: {int(off.sum())} plain {what} are neither the "
            f"correctly rounded sum nor within a near tie's range, first at "
            f"{(at[0] + b0, *at[1:])}: plain {plain[at].item()!r}, exact "
            f"{ex['exact'][at].item()!r}")


def bf16_tie_check(got, q, k, v, key_bias=None, *, bound: float,
                   scale=None) -> dict:
    """Kernel B's bf16 output ``got`` (or a list of outputs of the same
    inputs) against the bf16 plain version of (q, k, v, key_bias, scale),
    tie-aware. ``err``: the strict max|got - attention_plain| over the
    tensor. In batch chunks, the exact scores and the exact outputs of
    the plain P (exact_scores, exact_outputs) give the near-tie sets,
    counted in ``near_ties`` of ``n_scores`` and ``output_ties`` of
    ``n_outputs``; the plain version's own bf16 q k^T and output must lie
    in their ranges (_self_check, which raises). Every (b, h, i) row with
    a column beyond ``bound`` (counted in ``over_rows``) goes to
    :func:`_tie_row`: accepted by a tie, it joins ``accepted``; else the
    check fails (``ok`` False, ``rejected`` that row; later rows over the
    bound are not examined, the counts still are)."""
    gots = list(got) if isinstance(got, (list, tuple)) else [got]
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    b, h, t, dh = qc.shape
    scale = dh ** -0.5 if scale is None else scale
    # attention_plain's own steps, which it takes in this order
    raw = torch.einsum("bhqd,bhkd->bhqk", qc, kc)
    p = scores_softmax(raw, key_bias, scale)[1].to(qc.dtype)
    want = torch.einsum("bhqk,bhkd->bhqd", p, vc)
    row_errs = [(x.float() - want.float()).abs().amax(-1) for x in gots]
    out = dict(err=max(r.max().item() for r in row_errs), bound=bound,
               n_scores=raw.numel(), near_ties=0, n_outputs=want.numel(),
               output_ties=0,
               over_rows=sum(int((~(r <= bound)).sum()) for r in row_errs),
               accepted=[], rejected=None, ok=True)
    chunk = max(1, 2 ** 24 // (h * t * t))
    for b0 in range(0, b, chunk):
        sl = slice(b0, b0 + chunk)
        ex = exact_scores(qc[sl], kc[sl])
        _self_check("scores", raw[sl], ex, b0)
        eo = exact_outputs(p[sl], vc[sl])
        _self_check("outputs", want[sl], eo, b0)
        out["near_ties"] += int(ex["near"].sum())
        out["output_ties"] += int(eo["near"].sum())
        del eo
        over = [(n, at) for n, r in enumerate(row_errs)
                for at in torch.nonzero(~(r[sl] <= bound)).tolist()]
        for n, (bi, hh, i) in over:
            if not out["ok"]:
                break
            row = _tie_row(gots[n][b0 + bi, hh, i].float(),
                           want[b0 + bi, hh, i].float(),
                           {key: x[bi, hh, i] for key, x in ex.items()},
                           raw[b0 + bi, hh, i], vc[b0 + bi, hh],
                           None if key_bias is None
                           else key_bias[b0 + bi:b0 + bi + 1],
                           scale, bound)
            row.update(b=b0 + bi, h=hh, i=i, err=row_errs[n][b0 + bi, hh, i]
                       .item(), **({"out": n} if len(gots) > 1 else {}))
            if row.pop("fits"):
                out["accepted"].append(row)
            else:
                out.update(ok=False, rejected=row)
    return out


def _tie_row(got_row, want_row, ex: dict, plain_row, v, key_bias,
             scale: float, bound: float) -> dict:
    """One row of bf16_tie_check over the bound (``ex``: its exact_scores
    row), recomputed as attention_plain computes it for each of the 2^m
    choices over its m <= TIE_CAP most influential near-tie keys (of
    ``n_ties``): each keeps the plain version's bf16 score or takes the
    other neighbour of its midpoint (of lo and hi, the one farther from the
    plain score); every other key keeps the plain score (S* off the
    near-tie set, within its range on it). Each choice's P V may round to any value in its
    exact_outputs range. ``fits`` if for some choice every column lies
    within ``bound`` of its range; of those, the choice that moves the
    fewest keys, then lies nearest (``tie_err``, the distance), with
    ``keys``, each key it moves (its ulps from the midpoint, the exact q
    k^T, the plain and the tie's bf16 score, the plain P there and max|v|
    of the key), and ``cols``, each column beyond the bound of the plain
    output ``want_row`` whose P V is a near tie under that choice (its
    ulps from the midpoint, the exact P V, the plain output, got and the
    range)."""
    plain = plain_row.double()
    _, pp = scores_softmax(plain_row[None, None, None], key_bias, scale)
    pp = pp[0, 0, 0]
    keys = torch.nonzero(ex["near"]).flatten()
    n = len(keys)
    reach = pp[keys].double() * (ex["hi"] - ex["lo"])[keys]
    keys = keys[torch.argsort(reach, descending=True)[:TIE_CAP]]
    m = len(keys)
    lo, hi = ex["lo"][keys], ex["hi"][keys]
    other = torch.where((hi - plain[keys]).abs() >= (plain[keys] - lo).abs(),
                        hi, lo)
    moved = (torch.arange(2 ** m, device=keys.device)[:, None]
             >> torch.arange(m, device=keys.device)) & 1 == 1  # (C, m)
    s = plain.repeat(2 ** m, 1)
    s[:, keys] = torch.where(moved, other, plain[keys])
    # every value a bf16 one: the conversion is exact
    p32 = scores_softmax(s.to(torch.bfloat16)[None, None], key_bias,
                         scale)[1]
    eo = exact_outputs(p32.to(v.dtype), v[None, None])
    eo = {key: x[0, 0] for key, x in eo.items()}  # (C, dh)
    got = got_row.double()
    dist = ((eo["lo"] - got).clamp(min=0) + (got - eo["hi"]).clamp(min=0)
            ).amax(-1)
    flips = moved.sum(-1)
    fits = dist <= bound
    if not fits.any():
        return dict(fits=False, n_ties=n, tie_err=dist.min().item())
    c = int(torch.where(fits, flips + dist / bound / 2, math.inf).argmin())
    cols = torch.nonzero(eo["near"][c] & ((got_row - want_row).abs() > bound)
                         ).flatten()
    return dict(fits=True, n_ties=n, tie_err=dist[c].item(), keys=[
        dict(key=j, ulps=ex["ulps"][j].item(), exact=ex["exact"][j].item(),
             plain=plain[j].item(), tie=s[c, j].item(),
             p_plain=pp[j].item(), max_v=v[j].float().abs().max().item())
        for j, mv in zip(keys.tolist(), moved[c].tolist()) if mv], cols=[
        dict(col=j, ulps=eo["ulps"][c, j].item(),
             exact=eo["exact"][c, j].item(), plain=want_row[j].item(),
             got=got[j].item(), lo=eo["lo"][c, j].item(),
             hi=eo["hi"][c, j].item())
        for j in cols.tolist()])


def tie_summary(ties: dict) -> dict:
    """A tie check's counts and accepted rows, for the JSON lines."""
    return {key: ties[key] for key in ("near_ties", "n_scores",
                                       "output_ties", "n_outputs",
                                       "over_rows", "accepted")}


def tie_text(ties: dict) -> str:
    """A tie check's counts: the near-tie sets, the rows over the bound and
    those a tie accepted."""
    return (f"near ties {ties['near_ties']} of {ties['n_scores']} scores "
            f"and {ties['output_ties']} of {ties['n_outputs']} outputs, "
            f"{ties['over_rows']} rows over the bound, "
            f"{len(ties['accepted'])} accepted by a tie")


def tie_row_text(row: dict) -> str:
    """A tie-accepted row: its place, strict and tie errors, each key the
    tie moves (ulps from the midpoint in f32 ulps of the sum, the exact q
    k^T, the plain and the tie's bf16 score, the plain P, max|v|) and each
    output that only its rounding range brings within the bound."""
    parts = [f"key {key['key']} ({key['ulps']:.3g} ulps: q k^T "
             f"{key['exact']!r}, plain {key['plain']!r} tie {key['tie']!r}, "
             f"P {key['p_plain']:.4g}, max|v| {key['max_v']:.3g})"
             for key in row["keys"]]
    parts += [f"output column {col['col']} ({col['ulps']:.3g} ulps: P V "
              f"{col['exact']!r} may round to [{col['lo']!r}, "
              f"{col['hi']!r}]; plain {col['plain']!r}, got {col['got']!r})"
              for col in row["cols"]]
    return (f"row (b, h, i) = ({row['b']}, {row['h']}, {row['i']}) strict "
            f"{row['err']:.4g}, tie {row['tie_err']:.4g} through "
            + ", ".join(parts))


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


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call: time.perf_counter_ns around ``calls``
    back-to-back calls after a warm-up call, before any synchronize (what
    the caller's thread spends; at T <= 25 each call's host work outlasts
    its kernel, so the card's queue never fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def b_variants(fn) -> tuple:
    """(fn(), the names kernel B's launches of that call counted under in
    launches_by_kernel: its instantiation and variant, comma-joined)."""
    counter = attn.multi_head_attention.launches_by_kernel
    before = counter.copy()
    out = fn()
    return out, ",".join(sorted(counter - before))


def bound(nbytes: float, flops: float, peak: str,
          passes: int | None = None) -> dict:
    """The least time the card could take: bytes over HBM bandwidth
    against operations over the peak of ``peak``'s units. With
    ``passes``, also the design's own floor (``passes`` times the
    operations) and the bound on the f32 CUDA cores."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[peak] * 1e3
    out = dict(bound_ms=max(by_bytes, by_ops),
               bound_by="bytes" if by_bytes >= by_ops else "operations")
    if passes is not None:
        out.update(design_floor_ms=max(by_bytes, passes * by_ops),
                   f32_cuda_core_bound_ms=max(
                       by_bytes, flops / PEAK_FLOPS["f32"] * 1e3))
    return out


def bound_text(lim: dict) -> str:
    text = f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']})"
    if "design_floor_ms" in lim:
        text += (f", design floor {lim['design_floor_ms']:.4f} ms, f32 "
                 f"CUDA-core bound {lim['f32_cuda_core_bound_ms']:.4f} ms")
    return text


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
    for source in ("attention.cu", "patch_embed.cu", "fused_ln.cu"):
        log_ptxas(source)
    return smi


def _demangle(names: list) -> list:
    """C++ names through the toolkit's cu++filt, shortened to the kernel
    and its template arguments; the mangled names if that fails."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    try:
        out = subprocess.run([tool], input="\n".join(names), text=True,
                             capture_output=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    if len(out) != len(names):
        return names
    short = []
    for name in out:
        name = name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ")
        depth = 0
        for i, ch in enumerate(name):
            depth += {"<": 1, ">": -1}.get(ch, 0)
            if ch == "(" and depth == 0:
                name = name[:i]
                break
        short.append(name)
    return short


def _ptxas_lines(source: str, needle: str) -> list:
    """ptxas's registers and spills of the kernels of ``source`` whose
    mangled name holds ``needle``."""
    rows, name, spills = [], "?", ""
    for line in _build.ptxas_report(source):
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif "spill" in line:
            spills = line
        elif "registers" in line and needle in name:
            rows.append((name, line.split(":", 1)[1].strip(), spills))
    return [f"{short}: {used}; {spill}" for short, (_, used, spill) in
            zip(_demangle([r[0] for r in rows]), rows)]


def log_ptxas(source: str) -> None:
    """One line per kernel of ``source``: ptxas's registers, shared
    memory (static; dynamic shared memory is set at launch) and spills."""
    for line in _ptxas_lines(source, ""):
        log(f"[1] ptxas {source} {line}")


# (B, H, W, P, output dtypes): the main path's B=256 and the bf16
# engine's B=512 (bf16 out) carry the summaries.
PE_CASES = [(64, 224, 224, 16, (torch.float32, torch.bfloat16)),
            (BATCH, 224, 224, 16, (torch.float32, torch.bfloat16)),
            (16, 432, 768, 32, (torch.float32, torch.bfloat16)),
            (512, 224, 224, 16, (torch.bfloat16,))]


def phase_patch_embed(smi: str) -> dict:
    """Kernel A on uint8 frames against its plain version; the B=256 f32
    summary with the bf16 engine's (B=512, bf16 out) under "bf16"."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    summary = {}
    for b, h, w, p, out_dtypes in PE_CASES:
        k = p * p * 3
        images = torch.from_numpy(rng.integers(
            0, 256, size=(b, h, w, 3), dtype=np.uint8)).to(dev)
        wt = torch.from_numpy((rng.standard_normal((k, 768)) * k ** -0.5)
                              .astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.standard_normal(768).astype(
            np.float32)).to(dev)
        a_vec, b_vec = (torch.from_numpy(x).to(dev)
                        for x in pe.fold_affine(p, **HF_AFFINE))
        for out_dtype in out_dtypes:
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
            m = got.shape[0] * got.shape[1]
            lim = bound(images.numel() + wt.numel() * 4 + 768 * 4
                        + m * 768 * got.element_size(), 2 * m * k * 768,
                        "bf16", passes=3)
            name = str(out_dtype).split(".")[-1]
            log(f"[2] patch_embed u8 B={b} {h}x{w} P={p} out={name}: "
                f"max|err| {err:.3e} (bound {bound_err:.1e}) | kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {bound_text(lim)} "
                f"| {smi}")
            if not err <= bound_err:
                raise AssertionError(f"patch_embed kernel disagrees: {err}")
            del got, want
            key = {(BATCH, 16, torch.float32): "f32",
                   (512, 16, torch.bfloat16): "bf16"}.get((b, p, out_dtype))
            if key:
                summary[key] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, **lim,
                    library_ms=_conv_patch_embed_ms(
                        images, wt, bias, a_vec, b_vec, p, smi, out_dtype))
        del images
        torch.cuda.empty_cache()
    return dict(summary["f32"], bf16=summary["bf16"])


def _conv_patch_embed_ms(images, wt, bias, a_vec, b_vec, p, smi,
                         dtype) -> float:
    """No single PyTorch call takes uint8 NHWC through the affine and the
    projection; the nearest is F.conv2d (stride = kernel = P, TF32 off)
    over the already-normalised NCHW batch in ``dtype`` (the kernel's
    output dtype: f32, or bf16 batch, weight and bias for the bf16
    engine), timed here. It must compute the same function: within
    PE_BOUND of the f32 plain version in f32; in bf16 within 2^-5 of its
    largest output (its inputs are rounded to bf16, the kernel's are
    not)."""
    import torch.nn.functional as F

    c = images.shape[-1]
    want = pe.patch_embed_plain(images, wt, bias, a_vec, b_vec, patch_size=p)
    nchw = (images.float() * a_vec[:c] - b_vec[:c]).permute(0, 3, 1, 2) \
        .contiguous().to(dtype)
    cw = wt.reshape(p, p, c, -1).permute(3, 2, 0, 1).contiguous().to(dtype)
    cb = bias.to(dtype)

    def conv():
        return F.conv2d(nchw, cw, cb, stride=p)

    err = (conv().float().flatten(2).transpose(1, 2).reshape(want.shape)
           - want).abs().max().item()
    tol = PE_BOUND[torch.float32] if dtype == torch.float32 else \
        2 ** -5 * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"conv2d computes another function: {err}")
    del want
    ms = cuda_ms(conv)
    name = str(dtype).split(".")[-1]
    log(f"[2] library: F.conv2d over the normalised {name} NCHW batch (no "
        f"single call takes uint8 NHWC), B={images.shape[0]}: {ms:.4f} ms "
        f"(max|err| {err:.3e} against the f32 plain version, bound "
        f"{tol:.3e}) | {smi}")
    del nchw
    return ms


def phase_attention(smi: str) -> dict:
    """Kernel B at the backbone's shapes, in f32 and bf16: on contiguous
    (B, H, T, dh) inputs and on the views of (B, T, H, dh) tensors that the
    projections give, each held against the plain version of the same
    values; timed against the plain version and SDPA (contiguous inputs).
    Returns the f32 summary at T = 197 with the bf16 one under "bf16",
    and the f32 row of ``smoke``'s frame (B = 1, T = 313: the P = 32
    backbone at 432x768) under "smoke_t313"."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    summary = {}
    for b, t in ((BATCH, 197), (BATCH, 325), (32, 1297), (1, 313)):
        # projection order (B, T, H, dh), as the backbone's q/k/v
        q32, k32, v32 = (torch.randn(b, t, 12, 64, generator=g).to(dev)
                         for _ in range(3))
        for dtype in (torch.float32, torch.bfloat16):
            views = [x.to(dtype).transpose(1, 2) for x in (q32, k32, v32)]
            contig = [x.contiguous() for x in views]
            f32 = dtype == torch.float32
            # f32 against the f32 plain version; bf16 against the bf16
            # plain version (bf16_attention_errs, after both layouts)
            want = attn.attention_plain(*contig) if f32 else None
            name = str(dtype).split(".")[-1]
            bound_err = ATTN_BOUND[dtype]
            row, outs = {}, []
            for layout, (q, k, v) in (("contiguous", contig),
                                      ("projection order", views)):
                got, variant = b_variants(
                    lambda: attn.multi_head_attention(q, k, v))
                torch.cuda.synchronize()
                ms = cuda_ms(lambda: attn.multi_head_attention(q, k, v))
                if f32:
                    err = (got - want).abs().max().item()
                    log(f"[3] attention B={b} H=12 T={t} dh=64 {name} "
                        f"{layout}: max|err| {err:.3e} (bound "
                        f"{bound_err:.1e}) | kernel {ms:.4f} ms | {smi}")
                    if not err <= bound_err:
                        raise AssertionError(f"attention kernel disagrees "
                                             f"({layout}): {err}")
                else:
                    outs.append(got)
                    log(f"[3] attention B={b} H=12 T={t} dh=64 {name} "
                        f"{layout}: kernel {variant} {ms:.4f} ms | {smi}")
                    err = None
                row[layout] = (err, ms)
                del got
            if not f32:
                # the backbone's shape must tell f32 scores apart
                errs = bf16_attention_errs(
                    outs, *contig, bound=bound_err,
                    tells_apart=(b, t) == (BATCH, 197))
                log(f"[3] attention B={b} H=12 T={t} dh=64 bf16 ({variant}) "
                    f"against the bf16 plain version, both layouts: " +
                    check_bf16_attention(errs, f"B={b} T={t}"))
                row = {key: (errs["err"], ms) for key, (_, ms) in row.items()}
                summary.setdefault("bf16_rows", {})[f"B{b}_T{t}"] = dict(
                    launched=variant, max_abs_err=errs["err"],
                    **tie_summary(errs["ties"]),
                    ms=row["contiguous"][1],
                    ms_projection_order=row["projection order"][1])
                del outs
            del want
            q, k, v = contig
            plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v))
            log(f"[3] attention B={b} H=12 T={t} dh=64 {name}: plain "
                f"{plain_ms:.4f} ms | {smi}")
            if t == 313 and dtype == torch.float32:
                lim = bound(4 * q.numel() * 4, 4 * b * 12 * t * t * 64, "f32")
                summary["smoke_t313"] = dict(
                    max_abs_err=max(e for e, _ in row.values()),
                    ms=row["contiguous"][1],
                    ms_projection_order=row["projection order"][1],
                    device_ms=_device_ms(
                        lambda: attn.multi_head_attention(q, k, v)),
                    plain_ms=plain_ms, library_ms=cuda_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v)),
                    **lim)
                log(f"[3] smoke's frame, B=1 T=313: device "
                    f"{_ms(summary['smoke_t313']['device_ms'])} ms; SDPA "
                    f"{summary['smoke_t313']['library_ms']:.4f} ms; "
                    f"{bound_text(lim)} | {smi}")
            if t == 197:
                sdpa_ms = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v))
                lim = bound(4 * q.numel() * q.element_size(),
                            4 * b * 12 * t * t * 64,
                            "f32" if dtype == torch.float32 else "bf16")
                log(f"[3] library: F.scaled_dot_product_attention B={b} "
                    f"T={t} {name}: {sdpa_ms:.4f} ms; bound "
                    f"{lim['bound_ms']:.4f} ms ({lim['bound_by']}) | {smi}")
                summary[name] = dict(
                    max_abs_err=max(e for e, _ in row.values()),
                    ms=row["contiguous"][1],
                    ms_projection_order=row["projection order"][1],
                    plain_ms=plain_ms, library_ms=sdpa_ms, **lim)
                if not f32:
                    summary[name].update(
                        max_abs_err_f32_scores=errs["f32_scores"],
                        max_abs_err_f32_plain=errs["f32_plain"])
            if not f32:
                summary["bf16_rows"][f"B{b}_T{t}"].update(
                    plain_ms=plain_ms, **(dict(library_ms=sdpa_ms, **lim)
                                          if t == 197 else {}))
            del views, contig, q, k, v
        del q32, k32, v32
        torch.cuda.empty_cache()
    summary["bfloat16"]["t197_large_scores"] = _large_scores_case(
        BATCH, 197, 12, 64, "3", g)
    summary["bfloat16"]["rows"] = summary.pop("bf16_rows")
    summary["bfloat16"]["launched"] = \
        summary["bfloat16"]["rows"][f"B{BATCH}_T197"]["launched"]
    return dict(summary["float32"], bf16=summary["bfloat16"],
                smoke_t313=summary["smoke_t313"])


# q and k scaled so that the scores reach those of trained heads (max|S|
# 10 to 25; unit-normal q and k give 3 to 7).
LARGE_QK = 2.0
# Over several key tiles (T > 64) with large scores: an S that sits on a
# bf16 rounding boundary rounds apart between the kernel's sums and
# cuBLAS's (a few in 10^4 scores), and a rounding step of a score near 20
# moves its probability by ~10%, so the few outputs that a row with such
# a score feeds fall apart by more than an ulp: held to 2^-6 max|v|
# (2^-6.9 measured at B = 256, T = 197, max|S| 25).
LONG_ROWS_BOUND = 2 ** -6


# Stage 1's chunk encoder (768 wide, 8 heads): B = 256 chunks of 8 frames
# + CLS (T = 9) and of 24 + CLS (T = 25, max_len), and the training batch
# of 32 chunks (T = 9; phase 5i's bf16 steps).
STAGE1_HEADS, STAGE1_DH, STAGE1_B = 8, 96, 256


def phase_attention_stage1(smi: str) -> dict:
    """Kernel B at the stage-1 chunk encoder's shapes (dh = 96, H = 8, B =
    256 at T = 9 and 25, B = 32 at T = 9; f32 and bf16), on contiguous
    inputs and on
    projection-order views, each against the plain version of the same
    values; timed against the plain version and SDPA. The 64-row query
    tile holds T rows: at T = 9, 86% of it is idle."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    h, dh = STAGE1_HEADS, STAGE1_DH
    rows = {}
    for b, t in ((STAGE1_B, 9), (STAGE1_B, 25), (STAGE1_BATCH, 9)):
        q32, k32, v32 = (torch.randn(b, t, h, dh, generator=g).to(dev)
                         for _ in range(3))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            views = [x.to(dtype).transpose(1, 2) for x in (q32, k32, v32)]
            contig = [x.contiguous() for x in views]
            f32 = dtype == torch.float32
            # bf16, against the bf16 plain version: an output that falls
            # apart by one ulp (2^-8 of |o| <= max|v|), so the bound scales
            # with v: averages of only 9 values are not small
            bound_err = ATTN_BOUND[dtype] if f32 else \
                2 ** -8 * contig[2].float().abs().max().item()
            row, outs = {}, []
            for layout, (q, k, v) in (("contiguous", contig),
                                      ("projection order", views)):
                got, variant = b_variants(
                    lambda: attn.multi_head_attention(q, k, v))
                torch.cuda.synchronize()
                ms = cuda_ms(lambda: attn.multi_head_attention(q, k, v))
                err = None
                if f32:
                    err = (got - attn.attention_plain(*contig)).abs().max() \
                        .item()
                    if not err <= bound_err:
                        raise AssertionError(f"attention kernel dh=96 T={t} "
                                             f"{name} {layout}: {err}")
                outs.append(got)
                row[layout] = (err, ms)
            errs_text = ""
            if not f32:
                errs = bf16_attention_errs(outs, *contig, bound=bound_err)
                errs_text = "; " + check_bf16_attention(
                    errs, f"dh=96 B={b} T={t}", full=False)
                row = {key: (errs["err"], ms) for key, (_, ms) in row.items()}
            del outs
            q, k, v = contig
            plain_ms = cuda_ms(lambda: attn.attention_plain(q, k, v))
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            host = dict(
                host_us=host_us(lambda: attn.multi_head_attention(q, k, v)),
                library_host_us=host_us(
                    lambda: F.scaled_dot_product_attention(q, k, v)))
            lim = bound(4 * q.numel() * q.element_size(),
                        4 * b * h * t * t * dh,
                        "f32" if dtype == torch.float32 else "bf16")
            idle = 1 - t / 64
            log(f"[3c] attention B={b} H={h} T={t} dh={dh} {name}: max|err| "
                f"{max(e for e, _ in row.values()):.3e} (bound "
                f"{bound_err:.2e}{errs_text}) | kernel {variant} "
                f"{row['contiguous'][1]:.4f} ms "
                f"(projection order {row['projection order'][1]:.4f}; host "
                f"{host['host_us']:.2f} us a call) | "
                f"plain {plain_ms:.4f} ms | SDPA {sdpa_ms:.4f} ms (host "
                f"{host['library_host_us']:.2f} us) | "
                f"{bound_text(lim)} | query tile {100 * idle:.0f}% idle | "
                f"{smi}")
            key = f"T{t}_" if b == STAGE1_B else f"B{b}_T{t}_"
            rows[key + name] = dict(
                max_abs_err=max(e for e, _ in row.values()),
                ms=row["contiguous"][1],
                ms_projection_order=row["projection order"][1],
                plain_ms=plain_ms, library_ms=sdpa_ms, launched=variant,
                query_tile_idle=idle, **host, **lim)
            if not f32:
                rows[key + name].update(
                    max_abs_err_f32_scores=errs["f32_scores"],
                    max_abs_err_f32_plain=errs["f32_plain"])
            del views, contig, q, k, v
        del q32, k32, v32
    torch.cuda.empty_cache()
    for b in (STAGE1_B, STAGE1_BATCH):
        rows[f"B{b}_T9_bfloat16_large_scores"] = _large_scores_case(
            b, 9, h, dh, "3c", g)
    return rows


def _large_scores_case(b: int, t: int, h: int, dh: int, tag: str,
                       g: torch.Generator) -> dict:
    """The bf16 kernel with the scores of a trained head (q and k scaled by
    LARGE_QK: max|S| >= 10, checked), with and without a key bias, in
    projection order, against the bf16 plain version. In one key tile (T
    <= 64, the heads' shapes) within 2^-8 max|v|, while the f32-score
    semantics is not (a score's bf16 rounding moves a probability by up
    to 2^-9 |S|, 2% at |S| = 10); past it within LONG_ROWS_BOUND of
    max|v|, the residual logged."""
    dev = torch.device("cuda")
    q, k, v = ((torch.randn(b, t, h, dh, generator=g) * scale).to(
        dev, torch.bfloat16).transpose(1, 2)
        for scale in (LARGE_QK, LARGE_QK, 1.0))
    bias = torch.log(torch.randint(1, 9, (b, t), generator=g).float()).to(dev)
    one_tile = t <= 64
    out = {}
    bound_err = (2 ** -8 if one_tile else LONG_ROWS_BOUND) \
        * v.float().abs().max().item()
    for kb in (None, bias):
        errs = bf16_attention_errs(attn.multi_head_attention(
            q, k, v, key_bias=kb), q, k, v, kb, bound=bound_err,
            tells_apart=one_tile)
        with_kb = " + key bias" if kb is not None else ""
        what = f"B={b} H={h} T={t} dh={dh} bf16{with_kb}, large scores"
        if not errs["max_s"] >= 10:
            raise AssertionError(f"{what}: max|S| {errs['max_s']:.2f} < 10")
        log(f"[{tag}] attention {'' if one_tile else 'T > 64 residual, '}"
            f"{what}: " + check_bf16_attention(errs, what))
        out["bias" if kb is not None else "plain"] = errs
    del q, k, v, bias
    torch.cuda.empty_cache()
    return out


# Head widths other than the compiled ones (F4): dh = 128 natively (768
# wide with 6 heads), 80 (ViT-H/14's 1,280 / 16) and 48 (768 / 16)
# zero-padded to 96 and 64, each at B = 32, T = 9 and 197; dh = 256 (512
# wide with 2 heads) through EncoderBlock, on the plain route.
F4_CASES = ((128, 6), (80, 16), (48, 16))


def phase_attention_widths(smi: str) -> dict:
    """Kernel B at head widths the reference runs beyond the backbone's
    and the heads' (F4): dh = 128 on its own instantiation, 80 and 48
    zero-padded to the next compiled width (the wrapper's copies timed
    apart, ``padded_launches`` counted), f32 and bf16, each against the
    plain version of the same values under ATTN_BOUND, with SDPA's time
    and the bound; then an EncoderBlock at dh = 256 on the card against
    the CPU, on the plain route (no launch)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(12)
    b = 32
    rows = {}
    for dh, h in F4_CASES:
        width = attn.kernel_head_dim(dh)
        for t in (9, 197):
            q32, k32, v32 = (torch.randn(b, t, h, dh, generator=g).to(dev)
                             for _ in range(3))
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                q, k, v = (x.to(dtype).transpose(1, 2)
                           for x in (q32, k32, v32))
                bound_err = ATTN_BOUND[dtype] if dtype == torch.float32 \
                    else 2 ** -8 * v.float().abs().max().item()
                launches = attn.multi_head_attention.launches
                padded = attn.multi_head_attention.padded_launches
                got, variant = b_variants(
                    lambda: attn.multi_head_attention(q, k, v))
                torch.cuda.synchronize()
                n_launch = attn.multi_head_attention.launches - launches
                n_pad = attn.multi_head_attention.padded_launches - padded
                errs_text = ""
                if dtype == torch.float32:
                    err = (got - attn.attention_plain(q, k, v)).abs().max() \
                        .item()
                else:  # against the bf16 plain version
                    errs = bf16_attention_errs(got, q, k, v, bound=bound_err)
                    err = errs["err"]
                    errs_text = "; " + check_bf16_attention(
                        errs, f"dh={dh} T={t}", full=False)
                if not ((err <= bound_err or dtype == torch.bfloat16)
                        and got.shape == q.shape
                        and (n_launch, n_pad) == (1, int(width != dh))):
                    raise AssertionError(
                        f"attention kernel dh={dh} T={t} {name}: max|err| "
                        f"{err} (bound {bound_err}), {n_launch} launches, "
                        f"{n_pad} padded")
                ms = cuda_ms(lambda: attn.multi_head_attention(q, k, v))
                pad_ms = cuda_ms(lambda: [attn.pad_head_dim(x, width)
                                          for x in (q, k, v)]) \
                    if width != dh else 0.0
                qc, kc, vc = (x.contiguous() for x in (q, k, v))
                plain_ms = cuda_ms(lambda: attn.attention_plain(qc, kc, vc))
                sdpa_ms = cuda_ms(
                    lambda: F.scaled_dot_product_attention(qc, kc, vc))
                lim = bound(4 * q.numel() * q.element_size(),
                            4 * b * h * t * t * dh,
                            "f32" if dtype == torch.float32 else "bf16")
                log(f"[3c] F4 attention B={b} H={h} T={t} dh={dh}"
                    f"{'' if width == dh else f' (padded to {width})'} "
                    f"{name}: max|err| {err:.3e} (bound {bound_err:.2e}"
                    f"{errs_text}) | kernel {variant} "
                    f"{ms:.4f} ms (padding copies {pad_ms:.4f}) | "
                    f"plain {plain_ms:.4f} ms | SDPA {sdpa_ms:.4f} ms | "
                    f"{bound_text(lim)} | padded_launches +{n_pad} | {smi}")
                rows[f"dh{dh}_T{t}_{name}"] = dict(
                    max_abs_err=err, ms=ms, padding_ms=pad_ms,
                    launched=variant,
                    plain_ms=plain_ms, library_ms=sdpa_ms,
                    padded=width != dh, **lim)
                del q, k, v, qc, kc, vc, got
            del q32, k32, v32
    torch.cuda.empty_cache()

    # dh = 256: the block routes it to the plain path by its named rule
    torch.manual_seed(3)
    host = vit_mod.EncoderBlock(512, 2, 1024).eval()
    card = vit_mod.EncoderBlock(512, 2, 1024).to(dev).eval()
    card.load_state_dict(host.state_dict())
    x = torch.randn(b, 197, 512, generator=g)
    launches = attn.multi_head_attention.launches
    with torch.no_grad():
        got = card(x.to(dev))[0].cpu()
        want = host(x)[0]
    n_launch = attn.multi_head_attention.launches - launches
    err = float((got - want).abs().max() / want.abs().max())
    log(f"[3c] F4 EncoderBlock 512 wide, 2 heads (dh = 256, "
        f"head_too_wide_for_kernel: {vit_mod.head_too_wide_for_kernel(256)})"
        f" B={b} T=197 card vs CPU: max|err| / max|out| {err:.3e} (bound "
        f"{ATTN_BOUND[torch.float32]:.0e}); {n_launch} kernel launches "
        f"(the plain route)")
    if not (err <= ATTN_BOUND[torch.float32] and n_launch == 0):
        raise AssertionError(f"dh = 256 block: {err}, {n_launch} launches")
    rows["dh256_block_rel_err"] = err
    return rows


# Gradients through the kernels' autograd Functions: their backward is the
# plain version's VJP at the same saved inputs, so they agree with
# torch.autograd of the plain version to the rounding of reruns of the
# same library kernels (f32 1e-5 of the gradient's scale; bf16 2^-6).
GRAD_BOUND = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def phase_kernel_grads(smi: str) -> dict:
    """B's q/k/v and key-bias gradients through ``_Attention`` on the card
    (dh = 64 at T = 197 and dh = 96 at T = 25, f32 and bf16), and A's w and
    bias gradients through ``_PatchEmbed`` (uint8 B=8 @224, f32 out),
    against torch.autograd of the plain versions on the card. Each call
    launches its kernel once and returns an output with a grad_fn."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for dh, t, h, b in ((64, 197, 12, 8), (96, 25, 8, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            leaves = [torch.randn(b, h, t, dh, generator=g, device=dev)
                      .to(dtype).requires_grad_(True) for _ in range(3)]
            bias = torch.randn(b, t, generator=g, device=dev) \
                .requires_grad_(True)
            gout = torch.randn(b, h, t, dh, generator=g, device=dev).to(dtype)
            before = attn.multi_head_attention.launches
            got = attn.multi_head_attention(*leaves, key_bias=bias)
            if attn.multi_head_attention.launches != before + 1 or \
                    got.grad_fn is None:
                raise AssertionError(f"attention dh={dh} {name}: no kernel "
                                     "launch or no grad_fn")
            grads = torch.autograd.grad(got, [*leaves, bias], gout)
            ref = [x.detach().clone().requires_grad_(True)
                   for x in (*leaves, bias)]
            want = attn.attention_plain(*ref[:3], key_bias=ref[3])
            want_grads = torch.autograd.grad(want, ref, gout)
            # the forward against the plain version of the same values in
            # the same dtype (phase 3c's bounds)
            fwd_bound = ATTN_BOUND[dtype] if dtype == torch.float32 else \
                2 ** -8 * leaves[2].float().abs().max().item()
            with torch.no_grad():
                if dtype == torch.float32:
                    fwd = (got - want).abs().max().item()
                else:
                    errs = bf16_attention_errs(
                        got, *(x.detach() for x in leaves), bias.detach(),
                        bound=fwd_bound)
                    fwd = errs["err"]
                    log(f"[3c] attention grads dh={dh} T={t} bf16, the "
                        f"forward against the bf16 plain version: " +
                        check_bf16_attention(errs, f"grads dh={dh} T={t}"))
            errs = [_rel_err(x, y) for x, y in zip(grads, want_grads)]
            log(f"[3c] attention grads dh={dh} T={t} {name}: forward "
                f"max|err| {fwd:.3e} (bound {fwd_bound:.2e}); relative "
                f"max|err| dq {errs[0]:.2e} dk {errs[1]:.2e} dv "
                f"{errs[2]:.2e} dbias {errs[3]:.2e} (bound "
                f"{GRAD_BOUND[dtype]:.0e})")
            # bf16: check_bf16_attention held the forward, tie-aware
            if not ((fwd <= fwd_bound or dtype == torch.bfloat16)
                    and max(errs) <= GRAD_BOUND[dtype]):
                raise AssertionError(f"attention gradients dh={dh} {name} "
                                     f"disagree: {fwd}, {errs}")
            out[f"attention_dh{dh}_{name}"] = max(errs)
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (8, 224, 224, 3),
                                           dtype=np.uint8)).to(dev)
    w = (torch.randn(768, 768, generator=g, device=dev) / 768 ** 0.5) \
        .requires_grad_(True)
    bias = torch.randn(768, generator=g, device=dev).requires_grad_(True)
    gout = torch.randn(8, 196, 768, generator=g, device=dev)
    before = pe.fused_patch_embed.launches
    got = pe.fused_patch_embed(images, w, bias, patch_size=16, **HF_AFFINE)
    if pe.fused_patch_embed.launches != before + 1 or got.grad_fn is None:
        raise AssertionError("patch embed: no kernel launch or no grad_fn")
    grads = torch.autograd.grad(got, [w, bias], gout)
    a_vec, b_vec = (torch.from_numpy(x).to(dev) for x in pe.fold_affine(
        16, 3, **HF_AFFINE))
    ref = [x.detach().clone().requires_grad_(True) for x in (w, bias)]
    want = pe.patch_embed_plain(images, *ref, a_vec, b_vec, patch_size=16)
    want_grads = torch.autograd.grad(want, ref, gout.reshape(-1, 768))
    fwd = (got.reshape(-1, 768) - want).abs().max().item()
    errs = [_rel_err(x, y) for x, y in zip(grads, want_grads)]
    log(f"[3c] patch embed grads uint8 B=8 @224: forward max|err| {fwd:.3e}; "
        f"relative max|err| dw {errs[0]:.2e} dbias {errs[1]:.2e} (bound "
        f"{GRAD_BOUND[torch.float32]:.0e})")
    if not (fwd <= PE_BOUND[torch.float32]
            and max(errs) <= GRAD_BOUND[torch.float32]):
        raise AssertionError(f"patch embed gradients disagree: {fwd}, {errs}")
    out["patch_embed"] = max(errs)
    torch.cuda.empty_cache()
    return out


# The RAG/RATT heads (HeadConfig(): 768 wide, 4 heads): dh = 192 at T =
# 1 + num_queries = 5 for train-rag's B = 8 and a 256-chunk batch; T = 65
# and 130 stream a full and a partial second key tile (f32 holds one K/V
# buffer at this width).
RAG_HEADS, RAG_DH = 4, 192
RAG_ATTN_CASES = ((8, 5), (256, 5), (32, 65), (32, 130))


def _device_ms(fn, calls: int = 20, tries: int = 4) -> float | None:
    """The card's time of ``fn``'s work a call, where a call's host work
    outlasts its kernels (CUDA events around single calls time the host):
    ``calls`` calls queued behind a sleeping kernel, so the card runs them
    back to back, timed by CUDA events (the gaps between kernels
    included). The sleep is sized from the host's time for the calls and
    doubled until the card is still asleep when the host has queued them
    all; None (not measured) if it never is. torch.profiler's device
    records were lost or counted twice in some sessions late in a run."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # cycles a millisecond of torch.cuda._sleep
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(1_000_000)
    b.record()
    b.synchronize()
    cycles_ms = 1_000_000 / max(a.elapsed_time(b), 1e-3)
    sleep_ms = 2e3 * host_s + 1.0
    for _ in range(tries):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        torch.cuda._sleep(int(cycles_ms * sleep_ms))
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        queued_in_time = not start.query()
        stop.synchronize()
        if queued_in_time:
            return start.elapsed_time(stop) / calls
        sleep_ms *= 2
    return None


def _ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def phase_attention_rag(smi: str) -> dict:
    """Kernel B at the RAG/RATT heads' dh = 192 (H = 4; B = 8 and 256 at T
    = 5, B = 32 at T = 65 and 130), f32 and bf16, with and without a key
    bias, on contiguous inputs and on projection-order views, each against
    the plain version of the same values; timed against the plain version
    and SDPA (with the bias as a float mask) and its bound; at T = 5 also
    the kernel's and SDPA's device time (_device_ms). Then the
    gradients through ``_Attention`` against the plain VJP (T = 5 and
    130), and ptxas's registers and spills of the dh = 192 kernels."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    h, dh = RAG_HEADS, RAG_DH
    for line in _ptxas_lines("attention.cu", "192"):
        log(f"[3d] ptxas {line}")
    rows = {}
    for b, t in RAG_ATTN_CASES:
        q32, k32, v32 = (torch.randn(b, t, h, dh, generator=g).to(dev)
                         for _ in range(3))
        bias = torch.log(torch.randint(1, 9, (b, t), generator=g).float()) \
            .to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            views = [x.to(dtype).transpose(1, 2) for x in (q32, k32, v32)]
            contig = [x.contiguous() for x in views]
            f32 = dtype == torch.float32
            # bf16, against the bf16 plain version (phase 3c's bound)
            bound_err = ATTN_BOUND[dtype] if f32 else \
                2 ** -8 * contig[2].float().abs().max().item()
            for kb in (None, bias):
                row, outs = {}, []
                for layout, (q, k, v) in (("contiguous", contig),
                                          ("projection order", views)):
                    before = attn.multi_head_attention.launches
                    got, variant = b_variants(
                        lambda: attn.multi_head_attention(q, k, v,
                                                          key_bias=kb))
                    torch.cuda.synchronize()
                    err = (got - attn.attention_plain(*contig, key_bias=kb)
                           ).abs().max().item() if f32 else 0.0
                    if attn.multi_head_attention.launches != before + 1 \
                            or not err <= bound_err:
                        raise AssertionError(
                            f"attention kernel dh=192 B={b} T={t} {name} "
                            f"{layout} bias={kb is not None}: {err}")
                    outs.append(got)
                    row[layout] = (err, cuda_ms(
                        lambda: attn.multi_head_attention(q, k, v,
                                                          key_bias=kb)))
                errs_text = ""
                if not f32:
                    errs = bf16_attention_errs(outs, *contig, kb,
                                               bound=bound_err)
                    errs_text = "; " + check_bf16_attention(
                        errs, f"dh=192 B={b} T={t} bias={kb is not None}",
                        full=False)
                    row = {key: (errs["err"], ms)
                           for key, (_, ms) in row.items()}
                del outs
                q, k, v = contig
                plain_ms = cuda_ms(lambda: attn.attention_plain(
                    q, k, v, key_bias=kb))
                mask = None if kb is None else kb[:, None, None, :].to(dtype)
                sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask))
                lim = bound(4 * q.numel() * q.element_size()
                            + (0 if kb is None else kb.numel() * 4),
                            4 * b * h * t * t * dh,
                            "f32" if dtype == torch.float32 else "bf16")
                key = f"B{b}_T{t}_{name}" + ("_bias" if kb is not None
                                             else "")
                device = {}
                if t == 5:
                    device = dict(
                        device_ms=_device_ms(
                            lambda: attn.multi_head_attention(
                                q, k, v, key_bias=kb)),
                        library_device_ms=_device_ms(
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, attn_mask=mask)),
                        host_us=host_us(lambda: attn.multi_head_attention(
                            q, k, v, key_bias=kb)),
                        library_host_us=host_us(
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, attn_mask=mask)))
                    with_kb = " + key bias" if kb is not None else ""
                    log(f"[3d] device time a call, calls back to back, B={b}"
                        f" T={t} {name}{with_kb}: kernel "
                        f"{_ms(device['device_ms'])} ms, SDPA "
                        f"{_ms(device['library_device_ms'])} ms; host "
                        f"{device['host_us']:.2f} us a call, SDPA "
                        f"{device['library_host_us']:.2f} us | {smi}")
                log(f"[3d] attention B={b} H={h} T={t} dh={dh} {name}"
                    f"{' + key bias' if kb is not None else ''}: max|err| "
                    f"{max(e for e, _ in row.values()):.3e} (bound "
                    f"{bound_err:.2e}{errs_text}) | kernel {variant} "
                    f"{row['contiguous'][1]:.4f} "
                    f"ms (projection order {row['projection order'][1]:.4f})"
                    f" | plain {plain_ms:.4f} ms | SDPA"
                    f"{'+mask' if kb is not None else ''} {sdpa_ms:.4f} ms | "
                    f"{bound_text(lim)} | {smi}")
                rows[key] = dict(
                    max_abs_err=max(e for e, _ in row.values()),
                    ms=row["contiguous"][1],
                    ms_projection_order=row["projection order"][1],
                    plain_ms=plain_ms, library_ms=sdpa_ms, launched=variant,
                    **device, **lim)
                if not f32:
                    rows[key].update(
                        max_abs_err_f32_scores=errs["f32_scores"],
                        max_abs_err_f32_plain=errs["f32_plain"])
                del mask
            del views, contig, q, k, v
        del q32, k32, v32, bias
    torch.cuda.empty_cache()
    # the heads' scores (max|S| >= 10) at T = 5 (RAGHead) and 21 (RATTHead),
    # and past one key tile
    for b, t in ((8, 5), (256, 5), (8, 21)):
        rows[f"B{b}_T{t}_bfloat16_large_scores"] = _large_scores_case(
            b, t, h, dh, "3d", g)
    for b, t in RAG_ATTN_CASES[2:]:
        rows[f"B{b}_T{t}_bfloat16_large_scores"] = _large_scores_case(
            b, t, h, dh, "3d", g)

    grads = {}
    g = torch.Generator(device=dev).manual_seed(6)
    for t in (5, 130):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            leaves = [torch.randn(8, h, t, dh, generator=g, device=dev)
                      .to(dtype).requires_grad_(True) for _ in range(3)]
            bias = torch.randn(8, t, generator=g, device=dev) \
                .requires_grad_(True)
            gout = torch.randn(8, h, t, dh, generator=g, device=dev).to(dtype)
            before = attn.multi_head_attention.launches
            got = attn.multi_head_attention(*leaves, key_bias=bias)
            if attn.multi_head_attention.launches != before + 1 or \
                    got.grad_fn is None:
                raise AssertionError(f"attention dh=192 {name}: no kernel "
                                     "launch or no grad_fn")
            got_grads = torch.autograd.grad(got, [*leaves, bias], gout)
            ref = [x.detach().clone().requires_grad_(True)
                   for x in (*leaves, bias)]
            want_grads = torch.autograd.grad(
                attn.attention_plain(*ref[:3], key_bias=ref[3]), ref, gout)
            errs = [_rel_err(x, y) for x, y in zip(got_grads, want_grads)]
            log(f"[3d] attention grads dh=192 B=8 T={t} {name}: relative "
                f"max|err| dq {errs[0]:.2e} dk {errs[1]:.2e} dv "
                f"{errs[2]:.2e} dbias {errs[3]:.2e} (bound "
                f"{GRAD_BOUND[dtype]:.0e})")
            if not max(errs) <= GRAD_BOUND[dtype]:
                raise AssertionError(f"attention gradients dh=192 T={t} "
                                     f"{name} disagree: {errs}")
            grads[f"T{t}_{name}"] = max(errs)
    torch.cuda.empty_cache()
    return dict(rows=rows, grad_rel_err=grads)


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

    summary = {}
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
        f32_w = w.dtype == torch.float32
        lim = bound(x.numel() * 4 + w.numel() * w.element_size()
                    + (2 * k + n) * 4 + m * n * w.element_size(),
                    2 * m * k * n, "tf32" if f32_w else "bf16",
                    passes=3 if f32_w else 1)
        log(f"[3b] ln_matmul M={m} K={k} N={n} act={act} x=float32 "
            f"W={w_name}: max|err| {err:.3e} (bound {bound_err:.1e}) | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"layer_norm+linear{'+gelu' if act else ''} {lib_ms:.4f} ms "
            f"(max|err| {lib_err:.3e}); {bound_text(lim)} | {smi}")
        if not err <= bound_err:
            raise AssertionError(f"ln_matmul kernel disagrees: {err}")
        if n == 3072:
            summary[w_name] = dict(max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms, library_ms=lib_ms,
                                   **lim)
        del want
    del x, cases, outs
    torch.cuda.empty_cache()
    return dict(summary["float32"], launches=launches,
                bf16=summary["bfloat16"])


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


def _embed_rate(dtype: str, batch: int, iters: int = 16, **kw) -> float:
    """bench.py's method: device-resident random uint8 batches (8 staged
    buffers), the engine's forward per batch, one checksum readback per
    batch, timed on the host clock after a warm-up batch. ``kw`` goes to
    make_hf_frame_embedder (the fast profile's options)."""
    eng = embed.make_hf_frame_embedder(device="cuda", batch_size=batch,
                                       dtype=dtype, **kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bufs = [torch.randint(0, 256, (batch, 224, 224, 3), generator=gen,
                          device="cuda", dtype=torch.uint8) for _ in range(8)]
    float(eng._forward(bufs[0])[:, :8].sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = [eng._forward(bufs[i % 8])[:, :8].sum() for i in range(iters)]
    _ = [float(s) for s in sums]
    return batch * iters / (time.perf_counter() - t0)


def _host_prework(root: str, out: dict) -> None:
    """The default run's host work that needs no kernel, on a thread while
    phase 1 builds them (one nvcc, attention.cu's, keeps a single core busy
    for most of the build): phase 4's two games of JPEG frames, then phase
    5b's reference, the CPU plain forward of the seeded weights on the
    query game's first BATCH frames. Fills ``out``; an exception is kept
    under "error" for the main thread to raise."""
    try:
        t0 = time.monotonic()
        out["corpus"] = _write_game(root, 1, CORPUS_SEGMENTS)
        out["query"] = _write_game(root, 2, QUERY_SEGMENTS)
        out["games_s"] = time.monotonic() - t0
        frames = load_frames([os.path.join(out["query"][0],
                                           f"vid2_frame_{f}.jpg")
                              for f in range(1, BATCH + 1)], SPEC)
        host = embed.make_hf_frame_embedder(device="cpu", batch_size=BATCH)
        t0 = time.monotonic()
        out["reference"] = host.embed_batch(frames)
        out["reference_s"] = time.monotonic() - t0
    except BaseException as e:  # re-raised by the main thread
        out["error"] = e


def phase_main_path(smi: str, root: str, pre: dict) -> dict:
    """Phase 4 on the games ``_host_prework`` wrote into ``root``."""
    (corpus_dir, corpus_csv, _), (query_dir, _, planted) = \
        pre["corpus"], pre["query"]
    n_corpus = sum(n for _, n in CORPUS_SEGMENTS)
    n_query = sum(n for _, n in QUERY_SEGMENTS)
    log(f"[4] wrote {n_corpus} corpus + {n_query} query JPEG frames "
        f"(224x224) in {pre['games_s']:.1f} s, on a thread during the "
        f"kernel build")
    db = os.path.join(root, "db")
    out = os.path.join(root, "clips")

    _zero_counts()
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
    launches = _launch_counts()
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
                n_query=n_query, corpus_dir=corpus_dir,
                corpus_csv=corpus_csv, planted=planted,
                reference=pre["reference"], reference_s=pre["reference_s"])


def phase_backbone_ties(smi: str, main: dict) -> dict:
    """F10 on the backbone's own activations: one bf16 forward of the
    seeded ViT-B/16 (the bf16 engine at B = 256) on phase 4's first 256
    query frames, kernel B's 12 calls recorded (q, k, v as the blocks hand
    them, in projection order) and each held to the bf16 plain version by
    bf16_tie_check within ATTN_BOUND. Per block: the strict error, the
    near-tie set, the rows over the bound and those a tie accepts, with
    the plain P and max|v| of each key the tie moves."""
    t0 = time.monotonic()
    paths = [os.path.join(main["query_dir"], f"vid2_frame_{f}.jpg")
             for f in range(1, BATCH + 1)]
    frames = torch.from_numpy(load_frames(paths, SPEC)).to("cuda")
    eng = embed.make_hf_frame_embedder(device="cuda", batch_size=BATCH,
                                       dtype="bfloat16")
    calls = []
    launch = attn._launch

    def recording(q, k, v, scale, key_bias):
        out = launch(q, k, v, scale, key_bias)
        calls.append((q, k, v, key_bias, out))
        return out

    attn._launch = recording
    try:
        with torch.no_grad():
            eng.encode(frames)
    finally:
        attn._launch = launch
    torch.cuda.synchronize()
    if len(calls) != 12 or calls[0][0].shape != (BATCH, 12, 197, 64) or \
            calls[0][0].dtype != torch.bfloat16:
        raise AssertionError(f"bf16 forward: {len(calls)} kernel B calls, "
                             f"want 12 of (256, 12, 197, 64) bf16")
    blocks = []
    for n, (q, k, v, key_bias, out) in enumerate(calls):
        ties = bf16_tie_check(out, q, k, v, key_bias,
                              bound=ATTN_BOUND[torch.bfloat16])
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        blocks.append(dict(block=n, err=ties["err"], ok=ties["ok"],
                           max_s=(s.abs().max() * 64 ** -0.5).item(),
                           max_v=v.float().abs().max().item(),
                           rejected=ties["rejected"], **tie_summary(ties)))
        del s
        log(f"[4b] bf16 forward B={BATCH} block {n}: strict max|err| "
            f"{ties['err']:.4g} (bound {ATTN_BOUND[torch.bfloat16]:.0e}); "
            f"{tie_text(ties)}; max|S| {blocks[-1]['max_s']:.2f}, max|v| "
            f"{blocks[-1]['max_v']:.2f} | {smi}")
        for row in ties["accepted"]:
            log(f"[4b]   block {n} accepted by a tie: {tie_row_text(row)}")
    del calls
    torch.cuda.empty_cache()
    failed = [b for b in blocks if not b["ok"]]
    rows = [row for b in blocks for row in b["accepted"]]
    p_moved = [key["p_plain"] for row in rows for key in row["keys"]]
    log(f"[4b] F10 on the backbone's activations: near ties "
        f"{sum(b['near_ties'] for b in blocks)} of "
        f"{sum(b['n_scores'] for b in blocks)} scores and "
        f"{sum(b['output_ties'] for b in blocks)} of "
        f"{sum(b['n_outputs'] for b in blocks)} outputs, rows over the "
        f"bound {sum(b['over_rows'] for b in blocks)}, accepted by a tie "
        f"{len(rows)} (through a score {sum(bool(r['keys']) for r in rows)},"
        f" through outputs alone {sum(not r['keys'] for r in rows)}; the "
        f"moved keys' plain P at most {max(p_moved, default=0):.4g}), "
        f"failed blocks {[b['block'] for b in failed]}; "
        f"{time.monotonic() - t0:.1f} s")
    if failed:
        raise AssertionError(f"bf16 forward: kernel B beyond the bound, not "
                             f"a tie: {failed}")
    return dict(blocks=blocks)


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

    # clip labels for phase 5e's stage-1 training: left possessions 1,
    # right 0 (the synthetic frames show the side)
    labels_csv = os.path.join(root, "clip_labels.csv")
    with open(labels_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["clip_path", "label"])
        for d in sorted(os.listdir(main["out"])):
            if m := CLIP_RE.match(d):
                w.writerow([os.path.join(main["out"], d),
                            int(m.group(2) == "left")])

    _zero_counts()
    t0 = time.monotonic()
    cli.main(["build-frame-store", "--clip-root", main["out"], "--vids",
              "2", "--clip-labels", labels_csv, "--out", store,
              "--batch-size", str(BATCH), "--device", "cuda"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["search", *queries, "--db", main["db"], "--collection",
                  "corpus", "--k", "10", "--batch-size", str(BATCH),
                  "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
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


# ---- phase 5b: the serve path -------------------------------------------


def _socket_path(root: str) -> str:
    """The daemon's socket under ``root``, as the shorter of its absolute
    and cwd-relative paths: unix socket paths hold at most 107 bytes."""
    sock = os.path.join(root, "d.sock")
    sock = min(sock, os.path.relpath(sock), key=len)
    if len(sock) > 100:
        raise RuntimeError(f"socket path {sock!r} is too long for AF_UNIX")
    return sock


class _Counts(dict):
    """The kernels' launches since the counts were zeroed, with kernel B's
    by instantiation and variant in ``by_kernel``."""
    by_kernel: dict = {}


def _zero_counts() -> None:
    """Sets every launch count to 0, just before a path runs."""
    pe.fused_patch_embed.launches = 0
    attn.multi_head_attention.launches = 0
    attn.multi_head_attention.launches_by_kernel.clear()


def _launch_counts() -> dict:
    out = _Counts(patch_embed=pe.fused_patch_embed.launches,
                  attention=attn.multi_head_attention.launches)
    out.by_kernel = dict(attn.multi_head_attention.launches_by_kernel)
    return out


def _counts_minus(a: dict, b: dict) -> dict:
    """The launches of ``a`` not yet made at ``b`` (both _launch_counts)."""
    out = _Counts({k: v - b[k] for k, v in a.items()})
    out.by_kernel = {k: v - b.by_kernel.get(k, 0)
                     for k, v in a.by_kernel.items()
                     if v - b.by_kernel.get(k, 0)}
    return out


def _check_launches(got: dict, batches: int, what: str) -> None:
    if got != {"patch_embed": batches, "attention": 12 * batches}:
        raise AssertionError(f"{what}: kernel launches {got}, want "
                             f"{batches} and {12 * batches}")


def _serve_thread(argv: list) -> tuple:
    """``cli.main(argv)`` on a thread of this process (the kernels'
    launch counters stay readable); returns (thread, errors list)."""
    errors: list = []

    def run():
        try:
            cli.main(argv)
        except BaseException as e:  # surfaced by the phase's checks
            errors.append(e)

    t = threading.Thread(target=run, daemon=True, name="chip-smoke-serve")
    t.start()
    return t, errors


def _await_ready(sock: str, errors: list, limit_s: float = 600.0) -> float:
    """Poll ``ping`` until the reply stops reporting warming; returns
    the seconds waited."""
    t0 = time.monotonic()
    while True:
        if errors:
            raise RuntimeError(f"serve failed while warming: {errors[0]!r}")
        try:
            r = serve.request(sock, {"op": "ping"}, timeout=30.0)
        except (OSError, ConnectionError):
            r = None  # not bound yet, or the warming -> ready swap
        if r and r.get("ok") and not r.get("warming"):
            return time.monotonic() - t0
        if time.monotonic() - t0 > limit_s:
            raise TimeoutError(f"daemon still warming after {limit_s} s")
        time.sleep(0.2)


def _max_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"reply {got.shape}, want {want.shape} finite")
    return float(np.abs(got - want).max())


def _listing(root: str) -> dict:
    return {d: sorted(os.listdir(os.path.join(root, d)))
            for d in sorted(os.listdir(root)) if CLIP_RE.match(d)}


def _live_copy(src: str, dst: str) -> str:
    """A copy of a frames dir ending in the STOP file that tells
    ``segment --follow`` the producer is done."""
    os.makedirs(dst)
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), dst)
    open(os.path.join(dst, "STOP"), "w").close()
    return dst


def phase_serve_path(smi: str, root: str, main: dict) -> dict:
    """The daemon on the card (``cli serve ... --warmup``) on phase 4's
    corpus: embed in every input form, coalescing, query, a live session,
    ``segment --follow`` through the socket and in-process, serve-ctl."""
    db, query_dir, n_query = main["db"], main["query_dir"], main["n_query"]
    paths = [os.path.join(query_dir, f"vid2_frame_{f}.jpg")
             for f in range(1, n_query + 1)]
    sock = _socket_path(root)
    _zero_counts()
    t0 = time.monotonic()
    thread, errors = _serve_thread(
        ["serve", "--socket", sock, "--db", db, "--collection", "corpus",
         "--batch-size", str(BATCH), "--warmup", "--device", "cuda"])
    _await_ready(sock, errors)
    log(f"[5b] serve --warmup on the card: ready {time.monotonic() - t0:.2f} "
        f"s after start (engine init + kernel library, loaded by phase 1, "
        f"+ one batch of {BATCH})")

    # The CPU plain forward of the same seeded weights on the same frames
    # (_host_prework).
    frames = load_frames(paths[:BATCH], SPEC)
    want = main["reference"]
    log(f"[5b] CPU plain forward of {BATCH} frames (the reference, on a "
        f"thread during phases 1-3b): {main['reference_s']:.1f} s")
    blobs = [open(p, "rb").read() for p in paths[:BATCH]]

    sizes = (1, 16, BATCH)
    form_names = ("JSON paths", "JSON frames_b64", "binary raw_u8",
                  "binary jpeg")
    lat = {(form, n): [] for form in form_names for n in sizes}
    worst = 0.0
    with serve.SessionClient(sock, timeout=120.0) as c:
        for _ in range(EMBED_ROUNDS):
            for n in sizes:
                forms = [
                    lambda: serve.request(sock, {"op": "embed",
                                                 "paths": paths[:n]},
                                          timeout=120.0)["embeddings"],
                    lambda: serve.request(sock, {
                        "op": "embed", "frames_b64": [
                            base64.b64encode(b).decode()
                            for b in blobs[:n]]},
                        timeout=120.0)["embeddings"],
                    lambda: c.request_binary({"op": "embed"},
                                             frames=frames[:n])["embeddings"],
                    lambda: c.request_binary({"op": "embed"},
                                             jpegs=blobs[:n])["embeddings"]]
                for name, form in zip(form_names, forms):
                    t1 = time.perf_counter()
                    got = form()
                    lat[name, n].append((time.perf_counter() - t1) * 1e3)
                    worst = max(worst, _max_err(got, want[:n]))
    log(f"[5b] embed replies ({', '.join(form_names)}; 1, 16 and {BATCH} "
        f"frames, {EMBED_ROUNDS} rounds): max|err| {worst:.3e} against the "
        f"CPU plain forward (bound {EMBED_BOUND:.0e})")
    if worst > EMBED_BOUND:
        raise AssertionError(f"daemon embeddings disagree: {worst}")
    for n in sizes:
        every = [t for form in form_names for t in lat[form, n]]
        log(f"[5b] embed request latency, {n} frame(s): median "
            f"{statistics.median(every):.2f} ms over {len(every)} requests; "
            "by form " + ", ".join(
                f"{form} {statistics.median(lat[form, n]):.2f}"
                for form in form_names)
            + f" ms (host clock, client in this process) | {smi}")

    before = serve.request(sock, {"op": "stats"}, timeout=60.0)
    t1 = time.perf_counter()
    res = _concurrent([(lambda i=i: serve.request_binary(
        sock, {"op": "embed"}, frames=frames[16 * i:16 * i + 16],
        timeout=120.0)["embeddings"]) for i in range(8)])
    wall = (time.perf_counter() - t1) * 1e3
    after = serve.request(sock, {"op": "stats"}, timeout=60.0)
    merged = after["device_batches"] - before["device_batches"]
    err = max(_max_err(res[i], want[16 * i:16 * i + 16]) for i in range(8))
    log(f"[5b] 8 concurrent clients x 16 frames: {merged} device batches, "
        f"max|err| {err:.3e}; wall {wall:.2f} ms (host clock) | {smi}")
    if merged >= 8 or err > EMBED_BOUND:
        raise AssertionError(f"coalescer did not merge ({merged} batches) "
                             f"or rows disagree ({err})")

    sides = _query_sides()
    picks = [int(f) for f in np.linspace(1, n_query, 32)]
    q = serve.request(sock, {"op": "query", "paths": [paths[f - 1]
                                                      for f in picks],
                             "n_results": 10}, timeout=120.0)
    agree = [m["label"] == sides[f - 1]
             for f, row in zip(picks, q["metadatas"]) for m in row]
    share = sum(agree) / max(1, len(agree))
    log(f"[5b] query 32 frames, k=10: {100 * share:.1f}% of neighbours "
        "carry the frame's planted side")
    if not q["ok"] or len(agree) != 320 or share < 0.8:
        raise AssertionError(f"query neighbours disagree: {share}")

    offline = _clip_ranges(main["out"])
    clips, pushes, mid, push_ms = [], [37, 64, 128], False, []
    with serve.SessionClient(sock, timeout=120.0) as c:
        r = c.request({"op": "segment_start", "k": 50, "min_len": MIN_LEN,
                       "pad": PAD})
        if not r.get("ok"):
            raise AssertionError(f"segment_start refused: {r}")
        i = j = 0
        while i < n_query:
            chunk = paths[i:i + pushes[j % 3]]
            t1 = time.perf_counter()
            r = c.request({"op": "segment_push", "paths": chunk})
            if len(chunk) == 64:
                push_ms.append((time.perf_counter() - t1) * 1e3)
            if not r.get("ok"):
                raise AssertionError(f"segment_push failed: {r}")
            clips += r["clips"]
            i, j = i + len(chunk), j + 1
        mid = len(clips)
        t1 = time.perf_counter()
        fin = c.request({"op": "segment_finish"})
        finish_ms = (time.perf_counter() - t1) * 1e3
        clips += fin["clips"]
    live = [(c_["side"], c_["start"] + 1, c_["end"] + 1) for c_ in clips]
    log(f"[5b] live session (pushes of 37, 64, 128 frames): clips {live}, "
        f"{mid} before segment_finish, forced {fin['forced']}; offline "
        f"{offline}")
    if live != offline or mid < 1:
        raise AssertionError("live session clips differ from the offline "
                             "clips, or none arrived mid-game")
    log(f"[5b] segment_push latency, 64 frames: median "
        f"{statistics.median(push_ms):.2f} ms over {len(push_ms)} pushes; "
        f"segment_finish {finish_ms:.2f} ms (host clock) | {smi}")

    want_dirs = _listing(main["out"])
    follow = ["--method", "knn-hmm", "--follow", "--k", "50", "--min-len",
              str(MIN_LEN), "--pad", str(PAD), "--vid", "2", "--batch-size",
              str(BATCH), "--idle-timeout", "30", "--poll-interval", "0.05"]
    out_sock = os.path.join(root, "follow_socket")
    t1 = time.monotonic()
    cli.main(["segment", _live_copy(query_dir, os.path.join(
        root, "live_socket")), "--socket", sock, "--out", out_sock, *follow])
    log(f"[5b] segment --follow --socket: {time.monotonic() - t1:.1f} s, "
        f"clip dirs equal the offline ones: "
        f"{_listing(out_sock) == want_dirs}")
    stats = serve.request(sock, {"op": "stats"}, timeout=60.0)
    daemon_before = _launch_counts()
    out_local = os.path.join(root, "follow_local")
    t1 = time.monotonic()
    cli.main(["segment", _live_copy(query_dir, os.path.join(
        root, "live_local")), "--db", db, "--corpus-collection", "corpus",
        "--out", out_local, "--device", "cuda", *follow])
    local = _counts_minus(_launch_counts(), daemon_before)
    log(f"[5b] segment --follow (in-process engine): "
        f"{time.monotonic() - t1:.1f} s, clip dirs equal the offline ones: "
        f"{_listing(out_local) == want_dirs}; launches {local}")
    if not (_listing(out_sock) == _listing(out_local) == want_dirs):
        raise AssertionError("--follow clip dirs differ from the offline "
                             "segment's")
    _check_launches(local, math.ceil(n_query / BATCH), "segment --follow")

    seg = stats["segment"]
    embedded = EMBED_ROUNDS * 4 * sum(sizes) + 8 * 16 + 32 + 2 * n_query
    got = (stats["frames_embedded"], seg["sessions_finished"],
           seg["frames_pushed"], seg["clips_emitted"], seg["sessions_active"])
    log(f"[5b] stats: frames_embedded {got[0]}, sessions finished {got[1]}, "
        f"frames pushed {got[2]}, clips emitted {got[3]}, device batches "
        f"{stats['device_batches']}, errors {stats['errors']}")
    if got != (embedded, 2, 2 * n_query, 2 * len(offline), 0) \
            or stats["errors"]:
        raise AssertionError(f"stats do not add up: {got}, want "
                             f"{(embedded, 2, 2 * n_query, 2 * len(offline))}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["serve-ctl", "reload", "--socket", sock])
    rows = json.loads(buf.getvalue())["rows"]
    n_corpus = sum(n for _, n in CORPUS_SEGMENTS)
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["serve-ctl", "shutdown", "--socket", sock])
    thread.join(timeout=60.0)
    log(f"[5b] serve-ctl reload: {rows} rows; shutdown ended the serve "
        f"thread: {not thread.is_alive()}")
    if rows != n_corpus or thread.is_alive() or errors:
        raise AssertionError(f"reload rows {rows} (want {n_corpus}), serve "
                             f"thread alive {thread.is_alive()}, {errors}")
    daemon = _counts_minus(_launch_counts(), local)
    # one warm-up batch, then one engine batch per coalescer batch: no
    # request of this phase exceeds one engine batch, merged or not
    _check_launches(daemon, 1 + stats["device_batches"], "serve")
    log(f"[5b] launches on the serve path {daemon} for "
        f"{1 + stats['device_batches']} engine batches (warm-up included)")
    # The device's share of a request: the engine's forward alone on a
    # batch already on the card, at the request sizes above.
    eng = embed.make_hf_frame_embedder(device="cuda", batch_size=BATCH)
    on_card = torch.from_numpy(frames).to(eng.device)
    fwd = {n: cuda_ms(lambda n=n: eng._forward(on_card[:n]), reps=3, n=5)
           for n in (1, 16, 64, BATCH)}
    log("[5b] engine forward alone on the card (CUDA events): "
        + ", ".join(f"{n} frame(s) {ms:.2f} ms" for n, ms in fwd.items())
        + f" | {smi}")
    del eng, on_card
    torch.cuda.empty_cache()
    return dict(launches=daemon, follow_launches=local)


# ---- phase 5c: the labelling and clip-curation path ----------------------


def _numpy_two_pass(q, c, lab, k, min_votes, temperature):
    """Two-pass self-labelling in float64 numpy (segment/knn.py's rule:
    pass 1 accepts >= min_votes of k, pass 2 ranks the rest against the
    corpus plus the accepted frames). Returns (labels, probs, accepted,
    near) where ``near`` marks the queries whose k-th and (k+1)-th
    neighbours lie within 1e-4 of each other (a card ranking may swap
    them)."""
    def knn(qs, cs, ls):
        d = ((qs[:, None, :].astype(np.float64) - cs[None]) ** 2).sum(-1)
        order = np.argsort(d, axis=1, kind="stable")
        srt = np.take_along_axis(d, order, axis=1)
        near = (srt[:, k] - srt[:, k - 1] <= 1e-4) if cs.shape[0] > k \
            else np.zeros(len(qs), bool)
        votes = np.stack([(ls[order[:, :k]] == s).sum(1) for s in range(3)],
                         axis=1)
        return votes, near

    def softmax(v):
        x = v.astype(np.float64) / temperature
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    votes, near = knn(q, c, lab)
    accepted = votes.max(1) >= min_votes
    labels = np.where(accepted, votes.argmax(1), -1)
    probs = softmax(votes)
    if (~accepted).any():
        big_c = np.concatenate([c, q[accepted]])
        big_l = np.concatenate([lab, labels[accepted]])
        v2, near2 = knn(q[~accepted], big_c, big_l)
        labels[~accepted] = v2.argmax(1)
        probs[~accepted] = softmax(v2)
        near[~accepted] |= near2
    return labels, probs, accepted, near


def _write_1080p(root: str, n: int) -> list:
    """``n`` synthetic 1920x1080 JPEG frames (PIL, 8 threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    os.makedirs(root)

    def one(i):
        rng = np.random.default_rng(1000 + i)
        p = os.path.join(root, f"vid9_frame_{i + 1}.jpg")
        Image.fromarray(synth_frame(SIDES[i % 3], (1080, 1920), rng)).save(
            p, quality=90)
        return p

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(n)))


def _hf_state_dict(seed: int = 0) -> dict:
    """A seeded numpy state dict with ``transformers.ViTModel``'s key names
    and shapes for ViT-B/16 @224 (the card's machine has no transformers)."""
    rng = np.random.default_rng(seed)
    d, m, p = 768, 3072, 16

    def w(*shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sd = {"embeddings.cls_token": w(1, 1, d),
          "embeddings.position_embeddings": w(1, 197, d),
          "embeddings.patch_embeddings.projection.weight": w(d, 3, p, p),
          "embeddings.patch_embeddings.projection.bias": w(d),
          "layernorm.weight": 1 + w(d, scale=0.1),
          "layernorm.bias": w(d, scale=0.1)}
    for i in range(12):
        pre = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd[pre + f"attention.attention.{name}.weight"] = w(d, d)
            sd[pre + f"attention.attention.{name}.bias"] = w(d)
        sd[pre + "attention.output.dense.weight"] = w(d, d)
        sd[pre + "attention.output.dense.bias"] = w(d)
        sd[pre + "intermediate.dense.weight"] = w(m, d)
        sd[pre + "intermediate.dense.bias"] = w(m)
        sd[pre + "output.dense.weight"] = w(d, m)
        sd[pre + "output.dense.bias"] = w(d)
        for ln in ("layernorm_before", "layernorm_after"):
            sd[pre + f"{ln}.weight"] = 1 + w(d, scale=0.1)
            sd[pre + f"{ln}.bias"] = w(d, scale=0.1)
    return sd


def phase_label_path(smi: str, root: str, main: dict) -> dict:
    """self-label, finalize-clips, merge-clips, write-embeddings,
    clustering and fresh-test through the CLI on the card on phase 4's
    world, each checked against a host computation on the same card
    embeddings; then the HF import at full width and the native decoder."""
    t_phase = time.monotonic()
    db, query_dir, n_query = main["db"], main["query_dir"], main["n_query"]
    q_names = [f"vid2_frame_{f}.jpg" for f in range(1, n_query + 1)]
    q_paths = [os.path.join(query_dir, f) for f in q_names]
    sides = _query_sides()
    # The card embeddings of the query game, before the counted run (a
    # fresh engine of the same seeded weights: the kernels are
    # deterministic, so the verbs' engines compute the same rows).
    q_embs = embed.make_hf_frame_embedder(
        device="cuda", batch_size=BATCH).embed_paths(q_paths)
    _, _, corpus = common.load_corpus(db, "corpus", "cuda")
    n_corpus = len(corpus["labels"])
    fin_out = os.path.join(root, "clips_final")
    clip_dirs = [os.path.join(main["out"], d)
                 for d in sorted(os.listdir(main["out"])) if CLIP_RE.match(d)]
    clip_frames = [sorted(os.listdir(d), key=lambda f: int(
        FRAME_RE.match(f).group(1))) for d in clip_dirs]

    _zero_counts()
    db_label = os.path.join(root, "db_label")
    shutil.copytree(db, db_label)
    labels_csv = os.path.join(root, "labels.csv")
    emb_tpl = os.path.join(root, "emb_{cls}.npz")
    side_npz = os.path.join(root, "side.npz")
    fresh_out = os.path.join(root, "fresh")
    merged_out = os.path.join(root, "clips_merged")
    t0 = time.monotonic()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["self-label", query_dir, "--db", db_label, "--collection",
                  "corpus", "--out", labels_csv, "--upsert", "--batch-size",
                  str(BATCH), "--device", "cuda"])
        cli.main(["finalize-clips", "--clips", main["out"], "--db", db,
                  "--collection", "corpus", "--out", fin_out,
                  "--batch-size", str(BATCH), "--device", "cuda"])
        cli.main(["merge-clips", "--clips", fin_out, "--frame-pool",
                  query_dir, "--out", merged_out])
        cli.main(["write-embeddings", main["corpus_dir"], "--manual-csv",
                  main["corpus_csv"], "--out-template", emb_tpl,
                  "--batch-size", str(BATCH), "--device", "cuda"])
        cli.main(["clustering", "--db", db, "--collection", "corpus",
                  "--out", side_npz, "--device", "cuda"])
        cli.main(["fresh-test", query_dir, "--params", side_npz, "--out",
                  fresh_out, "--batch-size", str(BATCH), "--device",
                  "cuda"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    by_class = {s: sum(n for side, n in CORPUS_SEGMENTS if side == s)
                for s in SIDES}
    batches = (2 * math.ceil(n_query / BATCH)
               + sum(math.ceil(len(f) / BATCH) for f in clip_frames)
               + sum(math.ceil(n / BATCH) for n in by_class.values()))
    for line in buf.getvalue().splitlines():
        log(f"[5c]   | {line}")
    log(f"[5c] CLI self-label, finalize-clips, merge-clips, "
        f"write-embeddings, clustering, fresh-test on the card: {wall:.1f} "
        f"s wall; launches {launches} for {batches} engine batches")
    _check_launches(launches, batches, "label path")

    # self-label: the CSV against a float64 numpy two-pass on the same
    # card embeddings and corpus rows (tie-aware), and the planted sides
    with open(labels_csv) as fh:
        rows = list(csv.DictReader(fh))
    got_lab = np.array([SIDES.index(r["label"]) for r in rows])
    got_p = np.array([[float(r[f"{s}_prob"]) for s in SIDES] for r in rows])
    got_acc = np.array([r["pass"] == "1" for r in rows])
    w_lab, w_p, w_acc, near = _numpy_two_pass(
        q_embs, corpus["embeddings"], corpus["labels"], 25, 20, 7.0)
    if [r["frame"] for r in rows] != q_names:
        raise AssertionError("self-label wrote other frames than the game's")
    bad = ((got_lab != w_lab) | (got_acc != w_acc)
           | (np.abs(got_p - w_p).max(1) > 1e-6))
    planted = np.array([SIDES.index(s) for s in sides])
    agree = float((got_lab == planted).mean())
    log(f"[5c] self-label: {int(got_acc.sum())} pass-1 + "
        f"{int((~got_acc).sum())} pass-2 frames; labels and probabilities "
        f"equal the numpy two-pass on {n_query - int(bad.sum())} of "
        f"{n_query} frames ({int(bad.sum())} differ, all near-ties: "
        f"{bool(not (bad & ~near).any())}); {100 * agree:.1f}% carry the "
        f"planted side")
    if (bad & ~near).any() or agree < 0.9:
        raise AssertionError(f"self-label disagrees: {int(bad.sum())} rows "
                             f"off the numpy two-pass, planted {agree:.3f}")
    client = PersistentClient(db_label, device="cpu")
    col = client.get_collection("corpus")
    added = set(col.get()["ids"]) - set(f"vid1_frame_{i}.jpg"
                                         for i in range(1, n_corpus + 1))
    want_added = {n for n, a in zip(q_names, got_acc) if a}
    if added != want_added or col.count() != n_corpus + len(want_added):
        raise AssertionError(f"--upsert added {len(added)} rows, want the "
                             f"{len(want_added)} pass-1 frames")
    log(f"[5c] self-label --upsert: {len(added)} new ids (the pass-1 "
        f"frames), {n_corpus} seed rows kept, profile "
        f"{col.embedding_profile!r}")

    # finalize-clips: each kept mask against a host sequential decode of
    # the same card probabilities (5-NN votes on the card)
    routes = {"host sequential": 0, "card log-depth": 0}
    kept_ranges = []
    eng = embed.make_hf_frame_embedder(device="cuda", batch_size=BATCH)
    for cdir, frames in zip(clip_dirs, clip_frames):
        side = CLIP_RE.match(os.path.basename(cdir)).group(2)
        embs = eng.embed_paths([os.path.join(cdir, f) for f in frames])
        nl, _, _ = knn.knn_labels(embs, corpus["embeddings"],
                                  corpus["labels"], 5, device="cuda")
        probs = np.maximum(knn.vote_counts(nl) / 5, 1e-6).astype(np.float32)
        routes["host sequential" if len(frames) < hmm._PARALLEL_THRESHOLD
               else "card log-depth"] += 1
        path, _ = viterbi_ops.viterbi(
            np.log(probs), viterbi_ops.log_transition_matrix(
                hmm.DEFAULT_TRANSITIONS).numpy(), np.log(hmm.UNIFORM_PRIOR))
        want = [f for f, s in zip(frames, path) if s == SIDES.index(side)]
        got = sorted(os.listdir(os.path.join(fin_out, os.path.basename(cdir))),
                     key=lambda f: int(FRAME_RE.match(f).group(1)))
        if got != want:
            raise AssertionError(f"finalize-clips kept {len(got)} frames of "
                                 f"{cdir}, the host decode {len(want)}")
        nums = [int(FRAME_RE.match(f).group(1)) for f in got]
        kept_ranges.append((side, min(nums), max(nums)))
    log(f"[5c] finalize-clips: {len(clip_dirs)} clips, kept "
        f"{[r[2] - r[1] + 1 for r in kept_ranges]} of "
        f"{[len(f) for f in clip_frames]} frames, each mask equal to the "
        f"host sequential decode of the card's 5-NN votes; decodes by route "
        f"{routes}")
    if routes["card log-depth"]:
        raise AssertionError("a short clip took the log-depth route")
    merged = _clip_ranges(merged_out)
    planted_m = clips_mod.merge_clip_ranges(main["planted"])
    log(f"[5c] merge-clips: {merged}; merge_clip_ranges of the planted "
        f"possessions {planted_m}")
    if merged != clips_mod.merge_clip_ranges(kept_ranges) or \
            len(merged) != len(planted_m) or any(
                g[0] != w[0] or abs(g[1] - w[1]) > PAD + BOUNDARY_SLACK
                or abs(g[2] - w[2]) > PAD + BOUNDARY_SLACK
                for g, w in zip(merged, planted_m)):
        raise AssertionError("merged clips miss the planted possessions")

    # write-embeddings: every row against the engine's row of that frame
    # (the corpus collection that write-frame-db wrote in phase 4)
    ids = {f"vid1_frame_{i}.jpg": i - 1 for i in range(1, n_corpus + 1)}
    rows_by_id = PersistentClient(db, device="cpu").get_collection(
        "corpus").get(include=("embeddings",))
    by_id = dict(zip(rows_by_id["ids"],
                     np.asarray(rows_by_id["embeddings"], np.float32)))
    err, n_rows = 0.0, 0
    for cls in SIDES:
        with np.load(emb_tpl.format(cls=cls)) as z:
            e, fids = z["embeddings"], list(z["frame_ids"])
        if e.shape != (by_class[cls], 1, 768) or not set(fids) <= set(ids):
            raise AssertionError(f"{cls} npz holds {e.shape}")
        err = max(err, float(np.abs(
            e[:, 0] - np.stack([by_id[f] for f in fids])).max()))
        n_rows += len(fids)
    log(f"[5c] write-embeddings: {n_rows} rows in 3 npz, max|err| "
        f"{err:.3e} against the engine's rows (bound {EMBED_BOUND:.0e})")
    if err > EMBED_BOUND:
        raise AssertionError(f"write-embeddings rows off by {err}")

    # clustering + fresh-test: buckets against a CPU classification of the
    # card embeddings with the saved npz (tie-aware)
    try:
        import sklearn  # noqa: F401
        km = "sklearn KMeans"
    except ImportError:
        km = "numpy Lloyd (sklearn is not installed)"
    model = clustering.SideMLP(768, 3)
    model.load_state_dict(convert.side_mlp_to_state_dict(
        checkpoint.load_params_npz(None, side_npz)))
    with torch.no_grad():
        logits = model(torch.from_numpy(q_embs)).numpy()
    top2 = np.sort(logits, axis=1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= 1e-5
    pred = logits.argmax(1)
    got_pred = np.full(n_query, -1)
    for s, side in enumerate(SIDES):
        for f in os.listdir(os.path.join(fresh_out, side)):
            got_pred[q_names.index(f)] = s
    differ = got_pred != pred
    acc = float((got_pred == planted).mean())
    log(f"[5c] clustering: kmeans route {km}; fresh-test buckets equal the "
        f"CPU classification on {n_query - int(differ.sum())} of {n_query} "
        f"frames (the rest top-two ties: {bool(not (differ & ~tie).any())});"
        f" side accuracy against the planted sides {100 * acc:.1f}%")
    if (got_pred < 0).any() or (differ & ~tie).any():
        raise AssertionError("fresh-test buckets differ from the CPU "
                             "classification")

    # HF import at full width: a ViTModel-shaped state dict through the
    # port's mapping, card engine vs the CPU plain forward
    sd = hf_import.hf_state_dict_to_state_dict(_hf_state_dict(),
                                               hf_import.HF_VIT_B16_224)
    card = embed.make_hf_frame_embedder(sd, device="cuda", batch_size=BATCH)
    paths8 = q_paths[::n_query // 8][:8]
    got = card.embed_paths(paths8)
    host = embed.EmbeddingEngine(card.model.to("cpu"), card.spec,
                                 device="cpu", batch_size=8)
    want = host.embed_paths(paths8)
    err = float(np.abs(got - want).max())
    log(f"[5c] HF import (ViTModel keys and shapes, ViT-B/16 @224, seeded): "
        f"8 frames card vs CPU plain forward max|err| {err:.3e} (bound "
        f"{EMBED_BOUND:.0e})")
    if not (np.isfinite(got).all() and err <= EMBED_BOUND):
        raise AssertionError(f"HF-imported engine disagrees: {err}")
    del card, host, eng
    torch.cuda.empty_cache()

    # the native JPEG decoder against PIL, and both rates at 1080p -> 224
    reason = native.unavailable_reason()
    log(f"[5c] native JPEG decoder built: {reason is None}"
        + ("" if reason is None else f" ({reason}); the reference's PIL "
           "route decodes (load_frames(use_native=True) falls back)"))
    if reason is None:
        a = native.decode_batch(q_paths[:64], (224, 224), num_workers=8)
        b = load_frames(q_paths[:64], SPEC, num_workers=8)
        mad = float(np.abs(a.astype(int) - b.astype(int)).mean())
        log(f"[5c] native vs PIL on 64 phase-4 frames: mean |diff| "
            f"{mad:.3f} (bound 12)")
        if mad >= 12.0:
            raise AssertionError(f"native decode differs from PIL: {mad}")
    big = _write_1080p(os.path.join(root, "frames_1080p"), 256)
    rates = {}
    for name, fn in (("PIL", lambda: load_frames(big, SPEC, num_workers=8)),
                     ("native", lambda: native.decode_batch(
                         big, (224, 224), num_workers=8))):
        if name == "native" and reason is not None:
            continue
        fn()
        t0 = time.perf_counter()
        fn()
        rates[name] = len(big) / (time.perf_counter() - t0)
    log("[5c] JPEG decode 1920x1080 -> 224x224, 8 threads, 256 frames: "
        + ", ".join(f"{k} {v:.1f} frames/s" for k, v in rates.items())
        + f" | {smi}")
    log(f"[5c] phase 5c: {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches)


# ---- phase 5d: the fast profile -----------------------------------------

TOME_R = 16
FAST_ENV = ("VRT_TOME_R", "VRT_GEMM_QUANT", "VRT_GEMM_SCALES")
# Merge decisions taken on the card and on the CPU may differ only where
# the CPU's merge scores nearly tie (below this margin).
TIE_MARGIN = 1e-5
# int8 engines against the CPU forward of the same model: an ulp in a
# pre-GEMM activation (cuBLAS against the CPU) can move one int8 value by
# one step, so frames are held to a cosine, not to EMBED_BOUND.
INT8_COSINE = 0.999


@contextlib.contextmanager
def _env(**values):
    """Set the engine's env toggles for the block, then restore them."""
    old = {k: os.environ.get(k) for k in FAST_ENV}
    try:
        for k in FAST_ENV:
            os.environ.pop(k, None)
        os.environ.update({k: str(v) for k, v in values.items()})
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tome_sizes(b: int, t: int, r: int, layers: int, dev) -> list:
    """log(sizes) entering each ToMe block, from real merges of random
    tokens and keys: (T, (B, T) f32 log-size) per block."""
    g = torch.Generator(device=dev).manual_seed(1)
    sizes = torch.ones(b, t, device=dev)
    out = []
    for _ in range(layers):
        t = sizes.shape[1]
        out.append((t, torch.log(sizes)))
        x = torch.randn(b, t, 8, generator=g, device=dev)
        metric = torch.randn(b, t, 64, generator=g, device=dev)
        _, sizes = tome.bipartite_merge(x, metric, sizes, r)
    return out


def tome_bias_draws(dtype, g, biases, dev):
    """Kernel B's inputs at every ToMe T of ViT-B/16 @224 at r = 16 (B =
    256, H = 12, dh = 64): (T, key bias, q, k, v) with q/k/v drawn from
    ``g`` in projection order, as the ToMe blocks pass them."""
    for t, bias in biases:
        q, k, v = (torch.randn(BATCH, t, 12, 64, generator=g).to(
            dev, dtype).transpose(1, 2) for _ in range(3))
        yield t, bias, q, k, v


def phase_attention_bias(smi: str, dtypes=(torch.float32, torch.bfloat16)
                         ) -> dict:
    """Kernel B with ToMe's key bias at every ToMe T (tome_bias_draws from
    seed 7; ``dtypes`` in turn from one generator), f32 and bf16: against
    its plain version on the same values (f32 strictly within ATTN_BOUND,
    bf16 by bf16_tie_check against it), timed against the plain version
    and SDPA with the bias as a float mask (B, 1, 1, T). Returns per-dtype
    rows and sums, with bf16's tie-accepted rows. Every row is timed and
    logged (each tie-accepted row on a line of its own); then a row that
    fails its check raises (phase 5d, ``--kernel-b``)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    biases = _tome_sizes(BATCH, 197, TOME_R, 12, dev)
    out = {}
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        rows = []
        for t, bias, q, k, v in tome_bias_draws(dtype, g, biases, dev):
            got, variant = b_variants(
                lambda: attn.multi_head_attention(q, k, v, key_bias=bias))
            qc, kc, vc = (x.contiguous() for x in (q, k, v))
            errs, ties = {}, {}
            if dtype == torch.float32:
                err = (got - attn.attention_plain(qc, kc, vc, key_bias=bias)
                       ).abs().max().item()
                ok = err <= ATTN_BOUND[dtype]
            else:  # against the bf16 plain version, tie-aware
                errs = bf16_attention_errs(got, qc, kc, vc, bias,
                                           bound=ATTN_BOUND[dtype])
                err, ok = errs["err"], errs["ties"]["ok"]
                ties = dict(tie_summary(errs["ties"]),
                            rejected=errs["ties"]["rejected"])
            del got
            ms = cuda_ms(lambda: attn.multi_head_attention(
                q, k, v, key_bias=bias), reps=3, n=5)
            plain_ms = cuda_ms(lambda: attn.attention_plain(
                qc, kc, vc, key_bias=bias), reps=3, n=5)
            mask = bias[:, None, None, :].to(dtype)
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=mask), reps=3, n=5)
            lim = bound(4 * q.numel() * q.element_size() + bias.numel() * 4,
                        4 * BATCH * 12 * t * t * 64 + BATCH * 12 * t * t,
                        "f32" if dtype == torch.float32 else "bf16")
            rows.append(dict(T=t, max_abs_err=err, ok=ok, ms=ms,
                             plain_ms=plain_ms, library_ms=sdpa_ms,
                             launched=variant, **lim, **ties,
                             **{f"max_abs_err_{key}": errs[key]
                                for key in ("f32_scores", "f32_plain")
                                if key in errs}))
            del q, k, v, qc, kc, vc, mask
        for r in rows:
            old = "" if dtype == torch.float32 else (
                f"; {tie_text(r)}"
                f"; f32 scores {r['max_abs_err_f32_scores']:.3e}, f32 plain "
                f"{r['max_abs_err_f32_plain']:.3e}")
            log(f"[5d] attention + key bias B={BATCH} H=12 T={r['T']} dh=64 "
                f"{name}: max|err| {r['max_abs_err']:.3e} (bound "
                f"{ATTN_BOUND[dtype]:.0e}{old}) | kernel {r['launched']} "
                f"{r['ms']:.4f} ms | "
                f"plain "
                f"{r['plain_ms']:.4f} ms | SDPA+mask {r['library_ms']:.4f} ms"
                f" | {bound_text(r)}")
            for row in r.get("accepted", []):
                log(f"[5d]   T={r['T']} {name} accepted by a tie: "
                    f"{tie_row_text(row)}")
        sums = {key: sum(r[key] for r in rows)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        log(f"[5d] attention + key bias {name}, the 12 ToMe blocks of one "
            f"batch: kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f}"
            f" ms, SDPA+mask {sums['library_ms']:.4f} ms, bound "
            f"{sums['bound_ms']:.4f} ms | {smi}")
        failed = [dict(T=r["T"], max_abs_err=r["max_abs_err"],
                       rejected=r.get("rejected")) for r in rows
                  if not r["ok"]]
        if failed:
            log(f"[5d] attention + key bias {name}: beyond the bound "
                f"{ATTN_BOUND[dtype]:.0e}, not a tie, at {failed} | {smi}")
            raise AssertionError(f"attention kernel with key bias "
                                 f"disagrees in {name} at {failed}")
        out[name] = dict(
            tie_accepted={r["T"]: r["accepted"] for r in rows
                          if r.get("accepted")},
            near_ties=[r.get("near_ties") for r in rows],
            T=[r["T"] for r in rows], ms=[r["ms"] for r in rows],
            launched=[r["launched"] for r in rows],
            plain_ms=[r["plain_ms"] for r in rows],
            library_ms=[r["library_ms"] for r in rows],
            bound_ms=[r["bound_ms"] for r in rows],
            bound_by=[r["bound_by"] for r in rows],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            **{f"{key}_per_batch": v for key, v in sums.items()})
    torch.cuda.empty_cache()
    return out


def _merge_margin(metric: torch.Tensor, r: int) -> torch.Tensor:
    """(B,) smallest margin of one merge's decisions: the gap between each
    source's best and second-best destination score, and the gap at the
    r-th place of the sorted best scores (CLS left out)."""
    m = metric.to(torch.float32)
    src, dst = m[:, 0::2], m[:, 1::2]
    src = src / torch.linalg.vector_norm(src, dim=-1, keepdim=True).clamp_min(
        1e-6)
    dst = dst / torch.linalg.vector_norm(dst, dim=-1, keepdim=True).clamp_min(
        1e-6)
    scores = torch.bmm(src, dst.transpose(1, 2))[:, 1:]
    top = scores.topk(min(2, scores.shape[2]), dim=-1).values
    gap = (top[..., 0] - top[..., -1]).amin(dim=1) if top.shape[-1] > 1 \
        else torch.full((m.shape[0],), math.inf)
    best = torch.sort(top[..., 0], dim=1, descending=True).values
    r = min(r, best.shape[1])
    edge = (best[:, r - 1] - best[:, r]) if r < best.shape[1] \
        else torch.full_like(gap, math.inf)
    return torch.minimum(gap, edge)


def _tome_engine_check(paths: list, frames: np.ndarray) -> None:
    """The ToMe r=16 f32 engine (B = 256) on 8 frames on the card against
    the CPU forward of the same model: token sizes, embeddings, margins."""
    card = embed.make_hf_frame_embedder(device="cuda", batch_size=BATCH,
                                        tome_r=TOME_R)

    def endpoints(eng):
        out = eng.encode(torch.from_numpy(frames).to(eng.device))
        emb = out["pooled"].float()
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb.cpu().numpy(), out["token_sizes"].cpu().numpy()

    got, got_sizes = endpoints(card)
    margins = []
    merge = vit_mod.bipartite_merge

    def recording(x, metric, sizes, r):
        margins.append(_merge_margin(metric, r))
        return merge(x, metric, sizes, r)

    host = embed.EmbeddingEngine(card.model.to("cpu"), card.spec,
                                 device="cpu", batch_size=8)
    vit_mod.bipartite_merge = recording
    try:
        want, want_sizes = endpoints(host)
    finally:
        vit_mod.bipartite_merge = merge
    margin = torch.stack(margins).amin(dim=0).numpy()  # per frame
    same = np.all(got_sizes == want_sizes, axis=1)
    err = float(np.abs(got[same] - want[same]).max()) if same.any() else 0.0
    log(f"[5d] ToMe r={TOME_R} f32 engine, 8 frames card vs CPU: token sizes "
        f"{got_sizes.shape[1]} a frame, equal on {int(same.sum())}/8 frames;"
        f" max|err| {err:.3e} there (bound {EMBED_BOUND:.0e}); smallest "
        f"merge-score margin {margin.min():.3e}, on frames whose sizes "
        f"differ {margin[~same].tolist()}")
    if not (np.isfinite(got).all() and err <= EMBED_BOUND):
        raise AssertionError(f"ToMe embeddings disagree: {err}")
    if np.any(margin[~same] >= TIE_MARGIN):
        raise AssertionError("ToMe merged other tokens on the card than on "
                             "the CPU away from a tie")


def _int8_engine_check(name: str, frames: np.ndarray, f32: np.ndarray,
                       **kw) -> None:
    card = embed.make_hf_frame_embedder(device="cuda", batch_size=BATCH,
                                        **kw)
    got = card.embed_batch(frames)
    want = embed.EmbeddingEngine(card.model.to("cpu"), card.spec,
                                 device="cpu", batch_size=8
                                 ).embed_batch(frames)
    cos = np.sum(got * want, axis=1)
    err = float(np.abs(got - want).max())
    to_f32 = np.sum(got * f32, axis=1)
    log(f"[5d] {name} f32 engine, 8 frames card vs CPU: cosine min "
        f"{cos.min():.7f} (bound {INT8_COSINE}), max|err| {err:.3e}; cosine "
        f"to the f32 engine's embeddings min {to_f32.min():.5f} mean "
        f"{to_f32.mean():.5f}")
    if not (np.isfinite(got).all() and cos.min() >= INT8_COSINE):
        raise AssertionError(f"{name} embeddings disagree: cosine "
                             f"{cos.min()}")


def _stderr_of(argv: list) -> tuple:
    """(exit code or None, stderr) of ``cli.main(argv)``."""
    buf = io.StringIO()
    code = None
    with contextlib.redirect_stderr(buf):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
            buf.write(str(e.code))
    return code, buf.getvalue()


def phase_fast_path(smi: str, root: str, main: dict) -> dict:
    """The fast profile on phase 4's world: kernel B with the key bias,
    bipartite_merge on the card, the ToMe and int8 engines against the CPU,
    calibrate-int8 -> write-frame-db -> strided segment under the fast env
    (the clips against the planted possessions), the profile fence and the
    stride refusals, serve under the fast env, and the engines' rates."""
    t_phase = time.monotonic()
    dev = torch.device("cuda")
    bias_summary = phase_attention_bias(smi)

    # bipartite_merge on identical inputs on the card and the CPU
    g = torch.Generator().manual_seed(3)
    x = torch.randn(BATCH, 197, 768, generator=g)
    metric = torch.randn(BATCH, 197, 64, generator=g)
    sizes = torch.randint(1, 4, (BATCH, 197), generator=g).float()
    want = tome.bipartite_merge(x, metric, sizes, TOME_R)
    got = [a.cpu() for a in tome.bipartite_merge(
        x.to(dev), metric.to(dev), sizes.to(dev), TOME_R)]
    m_cpu, m_card = tome.match(metric, TOME_R), tome.match(metric.to(dev),
                                                           TOME_R)
    same = ((m_cpu[0] == m_card[0].cpu()).all(1)
            & (m_cpu[1] == m_card[1].cpu()).all(1)).numpy()
    margin = _merge_margin(metric, TOME_R).numpy()
    err = max(float((a[same] - b[same]).abs().max()) for a, b in
              zip(got, want)) if same.any() else 0.0
    log(f"[5d] bipartite_merge B={BATCH} T=197 D=768 r={TOME_R}, card vs "
        f"CPU: merged sources and destinations equal on {int(same.sum())}/"
        f"{BATCH} rows, max|err| {err:.3e} there (bound 1e-6); smallest "
        f"merge-score margin {margin.min():.3e}")
    if err > 1e-6 or np.any(margin[~same] >= TIE_MARGIN):
        raise AssertionError("bipartite_merge differs between the card and "
                             "the CPU")
    del x, metric, sizes, want, got

    # the engines against the CPU forward of the same port model
    query_dir, n_query = main["query_dir"], main["n_query"]
    paths = [os.path.join(query_dir, f"vid2_frame_{f}.jpg")
             for f in range(1, n_query + 1, 97)][:8]
    frames = load_frames(paths, SPEC)
    _tome_engine_check(paths, frames)
    f32 = embed.make_hf_frame_embedder(device="cuda", batch_size=BATCH
                                       ).embed_batch(frames)

    # calibrate-int8, then the fast profile's write-frame-db and segment
    scales_path = os.path.join(root, "scales.json")
    t0 = time.monotonic()
    with _env(VRT_TOME_R=TOME_R), contextlib.redirect_stdout(io.StringIO()):
        cli.main(["calibrate-int8", main["corpus_dir"], "--out", scales_path,
                  "--device", "cuda"])
    scales = json.load(open(scales_path))["scales"]
    log(f"[5d] calibrate-int8 (bf16 ViT-B/16, ToMe r={TOME_R}, 8 corpus "
        f"frames) on the card: {len(scales)} scales in "
        f"{time.monotonic() - t0:.1f} s, range {min(scales):.4g}.."
        f"{max(scales):.4g}")
    if len(scales) != 72 or not all(s > 0 for s in scales):
        raise AssertionError(f"calibrate-int8 wrote {len(scales)} scales")
    _int8_engine_check("int8 (dynamic)", frames, f32, gemm_quant="int8")
    _int8_engine_check("int8-static", frames, f32, gemm_quant="int8-static",
                       gemm_quant_scales=scales)
    fast = dict(VRT_TOME_R=TOME_R, VRT_GEMM_QUANT="int8-static",
                VRT_GEMM_SCALES=scales_path)
    db = os.path.join(root, "db_fast")
    out = os.path.join(root, "clips_fast")
    n_corpus = sum(n for _, n in CORPUS_SEGMENTS)
    _zero_counts()
    t0 = time.monotonic()
    buf = io.StringIO()
    with _env(**fast), contextlib.redirect_stdout(buf):
        profile = common.engine_profile()
        cli.main(["write-frame-db", main["corpus_dir"], "--manual-csv",
                  main["corpus_csv"], "--db", db, "--collection", "corpus",
                  "--batch-size", str(BATCH), "--device", "cuda"])
        cli.main(["segment", query_dir, "--method", "knn-hmm", "--db", db,
                  "--corpus-collection", "corpus", "--k", "50", "--out", out,
                  "--vid", "2", "--min-len", str(MIN_LEN), "--pad", str(PAD),
                  "--batch-size", str(BATCH), "--frame-stride", "4",
                  "--stride-refine", "auto", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    text = buf.getvalue()
    refine = re.search(r"stride-refine: (\d+)/(\d+) gaps hot \((\d+) frames",
                       text)
    keys = len(range(0, n_query, 4)) + ((n_query - 1) % 4 != 0)
    n_refined = int(refine.group(3)) if refine else -1
    batches = (math.ceil(n_corpus / BATCH) + math.ceil(keys / BATCH)
               + math.ceil(n_refined / BATCH))
    log(f"[5d] CLI write-frame-db + segment --frame-stride 4 --stride-refine "
        f"auto under VRT_TOME_R={TOME_R} VRT_GEMM_QUANT=int8-static: "
        f"{wall:.1f} s wall; {refine.group(0) if refine else 'no refine line'}"
        f" of {keys} keys; launches {launches} for {batches} engine batches")
    for line in text.splitlines():
        log(f"[5d]   {line}")
    _check_launches(launches, batches, "fast path")
    _, col, _ = common.load_corpus(db, "corpus", "cuda", check_profile=False)
    log(f"[5d] fast collection profile {col.embedding_profile!r}")
    if col.embedding_profile != profile or not profile.startswith(
            f"torch|tome{TOME_R}|quant-int8-static:"):
        raise AssertionError(f"fast collection stamped "
                             f"{col.embedding_profile!r}")
    clips, planted = _clip_ranges(out), main["planted"]
    log(f"[5d] fast-profile clips {clips}; planted possessions {planted}")
    if len(clips) != len(planted) or any(
            side != p_side
            or abs(s - max(1, p_s - PAD)) > BOUNDARY_SLACK
            or abs(e - min(n_query, p_e + PAD)) > BOUNDARY_SLACK
            for (side, s, e), (p_side, p_s, p_e) in zip(clips, planted)):
        raise AssertionError("fast-profile clips miss the planted "
                             "possessions")

    # the profile fence and the stride refusals
    code, err = _stderr_of(["write-frame-db", main["corpus_dir"],
                            "--manual-csv", main["corpus_csv"], "--db", db,
                            "--collection", "corpus", "--batch-size",
                            str(BATCH), "--device", "cuda"])
    refused = code not in (None, 0) and "mixing embedding spaces" in err
    with contextlib.redirect_stdout(io.StringIO()):
        _, warn = _stderr_of(["search", paths[0], "--db", db, "--collection",
                              "corpus", "--k", "3", "--device", "cuda"])
    warned = "distances across profiles are not comparable" in warn
    events = os.path.join(root, "events.json")
    with open(events, "w") as fh:
        json.dump({"clips/vid2_clip_1_left": {"event_make": [[60, 61]]}}, fh)
    seg = ["segment", query_dir, "--method", "knn-hmm", "--out",
           os.path.join(root, "clips_refused"), "--vid", "2",
           "--frame-stride", "4", "--event-template", events, "--device",
           "cuda"]
    code_t, err_t = _stderr_of(seg)
    # with --force-stride the check warns and the run goes on, to the next
    # check (no corpus given), before any engine starts
    code_f, err_f = _stderr_of(seg + ["--force-stride"])
    log(f"[5d] parity-env write into the fast db refused: {refused}; read "
        f"warns: {warned}; 2-frame event at stride 4 exits {code_t}; with "
        f"--force-stride warns: {'WARNING' in err_f}")
    if not (refused and warned and code_t not in (None, 0)
            and "shortest labeled event" in err_t
            and "--force-stride given" in err_f and "needs --db" in err_f):
        raise AssertionError("a fast-profile refusal did not hold")

    # serve under the fast env: a binary embed and a live session
    sock = os.path.join(os.path.dirname(_socket_path(root)), "f.sock")
    with _env(**fast):
        thread, errors = _serve_thread(
            ["serve", "--socket", sock, "--db", db, "--collection", "corpus",
             "--batch-size", str(BATCH), "--warmup", "--device", "cuda"])
        _await_ready(sock, errors)
        ref = common._engine(BATCH, "cuda")
        game = [os.path.join(query_dir, f"vid2_frame_{f}.jpg")
                for f in range(1, n_query + 1)]
        frames16 = load_frames(game[:16], SPEC)
        want = ref.embed_batch(frames16)
        r = serve.request_binary(sock, {"op": "embed"}, frames=frames16,
                                 timeout=120.0)
        err = _max_err(r["embeddings"], want)
        seen = []
        with serve.SessionClient(sock, timeout=120.0) as c:
            ok = c.request({"op": "segment_start", "k": 50,
                            "min_len": MIN_LEN, "pad": PAD}).get("ok")
            for i in range(3):
                rr = c.request({"op": "segment_push",
                                "paths": game[64 * i:64 * i + 64]})
                ok = ok and rr.get("ok")
                seen.append(rr.get("frames_seen"))
            ok = ok and c.request({"op": "segment_finish"}).get("ok")
        stats = serve.request(sock, {"op": "stats"}, timeout=60.0)
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["serve-ctl", "shutdown", "--socket", sock])
        thread.join(timeout=60.0)
    log(f"[5d] serve --warmup under the fast env: 16-frame binary embed "
        f"max|err| {err:.3e} against the in-process fast engine (bound "
        f"{EMBED_BOUND:.0e}); live session of 3 pushes ok {bool(ok)}, frames "
        f"seen {seen}; engine profile {stats.get('engine_profile')!r}")
    if err > EMBED_BOUND or not ok or seen != [64, 128, 192] \
            or thread.is_alive() or errors \
            or stats.get("engine_profile") != profile:
        raise AssertionError("the daemon under the fast env disagrees")
    del ref

    # the engines' rates, side by side in this call
    rates = {}
    for label, dtype, batch, kw in (
            ("parity f32", "float32", BATCH, {}),
            (f"ToMe r={TOME_R} f32", "float32", BATCH, dict(tome_r=TOME_R)),
            ("int8 f32", "float32", BATCH, dict(gemm_quant="int8")),
            (f"ToMe r={TOME_R} + int8-static f32", "float32", BATCH,
             dict(tome_r=TOME_R, gemm_quant="int8-static",
                  gemm_quant_scales=scales)),
            (f"ToMe r={TOME_R} bf16", "bfloat16", 512, dict(tome_r=TOME_R))):
        rates[label] = _embed_rate(dtype, batch, **kw)
        torch.cuda.empty_cache()
    log("[5d] embed rate ViT-B/16 @224, frames/s (host clock, 16 batches): "
        + "; ".join(f"{k} B={b}: {v:.1f}" for (k, v), b in zip(
            rates.items(), (BATCH, BATCH, BATCH, BATCH, 512)))
        + f" | {smi}")
    log(f"[5d] phase 5d: {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, attention_key_bias=bias_summary,
                rates=rates)


def _concurrent(fns: list) -> list:
    """Run the callables on one thread each; results in order, the first
    error raised."""
    out, threads = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except BaseException as e:
            out[i] = e

    for i in range(len(fns)):
        threads.append(threading.Thread(target=run, args=(i,)))
        threads[-1].start()
    for t in threads:
        t.join(timeout=300.0)
        if t.is_alive():
            raise TimeoutError("a concurrent client did not finish")
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out


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


# ---- phase 5e: stage-1 training and write-ratt-db ------------------------

# The rows of write-ratt-db on the card against a CPU plain forward of the
# same restored encoder: 3 f32 layers summed in other orders, then L2
# normalised.
RATT_ROW_BOUND = 1e-4
# The dropout-0 trajectory on the card against the CPU, 20 steps from one
# initial state. Adam divides each gradient by its running RMS, so an
# element whose gradient is rounding noise (the key projection's bias,
# whose gradient is zero: the softmax removes a per-query constant; rare
# elements near zero) takes steps of up to ~lr in either direction.
# Parameters, as tests/test_torch_train.py holds the port against JAX:
# every element within lr a step, and of the elements outside the key
# biases at most TRAJ_OFF_SHARE beyond 1e-5 + 1e-3 relative. Per-epoch
# losses: relative TRAJ_LOSS_RTOL. The same card run with a planted fault
# (_Attention's dq zeroed) must fail these checks.
TRAJ_LOSS_RTOL = 2e-3
TRAJ_OFF_SHARE = 1e-4
# The optimizer alone on identical gradients: the same f32 update on both
# devices, an ulp apart on weights of order 0.1: 1e-6.
TRAJ_OPT_BOUND = 1e-6
STAGE1_BATCH = 32


def _stage1_encoder(cfg: ChunkEncoderConfig, seed: int | None = None):
    """A ChunkEncoder of ``cfg`` (seeded when ``seed`` is given); at
    dropout 0 its class head's dropout is 0 too."""
    model = heads.ChunkEncoder(cfg, generator=None if seed is None else
                               torch.Generator().manual_seed(seed))
    if not cfg.dropout_rate:
        model.class_head.dropout.p = 0.0
    return model


@contextlib.contextmanager
def _planted_zero_dq():
    """A planted fault: _Attention's backward returns a zero dq."""
    orig = attn._Attention.backward

    def backward(ctx, grad):
        dq, *rest = orig(ctx, grad)
        return (None if dq is None else torch.zeros_like(dq), *rest)

    attn._Attention.backward = staticmethod(backward)
    try:
        yield
    finally:
        attn._Attention.backward = staticmethod(orig)


@contextlib.contextmanager
def _plain_attention():
    """Kernel B swapped for its plain version on the card (the S1
    bisection): ``_launch`` computes ``attention_plain`` and counts no
    launch."""
    orig = attn._launch
    attn._launch = lambda q, k, v, scale, key_bias: attn.attention_plain(
        q, k, v, scale=scale, key_bias=key_bias)
    try:
        yield
    finally:
        attn._launch = orig


def _trajectory_errs(h_c, p_c, h_h, p_h) -> dict:
    """Card run (losses ``h_c``, parameters ``p_c``) against the CPU run:
    the losses' relative max error, the parameters' max error, and the
    share (and the worst tensor) of elements outside the key biases beyond
    1e-5 + 1e-3 relative."""
    loss = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
               for a, b in zip(h_c, h_h) for k in ("train_loss", "val_loss"))
    p_err = max(float((p_c[k] - p_h[k]).abs().max()) for k in p_h)
    off = {k: int(((p_c[k] - p_h[k]).abs() > 1e-5 + 1e-3 * p_h[k].abs())
                  .sum()) for k in p_h if not k.endswith("attn.key.bias")}
    share = sum(off.values()) / sum(p_h[k].numel() for k in off)
    worst = max(off, key=lambda k: off[k] / p_h[k].numel())
    return dict(loss=loss, param=p_err, off_share=share,
                worst=f"{worst} {off[worst]}/{p_h[worst].numel()}")


def _write_ratt_rate(smi: str, root: str, params: dict,
                     n_frames: int = 200_000) -> dict:
    """write_ratt_chunk_db at a game's size: a seeded 200,000 x 768 frame
    store (a 2-hour game), chunks of 8 frames at stride 2 (~100,000) in
    possessions of 300 frames, encoded by the stage-1 encoder ``params``
    on the card into a cosine collection, then flushed. Times the library
    call and the flush, not the CLI's start-up, store open or restore."""
    rng = np.random.default_rng(11)
    store = FrameStore.build(
        [f"vid9/frame_{i:06d}.jpg" for i in range(n_frames)],
        lambda ps: rng.standard_normal((len(ps), 768), dtype=np.float32),
        os.path.join(root, "game_store"), batch_size=8192)
    start = np.arange(0, n_frames - 7, 2)
    poss = start // 300
    idx = {"frame_idx": (start[:, None] + np.arange(8)).astype(np.int32),
           "label": (poss % 2).astype(np.int32),
           "status_id": (poss % 2 + 1).astype(np.int32),
           "vid": np.full(len(start), 9, np.int32),
           "clip": poss.astype(np.int32),
           "start_idx": start.astype(np.int32),
           "end_idx": (start + 7).astype(np.int32),
           "t_center": ((start % 300 + 4) / 300).astype(np.float32),
           "t_width": np.full(len(start), 8 / 300, np.float32),
           "side": np.where(poss % 2, "left", "right")}
    model = heads.ChunkEncoder(ChunkEncoderConfig(max_len=8)).cuda()
    encode = tce.make_encode_fn(model, params)
    enc_s = [0.0]

    def timed_encode(frame_embs):
        t0 = time.perf_counter()
        out = encode(frame_embs)  # numpy back: synchronised
        enc_s[0] += time.perf_counter() - t0
        return out

    client = PersistentClient(os.path.join(root, "db_game"), device="cuda")
    col = client.get_or_create_collection(
        "ratt_db", metadata={"hnsw:space": "cosine"})
    t0 = time.perf_counter()
    n = write_ratt_chunk_db(idx, store, timed_encode, col)
    t1 = time.perf_counter()
    client.flush()
    wall = time.perf_counter() - t0
    if n != len(start) or col.count() != n:
        raise AssertionError(f"game-size write-ratt-db wrote {n} rows, "
                             f"{col.count()} stored, want {len(start)}")
    log(f"[5e] write_ratt_chunk_db at a game's size: {n} chunks of 8 from "
        f"a {n_frames} x 768 store in {wall:.2f} s ({n / wall:.1f} rows/s; "
        f"encode on the card {enc_s[0]:.2f} s, {100 * enc_s[0] / wall:.1f}%"
        f" of it, {math.ceil(n / 256)} batches of 256; the flush "
        f"{wall - (t1 - t0):.2f} s) | {smi}")
    del col, client, model
    torch.cuda.empty_cache()
    return dict(write_ratt_rows_per_s=n / wall,
                write_ratt_encode_share=enc_s[0] / wall,
                write_ratt_flush_share=(wall - (t1 - t0)) / wall,
                write_ratt_rows=n)


def _stage1_step_fn(model, opt, x, y):
    def step():
        _, logits = model(x)
        loss = 0.5 * tce.losses.bce_with_logits(y * 0.9 + 0.05, logits)
        opt.step(torch.autograd.grad(loss, opt.params))
    return step


def _stage1_times(smi: str) -> dict:
    """ms per train step (B = 32, dropout 0.1: attention on the plain path;
    dropout 0: kernel B and its Function's backward) and per eval batch
    (B = 32, kernel B), ChunkEncoder at full width on seeded inputs."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(STAGE1_BATCH, 8, 768, generator=g, device=dev)
    y = (torch.rand(STAGE1_BATCH, generator=g, device=dev) > 0.5).float()
    out = {}
    for rate in (0.1, 0.0):
        model = _stage1_encoder(
            ChunkEncoderConfig(max_len=8, dropout_rate=rate), 0) \
            .to(dev).train()
        vit_mod.set_dropout_generator(
            model, tce.dropout_generator(0, 0, dev))
        opt = tce.stage1_optimizer(list(model.parameters()), 5e-5, 1.0, 5e-4)
        out[f"train_step_ms_dropout_{rate}"] = cuda_ms(
            _stage1_step_fn(model, opt, x, y), reps=3, n=10)
    model.eval()
    with torch.no_grad():
        out["eval_batch_ms"] = cuda_ms(lambda: model(x))
    log(f"[5e] ChunkEncoder 768x3, 8 heads, B={STAGE1_BATCH} x 8 frames: "
        f"train step {out['train_step_ms_dropout_0.1']:.3f} ms (dropout 0.1,"
        f" plain attention), {out['train_step_ms_dropout_0.0']:.3f} ms "
        f"(dropout 0, kernel B + its Function); eval batch "
        f"{out['eval_batch_ms']:.3f} ms | {smi}")
    return out


def phase_stage1_path(smi: str, root: str) -> dict:
    """Stage 1 on phase 5's frame store (ViT-B/16 card embeddings, chunk
    8, stride 2, labelled left 1 / right 0): train-stage1 for 2 epochs,
    then --resume for a third, then write-ratt-db, through the CLI on the
    card at full width (768, 3 layers, 8 heads: dh = 96). Checks the
    resumed step, every ratt_db row against a CPU plain forward of the
    restored best encoder, search of 8 stored rows, kernel B's launches (3
    a validation or encode batch; training at dropout 0.1 takes the plain
    path), and a dropout-0 card vs CPU trajectory of 20 steps."""
    t_phase = time.monotonic()
    store_dir = os.path.join(root, "store")
    ck, db = os.path.join(root, "ckpt_s1"), os.path.join(root, "db_s1")
    fs = FrameStore(store_dir).open()
    idx = load_chunk_index(store_dir)
    n = len(idx["label"])
    if set(np.unique(idx["label"])) != {0, 1} or idx["frame_idx"].shape[1] \
            != 8:
        raise AssertionError(f"stage-1 store: labels "
                             f"{np.unique(idx['label'])}, chunk "
                             f"{idx['frame_idx'].shape}")
    n_train = max(int(n * 0.8), 1)
    n_val = n - n_train
    per_epoch = n_train // STAGE1_BATCH
    train_argv = ["train-stage1", "--store", store_dir, "--ckpt", ck,
                  "--run-id", "s1", "--batch-size", str(STAGE1_BATCH),
                  "--device", "cuda"]

    _zero_counts()
    t0 = time.monotonic()
    cli.main(train_argv + ["--epochs", "2"])
    torch.cuda.synchronize()
    t_train = time.monotonic() - t0
    mngr = checkpoint.CheckpointManager(ck, "s1")
    first = mngr.restore(1)["step"]
    t0 = time.monotonic()
    cli.main(train_argv + ["--epochs", "3", "--resume"])
    torch.cuda.synchronize()
    t_resume = time.monotonic() - t0
    resumed = mngr.restore(2)["step"]
    t0 = time.monotonic()
    cli.main(["write-ratt-db", "--store", store_dir, "--ckpt", ck, "--db",
              db, "--run-id", "s1", "--device", "cuda"])
    torch.cuda.synchronize()
    t_write = time.monotonic() - t0
    launches = _launch_counts()
    val_batches = 3 * math.ceil(n_val / STAGE1_BATCH)
    enc_batches = math.ceil(n / 256)
    log(f"[5e] CLI train-stage1 (2 epochs) {t_train:.1f} s, --resume (1 "
        f"more) {t_resume:.1f} s, write-ratt-db {t_write:.1f} s wall on "
        f"{n} chunks ({n_train} train, {n_val} val); launches {launches} "
        f"for {val_batches} validation + {enc_batches} encode batches")
    if (first, resumed) != (2 * per_epoch, 3 * per_epoch):
        raise AssertionError(f"steps after 2 epochs {first}, after the "
                             f"resumed third {resumed}; want "
                             f"{2 * per_epoch}, {3 * per_epoch}")
    epochs = [r["step"] for r in read_metrics(
        os.path.join(mngr.dir, "metrics.jsonl"))]
    if epochs != [0, 1, 2]:
        raise AssertionError(f"metrics.jsonl holds epochs {epochs}")
    want_launches = {"patch_embed": 0,
                     "attention": 3 * (val_batches + enc_batches)}
    if launches != want_launches:
        raise AssertionError(f"stage-1 launches {launches}, want "
                             f"{want_launches}")

    # (a) every row against a CPU plain forward of the restored best
    col = PersistentClient(db, device="cuda").get_collection("ratt_db")
    ids = [f"chunk_{i}" for i in range(n)]
    got = col.get(ids=ids, include=("embeddings", "metadatas"))
    if got["ids"] != ids or col.embedding_profile != fs.embedding_profile:
        raise AssertionError("ratt_db rows or profile differ from the store")
    host = heads.ChunkEncoder(ChunkEncoderConfig(max_len=8))
    encode = tce.make_encode_fn(host, mngr.restore_best()["params"])
    embs, logits = encode(gather_chunk_embedding_batch(fs, idx,
                                                      np.arange(n)))
    embs = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
    row_err = float(np.abs(np.asarray(got["embeddings"]) - embs).max())
    logit_err = max(abs(m["class_logit"] - float(x))
                    for m, x in zip(got["metadatas"], logits.reshape(-1)))
    acc = float(np.mean((logits.reshape(-1) > 0) == (idx["label"] == 1)))
    log(f"[5e] ratt_db {n} rows vs the CPU plain forward of the best "
        f"epoch: max|err| {row_err:.3e} (bound {RATT_ROW_BOUND:.0e}), "
        f"class logits {logit_err:.3e}; profile {col.embedding_profile!r}; "
        f"the encoder's accuracy on all chunks {acc:.3f}")
    if not (row_err <= RATT_ROW_BOUND and logit_err <= RATT_ROW_BOUND):
        raise AssertionError(f"ratt_db rows disagree: {row_err}, "
                             f"{logit_err}")

    # (b) search of 8 stored rows ranks each row first
    picks = np.linspace(0, n - 1, 8).astype(int)
    qpath = os.path.join(root, "s1_queries.npz")
    np.savez(qpath, rows=np.asarray(got["embeddings"])[picks])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["search", "--npz", qpath, "--db", db, "--collection",
                  "ratt_db", "--k", "3", "--device", "cuda"])
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    firsts = [r["neighbors"][0] for r in lines]
    ok = all(nb["id"] == f"chunk_{i}" or nb["distance"] <= 1e-6
             for nb, i in zip(firsts, picks))
    log(f"[5e] search 8 stored rows in ratt_db: first neighbours "
        f"{[nb['id'] for nb in firsts]} at distances "
        f"{[nb['distance'] for nb in firsts]}")
    if len(lines) != 8 or not ok:
        raise AssertionError("search does not rank the stored rows first")

    # (d) dropout-0 trajectory, card vs CPU, 20 steps from one state; the
    # optimizer alone first, on one seeded gradient sequence
    cfg0 = ChunkEncoderConfig(max_len=8, dropout_rate=0.0)
    init = _stage1_encoder(cfg0, 7).state_dict()
    g = torch.Generator().manual_seed(1)
    grad_seq = [[torch.randn(v.shape, generator=g) * (1e-3 if i % 3 else 1)
                 for v in init.values()] for i in range(20)]
    opt_runs = []
    for dev in ("cuda", "cpu"):
        params = [v.clone().to(dev) for v in init.values()]
        opt = tce.stage1_optimizer(params, 5e-5, 1.0, 5e-4)
        for grads in grad_seq:
            opt.step([x.to(dev) for x in grads])
        opt_runs.append([p.cpu() for p in params])
    opt_err = max(float((a - b).abs().max()) for a, b in zip(*opt_runs))
    log(f"[5e] stage-1 optimizer alone, 20 steps of one seeded gradient "
        f"sequence, card vs CPU: parameters max|err| {opt_err:.2e} (bound "
        f"{TRAJ_OPT_BOUND:.0e})")
    if not opt_err <= TRAJ_OPT_BOUND:
        raise AssertionError(f"the optimizer steps differ: {opt_err}")
    val16 = list(range(n_train, min(n, n_train + 16)))
    runs = {}
    for dev, fault in (("cuda", False), ("cpu", False), ("cuda", True)):
        model = _stage1_encoder(cfg0)
        model.load_state_dict(init)
        before = attn.multi_head_attention.launches
        t0 = time.monotonic()
        with _planted_zero_dq() if fault else contextlib.nullcontext():
            trained, _, hist = tce.train_chunk_encoder(
                fs, idx, list(range(40)), val16,
                config=cfg0, num_epochs=4, batch_size=8, device=dev,
                model=model)
        runs[dev, fault] = (hist, {k: v.detach().cpu() for k, v in
                                   trained.state_dict().items()},
                            attn.multi_head_attention.launches - before,
                            time.monotonic() - t0)
    (h_c, p_c, l_c, t_c), (h_h, p_h, _, t_h) = (runs["cuda", False],
                                                runs["cpu", False])
    errs = _trajectory_errs(h_c, p_c, h_h, p_h)
    planted = _trajectory_errs(*runs["cuda", True][:2], h_h, p_h)
    lr_bound = 5e-5 * 20

    def passes(e: dict) -> bool:
        return (e["loss"] <= TRAJ_LOSS_RTOL and e["param"] <= lr_bound
                and e["off_share"] <= TRAJ_OFF_SHARE)

    for epoch, (a, b) in enumerate(zip(h_c, h_h)):
        log(f"[5e]   epoch {epoch} card / CPU: train_loss "
            f"{a['train_loss']:.8f} / {b['train_loss']:.8f}, val_loss "
            f"{a['val_loss']:.8f} / {b['val_loss']:.8f}")
    for what, e in (("card", errs), ("card, dq zeroed (planted fault)",
                                     planted)):
        log(f"[5e] dropout-0 trajectory, 20 steps (B=8) + 4 validations, "
            f"{what} vs CPU from one state: losses relative max|err| "
            f"{e['loss']:.3e} (bound {TRAJ_LOSS_RTOL:.0e}); parameters "
            f"max|err| {e['param']:.3e} (bound lr x steps {lr_bound:.0e}), "
            f"{e['off_share']:.3e} of the elements outside the key biases "
            f"beyond 1e-5 + 1e-3 rel (bound {TRAJ_OFF_SHARE:.0e}; worst "
            f"{e['worst']})")
    log(f"[5e] kernel B launched {l_c} times in the card run (3 a training "
        f"step and a validation batch); card {t_c:.1f} s, CPU {t_h:.1f} s")
    if not (passes(errs) and l_c == 3 * (20 + 4 * math.ceil(len(val16) / 8))):
        raise AssertionError(f"dropout-0 trajectory: {errs}, {l_c} "
                             "launches")
    if passes(planted):
        raise AssertionError(f"the trajectory check passes a zeroed dq: "
                             f"{planted}")
    s1 = _s1_bisection(fs, idx, init, cfg0, val16, runs)

    times = _stage1_times(smi)
    times.update(_write_ratt_rate(smi, root, mngr.restore_best()["params"]))
    log(f"[5e] phase 5e: {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, ratt_row_err=row_err,
                optimizer_param_err=opt_err,
                trajectory_loss_rel_err=errs["loss"],
                trajectory_param_err=errs["param"],
                trajectory_off_share=errs["off_share"],
                planted_zero_dq_loss_rel_err=planted["loss"],
                planted_zero_dq_off_share=planted["off_share"],
                s1_bisection=s1, **times)


def _s1_bisection(fs, idx, init, cfg0, val16, runs) -> dict:
    """Suspect S1: where the stage-1 trajectory's card-vs-CPU loss gap
    comes from. The same 20-step dropout-0 run (a) as checked above, (b)
    with B swapped for its plain version on the card (isolates B at dh =
    96), (c) at max_len 24 instead of 8 on both devices from the same
    weights (the position table's size; the rows used are the same 9),
    (d) at max_len 24 from its own seeded init and (e) at max_len 8 from
    another seed (the init's share), each reported as the losses'
    relative and absolute gaps and as the gap between the trained
    encoders' validation logits (both evaluated on the CPU): the
    validation BCE is small, so a small logit gap reads as a large
    relative loss gap."""
    val_x = gather_chunk_embedding_batch(fs, idx, np.asarray(val16))

    def logits(state, cfg):
        model = heads.ChunkEncoder(cfg)
        return tce.make_encode_fn(model, state)(val_x)[1].reshape(-1)

    def run(dev, cfg, state, plain=False):
        model = _stage1_encoder(cfg)
        model.load_state_dict(state)
        with _plain_attention() if plain else contextlib.nullcontext():
            trained, _, hist = tce.train_chunk_encoder(
                fs, idx, list(range(40)), val16, config=cfg, num_epochs=4,
                batch_size=8, device=dev, model=model)
        return hist, {k: v.detach().cpu()
                      for k, v in trained.state_dict().items()}

    cfg24 = dataclasses.replace(cfg0, max_len=24)
    # the same weights in a 25-row position table (rows 9-24 unused)
    same24 = dict(init, pos_embedding=torch.cat(
        [init["pos_embedding"], _stage1_encoder(cfg24, 7).state_dict()[
            "pos_embedding"][:, 9:]], dim=1))
    init24 = _stage1_encoder(cfg24, 7).state_dict()
    seed8 = _stage1_encoder(cfg0, 8).state_dict()
    variants = {
        "kernel B (the check above)": (
            runs["cuda", False][:2], runs["cpu", False][:2], cfg0),
        "B swapped for plain": (
            run("cuda", cfg0, init, plain=True), runs["cpu", False][:2],
            cfg0),
        "max_len 24, the same weights": (
            run("cuda", cfg24, same24), run("cpu", cfg24, same24), cfg24),
        "max_len 24, its own seed-7 init": (
            run("cuda", cfg24, init24), run("cpu", cfg24, init24), cfg24),
        "max_len 8, a seed-8 init": (
            run("cuda", cfg0, seed8), run("cpu", cfg0, seed8), cfg0),
    }
    out = {}
    for name, ((h_c, p_c), (h_h, p_h), cfg) in variants.items():
        rel = _trajectory_errs(h_c, p_c, h_h, p_h)
        abs_loss = max(abs(a[k] - b[k]) for a, b in zip(h_c, h_h)
                       for k in ("train_loss", "val_loss"))
        lc, lh = logits(p_c, cfg), logits(p_h, cfg)
        out[name] = dict(loss_rel=rel["loss"], loss_abs=abs_loss,
                         logit_abs=float(np.abs(lc - lh).max()),
                         logit_max=float(np.abs(lh).max()),
                         param=rel["param"], off_share=rel["off_share"])
        log(f"[5e] S1 bisection, {name}: losses relative max|err| "
            f"{rel['loss']:.3e}, absolute {abs_loss:.3e}; validation "
            f"logits max|err| {out[name]['logit_abs']:.3e} (max|logit| "
            f"{out[name]['logit_max']:.3f}); parameters max|err| "
            f"{rel['param']:.3e}, off share {rel['off_share']:.3e}")
    return out


# ---- phase 5f: the retrieval heads and their trainers --------------------

# train-rag's preset batch (accumulation 4) and top-k
RAG_BATCH, RAG_TOP_K = 8, 5
# rebuild-db --run-id on the card against a CPU ProjectionHead of the same
# restored weights on the same store rows: three 768-wide f32 layers in
# other summation orders, then L2-normalised.
RAG_ROW_BOUND = 1e-5
# The card retriever against a float64 host masked top-k of the same rows:
# f32 scores are ~1e-7 off, so rows whose scores tie within this may come
# in either order (tie-aware).
RETRIEVE_TIE = 1e-5
# The dropout-0 train_rag trajectory, card vs CPU, 20 steps (5 updates of
# accumulation 4) from one state: phase 5e's bounds (TRAJ_LOSS_RTOL,
# TRAJ_OFF_SHARE), with every element within lr_phase1 an update.
RAG_TRAJ_STEPS = 20


def _rag_world(root: str, main: dict) -> list:
    """Two games' clip directories under ``rag_clips_{vid}``: vid 2 holds
    phase 4's segment clips, vid 1 the corpus game's possessions (links to
    its frames), and a clip-label CSV (left 1, right 0). Returns the world
    arguments of the CLI. Two games: the retrievers exclude rows of the
    query's own game, and phase 5's store holds one."""
    template = os.path.join(root, "rag_clips_{vid}")
    labels = {}
    d2 = template.format(vid=2)
    os.makedirs(d2)
    for d in sorted(os.listdir(main["out"])):
        if m := CLIP_RE.match(d):
            os.symlink(os.path.join(main["out"], d), os.path.join(d2, d))
            labels[os.path.join(d2, d)] = int(m.group(2) == "left")
    d1, fnum, clip = template.format(vid=1), 1, 0
    for side, n in CORPUS_SEGMENTS:
        if side != "none":
            clip += 1
            cd = os.path.join(d1, f"vid1_clip_{clip}_{side}")
            os.makedirs(cd)
            for f in range(fnum, fnum + n):
                name = f"vid1_frame_{f}.jpg"
                os.symlink(os.path.join(main["corpus_dir"], name),
                           os.path.join(cd, name))
            labels[cd] = int(side == "left")
        fnum += n
    labels_csv = os.path.join(root, "rag_clip_labels.csv")
    with open(labels_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["clip_path", "label"])
        for path, label in labels.items():
            w.writerow([path, label])
    return ["--clip-root", template, "--vids", "1", "2", "--clip-labels",
            labels_csv]


def _host_retrieval_check(got, rows, space, q, mask, k) -> int:
    """The card retriever's answer ``got`` (B, k, D) against a float64
    masked top-k of ``rows`` on the host: per query, as many rows as
    candidates (up to k) and zeros after them; every returned row a stored
    row inside the mask; the returned rows' scores equal the host's top-k
    scores within RETRIEVE_TIE. Returns the queries whose rows came in
    another order than the host's (near-ties)."""
    r = rows.astype(np.float64)
    unit = r / (np.linalg.norm(r, axis=1, keepdims=True) + 1e-8)
    q = q.astype(np.float64)
    if space == "l2":
        s = -((q * q).sum(1)[:, None] - 2 * q @ r.T + (r * r).sum(1)[None])
    else:
        s = q @ unit.T
    s = np.where(mask, s, -np.inf)
    reordered = 0
    for i in range(len(q)):
        n_valid = min(k, int(mask[i].sum()))
        live = np.abs(got[i]).sum(1) > 0
        if live.sum() != n_valid or live[n_valid:].any():
            raise AssertionError(f"retrieval query {i}: {live.sum()} rows, "
                                 f"want {n_valid} then zeros")
        if not n_valid:
            continue
        cos = got[i, :n_valid].astype(np.float64) @ unit.T
        idx = cos.argmax(1)
        if not (cos.max(1) >= 1 - 1e-5).all() or not mask[i, idx].all():
            raise AssertionError(f"retrieval query {i}: a returned row is "
                                 "not a stored row inside the mask")
        want = np.sort(s[i])[::-1][:n_valid]
        if np.abs(s[i, idx] - want).max() > RETRIEVE_TIE:
            raise AssertionError(f"retrieval query {i}: scores "
                                 f"{s[i, idx]} against the host's {want}")
        reordered += int(not np.array_equal(idx, np.argsort(
            -s[i], kind="stable")[:n_valid]))
    return reordered


def _rag_trajectory(smi: str) -> dict:
    """Dropout-0 train_rag at full width (HeadConfig(): RAGHead 768 x 2, 4
    heads; ProjectionHead 768), 20 steps of B = 8 (accumulation 4) and 2
    validations, on a seeded world (two training games, one validation
    game; 768-wide frame rows with a label signal, so retrieval ranks
    without near-ties), on the card and on the CPU from one state, and on
    the card with _Attention's dq zeroed (a planted fault: dh = 192 is
    the only attention of this run)."""
    from vit_research_tpu_torch.retrieval import FrameRetriever
    from vit_research_tpu_torch.train import train_rag as rag_mod
    from vit_research_tpu_torch.utils.configs import preset

    rng = np.random.default_rng(12)
    direction = rng.standard_normal(768).astype(np.float32)
    chunks, table = [], {}
    for vid in (1, 2, 3):
        for c in (range(40) if vid < 3 else range(16)):
            side = "left" if c % 2 else "right"
            label = int(rng.integers(0, 2))
            frames = [f"/g{vid}/c{c}/f{i}.jpg" for i in range(8)]
            for p in frames:
                table[p] = rng.standard_normal(768).astype(np.float32) \
                    + label * direction
            chunks.append(dict(vid=vid, clip=c // 4, start_idx=c * 8,
                               end_idx=c * 8 + 7, side=side, label=label,
                               status_id=label, t_center=(c % 10) / 10 + 0.05,
                               t_width=0.5, frames=frames))
    train = [c for c in chunks if c["vid"] < 3]
    val = [c for c in chunks if c["vid"] == 3]
    samples = [{"pth": p, "side": c["side"], "t_norm": c["t_center"],
                "clip_num": c["clip"], "vid_num": c["vid"]}
               for c in chunks for p in c["frames"]]

    def chunk_embed(batch):
        emb = np.stack([np.mean([table[p] for p in c["frames"]], axis=0)
                        for c in batch])
        return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)

    cfg = preset("rag")
    cfg = dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, classifier_dropout=0.0),
        train=dataclasses.replace(cfg.train, num_epochs=2, rebuild_every=0))
    init = rag_mod.build_model(cfg, 9).state_dict()
    runs = {}
    for dev, fault in (("cuda", False), ("cpu", False), ("cuda", True)):
        col = Collection("rag_traj", space="cosine", device=dev)
        col.upsert([s["pth"] for s in samples],
                   np.stack([table[s["pth"]] for s in samples]), samples)
        before = attn.multi_head_attention.launches
        t0 = time.monotonic()
        with _planted_zero_dq() if fault else contextlib.nullcontext():
            model, hist = rag_mod.train_rag(
                train, val, chunk_embed,
                FrameRetriever(col, top_k=RAG_TOP_K), cfg=cfg,
                init_params=init, device=dev)
        runs[dev, fault] = (hist, {k: v.detach().cpu() for k, v in
                                   model.state_dict().items()},
                            attn.multi_head_attention.launches - before,
                            time.monotonic() - t0)
    (h_c, p_c, l_c, t_c), (h_h, p_h, _, t_h) = (runs["cuda", False],
                                                runs["cpu", False])
    errs = _trajectory_errs(h_c, p_c, h_h, p_h)
    planted = _trajectory_errs(*runs["cuda", True][:2], h_h, p_h)
    updates = RAG_TRAJ_STEPS // cfg.train.accum_steps
    lr_bound = cfg.train.lr_phase1 * updates

    def passes(e: dict) -> bool:
        return (e["loss"] <= TRAJ_LOSS_RTOL and e["param"] <= lr_bound
                and e["off_share"] <= TRAJ_OFF_SHARE)

    for epoch, (a, b) in enumerate(zip(h_c, h_h)):
        log(f"[5f]   epoch {epoch} card / CPU: train_loss "
            f"{a['train_loss']:.8f} / {b['train_loss']:.8f}, val_loss "
            f"{a['val_loss']:.8f} / {b['val_loss']:.8f}, retr_sim "
            f"{a['retr_sim']:.6f} / {b['retr_sim']:.6f}")
    for what, e in (("card", errs), ("card, dq zeroed at dh = 192 (planted "
                                     "fault)", planted)):
        log(f"[5f] dropout-0 train_rag trajectory, {RAG_TRAJ_STEPS} steps "
            f"(B=8, {updates} updates) + 2 validations, {what} vs CPU from "
            f"one state: losses relative max|err| {e['loss']:.3e} (bound "
            f"{TRAJ_LOSS_RTOL:.0e}); parameters max|err| {e['param']:.3e} "
            f"(bound lr x updates {lr_bound:.0e}), {e['off_share']:.3e} of "
            f"the elements outside the key biases beyond 1e-5 + 1e-3 rel "
            f"(bound {TRAJ_OFF_SHARE:.0e}; worst {e['worst']})")
    val_batches = math.ceil(len(val) / RAG_BATCH)
    want_l = 2 * (RAG_TRAJ_STEPS + 2 * val_batches)
    log(f"[5f] kernel B launched {l_c} times in the card run (2 a training "
        f"step and a validation batch: {want_l}); card {t_c:.1f} s, CPU "
        f"{t_h:.1f} s")
    if len(h_c) != 2 or not (passes(errs) and l_c == want_l):
        raise AssertionError(f"train_rag trajectory: {errs}, {l_c} "
                             "launches")
    if passes(planted):
        raise AssertionError(f"the train_rag trajectory check passes a "
                             f"zeroed dq: {planted}")
    return dict(trajectory_loss_rel_err=errs["loss"],
                trajectory_param_err=errs["param"],
                trajectory_off_share=errs["off_share"],
                planted_zero_dq_loss_rel_err=planted["loss"],
                planted_zero_dq_off_share=planted["off_share"])


def _rag_step_times(smi: str, rows: np.ndarray, metas: list) -> dict:
    """A preset-`rag` train step at full width on the card (B = 8 chunk
    embeddings, retrieval of 5 rows from a FrameRetriever over ``rows``,
    RAGHead + ProjectionHead forward and backward, the Optimizer with
    accumulation 4: one update every 4 steps; classifier dropout 0.2 as the
    CLI's): ms a step by CUDA events over 8 steps, then launches a step and
    the device's idle share under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vit_research_tpu_torch.retrieval import FrameRetriever
    from vit_research_tpu_torch.train import train_rag as rag_mod
    from vit_research_tpu_torch.train.optim import make_optimizer
    from vit_research_tpu_torch.utils.configs import preset

    dev = torch.device("cuda")
    cfg = preset("rag")
    model = rag_mod.build_model(cfg, 0).to(dev)
    vit_mod.set_dropout_generator(model, tce.dropout_generator(0, 0, dev))
    opt = make_optimizer(cfg.train, 24, list(model.parameters()))
    train_step, _ = rag_mod.make_step_fns(model, opt, True)
    col = Collection("rag_steps", space="cosine", device="cuda")
    col.upsert([m["pth"] for m in metas], rows, metas)
    retriever = FrameRetriever(col, top_k=RAG_TOP_K)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.nn.functional.normalize(
        torch.randn(RAG_BATCH, 768, generator=g, device=dev), dim=1)
    y = (torch.rand(RAG_BATCH, generator=g, device=dev) > 0.5).float()
    pick = np.linspace(0, len(metas) - 1, RAG_BATCH).astype(int)
    md = {"vid": np.asarray([3 - metas[i]["vid_num"] for i in pick]),
          "side": np.asarray([metas[i]["side"] for i in pick], object),
          "t_center": np.asarray([metas[i]["t_norm"] for i in pick]),
          "t_width": np.full(RAG_BATCH, 0.2)}

    def step():
        with torch.no_grad():
            z = model["proj"](x)
        train_step(x, retriever(z, md), y, cfg.train.contrastive_weight)

    out = {"train_step_ms": cuda_ms(step, reps=3, n=8)}
    for _ in range(4):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 8
    out.update(train_step_wall_ms=wall_ms, train_step_kernel_ms=busy_ms,
               train_step_launches=sum(e.count for e in kernels) / 8,
               train_step_idle=max(0.0, 1 - busy_ms / wall_ms))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[5f] preset-rag train step (RAGHead 768x2, 4 heads, T=5; "
        f"ProjectionHead 768; B={RAG_BATCH}, accumulation 4, retrieval of "
        f"{RAG_TOP_K} from {len(metas)} rows): {out['train_step_ms']:.3f} ms "
        f"by CUDA events; under the profiler {busy_ms:.3f} ms of kernels in "
        f"{wall_ms:.3f} ms of wall, idle {100 * out['train_step_idle']:.1f}%"
        f", {out['train_step_launches']:.0f} launches a step | {smi}")
    for e in top:
        log(f"[5f]   {e.self_device_time_total / 1e3 / 8:8.3f} ms "
            f"x{e.count // 8:<4d} {e.key[:90]}")
    del model, opt, col, retriever
    torch.cuda.empty_cache()
    return out


def _retrieval_times(smi: str, n: int = 200_000, b: int = 8) -> dict:
    """A FrameRetriever batch of 8 queries against a seeded 200,000 x 768
    frame collection (8 games, two sides, t_norm uniform) on the card: the
    first call (the device snapshot's upload) on the host clock, then
    batches by CUDA events, and the answers against the host top-k."""
    from vit_research_tpu_torch.retrieval import FrameRetriever

    rng = np.random.default_rng(13)
    rows = rng.standard_normal((n, 768), dtype=np.float32)
    vids = rng.integers(1, 9, n)
    sides = np.where(rng.integers(0, 2, n) == 1, "left", "right")
    t_norm = rng.uniform(0, 1, n)
    col = Collection("rag_game", space="cosine", device="cuda")
    col.upsert([f"f{i}" for i in range(n)], rows,
               [{"vid_num": int(v), "side": str(s), "t_norm": float(t)}
                for v, s, t in zip(vids, sides, t_norm)])
    ret = FrameRetriever(col, top_k=RAG_TOP_K)
    q = rng.standard_normal((b, 768), dtype=np.float32)
    md = {"vid": np.arange(1, b + 1) % 8 + 1,
          "side": np.asarray(["left", "right"] * (b // 2), object),
          "t_center": rng.uniform(0.1, 0.9, b), "t_width": np.full(b, 0.2)}
    t0 = time.perf_counter()
    got = ret(q, md).cpu().numpy()
    first_ms = (time.perf_counter() - t0) * 1e3
    ms = cuda_ms(lambda: ret(q, md), reps=5, n=10)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        ret(q, md).cpu()
        host.append((time.perf_counter() - t0) * 1e3)
    t_c = md["t_center"]
    lo = (t_c - 0.1).astype(np.float32)[:, None]
    hi = (t_c + 0.1).astype(np.float32)[:, None]
    t32 = t_norm.astype(np.float32)[None]
    mask = ((vids[None] != md["vid"][:, None])
            & (sides[None] == md["side"].astype(str)[:, None])
            & (t32 >= lo) & (t32 <= hi))
    reordered = _host_retrieval_check(got, rows, "cosine", q, mask,
                                      RAG_TOP_K)
    lim = bound(rows.nbytes + b * 768 * 4 + b * RAG_TOP_K * 768 * 4,
                2 * b * n * 768, "f32")
    log(f"[5f] FrameRetriever, {b} queries x {n} x 768 rows (cosine, vid/"
        f"side/time mask, top {RAG_TOP_K}): first call (snapshot upload) "
        f"{first_ms:.1f} ms; then {ms:.3f} ms a batch by CUDA events, "
        f"{statistics.median(host):.3f} ms host clock with readback; "
        f"{bound_text(lim)}; answers equal the host top-k ({reordered} of "
        f"{b} queries in another order among near-ties) | {smi}")
    del col, ret
    torch.cuda.empty_cache()
    return dict(retrieval_first_ms=first_ms, retrieval_ms=ms,
                retrieval_host_ms=statistics.median(host),
                retrieval_bound_ms=lim["bound_ms"])


def phase_rag_path(smi: str, root: str, main: dict) -> dict:
    """The retrieval trainers through the CLI on the card at full width on
    phase 4's world: a two-game frame store (build-frame-store),
    write-rag-db (rows equal to the store's), write-ratt-db with phase
    5e's stage-1 run, train-rag 2 epochs with --rebuild sync
    --rebuild-every 1 and --resume for a third (kernel B at dh = 192: 2
    launches a training step and a validation batch), rebuild-db --run-id
    (rows against a CPU ProjectionHead), train-ratt with --rebuild sync
    (rows against a CPU projection) and with --attention-losses (no
    kernel launch: RATTHead returns its scores); then the card retriever
    against the host top-k, a dropout-0 card vs CPU trajectory with a
    planted fault, the step and retrieval times."""
    from vit_research_tpu_torch.db.enrich import chunk_stats
    from vit_research_tpu_torch.train.train_rag import chunk_embed_from_store
    from vit_research_tpu_torch.retrieval import FrameRetriever
    from vit_research_tpu_torch.utils.configs import load_config

    t_phase = time.monotonic()
    world = _rag_world(root, main)
    store_dir, db = os.path.join(root, "store_rag"), \
        os.path.join(root, "db_rag")
    ck = os.path.join(root, "ckpt_rag")
    cli.main(["build-frame-store", *world, "--out", store_dir,
              "--batch-size", str(BATCH), "--device", "cuda"])
    fs = FrameStore(store_dir).open()
    idx = load_chunk_index(store_dir)
    chunks = common._chunks_from_index(fs, idx)
    train = [c for c in chunks if c["vid"] == 1]
    val = [c for c in chunks if c["vid"] == 2]
    log(f"[5f] two-game frame store: {fs.n} frames, {len(chunks)} chunks "
        f"({len(train)} of vid 1 train, {len(val)} of vid 2 validate)")

    cli.main(["write-rag-db", *world, "--store", store_dir, "--db", db,
              "--device", "cuda"])
    col = PersistentClient(db, device="cpu").get_collection("ragdb")
    got = col.get(include=("embeddings", "metadatas"))
    want = fs.gather_paths([[p] for p in got["ids"]])[:, 0]
    raw_err = float(np.abs(np.asarray(got["embeddings"]) - want).max())
    if col.count() != fs.n or raw_err != 0.0 or \
            col.embedding_profile != fs.embedding_profile:
        raise AssertionError(f"write-rag-db: {col.count()} rows of "
                             f"{fs.n}, max|err| {raw_err}, profile "
                             f"{col.embedding_profile!r}")
    raw_rows = {i: e for i, e in zip(got["ids"], np.asarray(
        got["embeddings"]))}
    log(f"[5f] write-rag-db: {col.count()} rows equal the store's, "
        f"profile {col.embedding_profile!r}")
    cli.main(["write-ratt-db", "--store", store_dir, "--ckpt",
              os.path.join(root, "ckpt_s1"), "--run-id", "s1", "--db", db,
              "--device", "cuda"])

    # train-rag: the counted path, kernel B at dh = 192
    rag_argv = ["train-rag", "--store", store_dir, "--db", db, "--ckpt", ck,
                "--train-vids", "1", "--val-vids", "2", "--batch-size",
                str(RAG_BATCH), "--top-k", str(RAG_TOP_K), "--run-id",
                "rag1", "--rebuild", "sync", "--rebuild-every", "1", *world,
                "--device", "cuda"]
    steps, evals = len(train) // RAG_BATCH, math.ceil(len(val) / RAG_BATCH)
    _zero_counts()
    t0 = time.monotonic()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(rag_argv + ["--epochs", "2"])
        cli.main(rag_argv + ["--epochs", "3", "--resume"])
    torch.cuda.synchronize()
    t_rag = time.monotonic() - t0
    launches = _launch_counts()
    out = buf.getvalue()
    log("\n".join(f"[5f]   {line}" for line in out.splitlines()))
    mngr = checkpoint.CheckpointManager(ck, "rag1")
    epochs = [r["step"] for r in read_metrics(
        os.path.join(mngr.dir, "metrics.jsonl"))]
    want_launches = {"patch_embed": 0, "attention": 2 * 3 * (steps + evals)}
    log(f"[5f] CLI train-rag 2 epochs + --resume 1 ({steps} steps and "
        f"{evals} validation batches an epoch, --rebuild sync every epoch): "
        f"{t_rag:.1f} s wall; launches {launches} (want {want_launches})")
    if launches != want_launches or epochs != [0, 1, 2] or \
            mngr.restore(2)["step"] != 3 * steps or \
            out.count("epoch 2:") != 1:
        raise AssertionError(f"train-rag: launches {launches}, epochs "
                             f"{epochs}")
    if load_config(os.path.join(mngr.dir, "experiment.json")).head \
            .embed_dim != 768:
        raise AssertionError("train-rag's experiment.json")
    # --rebuild sync rewrote ragdb through the live projection of the last
    # epoch: the rows are the restored run's projection of the store rows
    params = mngr.restore(2)["params"]
    proj = heads.ProjectionHead(768, proj_dim=768)
    proj.load_state_dict({k[5:]: v for k, v in params.items()
                          if k.startswith("proj.")})
    ids = sorted(raw_rows)
    with torch.no_grad():
        want_proj = proj(torch.from_numpy(np.stack([raw_rows[i]
                                                    for i in ids]))).numpy()
    synced = PersistentClient(db, device="cpu").get_collection("ragdb").get(
        ids=ids, include=("embeddings",))
    sync_err = float(np.abs(np.asarray(synced["embeddings"])
                            - want_proj).max())

    cli.main(["rebuild-db", *world, "--store", store_dir, "--db", db,
              "--collection", "ragdb_proj", "--ckpt", ck, "--run-id", "rag1",
              "--device", "cuda"])
    best = mngr.restore_best()["params"]
    proj.load_state_dict({k[5:]: v for k, v in best.items()
                          if k.startswith("proj.")})
    with torch.no_grad():
        want_best = proj(torch.from_numpy(np.stack([raw_rows[i]
                                                    for i in ids]))).numpy()
    rebuilt = PersistentClient(db, device="cpu").get_collection("ragdb_proj")
    row_err = float(np.abs(np.asarray(rebuilt.get(
        ids=ids, include=("embeddings",))["embeddings"]) - want_best).max())
    log(f"[5f] train-rag --rebuild sync rows vs a CPU ProjectionHead of the "
        f"last epoch: max|err| {sync_err:.3e}; rebuild-db --run-id rag1: "
        f"{rebuilt.count()} rows vs a CPU ProjectionHead of the best epoch: "
        f"max|err| {row_err:.3e} (bound {RAG_ROW_BOUND:.0e}), profile "
        f"{rebuilt.embedding_profile!r}")
    if not (sync_err <= RAG_ROW_BOUND and row_err <= RAG_ROW_BOUND) or \
            rebuilt.embedding_profile != fs.embedding_profile + "|proj:rag1":
        raise AssertionError(f"rebuilt rows disagree: {sync_err}, "
                             f"{row_err}")

    # train-ratt: RATTHead returns its scores, so no kernel launch
    ratt_argv = ["train-ratt", "--store", store_dir, "--db", db, "--ckpt",
                 ck, "--train-vids", "1", "--val-vids", "2", "--batch-size",
                 str(RAG_BATCH), "--epochs", "1", "--device", "cuda"]
    t0 = time.monotonic()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(ratt_argv + ["--rebuild", "sync", "--rebuild-every", "1",
                              "--run-id", "ratt1"])
        cli.main(ratt_argv + ["--attention-losses", "--run-id", "ratt2"])
    torch.cuda.synchronize()
    t_ratt = time.monotonic() - t0
    out = buf.getvalue()
    log("\n".join(f"[5f]   {line}" for line in out.splitlines()))
    after = _launch_counts()
    sd = checkpoint.CheckpointManager(ck, "ratt1").restore(0)["params"]
    chunk_proj = heads.ProjectionHead(3 * 768, hidden_dim=768, proj_dim=768)
    chunk_proj.load_state_dict({k[5:]: v for k, v in sd.items()
                                if k.startswith("proj.")})
    frames = gather_chunk_embedding_batch(fs, idx, np.arange(len(chunks)))
    with torch.no_grad():
        z = chunk_proj(torch.from_numpy(chunk_stats(frames))).numpy()
    z /= np.linalg.norm(z, axis=1, keepdims=True) + 1e-8
    ratt_rows = PersistentClient(db, device="cpu").get_collection(
        "ratt_db").get(ids=[f"chunk_{i}" for i in range(len(chunks))],
                       include=("embeddings",))
    ratt_err = float(np.abs(np.asarray(ratt_rows["embeddings"]) - z).max())
    log(f"[5f] CLI train-ratt --rebuild sync and --attention-losses, 1 "
        f"epoch each: {t_ratt:.1f} s wall; launches {after} (train-rag's "
        f"{launches}); re-projected ratt_db rows vs a CPU projection of the "
        f"run: max|err| {ratt_err:.3e} (bound {RAG_ROW_BOUND:.0e})")
    if after != launches or "loss_attn_entropy" not in out or \
            f"rebuilt {len(chunks)} chunk rows" not in out or \
            not ratt_err <= RAG_ROW_BOUND:
        raise AssertionError(f"train-ratt: launches {after}, rows "
                             f"{ratt_err}")

    # the card retriever against the host top-k on ragdb's rows
    col = PersistentClient(db, device="cuda").get_collection("ragdb")
    every = np.linspace(0, len(chunks) - 1, 64).astype(int)
    batch = [chunks[i] for i in every]
    md = {"vid": np.asarray([c["vid"] for c in batch]),
          "side": np.asarray([c["side"] for c in batch], object),
          "t_center": np.asarray([c["t_center"] for c in batch],
                                 np.float32),
          "t_width": np.asarray([c["t_width"] for c in batch], np.float32)}
    q = chunk_embed_from_store(fs)(batch).astype(np.float32)
    got = FrameRetriever(col, top_k=RAG_TOP_K)(q, md).cpu().numpy()
    all_rows = col.get(include=("embeddings", "metadatas"))
    metas = all_rows["metadatas"]
    cv = np.asarray([m["vid_num"] for m in metas])
    cs = np.asarray([m["side"] for m in metas])
    ct = np.asarray([m["t_norm"] for m in metas], np.float32)
    lo = (md["t_center"].astype(np.float64) - md["t_width"] / 2).astype(
        np.float32)
    hi = (md["t_center"].astype(np.float64) + md["t_width"] / 2).astype(
        np.float32)
    mask = ((cv[None] != md["vid"][:, None])
            & (cs[None] == md["side"].astype(str)[:, None])
            & (ct[None] >= lo[:, None]) & (ct[None] <= hi[:, None]))
    reordered = _host_retrieval_check(
        got, np.asarray(all_rows["embeddings"]), col.space, q, mask,
        RAG_TOP_K)
    log(f"[5f] FrameRetriever on the card, 64 chunk queries x "
        f"{col.count()} ragdb rows: equal to the host float64 masked "
        f"top-{RAG_TOP_K} ({int(mask.any(1).sum())} queries with candidates;"
        f" {reordered} in another order among near-ties within "
        f"{RETRIEVE_TIE:.0e})")

    out = dict(launches=launches, rag_row_err=row_err, sync_row_err=sync_err,
               ratt_row_err=ratt_err, retriever_reordered=reordered)
    out.update(_rag_trajectory(smi))
    store_rows = fs.gather(np.arange(fs.n))
    store_metas = [{"pth": str(p), "vid_num": 1 + i % 2,
                    "side": "left" if i % 3 else "right",
                    "t_norm": (i % 100) / 100} for i, p in
                   enumerate(fs.paths)]
    out.update(_rag_step_times(smi, store_rows, store_metas))
    out.update(_retrieval_times(smi))
    log(f"[5f] phase 5f: {time.monotonic() - t_phase:.1f} s")
    return out


# ---- phase 5g: stage 2 and live event scoring ---------------------------

# the CLI's k = 6/6/4: RATTHeadV2 (HeadConfig(): 768 x 2, 4 heads) sees T =
# 5 + 6 + 6 + 4 = 21 tokens
S2_K = dict(k_sim=6, k_contrast=6, k_temporal=4)
S2_KARGS = ["--k-sim", "6", "--k-contrast", "6", "--k-temporal", "4"]
# Scored rows on the card against a CPU LiveEventScorer of the same
# restored weights on the same clips and frame embeddings (and the three
# card routes against one another): probabilities through three encoder
# layers and the head in other summation orders. A top-k chunk may differ
# only where the CPU's probabilities of the two chunks are within
# SCORE_TIE (the near tie phase 5d allows ToMe's merges). The logits'
# difference is
# printed: a head trained to a small loss gives logits of order 10, whose
# f32 rounding through the head exceeds 1e-4 where the probabilities
# saturate.
SCORE_BOUND = 1e-4
SCORE_TIE = 1e-5
# the dropout-0 train_stage2 trajectory: 20 steps of B = 8 (5 updates of
# accumulation 4), phase 5e's bounds
S2_TRAJ_STEPS, S2_BATCH = 20, 8
S2_CHUNKS, S2_ROWS = 2_000, 99_997


def _rows_agree(got: list, want: list, what: str) -> float:
    """Scored rows ``got`` against ``want``: the same clips and chunks,
    probabilities within SCORE_BOUND, the same top-k chunks but where
    ``want``'s probabilities of the two chunks tie within SCORE_TIE.
    Returns the largest probability difference; prints the logits'."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, want {len(want)}")
    worst, logit_err, logit_max = 0.0, 0.0, 0.0
    for g, w in zip(got, want):
        if g is None or w is None:
            if g is not w:
                raise AssertionError(f"{what}: {g!r} against {w!r}")
            continue
        keys = ("clip_key", "side", "num_chunks", "start_idxs",
                "start_frames", "end_frames")
        if any(g[k] != w[k] for k in keys):
            raise AssertionError(f"{what}: {g['clip_key']} differs in "
                                 f"{[k for k in keys if g[k] != w[k]]}")
        a, b = (np.asarray(r["prob_sequence"], np.float64) for r in (g, w))
        la, lb = (np.asarray(r["raw_sequence"], np.float64) for r in (g, w))
        if not (np.isfinite(a).all() and np.isfinite(la).all()):
            raise AssertionError(f"{what}: a sequence is not finite")
        worst = max(worst, float(np.abs(a - b).max()))
        logit_err = max(logit_err, float(np.abs(la - lb).max()))
        logit_max = max(logit_max, float(np.abs(lb).max()))
        prob = dict(zip(w["start_idxs"], w["prob_sequence"]))
        for a, b in zip(g["topk_chunks"], w["topk_chunks"]):
            ia, ib = a["chunk_start_idx"], b["chunk_start_idx"]
            if ia != ib and abs(prob[ia] - prob[ib]) >= SCORE_TIE:
                raise AssertionError(f"{what}: {g['clip_key']} ranks chunk "
                                     f"{ia} where the reference ranks {ib}")
    log(f"[5g]   {what}: probabilities max|err| {worst:.3e}, logits "
        f"{logit_err:.3e} (max |logit| {logit_max:.2f})")
    if not worst <= SCORE_BOUND:
        raise AssertionError(f"{what}: probabilities differ by {worst}")
    return worst


@contextlib.contextmanager
def _planted_zero_head():
    """A planted fault in kernel B's forward: the first head's output
    zeroed (the stage-2 path takes no gradient through B)."""
    orig = attn._launch

    def faulty(q, k, v, scale, key_bias):
        out = orig(q, k, v, scale, key_bias)
        out[:, 0] = 0
        return out

    attn._launch = faulty
    try:
        yield
    finally:
        attn._launch = orig


def _stage2_kernel_rows(smi: str) -> dict:
    """Kernel B at the stage-2 path's dh = 96 shapes: B = 1 chunk (the
    cache build and live validation encode one chunk a call) and B = 29
    (a 64-frame clip's chunks in one scoring batch), T = 9, f32, in
    projection order against the plain version, with the plain version's
    time, SDPA's and the bound; device times by _device_ms (the calls
    are host-bound)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(5)
    rows = {}
    for b in (1, 29):
        q, k, v = (torch.randn(b, 9, 8, 96, generator=g).cuda()
                   .transpose(1, 2) for _ in range(3))
        want = attn.attention_plain(*(x.contiguous() for x in (q, k, v)))
        err = (attn.multi_head_attention(q, k, v) - want).abs().max().item()
        if not err <= ATTN_BOUND[torch.float32]:
            raise AssertionError(f"attention dh=96 B={b} T=9: {err}")
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        row = dict(max_abs_err=err,
                   ms=cuda_ms(lambda: attn.multi_head_attention(q, k, v)),
                   device_ms=_device_ms(
                       lambda: attn.multi_head_attention(q, k, v)),
                   plain_ms=cuda_ms(lambda: attn.attention_plain(qc, kc, vc)),
                   library_ms=cuda_ms(
                       lambda: F.scaled_dot_product_attention(qc, kc, vc)),
                   library_device_ms=_device_ms(
                       lambda: F.scaled_dot_product_attention(qc, kc, vc)),
                   host_us=host_us(lambda: attn.multi_head_attention(q, k, v)),
                   library_host_us=host_us(
                       lambda: F.scaled_dot_product_attention(qc, kc, vc)),
                   **bound(4 * q.numel() * 4, 4 * b * 8 * 9 * 9 * 96, "f32"))
        log(f"[5g] attention B={b} H=8 T=9 dh=96 f32 projection order: "
            f"max|err| {err:.3e} | kernel {row['ms']:.4f} ms (device "
            f"{_ms(row['device_ms'])}; host {row['host_us']:.2f} us a call) "
            f"| plain {row['plain_ms']:.4f} ms | SDPA {row['library_ms']:.4f}"
            f" ms (device {_ms(row['library_device_ms'])}; host "
            f"{row['library_host_us']:.2f} us) | {bound_text(row)} | {smi}")
        rows[f"B{b}_T9_float32"] = row
    return rows


def _stage2_trajectory(smi: str, fs, chunks, ck: str, db: str) -> dict:
    """Dropout-0 train_stage2 at full width (HeadConfig(): RATTHeadV2 768 x
    2, 4 heads, k = 6/6/4; preset stage2: B = 8, accumulation 4), 20 steps
    and one live validation of 16 chunks, on the card and on the CPU from
    one state; each builds its own cache with its own stage-1 encoder (B
    at dh = 96 on the card) against the same collection. Then the card
    run with kernel B's first head zeroed (a planted fault: it must fail
    the bounds) and with _Attention's dq zeroed (no gradient flows through
    B on this path: it must equal the card run)."""
    from vit_research_tpu_torch.retrieval import cache_stage2 as CS
    from vit_research_tpu_torch.train import train_stage2 as ts2
    from vit_research_tpu_torch.utils.configs import preset

    params = checkpoint.CheckpointManager(ck, "s1").restore_best()["params"]
    train = [c for c in chunks if c["vid"] == 1][:S2_TRAJ_STEPS * S2_BATCH]
    val = [c for c in chunks if c["vid"] == 2][:16]
    col = PersistentClient(db, device="cpu").get_collection("ratt_db")
    cfg = preset("stage2")
    cfg = dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, classifier_dropout=0.0,
                                      **S2_K),
        train=dataclasses.replace(cfg.train, num_epochs=1,
                                  batch_size=S2_BATCH))
    init = ts2.build_head(cfg, 9).state_dict()

    def encoder(dev):
        enc = tce.make_encode_fn(
            heads.ChunkEncoder(ChunkEncoderConfig(max_len=8)).to(dev), params)

        def encode_chunk(ch):
            emb, _ = enc(fs.gather_paths([ch["frames"]]))
            return emb[0] / (np.linalg.norm(emb[0]) + 1e-8)
        return encode_chunk

    runs = {}
    for dev, fault in (("cuda", None), ("cpu", None), ("cuda", "head"),
                       ("cuda", "dq")):
        plant = {"head": _planted_zero_head, "dq": _planted_zero_dq}.get(
            fault, contextlib.nullcontext)
        before = attn.multi_head_attention.launches
        t0 = time.monotonic()
        with plant():
            enc = encoder(dev)
            cache = CS.build_stage2_cache(train + val, enc, col, **S2_K)
            head, hist = ts2.train_stage2(train, val, cache, encode_fn=enc,
                                          collection=col, cfg=cfg,
                                          init_params=init, device=dev)
        runs[dev, fault] = (hist, {k: v.detach().cpu() for k, v in
                                   head.state_dict().items()},
                            attn.multi_head_attention.launches - before,
                            time.monotonic() - t0)
    (h_c, p_c, l_c, t_c), (h_h, p_h, _, t_h) = (runs["cuda", None],
                                                runs["cpu", None])
    errs = _trajectory_errs(h_c, p_c, h_h, p_h)
    planted = _trajectory_errs(*runs["cuda", "head"][:2], h_h, p_h)
    h_dq, p_dq = runs["cuda", "dq"][:2]
    dq_errs = _trajectory_errs(h_dq, p_dq, h_h, p_h)
    dq_same = h_dq == h_c and all(torch.equal(p_dq[k], p_c[k]) for k in p_c)
    updates = S2_TRAJ_STEPS // cfg.train.accum_steps
    lr_bound = cfg.train.lr_phase1 * updates

    def passes(e: dict) -> bool:
        return (e["loss"] <= TRAJ_LOSS_RTOL and e["param"] <= lr_bound
                and e["off_share"] <= TRAJ_OFF_SHARE)

    a, b = h_c[0], h_h[0]
    log(f"[5g]   card / CPU: train_loss {a['train_loss']:.8f} / "
        f"{b['train_loss']:.8f}, val_loss {a['val_loss']:.8f} / "
        f"{b['val_loss']:.8f}, grad_rms_support {a['grad_rms_support']:.8f}"
        f" / {b['grad_rms_support']:.8f}")
    for what, e in (("card", errs), ("card, B's first head zeroed (planted "
                                     "fault)", planted)):
        log(f"[5g] dropout-0 train_stage2 trajectory, {S2_TRAJ_STEPS} steps "
            f"(B={S2_BATCH}, {updates} updates) + a live validation of "
            f"{len(val)} chunks, {what} vs CPU from one state: losses "
            f"relative max|err| {e['loss']:.3e} (bound {TRAJ_LOSS_RTOL:.0e});"
            f" parameters max|err| {e['param']:.3e} (bound lr x updates "
            f"{lr_bound:.0e}), {e['off_share']:.3e} of the elements outside "
            f"the key biases beyond 1e-5 + 1e-3 rel (bound "
            f"{TRAJ_OFF_SHARE:.0e}; worst {e['worst']})")
    want_l = 3 * (len(train) + 2 * len(val))
    log(f"[5g] kernel B launched {l_c} times in the card run (3 a chunk "
        f"encode: the cache's {len(train) + len(val)} chunks and the "
        f"validation pool's {len(val)}: {want_l}); with dq zeroed the run "
        f"passes the bounds (losses {dq_errs['loss']:.3e}) and equals the "
        f"card run bit for bit: {dq_same}; card {t_c:.1f} s, CPU {t_h:.1f} s")
    if not (passes(errs) and l_c == want_l and passes(dq_errs)):
        raise AssertionError(f"train_stage2 trajectory: {errs}, {l_c} "
                             f"launches, dq zeroed {dq_errs}")
    if passes(planted):
        raise AssertionError(f"the train_stage2 trajectory check passes a "
                             f"zeroed head in B: {planted}")
    return dict(trajectory_loss_rel_err=errs["loss"],
                trajectory_param_err=errs["param"],
                trajectory_off_share=errs["off_share"],
                planted_zero_head_loss_rel_err=planted["loss"],
                planted_zero_head_off_share=planted["off_share"])


def _stage2_step_times(smi: str) -> dict:
    """A preset-`stage2` train step at full width on the card (RATTHeadV2
    768 x 2, 4 heads, T = 21; B = 8 seeded branch inputs; classifier
    dropout 0.2; the Optimizer with accumulation 4): ms a step by CUDA
    events over 8 steps, then launches a step and the device's idle share
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vit_research_tpu_torch.train import train_stage2 as ts2
    from vit_research_tpu_torch.train.optim import make_optimizer
    from vit_research_tpu_torch.utils.configs import preset

    dev = torch.device("cuda")
    cfg = preset("stage2")
    head = ts2.build_head(cfg, 0).to(dev)
    vit_mod.set_dropout_generator(head, tce.dropout_generator(0, 0, dev))
    opt = make_optimizer(cfg.train, 24, list(head.parameters()))
    train_step, _ = ts2.make_step_fns(head, opt, 1.0)
    g = torch.Generator(device=dev).manual_seed(6)
    x = [torch.randn(S2_BATCH, *s, 768, generator=g, device=dev)
         for s in ((), (6,), (6,), (4,))]
    y = (torch.rand(S2_BATCH, generator=g, device=dev) > 0.5).float()
    out = {"train_step_ms": cuda_ms(lambda: train_step(*x, y), reps=3, n=8)}
    for _ in range(4):
        train_step(*x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            train_step(*x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 8
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 8
    out.update(train_step_wall_ms=wall_ms, train_step_kernel_ms=busy_ms,
               train_step_launches=sum(e.count for e in kernels) / 8,
               train_step_idle=max(0.0, 1 - busy_ms / wall_ms))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    log(f"[5g] preset-stage2 train step (RATTHeadV2 768x2, 4 heads, T=21; "
        f"B={S2_BATCH}, accumulation 4, plain attention): "
        f"{out['train_step_ms']:.3f} ms by CUDA events; under the profiler "
        f"{busy_ms:.3f} ms of kernels in {wall_ms:.3f} ms of wall, idle "
        f"{100 * out['train_step_idle']:.1f}%, "
        f"{out['train_step_launches']:.0f} launches a step | {smi}")
    for e in top:
        log(f"[5g]   {e.self_device_time_total / 1e3 / 8:8.3f} ms "
            f"x{e.count // 8:<4d} {e.key[:90]}")
    del head, opt
    torch.cuda.empty_cache()
    return out


def _stage2_cache_rate(smi: str, params: dict) -> dict:
    """build_stage2_cache for 2,000 chunks against a seeded 99,997-row
    chunk collection on the card (a single query at >= 2^14 rows takes
    the device route): each chunk encoded by the stage-1 encoder (B = 1,
    kernel B at dh = 96) from seeded frame rows, then its content and
    temporal queries (64 and 32 results) and branch selection on the
    host. Host clock."""
    from vit_research_tpu_torch.retrieval import cache_stage2 as CS

    rng = np.random.default_rng(14)
    n = S2_ROWS
    rows = rng.standard_normal((n, 768), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    clip = np.arange(n) // 40
    col = Collection("s2_game", space="cosine", device="cuda")
    col.upsert([f"chunk_{i}" for i in range(n)], rows, [
        {"vid_num": int(c % 50), "clip_num": int(c), "side":
         "left" if c % 2 else "right", "label": int(c % 3 == 0),
         "t_center": float((i % 40 + 4) / 40), "t_width": 0.2,
         "start_idx": int(2 * (i % 40)), "end_idx": int(2 * (i % 40) + 7)}
        for i, c in enumerate(clip)])
    frames = rng.standard_normal((S2_CHUNKS, 8, 768), dtype=np.float32)
    chunks = [{"vid": 99, "clip": i // 50, "start_idx": 2 * (i % 50),
               "end_idx": 2 * (i % 50) + 7, "side": "left" if i % 3
               else "right", "label": i % 2, "t_center": (i % 50) / 50,
               "t_width": 0.16, "row": i} for i in range(S2_CHUNKS)]
    enc = tce.make_encode_fn(
        heads.ChunkEncoder(ChunkEncoderConfig(max_len=8)).cuda(), params)
    enc_s = [0.0]

    def encode_chunk(ch):
        t0 = time.perf_counter()
        emb, _ = enc(frames[ch["row"]][None])
        enc_s[0] += time.perf_counter() - t0
        return emb[0] / (np.linalg.norm(emb[0]) + 1e-8)

    col.query(query_embeddings=rows[:1], n_results=1)  # snapshot upload
    before = attn.multi_head_attention.launches
    t0 = time.perf_counter()
    cache = CS.build_stage2_cache(chunks, encode_chunk, col, **S2_K)
    wall = time.perf_counter() - t0
    launches = attn.multi_head_attention.launches - before
    filled = np.mean([(np.abs(e["sim_embs"]).sum(1) > 0).mean()
                      for e in cache.values()])
    log(f"[5g] build_stage2_cache: {S2_CHUNKS} chunks against {n} x 768 "
        f"rows (device route, 2 queries a chunk) in {wall:.2f} s = "
        f"{S2_CHUNKS / wall:.1f} chunks/s; the encode {enc_s[0]:.2f} s "
        f"({100 * enc_s[0] / wall:.1f}%, B launched {launches} times); "
        f"{100 * filled:.1f}% of the sim slots filled | {smi}")
    if len(cache) != S2_CHUNKS or launches != 3 * S2_CHUNKS:
        raise AssertionError(f"cache of {len(cache)} entries, {launches} "
                             "launches")
    del col, cache
    torch.cuda.empty_cache()
    return dict(cache_build_chunks_per_s=S2_CHUNKS / wall,
                cache_build_encode_share=enc_s[0] / wall)


def _read_rows(path: str) -> list:
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def _scoring_session(sock: str, paths: list, cfg, n: int = 64) -> tuple:
    """One live session on the daemon (``cfg``: its score_events config or
    None) in pushes of ``n`` frames: (start reply, the rows of the clips,
    push ms on the host clock)."""
    push_ms, rows = [], []
    with serve.SessionClient(sock, timeout=300.0) as c:
        start = c.request({"op": "segment_start", "k": 50,
                           "min_len": MIN_LEN, "pad": PAD, "vid": 2,
                           **({"score_events": cfg} if cfg else {})})
        if not start.get("ok"):
            raise AssertionError(f"segment_start refused: {start}")
        for i in range(0, len(paths), n):
            t0 = time.perf_counter()
            r = c.request({"op": "segment_push", "paths": paths[i:i + n]})
            push_ms.append((time.perf_counter() - t0) * 1e3)
            rows += r.get("events") or []
        rows += c.request({"op": "segment_finish"}).get("events") or []
    return start, rows, push_ms


def phase_stage2_path(smi: str, root: str, main: dict) -> dict:
    """Stage 2 and live event scoring through the CLI on the card at full
    width: write-ratt-db of phase 5f's two-game store with phase 5e's
    stage-1 run; train-stage2 (RATTHeadV2 HeadConfig(), k = 6/6/4) 2
    epochs and --resume for a third, then --preset stage3 from its best
    weights with --cached-val; eval-clips on the validation game,
    score-events against a planted template, metrics, smoke; segment
    --score-events offline, with --follow, and with --follow --socket
    against a serve --warmup daemon; serve-ctl reload-weights to the
    stage-3 run while a scoring session is open. Checks the card's rows
    against a CPU scorer of the same weights, the routes against one
    another, the pinned session, kernel B's launches at dh = 96, and a
    dropout-0 card vs CPU trajectory with a planted fault."""
    from vit_research_tpu_torch.evaluate import scoring
    from vit_research_tpu_torch.evaluate.clip_sequences import \
        infer_clip_sequences
    from vit_research_tpu_torch.evaluate.event_scoring import (
        score_event_localization, truth_events_by_clip)
    from vit_research_tpu_torch.utils.configs import load_config

    t_phase = time.monotonic()
    store_dir = os.path.join(root, "store_rag")
    ck, db = os.path.join(root, "ckpt_s1"), os.path.join(root, "db_s2")
    cache = os.path.join(root, "s2_cache.pkl")
    fs = FrameStore(store_dir).open()
    chunks = common._chunks_from_index(fs, load_chunk_index(store_dir))
    n_train = sum(c["vid"] == 1 for c in chunks)
    val = [c for c in chunks if c["vid"] == 2]
    walls: dict = {}
    by_path: dict = {}

    def verb(name: str, argv: list) -> str:
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        walls[name] = walls.get(name, 0.0) + time.monotonic() - t0
        return buf.getvalue()

    def counted(path: str, fn):
        _zero_counts()
        out = fn()
        by_path[path] = _launch_counts()
        return out

    verb("write-ratt-db", ["write-ratt-db", "--store", store_dir, "--ckpt",
                           ck, "--run-id", "s1", "--db", db, "--device",
                           "cuda"])
    t2 = ["train-stage2", "--store", store_dir, "--db", db, "--ckpt", ck,
          "--collection", "ratt_db", "--cache", cache, "--stage1-run-id",
          "s1", "--train-vids", "1", "--val-vids", "2", *S2_KARGS,
          "--device", "cuda"]
    out = counted("stage2", lambda: verb(
        "train-stage2 (2 epochs)", t2 + ["--epochs", "2", "--run-id", "s2"])
        + verb("train-stage2 --resume", t2 + ["--epochs", "3", "--run-id",
                                              "s2", "--resume"])
        + verb("train-stage2 --preset stage3 --cached-val", t2 + [
            "--epochs", "1", "--run-id", "s3", "--preset", "stage3",
            "--init-run-id", "s2", "--cached-val"]))
    log("\n".join(f"[5g]   {line}" for line in out.splitlines()
                  if not line.startswith("[CACHE] built ")))
    mngr = checkpoint.CheckpointManager(ck, "s2")
    epochs = [r["step"] for r in read_metrics(
        os.path.join(mngr.dir, "metrics.jsonl"))]
    # B: the cache build encodes every chunk once, live validation the
    # validation pool once a run (the stage-3 run reads both from the cache)
    want = {"patch_embed": 0,
            "attention": 3 * (len(chunks) + 2 * len(val))}
    log(f"[5g] train-stage2 on {len(chunks)} chunks ({n_train} train, "
        f"{len(val)} validate): launches {by_path['stage2']} (want {want}: "
        f"B at dh = 96, {3 * len(chunks)} in the cache build)")
    pinned = load_config(os.path.join(ck, "s3", "experiment.json"))
    if (by_path["stage2"] != want or epochs != [0, 1, 2]
            or mngr.restore(2)["step"] != 3 * (n_train // S2_BATCH)
            or out.count("built stage-2 cache") != 1
            or out.count("loaded stage-2 cache") != 2
            or pinned.pinned_run_id != "s2" or "run s3: best" not in out):
        raise AssertionError(f"train-stage2: launches {by_path['stage2']}, "
                             f"epochs {epochs}")

    # eval-clips on the validation game, against the CPU
    res = os.path.join(root, "s2_eval")
    counted("eval_clips", lambda: verb("eval-clips", [
        "eval-clips", "--store", store_dir, "--ckpt", ck, "--db", db,
        "--collection", "ratt_db", "--vids", "2", "--out", res,
        "--stage1-run-id", "s1", "--stage2-run-id", "s2", *S2_KARGS,
        "--device", "cuda"]))
    rows = _read_rows(os.path.join(res, "logit_sequences.json"))
    cpu_col = scoring.open_collection(db, "ratt_db", device="cpu")
    _, cpu_encode = common._stage1_encode(fs, load_chunk_index(store_dir),
                                          ck, "s1", "cpu")
    cpu_head = scoring.stage2_head(768, ck, "s2", strict=True,
                                   device="cpu", **S2_K)
    want_rows = infer_clip_sequences(val, cpu_head, cpu_encode, cpu_col,
                                     **S2_K)
    eval_err = _rows_agree(rows, want_rows, "eval-clips")
    log(f"[5g] eval-clips on game 2: {len(rows)} clips, {len(val)} chunks; "
        f"launches {by_path['eval_clips']}; rows vs the CPU max|err| "
        f"{eval_err:.3e} (bound {SCORE_BOUND:.0e})")
    if by_path["eval_clips"] != {"patch_embed": 0,
                                 "attention": 3 * len(val)}:
        raise AssertionError(f"eval-clips launches {by_path['eval_clips']}")

    # score-events against a planted template: frames 20-35 of every clip
    template = {}
    for d in sorted(os.listdir(main["out"])):
        if CLIP_RE.match(d):
            nums = sorted(int(FRAME_RE.match(f).group(1)) for f in
                          os.listdir(os.path.join(main["out"], d))
                          if FRAME_RE.match(f))
            template[os.path.join(main["out"], d)] = {
                "event_make": [[nums[20], nums[35]]]}
    tpl = os.path.join(root, "s2_events.json")
    with open(tpl, "w") as f:
        json.dump(template, f)
    report = os.path.join(root, "s2_report.json")
    verb("score-events", ["score-events", os.path.join(
        res, "logit_sequences.json"), "--events", tpl, "--out", report])
    got = _read_rows(report)
    want_report = score_event_localization(rows, truth_events_by_clip(
        template))
    log(f"[5g] score-events: {got['clips_scored']} clips scored against "
        f"the planted template, hit@k {got['hit_at']}, top-1 centre error "
        f"{got.get('center_error_mean')} frames")
    if got != want_report or got["clips_scored"] != len(rows):
        raise AssertionError(f"score-events report {got}")

    out = verb("metrics", ["metrics", mngr.dir])
    if out.count("epoch ") != 3 or "val_best_f1=" not in out:
        raise AssertionError(f"metrics printed {out!r}")
    out = counted("smoke", lambda: verb("smoke", ["smoke", "--device",
                                                  "cuda"]))
    log(f"[5g] smoke: {out.strip().splitlines()}; launches "
        f"{by_path['smoke']} (A at P = 32, B at T = 313: 12 blocks)")
    if by_path["smoke"] != {"patch_embed": 1, "attention": 12} or \
            "encoded_tokens: (1, 313, 768)" not in out:
        raise AssertionError(f"smoke: {by_path['smoke']}, {out!r}")

    # segment --score-events offline, then the CPU scorer on its clips
    score = ["--score-events", "--score-ckpt", ck, "--stage1-run-id", "s1",
             "--stage2-run-id", "s2", "--score-db", db,
             "--score-collection", "ratt_db", "--chunk-size", "8",
             "--chunk-stride", "2", *S2_KARGS]
    seg = ["--method", "knn-hmm", "--k", "50", "--min-len", str(MIN_LEN),
           "--pad", str(PAD), "--vid", "2", "--batch-size", str(BATCH)]
    query_dir, n_query = main["query_dir"], main["n_query"]
    out_off = os.path.join(root, "s2_scored")
    out = counted("score", lambda: verb("segment --score-events", [
        "segment", query_dir, "--db", main["db"], "--corpus-collection",
        "corpus", "--out", out_off, *seg, *score, "--device", "cuda"]))
    offline = _read_rows(os.path.join(out_off, "events.json"))
    batches = math.ceil(n_query / BATCH)
    scored_b = by_path["score"]["attention"] - 12 * batches
    log(f"[5g] segment --score-events: {len(offline)} clips scored; "
        f"launches {by_path['score']} ({batches} engine batches; B at dh = "
        f"96 {scored_b} = 3 a clip)")
    if by_path["score"]["patch_embed"] != batches or \
            scored_b != 3 * len(offline) or len(offline) != len(template):
        raise AssertionError(f"segment --score-events: launches "
                             f"{by_path['score']}, {len(offline)} rows")
    paths = [os.path.join(query_dir, f"vid2_frame_{f}.jpg")
             for f in range(1, n_query + 1)]
    card = embed.make_hf_frame_embedder(device="cuda", batch_size=BATCH)
    table = {os.path.basename(p): e
             for p, e in zip(paths, card.embed_paths(paths))}
    del card

    def cpu_scorer(run_id):
        return scoring.make_live_scorer(
            lambda ps: np.stack([table[os.path.basename(p)] for p in ps]),
            dim=768, ckpt=ck, stage1_run_id="s1", stage2_run_id=run_id,
            db=db, collection="ratt_db", chunk_size=8, chunk_stride=2,
            device="cpu", **S2_K)

    clip_dirs = common._list_clip_dirs(out_off)
    cpu_rows = [common._score_clip_dir(cpu_scorer("s2"), d)
                for d in clip_dirs]
    score_err = _rows_agree(offline, cpu_rows, "segment --score-events")
    log(f"[5g] the card's scored rows vs a CPU LiveEventScorer of the same "
        f"runs on the same clips and frame embeddings: max|err| "
        f"{score_err:.3e} (bound {SCORE_BOUND:.0e}; top-k chunks equal "
        f"but for ties within {SCORE_TIE:.0e})")

    # the live routes: in-process --follow, then a daemon
    follow = [*seg, "--follow", "--idle-timeout", "30", "--poll-interval",
              "0.05"]
    out_local = os.path.join(root, "s2_follow_local")
    out_sock = os.path.join(root, "s2_follow_socket")
    sock = os.path.join(os.path.dirname(_socket_path(root)), "s.sock")
    cfg = {"ckpt": os.path.abspath(ck), "stage1_run_id": "s1",
           "stage2_run_id": "s2", "db": os.path.abspath(db),
           "collection": "ratt_db", "chunk_size": 8, "chunk_stride": 2,
           **S2_K}
    sessions: dict = {}

    def live_routes():
        verb("segment --follow --score-events", [
            "segment", _live_copy(query_dir, os.path.join(root, "s2_live_a")),
            "--db", main["db"], "--corpus-collection", "corpus", "--out",
            out_local, *follow, *score, "--device", "cuda"])
        thread, errors = _serve_thread(
            ["serve", "--socket", sock, "--db", main["db"], "--collection",
             "corpus", "--batch-size", str(BATCH), "--warmup", "--device",
             "cuda"])
        _await_ready(sock, errors)
        verb("segment --follow --socket --score-events", [
            "segment", _live_copy(query_dir, os.path.join(root, "s2_live_b")),
            "--socket", sock, "--out", out_sock, *follow, *score])
        # a session open across serve-ctl reload-weights (to the stage-3
        # run), then one opened after it
        with serve.SessionClient(sock, timeout=300.0) as c:
            start = c.request({"op": "segment_start", "k": 50,
                               "min_len": MIN_LEN, "pad": PAD, "vid": 2,
                               "score_events": cfg})
            half = len(paths) // 2
            rows_a = []
            for i in range(0, half, 64):
                rows_a += c.request({"op": "segment_push", "paths": paths[
                    i:min(i + 64, half)]}).get("events") or []
            sessions["reload"] = json.loads(verb("serve-ctl reload-weights", [
                "serve-ctl", "reload-weights", "--socket", sock, "--ckpt",
                os.path.abspath(ck), "--stage1-run-id", "s1",
                "--stage2-run-id", "s3", "--chunk-size", "8", *S2_KARGS]))
            for i in range(half, len(paths), 64):
                rows_a += c.request({"op": "segment_push", "paths": paths[
                    i:i + 64]}).get("events") or []
            rows_a += c.request({"op": "segment_finish"}).get("events") \
                or []
        sessions["pinned"] = (start, rows_a)
        sessions["after"] = _scoring_session(
            sock, paths, dict(cfg, stage2_run_id="s3"))
        sessions["off"] = _scoring_session(sock, paths, None)
        sessions["stats"] = serve.request(sock, {"op": "stats"},
                                          timeout=60.0)
        verb("serve-ctl shutdown", ["serve-ctl", "shutdown", "--socket",
                                    sock])
        thread.join(timeout=60.0)
        if thread.is_alive() or errors:
            raise AssertionError(f"serve thread alive {thread.is_alive()},"
                                 f" {errors}")

    counted("score_live", live_routes)
    local = _read_rows(os.path.join(out_local, "events.jsonl"))
    daemon = _read_rows(os.path.join(out_sock, "events.jsonl"))
    route_err = max(_rows_agree(local, offline, "segment --follow"),
                    _rows_agree(daemon, offline, "--follow --socket"))
    start_a, rows_a = sessions["pinned"]
    start_b, rows_b, push_on = sessions["after"]
    _, _, push_off = sessions["off"]
    reload_reply = sessions["reload"]
    pinned_err = _rows_agree(rows_a, offline, "the pinned session")
    s3_err = _rows_agree(rows_b, [common._score_clip_dir(cpu_scorer("s3"), d)
                                  for d in clip_dirs], "after the reload")
    moved = max(float(np.abs(np.subtract(a["raw_sequence"],
                                         b["raw_sequence"])).max())
                for a, b in zip(rows_b, offline))
    w2, w3 = (checkpoint.CheckpointManager(ck, r).restore_best()["params"]
              for r in ("s2", "s3"))
    w_moved = max(float((w3[k] - w2[k]).abs().max()) for k in w2)
    stats = sessions["stats"]
    live = by_path["score_live"]
    scored_live = len(local) + len(daemon) + len(rows_a) + len(rows_b)
    log(f"[5g] live rows: --follow and --follow --socket vs offline max|err|"
        f" {route_err:.3e}; serve-ctl reload-weights -> generation "
        f"{reload_reply['generation']}, "
        f"{reload_reply['active_sessions_pinned']} session pinned; the "
        f"pinned session (generation "
        f"{start_a['weights_generation']}) vs offline {pinned_err:.3e}; the "
        f"session after it (generation {start_b['weights_generation']}, "
        f"stage-3 run) vs a CPU scorer of s3 {s3_err:.3e}; s3's weights "
        f"{w_moved:.3e} from s2's, its logits {moved:.3e}; stats "
        f"events_scored "
        f"{stats['segment']['events_scored']}, errors "
        f"{stats['segment']['event_errors']}, stacks "
        f"{stats['scorer_stacks']}; launches {live} (B - 12 A = "
        f"{live['attention'] - 12 * live['patch_embed']} = 3 x "
        f"{scored_live} clips scored)")
    if (start_a["weights_generation"] != 0
            or start_b["weights_generation"] != 1
            or reload_reply["generation"] != 1
            or reload_reply["active_sessions_pinned"] != 1
            or not w_moved > 0.0
            or stats["segment"]["event_errors"]
            or stats["segment"]["events_scored"] != len(daemon)
            + len(rows_a) + len(rows_b)
            or live["attention"] - 12 * live["patch_embed"]
            != 3 * scored_live):
        raise AssertionError(f"live scoring: {reload_reply}, {stats}, "
                             f"{live}")
    log(f"[5g] segment_push of 64 frames, host clock: median "
        f"{statistics.median(push_on):.2f} ms with scoring, max "
        f"{max(push_on):.2f} (a push that scores a clip); "
        f"{statistics.median(push_off):.2f} ms without, max "
        f"{max(push_off):.2f} | {smi}")

    # a 64-frame clip's score_clip on the card (its frames cached)
    params = checkpoint.CheckpointManager(ck, "s1").restore_best()["params"]
    scorer = scoring.make_live_scorer(
        None, dim=768, ckpt=ck, stage1_run_id="s1", stage2_run_id="s2",
        db=db, collection="ratt_db", chunk_size=8, chunk_stride=2,
        device="cuda", **S2_K)
    clip64 = paths[60:124]
    scorer.remember(clip64, np.stack([table[os.path.basename(p)]
                                      for p in clip64]))
    score_ms = []
    for _ in range(6):
        t0 = time.perf_counter()
        scorer.score_clip(clip64, side="left", clip_num=1, vid=2)
        score_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[5g] score_clip of a 64-frame clip (29 chunks, 58 store queries) "
        f"on the card: median {statistics.median(score_ms[1:]):.2f} ms, "
        f"first {score_ms[0]:.2f} ms (host clock) | {smi}")

    log("[5g] verbs' wall: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in walls.items()))
    out = dict(launches_by_path=by_path, eval_row_err=eval_err,
               score_row_err=score_err, route_row_err=route_err,
               pinned_row_err=pinned_err, reload_row_err=s3_err,
               push_ms_scoring=statistics.median(push_on),
               push_ms_plain=statistics.median(push_off),
               score_clip_ms=statistics.median(score_ms[1:]),
               verb_wall_s=walls, attention_dh96=_stage2_kernel_rows(smi))
    out.update(_stage2_trajectory(smi, fs, chunks, ck, db))
    out.update(_stage2_step_times(smi))
    out.update(_stage2_cache_rate(smi, params))
    log(f"[5g] phase 5g: {time.monotonic() - t_phase:.1f} s")
    return out


# ---- phase 5h: train-cached, the temporal head, the joint step, RAG-ViT

# train-cached's flags on phase 5f's store (the preset's batch and top-k;
# bins of 0.1 in t_center)
CACHED_BATCH, CACHED_TOP_K, CACHED_DELTA_T = 8, 8, 0.1
# the temporal head: the first epochs of the card's training against a
# CPU run of the same init; its probabilities card vs CPU from the
# temporal_head.npz the card wrote (f32 through five convolutions)
TEMPORAL_TRAJ_EPOCHS = 50
TEMPORAL_PROB_BOUND = 1e-4
TEMPORAL_EPOCH_FRAMES = 20_000
# the joint ViT + RAGHead step: Adam's learning rate, steps card vs CPU
JOINT_LR, JOINT_STEPS = 1e-4, 2


def _profiled(fn, steps: int) -> dict:
    """``fn`` ``steps`` times under torch.profiler after a warm-up: wall
    ms a call, kernel ms a call, launches a call and the idle share
    1 - kernel time / wall time, with the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return dict(wall_ms=wall_ms, kernel_ms=busy_ms,
                launches=sum(e.count for e in kernels) / steps,
                idle=max(0.0, 1 - busy_ms / wall_ms),
                top=[(e.key[:80], e.self_device_time_total / 1e3 / steps)
                     for e in top])


def _recording_queries(col, calls: list):
    """``col`` whose ``query`` also appends each answer (ids and distances
    per anchor) to ``calls``."""
    real = col.query

    def query(*a, **kw):
        res = real(*a, **kw)
        calls.append([dict(zip(i, d)) for i, d in
                      zip(res["ids"], res["distances"])])
        return res

    col.query = query
    return col


def _same_pools(got: dict, want: dict) -> tuple:
    """Bins whose pools differ between two bin caches: (in order, as sets
    of rows, the first differing bin in build order or None). Raises
    unless both hold the same bins."""
    if got.keys() != want.keys():
        raise AssertionError(f"bin caches hold other bins: "
                             f"{len(got)} vs {len(want)}")
    ordered = as_sets = 0
    first = None
    for i, (key, w) in enumerate(want.items()):
        g = got[key]
        same = all(np.array_equal(g[n], w[n]) for n in w)
        ordered += not same
        if not same and first is None:
            first = i
        rows = [{(int(v), float(t), int(f)) for v, t, f in
                 zip(p["vid"], p["t_center"], p["is_hard_negative"])}
                for p in (g, w)]
        as_sets += rows[0] != rows[1]
    return ordered, as_sets, first


def _nearest_tie(answers: list) -> float:
    """The smallest gap between two candidates' best distances over a
    bin's mega-query (one {id: distance} a anchor)."""
    best: dict = {}
    for answer in answers:
        for i, d in answer.items():
            best[i] = min(d, best.get(i, math.inf))
    d = np.sort(np.asarray(list(best.values())))
    return float(np.diff(d).min()) if len(d) > 1 else math.inf


def phase_cached_path(smi: str, root: str) -> dict:
    """train-cached on phase 5f's two-game store with phase 5e's stage-1
    run and phase 5g's ratt_db: the bin cache built and 2 epochs, then
    --resume for a third, through the CLI on the card (B at dh = 96
    encodes every anchor and batch; RATTHead runs plain attention). The
    card's cache against a CPU build from the same collection rows
    (tie-aware: the mega-queries' answers equal within RETRIEVE_TIE),
    and a dropout-0 train_chunk_cached trajectory on the card against
    the CPU's within phase 5e's bounds."""
    from vit_research_tpu_torch.retrieval import cache_bins as CB
    from vit_research_tpu_torch.train import train_chunk_cached as tcc
    from vit_research_tpu_torch.utils.configs import preset

    t_phase = time.monotonic()
    store_dir = os.path.join(root, "store_rag")
    ck, db = os.path.join(root, "ckpt_s1"), os.path.join(root, "db_s2")
    cache = os.path.join(root, "bin_cache.pkl")
    fs = FrameStore(store_dir).open()
    idx = load_chunk_index(store_dir)
    chunks = common._chunks_from_index(fs, idx)
    train = [c for c in chunks if c["vid"] == 1]
    val = [c for c in chunks if c["vid"] == 2]
    tc = ["train-cached", "--store", store_dir, "--db", db, "--ckpt", ck,
          "--collection", "ratt_db", "--cache", cache, "--stage1-run-id",
          "s1", "--train-vids", "1", "--val-vids", "2", "--batch-size",
          str(CACHED_BATCH), "--top-k", str(CACHED_TOP_K), "--delta-t",
          str(CACHED_DELTA_T), "--run-id", "c1", "--device", "cuda"]
    _zero_counts()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        cli.main(tc + ["--epochs", "2"])
        cli.main(tc + ["--epochs", "3", "--resume"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    out = buf.getvalue()
    log("\n".join(f"[5h]   {line}" for line in out.splitlines()
                  if not line.startswith("[CACHE] (")))
    bins: dict = {}
    for ch in chunks:
        bins.setdefault((ch["side"], CB.coarse_time_bin(
            ch["t_center"], CACHED_DELTA_T), ch["label"]), []).append(ch)
    anchors = sum(min(3, len(v)) for v in bins.values())
    encodes = anchors + 3 * (len(train) // CACHED_BATCH) \
        + 3 * math.ceil(len(val) / CACHED_BATCH)
    want = {"patch_embed": 0, "attention": 3 * encodes}
    ckpt_steps = checkpoint.CheckpointManager(ck, "c1").all_steps()
    log(f"[5h] CLI train-cached (bin cache + 2 epochs, then --resume for "
        f"a third) {wall:.1f} s wall on {len(chunks)} chunks ({len(train)} "
        f"train, {len(val)} validate, {len(bins)} bins, {anchors} anchors):"
        f" launches {launches} (want {want}: B at dh = 96, 3 an encode)")
    if (launches != want or ckpt_steps != [0, 1, 2]
            or out.count("built bin cache") != 1
            or out.count("loaded bin cache") != 1
            or out.count("epoch 0:") != 1 or "epoch 2:" not in out):
        raise AssertionError(f"train-cached: launches {launches}, "
                             f"checkpoints {ckpt_steps}")

    # the card's cache against a CPU build of the same rows: the card
    # rebuilt in this process (equal to the CLI's pickle) and the CPU, each
    # recording its mega-queries' answers
    cfg = preset("chunks_cached")
    r = cfg.retrieval
    kw = dict(train_vids=[1], candidates_per_bin=r.candidates_per_bin,
              query_mult=r.query_mult, max_per_video=r.per_video_cap,
              max_global_appearances=r.global_cap,
              min_time_gap=r.min_time_gap,
              hard_negative_ratio=r.hard_negative_ratio,
              lambda_global=r.lambda_global, delta_t=CACHED_DELTA_T,
              seed=cfg.train.seed)
    card_cache = CB.load_cache(cache)
    built, calls = {}, {}
    for key, dev in (("card", "cuda"), ("host", "cpu")):
        _, encode = common._stage1_encode(fs, idx, ck, "s1", dev)
        col = PersistentClient(db, device=dev).get_collection("ratt_db")
        calls[key] = []
        built[key] = CB.build_bin_cache(
            chunks, encode, _recording_queries(col, calls[key]), **kw)
    rebuilt = _same_pools(built["card"], card_cache)[0]
    worst = 0.0
    if len(calls["card"]) != len(calls["host"]):
        raise AssertionError("the builds queried other bins")
    for a, b in zip(calls["card"], calls["host"]):
        for qa, qb in zip(a, b):
            if qa.keys() != qb.keys():
                raise AssertionError("a mega-query returned other rows")
            worst = max(worst, max(abs(qa[i] - qb[i]) for i in qa))
    # a pool may differ only from the first bin whose candidates hold a
    # near tie on: the greedy picks carry global counts into later bins
    ordered, as_sets, first = _same_pools(built["card"], built["host"])
    tie = math.inf if first is None else _nearest_tie(calls["host"][first])
    log(f"[5h] bin cache ({len(card_cache)} bins): the card's CLI pickle "
        f"vs an in-process card rebuild: {rebuilt} bins differ; card vs CPU"
        f" build of the same rows: {len(calls['card'])} mega-queries, the "
        f"same rows, distances max|err| {worst:.3e} (ties within "
        f"{RETRIEVE_TIE:.0e}); pools differing {ordered} in order, "
        f"{as_sets} as sets, from bin {first} of the build on, whose "
        f"candidates' nearest distances are {tie:.2e} apart")
    if (rebuilt or worst > RETRIEVE_TIE or len(calls["host"]) != len(
            card_cache) or (first is not None and tie > RETRIEVE_TIE)):
        raise AssertionError(f"bin cache: {rebuilt} bins differ from the "
                             f"pickle, distances {worst}, first differing "
                             f"bin {first} without a tie ({tie})")

    # dropout-0 trajectory, card vs CPU, from one seeded init on the same
    # cached rows and chunk embeddings (the card's encoder). Its cache
    # draws candidates from both games, so that the training game's
    # chunks retrieve the other game's rows (the CLI's --train-vids 1
    # cache gives them none: same-game rows are masked)
    encode_batch, encode_chunk = common._stage1_encode(fs, idx, ck, "s1",
                                                       "cuda")
    both = CB.build_bin_cache(
        chunks, encode_chunk, PersistentClient(db, device="cuda")
        .get_collection("ratt_db"), **dict(kw, train_vids=[1, 2]))
    embs = encode_batch(gather_chunk_embedding_batch(
        fs, idx, np.arange(len(chunks))))[0]
    embs = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
    row = {(c["vid"], c["clip"], c["start_idx"]): i
           for i, c in enumerate(chunks)}

    def chunk_embed(batch):
        return embs[[row[c["vid"], c["clip"], c["start_idx"]]
                     for c in batch]]

    tcfg = dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, embed_dim=fs.dim,
                                      classifier_dropout=0.0),
        retrieval=dataclasses.replace(r, top_k=CACHED_TOP_K),
        train=dataclasses.replace(cfg.train, num_epochs=2,
                                  batch_size=CACHED_BATCH))
    runs = {}
    for key, dev in (("card", "cuda"), ("host", "cpu")):
        head, hist = tcc.train_chunk_cached(
            train, val, chunk_embed, both, cfg=tcfg,
            delta_t=CACHED_DELTA_T, device=dev)
        runs[key] = (hist, {k: v.detach().cpu()
                            for k, v in head.state_dict().items()})
    errs = _trajectory_errs(*runs["card"], *runs["host"])
    n_steps = 2 * (len(train) // CACHED_BATCH)
    lr_bound = tcfg.train.lr_phase1 * n_steps
    log(f"[5h] dropout-0 train_chunk_cached, {n_steps} steps + 2 "
        f"validations, card vs CPU from one init: losses relative max|err| "
        f"{errs['loss']:.3e} (bound {TRAJ_LOSS_RTOL:.0e}); parameters "
        f"max|err| {errs['param']:.3e} (bound lr x steps {lr_bound:.0e}), "
        f"off share {errs['off_share']:.3e} (bound {TRAJ_OFF_SHARE:.0e}; "
        f"worst {errs['worst']}); agreement {runs['card'][0][-1]['agreement']:.3f}")
    if not (errs["loss"] <= TRAJ_LOSS_RTOL and errs["param"] <= lr_bound
            and errs["off_share"] <= TRAJ_OFF_SHARE):
        raise AssertionError(f"train_chunk_cached trajectory: {errs}")
    log(f"[5h] train-cached part: {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, wall_s=wall, bins=len(card_cache),
                anchors=anchors, query_dist_err=worst,
                pools_differing_in_order=ordered,
                pools_differing_as_sets=as_sets,
                trajectory_loss_rel_err=errs["loss"],
                trajectory_param_err=errs["param"],
                trajectory_off_share=errs["off_share"])


def phase_temporal_path(smi: str, root: str, main: dict) -> dict:
    """``segment --method temporal`` (the default method; 3000 epochs) on
    phase 4's corpus game with its manual CSV through the CLI on the card:
    the engine embeds the game (kernels A and B at ViT-B/16 @224), the
    TemporalHead trains on the card and is written to temporal_head.npz.
    That file read on the CPU: its probabilities against the card's
    (TEMPORAL_PROB_BOUND) and the decoded paths (equal but at ties below
    TIE_MARGIN); the first 50 epochs of a card run against a CPU run of
    one init (phase 5e's loss bound); whether the clips are the planted
    possessions (reported); an epoch at a game's length under the
    profiler."""
    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.data.labels import ManualIntervals
    from vit_research_tpu_torch.models.temporal_head import (
        TemporalHead, f32_convolutions, masked_cross_entropy)
    from vit_research_tpu_torch.train import train_temporal as tt

    t_phase = time.monotonic()
    frames_dir, manual = main["corpus_dir"], main["corpus_csv"]
    out_dir = os.path.join(root, "clips_temporal")
    names = naming.list_frames(frames_dir)
    _zero_counts()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        cli.main(["segment", frames_dir, "--manual-csv", manual, "--out",
                  out_dir, "--vid", "1", "--min-len", str(MIN_LEN), "--pad",
                  str(PAD), "--batch-size", str(BATCH), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    batches = math.ceil(len(names) / BATCH)
    log(f"[5h] CLI segment --method temporal (default; 3000 epochs) on "
        f"{len(names)} frames: {wall:.1f} s wall; {buf.getvalue().strip()};"
        f" launches {launches} for {batches} engine batches | {smi}")
    _check_launches(launches, batches, "segment --method temporal")
    if f"decoded {len(names)} frames" not in buf.getvalue():
        raise AssertionError(buf.getvalue())

    # the card's weights, read on the CPU, on the engine's embeddings
    embs = common._engine(BATCH, "cuda").embed_paths(
        [os.path.join(frames_dir, n) for n in names])
    npz = os.path.join(out_dir, "temporal_head.npz")
    dim = embs.shape[1]
    model = TemporalHead(dim)
    model.load_state_dict(convert.temporal_head_to_state_dict(
        checkpoint.load_params_npz(
            convert.temporal_head_to_params(model.state_dict()), npz)))
    p_host = tt.predict_probs(model, embs)
    p_card = tt.predict_probs(model.to("cuda"), embs)
    prob_err = float(np.abs(p_card - p_host).max())
    path_card = hmm.smooth_probabilities(p_card, device="cuda")
    path_host = hmm.smooth_probabilities(p_host, device="cpu")
    top2 = np.sort(p_host, axis=1)[:, -2:]
    differ = np.flatnonzero(path_card != path_host)
    margins = top2[differ, 1] - top2[differ, 0]
    clips = _clip_ranges(out_dir)
    planted, fnum = [], 1
    for side, n in CORPUS_SEGMENTS:  # possessions of at least MIN_LEN
        if side != "none" and n >= MIN_LEN:
            planted.append((side, max(1, fnum - PAD),
                            min(len(names), fnum + n - 1 + PAD)))
        fnum += n
    at_planted = len(clips) == len(planted) and all(
        c[0] == p[0] and abs(c[1] - p[1]) <= BOUNDARY_SLACK
        and abs(c[2] - p[2]) <= BOUNDARY_SLACK
        for c, p in zip(clips, planted))
    log(f"[5h] temporal_head.npz on the CPU vs the card: probabilities "
        f"max|err| {prob_err:.3e} (bound {TEMPORAL_PROB_BOUND:.0e}); decoded "
        f"paths differ at {len(differ)} frames (emission margins there "
        f"{margins.max() if len(differ) else 0:.2e}, ties below "
        f"{TIE_MARGIN:.0e}); clips {clips} vs the planted possessions "
        f"{planted}: {'equal' if at_planted else 'NOT equal'} (reported)")
    if not (prob_err <= TEMPORAL_PROB_BOUND and np.isfinite(p_card).all()
            and (margins < TIE_MARGIN).all()):
        raise AssertionError(f"temporal head card vs CPU: {prob_err}, "
                             f"margins {margins}")

    # the first 50 epochs, card vs CPU from one seeded init
    labels = np.asarray(ManualIntervals.from_csv(manual).label_array(names))
    init = convert.temporal_head_to_params(TemporalHead(
        dim, generator=torch.Generator().manual_seed(0)).state_dict())
    losses = {key: tt.train_temporal_head(
        embs, labels, epochs=TEMPORAL_TRAJ_EPOCHS, init_params=init,
        device=dev)[1] for key, dev in (("card", "cuda"), ("host", "cpu"))}
    traj = float(np.max(np.abs(losses["card"] - losses["host"])
                        / np.abs(losses["host"])))
    log(f"[5h] TemporalHead, {TEMPORAL_TRAJ_EPOCHS} epochs card vs CPU from "
        f"one init: losses relative max|err| {traj:.3e} (bound "
        f"{TRAJ_LOSS_RTOL:.0e}; {losses['host'][0]:.5f} -> "
        f"{losses['host'][-1]:.5f})")
    if not traj <= TRAJ_LOSS_RTOL:
        raise AssertionError(f"temporal trajectory: {traj}")

    # an epoch at a game's length: forward + backward + Adam, f32 convs
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(1, TEMPORAL_EPOCH_FRAMES, 768, generator=g, device=dev)
    y = torch.randint(-1, 3, (1, TEMPORAL_EPOCH_FRAMES), generator=g,
                      device=dev)
    head = TemporalHead(768).to(dev).train()
    opt = torch.optim.Adam(head.parameters(), lr=1e-5, betas=tt._BETAS,
                           eps=1e-8)

    def epoch():
        loss = masked_cross_entropy(head(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    with f32_convolutions():
        epoch_ms = cuda_ms(epoch, reps=3, n=5)
        prof = _profiled(epoch, 5)
    flops = 0
    dims = [768, 256, 256, 128, 64, 3]
    for (c_in, c_out, k) in zip(dims, dims[1:], (9, 7, 5, 3, 1)):
        # forward; backward: the weight gradient and (but conv1) the input's
        flops += 2 * TEMPORAL_EPOCH_FRAMES * c_in * c_out * k * (
            3 if c_in != 768 else 2)
    lim = bound(TEMPORAL_EPOCH_FRAMES * 768 * 4, flops, "f32")
    log(f"[5h] TemporalHead epoch at {TEMPORAL_EPOCH_FRAMES} frames x 768 "
        f"(f32 convolutions): {epoch_ms:.3f} ms by CUDA events; "
        f"{bound_text(lim)}; under the profiler {prof['kernel_ms']:.3f} ms "
        f"of kernels in {prof['wall_ms']:.3f} ms of wall, idle "
        f"{100 * prof['idle']:.1f}%, {prof['launches']:.0f} launches | {smi}")
    for key, ms in prof["top"]:
        log(f"[5h]   {ms:8.3f} ms {key}")
    log(f"[5h] temporal part: {time.monotonic() - t_phase:.1f} s")
    del head, opt, x, y
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, prob_err=prob_err,
                path_frames_differing=int(len(differ)),
                clips_at_planted=at_planted, trajectory_loss_rel_err=traj,
                epoch_ms=epoch_ms, epoch_idle=prof["idle"],
                epoch_launches=prof["launches"], epoch_gflop=flops / 1e9,
                **{f"epoch_{k}": v for k, v in lim.items()})


def _joint_models(dev, **vit_kw):
    """ViT-B/16 @224 (``ViTConfig(**vit_kw)``), ProjectionHead 768 and
    RAGHead (HeadConfig()) from one seed, on ``dev``."""
    from vit_research_tpu_torch.utils.configs import HeadConfig, ViTConfig

    gen = torch.Generator().manual_seed(0)
    return [m.to(dev) for m in (
        vit_mod.VisionTransformer(ViTConfig(**vit_kw), generator=gen),
        heads.ProjectionHead(768, generator=gen),
        heads.RAGHead(HeadConfig(), generator=gen))]


def phase_joint_path(smi: str) -> dict:
    """The joint train step (train/train_step.py) at full ViT-B/16 @224
    width: 2 steps of B = 1 chunk x 2 frames on the card against the CPU
    from one state (phase 5e's bounds), the same card run with B's dq
    zeroed (must fail them), then the card alone at B = 4 chunks x 8
    frames: the step by CUDA events, its launches and idle share."""
    from vit_research_tpu_torch.train.optim import Optimizer
    from vit_research_tpu_torch.train.train_step import \
        make_joint_train_step

    t_phase = time.monotonic()
    g = torch.Generator().manual_seed(9)
    inputs = [(torch.randn(1, 2, 224, 224, 3, generator=g),
               torch.randn(1, 5, 768, generator=g),
               torch.tensor([float(i % 2)])) for i in range(JOINT_STEPS)]
    runs, by_path = {}, {}
    for key, dev, fault in (("card", "cuda", False), ("host", "cpu", False),
                            ("card", "cuda", True)):
        mods = _joint_models(dev)
        opt = Optimizer([p for m in mods for p in m.parameters()],
                        lr=JOINT_LR)
        step = make_joint_train_step(*mods, opt)
        _zero_counts()
        t0 = time.monotonic()
        with _planted_zero_dq() if fault else contextlib.nullcontext():
            losses = [float(step(*(t.to(dev) for t in batch)))
                      for batch in inputs]
        if key == "card" and not fault:
            by_path = _launch_counts()
        runs[key, fault] = (
            [dict(train_loss=l, val_loss=l) for l in losses],
            {f"{i}.{k}": v.detach().cpu() for i, m in enumerate(mods)
             for k, v in m.state_dict().items()}, time.monotonic() - t0)
        del mods, opt, step
        torch.cuda.empty_cache()
    base = runs["host", False][:2]
    errs = _trajectory_errs(*runs["card", False][:2], *base)
    planted = _trajectory_errs(*runs["card", True][:2], *base)
    lr_bound = JOINT_LR * JOINT_STEPS

    def passes(e: dict) -> bool:
        return (e["loss"] <= TRAJ_LOSS_RTOL and e["param"] <= lr_bound
                and e["off_share"] <= TRAJ_OFF_SHARE)

    for what, e in (("card", errs), ("card, dq zeroed (planted fault)",
                                     planted)):
        log(f"[5h] joint step ViT-B/16 @224 + ProjectionHead + RAGHead, "
            f"{JOINT_STEPS} steps of 1 chunk x 2 frames, {what} vs CPU: "
            f"losses relative max|err| {e['loss']:.3e} (bound "
            f"{TRAJ_LOSS_RTOL:.0e}); parameters max|err| {e['param']:.3e} "
            f"(bound lr x steps {lr_bound:.0e}), off share "
            f"{e['off_share']:.3e} (bound {TRAJ_OFF_SHARE:.0e}; worst "
            f"{e['worst']})")
    want = {"patch_embed": 0, "attention": JOINT_STEPS * (12 + 2)}
    log(f"[5h] joint step launches on the card {by_path} (want {want}: B "
        f"forward in the 12 ViT blocks at T = 197, dh = 64 and RAGHead's 2 "
        f"at dh = 192; the backward is the plain VJP); card "
        f"{runs['card', False][2]:.1f} s, CPU {runs['host', False][2]:.1f} s")
    if not (passes(errs) and by_path == want):
        raise AssertionError(f"joint step: {errs}, launches {by_path}")
    if passes(planted):
        raise AssertionError(f"the joint-step check passes a zeroed dq: "
                             f"{planted}")

    # the card alone at B = 4 chunks x 8 frames
    dev = torch.device("cuda")
    mods = _joint_models(dev)
    opt = Optimizer([p for m in mods for p in m.parameters()], lr=JOINT_LR)
    step = make_joint_train_step(*mods, opt)
    gd = torch.Generator(device=dev).manual_seed(10)
    frames = torch.randn(4, 8, 224, 224, 3, generator=gd, device=dev)
    retrieved = torch.randn(4, 5, 768, generator=gd, device=dev)
    labels = torch.tensor([0.0, 1.0, 0.0, 1.0], device=dev)
    step_ms = cuda_ms(lambda: step(frames, retrieved, labels), reps=3, n=3)
    prof = _profiled(lambda: step(frames, retrieved, labels), 3)
    t, d = 197, 768  # a frame's forward: 12 blocks and the patch matmul
    frame = 12 * (2 * t * (4 * d * d + 2 * d * 4 * d) + 4 * t * t * d) \
        + 2 * 196 * 768 * d
    flops = 3 * 32 * frame  # the backward: twice the forward
    lim = bound(0, flops, "f32")
    log(f"[5h] joint step B = 4 chunks x 8 frames: {step_ms:.2f} ms by CUDA "
        f"events ({flops / step_ms / 1e9:.1f} TFLOP/s at ~{flops / 1e12:.2f}"
        f" TFLOP); {bound_text(lim)}; under the profiler "
        f"{prof['kernel_ms']:.2f} ms of kernels in {prof['wall_ms']:.2f} ms "
        f"of wall, idle {100 * prof['idle']:.1f}%, {prof['launches']:.0f} "
        f"launches | {smi}")
    for key, ms in prof["top"]:
        log(f"[5h]   {ms:8.3f} ms {key}")
    log(f"[5h] joint part: {time.monotonic() - t_phase:.1f} s")
    del mods, opt, step, frames
    torch.cuda.empty_cache()
    return dict(launches=by_path, trajectory_loss_rel_err=errs["loss"],
                trajectory_param_err=errs["param"],
                trajectory_off_share=errs["off_share"],
                planted_zero_dq_loss_rel_err=planted["loss"],
                planted_zero_dq_off_share=planted["off_share"],
                step_ms=step_ms, step_idle=prof["idle"],
                step_launches=prof["launches"], step_bound_ms=lim["bound_ms"])


def phase_rag_vit_path(smi: str) -> dict:
    """RAG-ViT at full width (ViT-B/16 @224 with 4 retrieval tokens from 8
    retrieved rows: T = 197 + 4) on 8 frames, the card against the CPU
    within EMBED_BOUND; B's launches (12, dh = 64)."""
    from vit_research_tpu_torch.models import rag_vit

    host = rag_vit.build_rag_vit(num_retrieval_tokens=4, seed=0).eval()
    g = torch.Generator().manual_seed(13)
    imgs = torch.randn(8, 224, 224, 3, generator=g)
    retrieved = torch.nn.functional.normalize(
        torch.randn(8, 8, 768, generator=g), dim=-1)
    with torch.no_grad():
        want = host(imgs, retrieved)
        card = host.to("cuda")
        _zero_counts()
        got = card(imgs.to("cuda"), retrieved.to("cuda"))
        torch.cuda.synchronize()
        launches = _launch_counts()
        ms = cuda_ms(lambda: card(imgs.to("cuda"), retrieved.to("cuda")),
                     reps=3, n=3)
    err = max(float((got[k].cpu() - want[k]).abs().max()) for k in want)
    log(f"[5h] RAG-ViT ViT-B/16 @224 + 4 retrieval tokens (T = 201), 8 "
        f"frames, card vs CPU: max|err| {err:.3e} over the endpoints "
        f"(bound {EMBED_BOUND:.0e}); launches {launches}; forward "
        f"{ms:.2f} ms | {smi}")
    if not (err <= EMBED_BOUND and launches == {"patch_embed": 0,
                                                "attention": 12}):
        raise AssertionError(f"RAG-ViT: {err}, {launches}")
    del card, host
    torch.cuda.empty_cache()
    return dict(launches=launches, max_abs_err=err, forward_ms=ms)


def phase_game_store(smi: str, n: int = 200_000, d: int = 768,
                     n_q: int = 256, k: int = 50) -> dict:
    """A game's worth of frames as a seeded cosine collection, queried on
    the card in f32 and int8 and held against the CPU answers; returns
    the rows, the queries, k and the card collection (phase 5i's)."""
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
    del cpu
    torch.cuda.empty_cache()
    return dict(embs=embs, q=q, k=k, col=col)


# ---- phase 5i: bf16 heads, remat, the mesh, attn_layout -----------------

# Two dropout-0 training steps of a bf16 head on the card against the same
# steps on the CPU, from one state: the two round their bf16 products at
# other points (cuBLAS and kernel B against the CPU's matmuls and the
# plain attention, which rounds the scores to bf16 before the softmax),
# 8 significant bits through each layer, and Adam moves a weight by up to
# lr whatever the size of its gradient, so a rounding-noise gradient's
# sign decides a whole step. Per-step losses: relative BF16_LOSS_RTOL;
# the trained head's outputs on a held-out batch: within BF16_OUT of
# their scale (the chunk embedding and the fused row, both after the f32
# final LayerNorm, and the logits): each of the ~20 roundings to bf16 on
# a block's path may fall apart by an ulp (2^-8 of the value), and the
# worst of a batch's outputs sums several of them. The parameters'
# largest difference is printed, with no bound: the outputs carry their
# effect. The card run with B's first head zeroed must fail: a head's
# whole output is more than that.
BF16_LOSS_RTOL = 2 ** -5
BF16_OUT = 2 ** -3
# remat against the same step without it: the recompute reruns the same
# kernels on the same inputs (and replays the dropout generators).
REMAT_BOUND = 1e-6
MESH_ENTRIES = 4
BF16_STEPS = 2


def _bf16_head_steps(model, batches, lr: float, dev) -> tuple:
    """``BF16_STEPS`` Adam steps of ``model`` (a ChunkEncoder or a
    RAGHead) on ``batches`` (a list of (inputs, labels)), then its
    outputs on the last batch in eval mode: (losses, outputs,
    parameters), on the host."""
    from vit_research_tpu_torch.train import losses
    from vit_research_tpu_torch.train.optim import Optimizer

    model = model.to(dev).train()
    opt = Optimizer(list(model.parameters()), lr=lr)
    out_losses = []
    for inputs, labels in batches[:BF16_STEPS]:
        xs = [x.to(dev) for x in inputs]
        logits = model(*xs)[0 if isinstance(model, heads.RAGHead) else 1]
        loss = losses.bce_with_logits(labels.to(dev), logits)
        opt.step(torch.autograd.grad(loss, opt.params))
        out_losses.append(float(loss))
    model.eval()
    with torch.no_grad():
        outs = model(*(x.to(dev) for x in batches[-1][0]))
    return (out_losses, [o.float().cpu() for o in outs[:2]],
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def _bf16_errs(card, host, lr: float) -> dict:
    loss = max(abs(a - b) / max(abs(b), 1e-12)
               for a, b in zip(card[0], host[0]))
    out = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(card[1], host[1]))
    param = max(float((card[2][k] - host[2][k]).abs().max())
                for k in host[2])
    ok = loss <= BF16_LOSS_RTOL and out <= BF16_OUT
    return dict(loss=loss, out=out, param=param, ok=ok)


# S2's fault lines, which fail the run. The card's forward at step 0
# against the CPU's from equal weights and inputs: beyond a few bf16 ulps
# (2^-8 of a value each) of its scale is a fault, not rounding. Kernel
# B's forward against the same forward with B's plain version on the
# same card: one ulp of the scale (they round S, the scale, the bias and
# P alike and differ only in summation order).
S2_FORWARD_FAULT = 2 ** -6
S2_KERNEL_FAULT = 2 ** -8


def _s2_bisection(make, batches, lr: float) -> dict:
    """Where the bf16 heads' card-vs-CPU output gap after two steps comes
    from: the held-out outputs of (1) the forward at step 0, and the same
    with kernel B swapped for its plain version on the card, (2) one
    plain SGD step (scaled so that the CPU's largest step is ``lr``, as
    large as Adam's), (3) one step of the training Optimizer (AdamW),
    each on the card against the CPU from the same weights and inputs,
    as a share of the outputs' scale; the forward with kernel B against the
    same with its plain version, both on the card; and the first step's
    gradients."""
    from vit_research_tpu_torch.train import losses
    from vit_research_tpu_torch.train.optim import Optimizer

    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def outputs(model, dev):
        model.eval()
        with torch.no_grad():
            outs = model(*(x.to(dev) for x in batches[-1][0]))
        return [o.float().cpu() for o in outs[:2]]

    def grads(model, dev):
        model.train()
        inputs, labels = batches[0]
        idx = 0 if isinstance(model, heads.RAGHead) else 1
        loss = losses.bce_with_logits(
            labels.to(dev), model(*(x.to(dev) for x in inputs))[idx])
        return torch.autograd.grad(loss, list(model.parameters()))

    def rel(a, b):
        return max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(a, b))

    def sgd(dev, scale):
        model = make().to(dev)
        step = grads(model, dev)
        with torch.no_grad():
            for p, g in zip(model.parameters(), step):
                p -= scale * g
        return outputs(model, dev)

    def adamw(dev):
        model = make().to(dev)
        Optimizer(list(model.parameters()), lr=lr).step(grads(model, dev))
        return outputs(model, dev)

    host_g = grads(make().to(cpu), cpu)
    card_g = [g.float().cpu() for g in grads(make().to(cuda), cuda)]
    scale = lr / max(float(g.abs().max()) for g in host_g)
    host = outputs(make().to(cpu), cpu)
    with _plain_attention():
        plain = outputs(make().to(cuda), cuda)
    card = outputs(make().to(cuda), cuda)
    return dict(forward=rel(card, host), forward_plain=rel(plain, host),
                kernel_vs_plain=rel(card, plain),
                sgd=rel(sgd(cuda, scale), sgd(cpu, scale)),
                adamw=rel(adamw(cuda), adamw(cpu)),
                grad=rel(card_g, [g.float() for g in host_g]))


def _bf16_head_case(smi: str, name: str, make, batches, lr: float,
                    kernel: str, f32_make) -> dict:
    """One bf16 head: card vs CPU steps, the planted fault, the step ms
    of the bf16 and the f32 head by CUDA events, and the kernel B
    instantiation its training launched."""
    dev = torch.device("cuda")
    card_model = make()
    counter = attn.multi_head_attention.launches_by_kernel
    counter.clear()
    _zero_counts()
    card = _bf16_head_steps(card_model, batches, lr, dev)
    launches, launched = _launch_counts(), dict(counter)
    host = _bf16_head_steps(make(), batches, lr, torch.device("cpu"))
    with _planted_zero_head():
        planted = _bf16_head_steps(make(), batches, lr, dev)
    errs, bad = _bf16_errs(card, host, lr), _bf16_errs(planted, host, lr)

    def step_ms(model):
        from vit_research_tpu_torch.train import losses
        from vit_research_tpu_torch.train.optim import Optimizer

        model = model.to(dev).train()
        opt = Optimizer(list(model.parameters()), lr=lr)
        xs = [x.to(dev) for x in batches[0][0]]
        y = batches[0][1].to(dev)
        idx = 0 if isinstance(model, heads.RAGHead) else 1

        def step():
            loss = losses.bce_with_logits(y, model(*xs)[idx])
            opt.step(torch.autograd.grad(loss, opt.params))
        return cuda_ms(step, reps=3, n=5)

    ms = {"bf16": step_ms(make()), "f32": step_ms(f32_make())}
    s2 = _s2_bisection(make, batches, lr)
    log(f"[5i] S2 bisection, {name} bf16, card vs CPU from equal weights "
        f"and inputs, held-out outputs as a share of their scale: forward "
        f"at step 0 {s2['forward']:.3e} (fails above {S2_FORWARD_FAULT:.3e}; "
        f"{s2['forward_plain']:.3e} with B's plain version on the card; B "
        f"against that plain forward on the card {s2['kernel_vs_plain']:.3e},"
        f" fails above {S2_KERNEL_FAULT:.3e}), after one plain SGD step "
        f"{s2['sgd']:.3e}, after one AdamW step {s2['adamw']:.3e}; the "
        f"first step's gradients {s2['grad']:.3e} of their scale | {smi}")
    log(f"[5i] {name} bf16, {BF16_STEPS} dropout-0 steps card vs CPU: losses "
        f"relative {errs['loss']:.3e} (bound {BF16_LOSS_RTOL:.3e}), "
        f"outputs {errs['out']:.3e} of their scale (bound {BF16_OUT:.3e}), "
        f"parameters max|err| {errs['param']:.3e} (lr {lr:.0e}); B's first "
        f"head zeroed (planted fault): "
        f"losses {bad['loss']:.3e}, outputs {bad['out']:.3e}, parameters "
        f"{bad['param']:.3e}; kernel B launches in the card's steps "
        f"{launched}; step {ms['bf16']:.3f} ms bf16, {ms['f32']:.3f} ms "
        f"f32 by CUDA events | {smi}")
    if not errs["ok"]:
        raise AssertionError(f"{name} bf16 card vs CPU: {errs}")
    if not (s2["forward"] <= S2_FORWARD_FAULT
            and s2["kernel_vs_plain"] <= S2_KERNEL_FAULT):
        raise AssertionError(f"{name} bf16 forward at step 0: {s2}")
    if bad["ok"]:
        raise AssertionError(f"{name} bf16: the check passes B's first head "
                             f"zeroed: {bad}")
    if not launched.get(kernel):
        raise AssertionError(f"{name} bf16 training launched {launched}, "
                             f"not {kernel}")
    return dict(step_ms_bf16=ms["bf16"], step_ms_f32=ms["f32"],
                loss_rel_err=errs["loss"], out_rel_err=errs["out"],
                planted_out_rel_err=bad["out"], launches=launches,
                launches_by_kernel=launched, s2_bisection=s2)


def phase_bf16_heads(smi: str, root: str) -> dict:
    """bf16 heads on the card: a ChunkEncoder at ChunkEncoderConfig()
    width (768, 3 layers, 8 heads: attn_bf16<96>) from phase 5e's trained
    run on phase 5's store chunks (B = 32), and a RAGHead (768 x 2, 4
    heads: attn_bf16<192>) on phase 5f's store rows (B = 8). Counted as
    the path ``bf16``."""
    from vit_research_tpu_torch.utils.configs import HeadConfig

    t_phase = time.monotonic()
    params = checkpoint.CheckpointManager(
        os.path.join(root, "ckpt_s1"), "s1").restore_best()["params"]
    max_len = params["pos_embedding"].shape[1] - 1

    def encoder(dtype):
        m = _stage1_encoder(ChunkEncoderConfig(max_len=max_len,
                                               dropout_rate=0.0,
                                               dtype=dtype))
        m.load_state_dict(params)
        return m

    fs = FrameStore(os.path.join(root, "store")).open()
    idx = load_chunk_index(os.path.join(root, "store"))
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(BF16_STEPS + 1):
        ids = rng.choice(len(idx["label"]), STAGE1_BATCH, replace=False)
        batches.append(([torch.from_numpy(gather_chunk_embedding_batch(
            fs, idx, ids))], torch.from_numpy(
                idx["label"][ids].astype(np.float32))))
    out = {"chunk_encoder": _bf16_head_case(
        smi, "ChunkEncoder 768x3, 8 heads, B=32", lambda: encoder("bfloat16"),
        batches, 5e-5, "attn_bf16<96>", lambda: encoder("float32"))}

    rag_fs = FrameStore(os.path.join(root, "store_rag")).open()
    rows = rag_fs.gather(np.arange(rag_fs.n))
    gen = torch.Generator().manual_seed(12)
    rag_init = heads.RAGHead(HeadConfig(dtype="bfloat16", dropout_rate=0.0,
                                        classifier_dropout=0.0),
                             generator=gen).state_dict()

    def rag(dtype):
        m = heads.RAGHead(HeadConfig(dtype=dtype, dropout_rate=0.0,
                                     classifier_dropout=0.0))
        m.load_state_dict(rag_init)
        return m

    batches = []
    for _ in range(BF16_STEPS + 1):
        pick = rng.choice(len(rows), RAG_BATCH * (1 + RAG_TOP_K))
        x = torch.from_numpy(rows[pick]).reshape(RAG_BATCH, 1 + RAG_TOP_K,
                                                 -1)
        batches.append(([x[:, 0], x[:, 1:]], torch.from_numpy(
            (rng.random(RAG_BATCH) > 0.5).astype(np.float32))))
    out["rag_head"] = _bf16_head_case(
        smi, f"RAGHead 768x2, 4 heads, B={RAG_BATCH}", lambda: rag("bfloat16"),
        batches, 1e-4, "attn_bf16<192>", lambda: rag("float32"))
    # the path's launches: the two heads' card steps
    out["launches"] = _Counts({k: sum(out[h]["launches"][k] for h in
                                      ("chunk_encoder", "rag_head"))
                               for k in ("patch_embed", "attention")})
    out["launches"].by_kernel = dict(sum(
        (collections.Counter(out[h]["launches"].by_kernel)
         for h in ("chunk_encoder", "rag_head")), collections.Counter()))
    log(f"[5i] bf16 heads part: {time.monotonic() - t_phase:.1f} s")
    return out


def _remat_run(mods, init, remat: bool, frames, retrieved, labels,
               train_mode: bool):
    """From the state ``init``: the joint step (eval mode, as
    train_step.py runs it) or, with ``train_mode``, a backbone step in
    training mode at dropout 0.1 whose masks come from a seeded
    generator; 2 steps with ``remat`` set or not: (losses, parameters on
    the host, peak bytes above the models', ms a step by CUDA events)."""
    from vit_research_tpu_torch.train.optim import Optimizer
    from vit_research_tpu_torch.train.train_step import \
        make_joint_train_step

    dev = torch.device("cuda")
    for m, sd in zip(mods, init):
        m.load_state_dict(sd)
    vit = mods[0]
    vit.config = dataclasses.replace(vit.config, remat=remat)
    if train_mode:
        vit.train()
        vit_mod.set_dropout_generator(
            vit, torch.Generator(device=dev).manual_seed(21))
        w = torch.randn(frames.shape[0] * frames.shape[1], 768,
                        generator=torch.Generator(device=dev).manual_seed(22),
                        device=dev)
        flat = frames.reshape(-1, *frames.shape[2:])
        opt = Optimizer(list(vit.parameters()), lr=JOINT_LR)

        def step():
            loss = (vit(flat)["pooled"] * w).sum() / w.shape[0]
            opt.step(torch.autograd.grad(loss, opt.params))
            return loss.detach()
    else:
        opt = Optimizer([p for m in mods for p in m.parameters()],
                        lr=JOINT_LR)
        step = functools.partial(make_joint_train_step(*mods, opt), frames,
                                 retrieved, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    losses = [float(step()) for _ in range(2)]
    peak = torch.cuda.max_memory_allocated() - base
    params = {f"{i}.{k}": v.detach().cpu() for i, m in enumerate(mods)
              for k, v in m.state_dict().items()}
    ms = cuda_ms(step, reps=3, n=2)
    vit_mod.set_dropout_generator(vit, None)
    del opt, step
    torch.cuda.empty_cache()
    return losses, params, peak, ms


def phase_remat(smi: str) -> dict:
    """ViTConfig.remat on the card: the joint ViT-B/16 step
    (train/train_step.py, 4 chunks x 8 frames; dropout 0.1 in the
    config, which the step's eval mode does not draw) with remat against
    the same step without it over 2 steps (losses and parameters within
    REMAT_BOUND), then a backbone step in training mode at dropout 0.1
    with the masks from a seeded generator (the recompute must replay
    them); peak memory and ms a step of each."""
    t_phase = time.monotonic()
    dev = torch.device("cuda")
    mods = _joint_models(dev, dropout_rate=0.1, attention_dropout_rate=0.1)
    init = [{k: v.clone() for k, v in m.state_dict().items()} for m in mods]
    gd = torch.Generator(device=dev).manual_seed(20)
    frames = torch.randn(4, 8, 224, 224, 3, generator=gd, device=dev)
    retrieved = torch.randn(4, 5, 768, generator=gd, device=dev)
    labels = torch.tensor([0.0, 1.0, 0.0, 1.0], device=dev)
    out = {}
    for what, train_mode in (("joint step", False),
                             ("backbone train step, dropout 0.1", True)):
        runs = {r: _remat_run(mods, init, r, frames, retrieved, labels,
                              train_mode) for r in (False, True)}
        loss_err = max(abs(a - b) for a, b in zip(runs[True][0],
                                                  runs[False][0]))
        param_err = max(float((runs[True][1][k] - runs[False][1][k])
                              .abs().max()) for k in runs[False][1])
        log(f"[5i] remat, {what}, 4 chunks x 8 frames of ViT-B/16 @224: "
            f"losses max|err| {loss_err:.3e}, parameters max|err| "
            f"{param_err:.3e} after 2 steps (bound {REMAT_BOUND:.0e}); peak "
            f"memory {runs[False][2] / 2**30:.3f} GiB without remat, "
            f"{runs[True][2] / 2**30:.3f} GiB with; {runs[False][3]:.2f} ms "
            f"a step without, {runs[True][3]:.2f} ms with (CUDA events) | "
            f"{smi}")
        if max(loss_err, param_err) > REMAT_BOUND:
            raise AssertionError(f"remat {what}: losses {loss_err}, "
                                 f"parameters {param_err}")
        out["train_dropout" if train_mode else "joint"] = dict(
            peak_gib=runs[False][2] / 2**30,
            peak_gib_remat=runs[True][2] / 2**30, step_ms=runs[False][3],
            step_ms_remat=runs[True][3], loss_err=loss_err,
            param_err=param_err)
    del mods, init, frames
    torch.cuda.empty_cache()
    log(f"[5i] remat part: {time.monotonic() - t_phase:.1f} s")
    return out


def phase_mesh(smi: str, root: str, main: dict, game: dict) -> dict:
    """The mesh on the one card: make_mesh() over the visible cards; a
    4-entry mesh on cuda:0 under sharded_masked_topk and its int8 twin
    over phase 6's 200,000 x 768 cosine rows (256 queries, k = 50, with
    and without a mask) against the flat device path (tie-aware), the
    sharded Collection against the unsharded one, both timed; a 2-entry
    mesh engine on phase 4's frames against the single-device engine
    (EMBED_BOUND; its launches, the path ``mesh``); serve --shard-device
    answering query as an unsharded daemon; attn_layout 'bthd' against
    'bhtd' on the card."""
    from vit_research_tpu_torch.ops import sharded_topk as st
    from vit_research_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.monotonic()
    dev = torch.device("cuda")
    whole = make_mesh()
    if whole.size != torch.cuda.device_count() or whole.shape != {
            "data": torch.cuda.device_count()}:
        raise AssertionError(f"make_mesh() on this machine: {whole}")
    mesh = make_mesh(devices=["cuda:0"] * MESH_ENTRIES)
    embs, q, col, k = game["embs"], game["q"], game["col"], game["k"]
    corpus = topk.l2_normalize(torch.from_numpy(embs).to(dev))
    qd = topk.l2_normalize(torch.from_numpy(q).to(dev))
    g = torch.Generator(device=dev).manual_seed(30)
    mask = torch.rand(len(q), len(embs), generator=g, device=dev) > 0.5
    placed = st.place_sharded(st.pad_corpus(corpus, MESH_ENTRIES)[0], mesh)
    cq, cs = topk.quantize_int8(corpus)
    qq, qs = topk.quantize_int8(qd)
    placed_q = st.place_sharded(st.pad_corpus(cq, MESH_ENTRIES)[0], mesh)
    placed_s = st.place_sharded(st.pad_corpus(cs, MESH_ENTRIES)[0], mesh)
    n = len(embs)
    timings = {}
    for m in (None, mask):
        cases = {
            "f32": (lambda: st.sharded_masked_topk(
                        qd, placed, m, k=k, mesh=mesh, metric="ip",
                        n_valid=n),
                    lambda: topk.masked_topk(qd, corpus, m, k=k,
                                             metric="ip")),
            "int8": (lambda: st.sharded_masked_topk_int8(
                         qq, qs, placed_q, placed_s, m, k=k, mesh=mesh,
                         n_valid=n),
                     lambda: topk.masked_topk_int8(qq, qs, cq, cs, m, k=k))}
        for name, (sharded, flat) in cases.items():
            (gs, gi), (ws, wi) = sharded(), flat()
            differ = _same_neighbours(gi.cpu().numpy(), gs.cpu().numpy(),
                                      wi.cpu().numpy(), ws.cpu().numpy(),
                                      1e-5)
            what = f"{name}, {'masked' if m is not None else 'unmasked'}"
            timings[what] = (cuda_ms(sharded, reps=3, n=3),
                             cuda_ms(flat, reps=3, n=3))
            log(f"[5i] sharded top-k over {MESH_ENTRIES} entries of cuda:0, "
                f"{what}, {n} x 768 rows, {len(q)} queries, k={k}: equal to "
                f"the flat path ({differ} of {len(q)} queries differ only in "
                f"near-ties within 1e-5); {timings[what][0]:.3f} ms sharded, "
                f"{timings[what][1]:.3f} ms flat (CUDA events) | {smi}")
    del placed, placed_q, placed_s, cq, cs, mask

    # the Collection: unsharded and sharded over the 4 entries, f32 and int8
    col_ms = {}
    for quant in (None, "int8"):
        col.shard_device(None)
        col.set_device_quantization(quant)
        want, _, flat_ms = _timed_query(col, q, k)
        col.shard_device(mesh)
        got, first, ms = _timed_query(col, q, k)
        ws, gs = (1.0 - np.asarray(a["distances"]) for a in (want, got))
        # the sharded corpus is normalised (and quantized) on the host, the
        # flat one on the card: an ulp of the norm can move an int8 value
        differ = _same_neighbours(got["ids"], gs, want["ids"], ws,
                                  STORE_BOUND[quant or "f32"])
        col_ms[quant or "f32"] = (ms, flat_ms)
        log(f"[5i] Collection.query sharded over {MESH_ENTRIES} entries "
            f"({quant or 'f32'}): {ms:.1f} ms (first, with the shards' "
            f"upload: {first:.1f} ms) against {flat_ms:.1f} ms unsharded, "
            f"host clock; equal ({differ} of {len(q)} queries differ only in"
            f" near-ties) | {smi}")
    col.shard_device(None)
    del corpus

    # the mesh engine on phase 4's frames
    paths = sorted(os.path.join(main["query_dir"], f)
                   for f in os.listdir(main["query_dir"]))[:BATCH]
    frames = load_frames(paths, SPEC)
    single = embed.make_hf_frame_embedder(device="cuda", batch_size=BATCH)
    want = single.embed_batch(frames)
    eng = embed.EmbeddingEngine(single.model, SPEC, mesh=make_mesh(
        devices=["cuda:0"] * 2), batch_size=BATCH)
    _zero_counts()
    got = eng.embed_batch(frames)
    launches = _launch_counts()
    err = _max_err(got, want)
    log(f"[5i] mesh engine, 2 entries of cuda:0, {len(frames)} frames of "
        f"phase 4's game: max|err| {err:.2e} against the single-device "
        f"engine (bound {EMBED_BOUND:.0e}); launches {launches} (a share "
        f"a device) | {smi}")
    if err > EMBED_BOUND or launches != {"patch_embed": 2,
                                         "attention": 24}:
        raise AssertionError(f"mesh engine: err {err}, launches {launches}")

    # attn_layout='bthd' against 'bhtd' on the card (the plain path)
    x = single.encode  # the engine's model, kernel A then the encoder
    small = torch.from_numpy(frames[:8]).to(dev)
    base = x(small)["pooled"].float()
    for blk in single.model.blocks:
        blk.attn.attn_layout = "bthd"
    try:
        bthd = x(small)["pooled"].float()
    finally:
        for blk in single.model.blocks:
            blk.attn.attn_layout = "bhtd"
    bthd_err = float((bthd - base).abs().max())
    log(f"[5i] attn_layout 'bthd' (plain path) against 'bhtd' (kernel B), "
        f"ViT-B/16 @224 on 8 frames: max|err| {bthd_err:.2e} (bound "
        f"{EMBED_BOUND:.0e})")
    if bthd_err > EMBED_BOUND:
        raise AssertionError(f"bthd vs bhtd: {bthd_err}")
    del single, eng, small
    torch.cuda.empty_cache()

    # serve --shard-device against an unsharded daemon on phase 4's db
    socks = {name: os.path.join(root, f"{name}.sock")
             for name in ("plain", "shard")}
    socks = {k: min(v, os.path.relpath(v), key=len) for k, v in socks.items()}
    threads = {name: _serve_thread(
        ["serve", "--socket", sock, "--db", main["db"], "--collection",
         "corpus", "--batch-size", "16", "--device", "cuda"]
        + (["--shard-device"] if name == "shard" else []))
        for name, sock in socks.items()}
    try:
        for name, (t, errors) in threads.items():
            _await_ready(socks[name], errors)
        req = {"op": "query", "paths": paths[::16], "n_results": 10}
        want = serve.request(socks["plain"], req, timeout=120.0)
        got = serve.request(socks["shard"], req, timeout=120.0)
        stats = serve.request(socks["shard"], {"op": "stats"}, timeout=30.0)
        if not (got["ok"] and want["ok"] and stats["sharded"]):
            raise AssertionError(f"serve --shard-device: {got}, {stats}")
        differ = _same_neighbours(got["ids"], 1 - np.asarray(got["distances"]),
                                  want["ids"],
                                  1 - np.asarray(want["distances"]), 1e-5)
        log(f"[5i] serve --shard-device (stats: sharded "
            f"{stats['sharded']}) answers {len(req['paths'])} queries as "
            f"the unsharded daemon ({differ} differ only in near-ties)")
    finally:
        for name, (t, errors) in threads.items():
            try:
                serve.request(socks[name], {"op": "shutdown"}, timeout=30.0)
            except (OSError, ConnectionError):
                pass
            t.join(timeout=60.0)
            if t.is_alive() or errors:
                raise RuntimeError(f"{name} daemon: {errors}")
    log(f"[5i] mesh part: {time.monotonic() - t_phase:.1f} s")
    return dict(launches=launches, engine_max_abs_err=err,
                bthd_max_abs_err=bthd_err,
                sharded_topk_ms={k: v[0] for k, v in timings.items()},
                flat_topk_ms={k: v[1] for k, v in timings.items()},
                sharded_query_ms={k: v[0] for k, v in col_ms.items()},
                flat_query_ms={k: v[1] for k, v in col_ms.items()})


# ---- phase 5j: the walkthroughs and the dossier ----------------------

#: the keys of every JAX dossier row, and of its quantized and refined rows
DOSSIER_KEYS = {
    "variant", "tome_r", "stride", "gemm_quant", "world_entropy",
    "fidelity_cos_mean", "fidelity_cos_p5", "clip_f1", "clip_precision",
    "clip_recall", "frame_accuracy", "boundary_drift_frames", "n_pred",
    "n_true", "retrieval_top8_overlap", "event_hit@1", "event_hit@3",
    "event_center_err", "scored_clips", "metric_wall_s"}
DOSSIER_QUANT_KEYS = {"calibration"}
DOSSIER_REFINE_KEYS = {"stride_refine", "refined_frame_frac", "refine_gaps",
                       "refine_keys", "refine_refined_gaps",
                       "refine_refined_frames", "exact_embed_frac"}
#: phase 5d's per-frame cosine bound for an int8 engine, held by the
#: dossier's unstrided int8-static rows against the parity engine
INT8_FIDELITY = 0.999
#: the sharded search's scores against the flat path's (the same int8
#: products, merged)
SHARDED_SCORE_BOUND = 1e-6
#: the pod's gathered rows against one process's: the same kernels over
#: other batch shapes (48-frame shards against 64 + 32 frames)
POD_BOUND = 1e-5


def _walkthrough(fn, argv: list) -> tuple:
    """``fn(argv)`` with its prints on stderr, and the kernels' launches
    it made (and kernel B's by instantiation), counted from 0 just before
    it ran."""
    _zero_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(sys.stderr):
        out = fn(argv)
    return (out, _launch_counts(),
            dict(attn.multi_head_attention.launches_by_kernel),
            time.monotonic() - t0)


def phase_examples(smi: str, root: str, game: dict) -> dict:
    """The walkthroughs of vit_research_tpu_torch/examples/ in this
    process through their ``main`` at full width on the card (the path
    ``examples``), then the IVF spill on phase 6's rows. Each
    walkthrough is held to its result: full_pipeline's clips carry the
    planted sides and every validation clip has a row;
    live_segmentation's streamed clips equal the offline clips of the
    same embeddings and the daemon session's; serving's embeddings are
    within EMBED_BOUND of the in-process engine's, and both followers
    finish with their clips; sharded_search's ids equal
    the flat path's (tie order included) and its scores are within
    SHARDED_SCORE_BOUND; pod_embedding's gathered rows are within
    POD_BOUND of one process's engine; the dossier's rows have every JAX
    key, parity's clip F1 is 1.0 and the unstrided int8-static rows reach
    INT8_FIDELITY. The spill: an IVF fit of the 200,000 x 768 rows,
    spilled to disk, loaded back and searched out of core, equal to the
    in-RAM IVF's answers."""
    from vit_research_tpu_torch.examples import (full_pipeline,
                                                 live_segmentation,
                                                 pod_embedding,
                                                 quality_fast_profile,
                                                 serving, sharded_search)
    from vit_research_tpu_torch.segment.clips import (
        clip_intervals_from_decoded)
    from vit_research_tpu_torch.segment.pipeline import segment_with_knn_hmm
    from vit_research_tpu_torch.store.ivf import IVFIndex

    t_phase = time.monotonic()
    wd = os.path.join(root, "ex")
    launches = {"patch_embed": 0, "attention": 0}
    by_kernel = {}
    times = {}

    def run(name, fn, argv):
        out, counts, b_counts, secs = _walkthrough(fn, argv)
        for kname, v in counts.items():
            launches[kname] += v
        for kname, v in b_counts.items():
            by_kernel[kname] = by_kernel.get(kname, 0) + v
        times[name] = secs
        log(f"[5j] {name}: {secs:.1f} s, kernel launches {counts}, B by "
            f"instantiation {b_counts}")
        return out

    fp = run("full_pipeline", full_pipeline.main, [os.path.join(wd, "fp")])
    for vid, dirs in fp["clip_dirs"].items():
        sides = sorted(CLIP_RE.match(os.path.basename(d)).group(2)
                       for d in dirs)
        if set(sides) != {"left", "right"}:
            raise AssertionError(f"full_pipeline vid {vid}: clips {sides}")
    want = {(c["vid"], c["clip"]) for c in fp["val_chunks"]}
    got = {(r["vid"], r["clip"]) for r in fp["rows"]}
    if got != want:
        raise AssertionError(f"full_pipeline rows {sorted(got)} for the "
                             f"validation clips {sorted(want)}")
    n_clips = [len(d) for d in fp["clip_dirs"].values()]
    log(f"[5j] full_pipeline: {n_clips} clips a game (left and right), "
        f"{len(fp['rows'])} rows for {len(want)} validation clips")

    ls = run("live_segmentation", live_segmentation.main,
             [os.path.join(wd, "ls")])
    batches = list(live_segmentation.stream_batches(ls["engine"],
                                                    ls["paths"]))
    decoded, _, _ = segment_with_knn_hmm(
        [n for names, _ in batches for n in names],
        np.concatenate([e for _, e in batches]),
        knn.corpus_from_collection(ls["collection"]), k=5,
        device=ls["engine"].device)
    offline = [(c.side, c.start, c.end) for c in
               clip_intervals_from_decoded(decoded, min_len=100, pad=20)]
    streamed = [(c.side, c.start, c.end) for c in ls["streamed"]]
    served = [(c["side"], c["start"], c["end"]) for c in ls["served"]]
    if not streamed or streamed != offline or served != streamed:
        raise AssertionError(f"live_segmentation: streamed {streamed}, "
                             f"offline {offline}, daemon {served}")
    log(f"[5j] live_segmentation: streamed = offline = daemon clips "
        f"{streamed}")

    sv = run("serving", serving.main, [os.path.join(wd, "sv")])
    paths = [sv["paths"][s] for s in live_segmentation.SIDES]
    err = _max_err(np.asarray(sv["ops"]["embed"]["embeddings"], np.float32),
                   sv["engine"].embed_paths(paths))
    followed = sv["followed"]
    if err > EMBED_BOUND or any(len(followed[v]) != 2 for v in (1, 2)):
        raise AssertionError(f"serving: embed max|err| {err:.2e}, "
                             f"followers' clips {followed}")
    log(f"[5j] serving: daemon embeddings max|err| {err:.2e} against the "
        f"engine (bound {EMBED_BOUND:.0e}); both followers finished: "
        f"{followed}; sessions {sv['stats']['segment']}")

    ss = run("sharded_search", sharded_search.main, [])
    s_err = _max_err(np.asarray(ss["sharded"]["distances"]),
                     np.asarray(ss["flat"]["distances"]))
    if ss["sharded"]["ids"] != ss["flat"]["ids"] or \
            s_err > SHARDED_SCORE_BOUND:
        raise AssertionError(f"sharded_search: ids differ or scores "
                             f"{s_err:.2e}")
    log(f"[5j] sharded_search: {ss['mesh'].devices.size} entries, ids equal "
        f"the flat path's, scores max|err| {s_err:.2e} (bound "
        f"{SHARDED_SCORE_BOUND:.0e})")

    pod = run("pod_embedding", pod_embedding.main,
              ["--out", os.path.join(root, "pod.npy")])
    one = pod_embedding.build_engine("cuda", False).embed_batch(
        pod["frames"])
    p_err = _max_err(pod["gathered"], one)
    if pod["gathered"].shape != one.shape or p_err > POD_BOUND:
        raise AssertionError(f"pod_embedding: {pod['gathered'].shape} "
                             f"max|err| {p_err:.2e}")
    log(f"[5j] pod_embedding: 2 processes over gloo, gathered "
        f"{pod['gathered'].shape} within {p_err:.2e} of one process's "
        f"engine (bound {POD_BOUND:.0e})")

    q = run("quality_fast_profile", quality_fast_profile.main,
            ["--root", os.path.join(wd, "q"),
             "--out", os.path.join(wd, "q.jsonl")])
    for row in q["rows"]:
        need = set(DOSSIER_KEYS)
        if row["gemm_quant"]:
            need |= DOSSIER_QUANT_KEYS
        if "stride_refine" in row:
            need |= DOSSIER_REFINE_KEYS
        if need - set(row):
            raise AssertionError(f"dossier row {row['variant']} lacks "
                                 f"{sorted(need - set(row))}")
        log(f"[5j] dossier row {json.dumps(row)}")
    rows = {r["variant"]: r for r in q["rows"]}
    low = {n: r["fidelity_cos_mean"] for n, r in rows.items()
           if r["gemm_quant"] and r["stride"] == 1
           and r["fidelity_cos_mean"] < INT8_FIDELITY}
    if rows["parity"]["clip_f1"] != 1.0 or low:
        raise AssertionError(f"dossier: parity clip_f1 "
                             f"{rows['parity']['clip_f1']}, int8-static "
                             f"fidelity below {INT8_FIDELITY}: {low}")

    t0 = time.monotonic()
    embs, qs, k = game["embs"], game["q"], game["k"]
    ivf = IVFIndex(seed=0).fit(embs)
    ram_s, ram_i = ivf.search(qs, embs, k)
    prefix = os.path.join(root, "game_ivf")
    ivf.spill(embs, prefix)
    disk_s, disk_i = IVFIndex.load(prefix).search(qs, None, k)
    spill_err = _max_err(disk_s, ram_s)
    if not np.array_equal(disk_i, ram_i) or spill_err > 1e-6:
        raise AssertionError(f"IVF spill: ids differ or scores "
                             f"{spill_err:.2e}")
    times["ivf_spill"] = time.monotonic() - t0
    log(f"[5j] IVF spill of {embs.shape[0]} x {embs.shape[1]} rows "
        f"({len(ivf.cells)} cells): loaded from disk, {len(qs)} queries "
        f"k={k} equal the in-RAM IVF's (scores max|err| {spill_err:.2e}); "
        f"fit, spill, load and both searches {times['ivf_spill']:.1f} s")
    if not (launches["patch_embed"] and launches["attention"]):
        raise AssertionError(f"examples: kernel launches {launches}")
    times["phase"] = time.monotonic() - t_phase
    log(f"[5j] examples phase: {times['phase']:.1f} s, kernel launches "
        f"{launches}, B by instantiation {by_kernel} | {smi}")
    return dict(launches=launches, launches_by_kernel=by_kernel,
                seconds=times,
                dossier={n: {k2: r[k2] for k2 in (
                    "clip_f1", "fidelity_cos_mean", "retrieval_top8_overlap",
                    "event_hit@1", "metric_wall_s")}
                    for n, r in rows.items()})


def profile_forward(smi: str, dtype: str, batch: int, steps: int = 3,
                    top: int = 10, **kw) -> dict:
    """torch.profiler over ``steps`` steady batches of the engine's forward
    on device-resident uint8 frames: device time per batch by kernel, and
    the idle share 1 - kernel time / wall time of the window. ``kw`` goes
    to make_hf_frame_embedder; ``gemm_quant='int8-static'`` without scales
    calibrates on the profiled frames first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.randint(0, 256, (batch, 224, 224, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    if kw.get("gemm_quant") == "int8-static" and not kw.get(
            "gemm_quant_scales"):
        calib = embed.make_hf_frame_embedder(device="cuda", batch_size=batch,
                                             dtype=dtype, **kw)
        with quant.calibration_mode() as scales:
            calib._forward(frames)
        kw = dict(kw, gemm_quant_scales=scales)
        del calib
    eng = embed.make_hf_frame_embedder(device="cuda", batch_size=batch,
                                       dtype=dtype, **kw)
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
    what = ", ".join(f"{k}={v}" for k, v in kw.items()
                     if k != "gemm_quant_scales")
    log(f"[profile] ViT-B/16 @224 {dtype} B={batch}{' ' + what if what else ''}"
        f": {busy_ms:.1f} ms/batch "
        f"of kernels, {wall_ms:.1f} ms/batch wall, idle "
        f"{100 * max(0.0, 1 - busy_ms / wall_ms):.1f}% | {smi}")
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3 / steps
        log(f"[profile]   {ms:8.2f} ms {100 * ms / busy_ms:5.1f}% "
            f"x{e.count // steps:<3d} {e.key[:90]}")
    del eng, frames
    torch.cuda.empty_cache()
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, kernels_ms={
        e.key: e.self_device_time_total / 1e3 / steps for e in kernels})


def profile_train_step(smi: str, dropout: float, steps: int = 5,
                       top: int = 14) -> None:
    """torch.profiler over ``steps`` steady stage-1 training steps of the
    full-width ChunkEncoder (B = 32 chunks of 8 frames; dropout 0.1, the
    CLI's, or 0): device time per step by kernel and the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(STAGE1_BATCH, 8, 768, generator=g, device=dev)
    y = (torch.rand(STAGE1_BATCH, generator=g, device=dev) > 0.5).float()
    model = _stage1_encoder(
        ChunkEncoderConfig(max_len=8, dropout_rate=dropout), 0) \
        .to(dev).train()
    vit_mod.set_dropout_generator(model, tce.dropout_generator(0, 0, dev))
    opt = tce.stage1_optimizer(list(model.parameters()), 5e-5, 1.0, 5e-4)
    step = _stage1_step_fn(model, opt, x, y)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    log(f"[profile] stage-1 train step, ChunkEncoder 768x3 B="
        f"{STAGE1_BATCH}x8 dropout {dropout}: {busy_ms:.3f} ms/step of "
        f"kernels, {wall_ms:.3f} ms/step wall, idle "
        f"{100 * max(0.0, 1 - busy_ms / wall_ms):.1f}%, {launches:.0f} "
        f"kernel launches a step | {smi}")
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3 / steps
        log(f"[profile]   {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% "
            f"x{e.count // steps:<4d} {e.key[:90]}")
    del model, opt
    torch.cuda.empty_cache()


def _vote_emissions(t: int, seed: int = 0, k: int = 10) -> np.ndarray:
    """k-neighbour vote fractions over runs of 80-400 frames of one side:
    the emissions a write-frame-db corpus gives the HMM (many exact
    ties)."""
    rng = np.random.default_rng(seed)
    lab = []
    while len(lab) < t:
        lab += [int(rng.integers(0, 3))] * int(rng.integers(80, 401))
    p = np.full((t, 3), 0.15)
    p[np.arange(t), lab[:t]] = 0.7
    return (np.stack([rng.multinomial(k, row) for row in p]) / k).astype(
        np.float32)


def _torch_loop_viterbi(log_emit, log_trans, log_prior):
    """A per-frame torch loop on the card (the port's sequential decoder
    before it moved to the host): timed for comparison only."""
    dp = log_prior + log_emit[0]
    bps = []
    for i in range(1, log_emit.shape[0]):
        m = dp[:, None] + log_trans
        bps.append(torch.argmax(m, dim=0))
        dp = torch.amax(m, dim=0) + log_emit[i]
    state = torch.argmax(dp)
    path = [state]
    for bp in reversed(bps):
        state = bp[state]
        path.append(state)
    return torch.stack(path[::-1]).to(torch.int32).cpu().numpy()


def time_viterbi(smi: str, lengths=(512, 2048, 8191, 8192, 32768)) -> None:
    """The three offline Viterbi decoders on vote-fraction emissions (host
    clock, upload and readback included; one warm-up and the median of 3
    timed calls each): the host numpy loop (``smooth_probabilities``
    below 8192 frames), the log-depth scan on the card (from 8192), and a
    per-frame torch loop on the card; which one the default routing takes
    and whether the paths agree."""
    trans = viterbi_ops.log_transition_matrix(hmm.DEFAULT_TRANSITIONS)
    prior = np.log(hmm.UNIFORM_PRIOR)
    for t in lengths:
        probs = _vote_emissions(t)
        le = np.log(np.maximum(probs, 1e-6))
        le_dev = torch.from_numpy(le).cuda()
        decoders = {
            "host loop": lambda: hmm.smooth_probabilities(
                probs, parallel=False, device="cuda"),
            "card log-depth": lambda: hmm.smooth_probabilities(
                probs, parallel=True, device="cuda"),
            "card torch loop": lambda: _torch_loop_viterbi(
                le_dev, trans.cuda(), torch.from_numpy(prior).cuda()),
        }
        ms, paths = {}, {}
        for name, fn in decoders.items():
            fn()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                paths[name] = fn()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name] = statistics.median(times)
        default = ("card log-depth" if t >= hmm._PARALLEL_THRESHOLD
                   else "host loop")
        same = np.array_equal(paths["host loop"], paths["card log-depth"])
        log(f"[viterbi] T={t}: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in ms.items())
            + f"; default route {default}; host loop = torch loop "
            f"{np.array_equal(paths['host loop'], paths['card torch loop'])}"
            f", host loop = log-depth {same} | {smi}")


# Kernel B's T <= 25 rows, where the host wrapper bounds a call: (B, H, T,
# dh, dtype, what): stage 2 (a chunk an encode), the RAGHead's training
# batch, scoring (a 64-frame clip's chunks), the bf16 chunk encoder's
# training batch.
HOST_ROWS = ((1, 8, 9, 96, torch.float32, "stage 2, a chunk an encode"),
             (8, 4, 5, 192, torch.float32, "RAGHead training batch"),
             (29, 8, 9, 96, torch.float32, "scoring, a clip's 29 chunks"),
             (32, 8, 9, 96, torch.bfloat16, "bf16 chunk encoder batch"),
             (8, 4, 5, 192, torch.bfloat16, "bf16 RAGHead training batch"))


def _host_steps(q, k, v) -> dict:
    """Host microseconds a call of each step of kernel B's launch path at
    these inputs, each step timed alone (host_us over 1,000 calls; the C
    call, which launches the kernel each time, over 200): the steps of the
    launch path before it was cut, in their order, with the cheaper calls
    that stand in for some of them now."""
    b, h, t, d = q.shape
    fn = _build.library().vrt_attention_fwd
    o = torch.empty(b, t, h, d, dtype=q.dtype, device=q.device) \
        .transpose(1, 2)
    strides = [s for x in (q, k, v, o) for s in attn._kernel_strides(x)]
    arr = (ctypes.c_longlong * 12)(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    is_bf16 = int(q.dtype == torch.bfloat16)
    counter = collections.Counter()

    def device_context():
        with torch.cuda.device(q.device):
            pass

    steps = {
        "argument checks (shapes, dtype, grad mode)": lambda: (
            q.dim() != 4 or q.shape != k.shape or q.shape != v.shape,
            q.dtype in (torch.float32, torch.bfloat16),
            torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v))),
        "q.device.type": lambda: q.device.type,
        "4 x _kernel_strides": lambda: [attn._kernel_strides(x)
                                        for x in (q, k, v, o)],
        "torch.empty(...).transpose(1, 2)": lambda: torch.empty(
            b, t, h, d, dtype=q.dtype, device=q.device).transpose(1, 2),
        "torch.empty_strided(...)": lambda: torch.empty_strided(
            (b, h, t, d), (t * h * d, d, h * d, 1), dtype=q.dtype,
            device=q.device),
        "_build.library()": _build.library,
        "torch.cuda.device(q.device) entered and left": device_context,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream(q.device).cuda_stream":
            lambda: torch.cuda.current_stream(q.device).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(q.get_device()),
        "(ctypes.c_longlong * 12)(*strides)":
            lambda: (ctypes.c_longlong * 12)(*strides),
        "launch count under an f-string key": lambda: counter.__setitem__(
            f"attn_{'bf16' if is_bf16 else 'f32'}<{d}>", 1),
        "_build.check(0, ...)": lambda: _build.check(0, "attention kernel"),
    }
    out = {name: host_us(step) for name, step in steps.items()}
    out["the C call (argument conversion, the launch)"] = host_us(
        lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   b, h, t, d, arr, 0.125, is_bf16, None, 0, stream), 200)
    return out


def kernel_probs(q, k, key_bias=None) -> torch.Tensor:
    """Kernel B's bf16 P for (q, k, key_bias), (B, H, T, T), read exactly
    through one-hot V: with v[j] = e_(j - j0) for the dh keys from j0 on
    and 0 elsewhere, the output's column c is P[:, j0 + c] (one nonzero
    product, and P is a bf16 value). ceil(T / dh) launches."""
    b, h, t, dh = q.shape
    out = torch.empty(b, h, t, t, dtype=q.dtype, device=q.device)
    eye = torch.eye(dh, dtype=q.dtype, device=q.device)
    for j0 in range(0, t, dh):
        n = min(dh, t - j0)
        v = torch.zeros(b, t, h, dh, dtype=q.dtype, device=q.device)
        v[:, j0:j0 + n] = eye[:n, None, :]
        out[..., j0:j0 + n] = attn.multi_head_attention(
            q, k, v.transpose(1, 2), key_bias=key_bias)[..., :n]
    return out


def plain_softmax(q, k, key_bias=None) -> tuple:
    """attention_plain's scores of (q, k, key_bias) in their dtype and
    their f32 softmax, before attention_plain rounds it to P."""
    return scores_softmax(torch.einsum("bhqd,bhkd->bhqk", q, k), key_bias,
                          q.shape[-1] ** -0.5)


# The P probe's cause test. A P that rounds apart from f32 differences in
# its arithmetic (the exp, the sum, the quotient: ~2^-20 relative) lies
# within 2^-16 of a bf16 rounding midpoint; the kernel's P pins each score
# less the row's max to within its two bf16 roundings (2^-9 relative each)
# plus 2^-18 for that arithmetic.
P_MIDPOINT = 2.0 ** -16
P_SLACK = 2.0 ** -18


def _bf16_half_ulp(x: torch.Tensor) -> torch.Tensor:
    """Half the bf16 spacing at each (nonnegative) bf16 value of x, f64:
    2^(e - 9) for x in [2^(e-1), 2^e), 2^-134 at 0 and below 2^-126."""
    _, e = torch.frexp(x.float())
    half = torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                       (e - 9).clamp(min=-134))
    return torch.where(x == 0, 2.0 ** -134, half)


def p_causes(pk, s, p32) -> dict:
    """Kernel B's P (``pk``, bf16) against the plain version's
    (bf16(``p32``), the f32 softmax of the plain bf16 scores ``s``): how
    many of ``n_p`` values differ (``differ``), sorted by cause.
    ``s``: the scores differ in the row: at some key, the score less the
    row's max (the plain max's key) implied by the kernel's P row (the
    ratio of two bf16 values, each within half a bf16 step of its exact
    value) excludes the plain one. ``p``: the row's scores agree and the
    plain f32 P lies within P_MIDPOINT of a bf16 rounding midpoint, so only
    P's arithmetic (exp, sum, quotient) rounds it apart. ``other``:
    neither. ``largest``: the largest P among the differing values."""
    pp = p32.to(torch.bfloat16)
    diff = pk != pp
    n = int(diff.sum())
    out = dict(n_p=pk.numel(), differ=n, s=0, p=0, other=0, largest=0.0)
    if not n:
        return out
    d = s.double() - s.double().amax(-1, keepdim=True)
    at = s.float().argmax(-1, keepdim=True)
    pkd, half = pk.double(), _bf16_half_ulp(pk)
    pm, half_m = pkd.gather(-1, at), half.gather(-1, at)
    lo = (pkd - half) / (pm + half_m) * (1 - P_SLACK)
    hi = (pkd + half) / (pm - half_m) * (1 + P_SLACK)
    ed = torch.exp(d)
    s_row = ((ed < lo) | (ed > hi)).any(-1, keepdim=True)
    bits = p32.view(torch.int32)
    mid = ((bits & -65536) | 32768).view(torch.float32)
    near = (p32 - mid).abs() <= P_MIDPOINT * p32
    by_s = diff & s_row
    by_p = diff & ~s_row & near
    out.update(s=int(by_s.sum()), p=int(by_p.sum()),
               other=n - int(by_s.sum()) - int(by_p.sum()),
               largest=torch.maximum(pk.float(), pp.float())[diff]
               .max().item())
    return out


def p_probe(q, k, key_bias=None, chunk: int = 32) -> dict:
    """p_causes of kernel B's P (kernel_probs, ``chunk`` batch rows a
    launch) against the plain version's: plain_softmax of the contiguous
    q, k over the whole batch, as the bf16 checks compute it (cuBLAS may
    sum q k^T in another order at another batch size, and round a score
    otherwise). The counts summed, ``largest`` the max."""
    s, p32 = plain_softmax(q.contiguous(), k.contiguous(), key_bias)
    total = dict(n_p=0, differ=0, s=0, p=0, other=0, largest=0.0)
    for b0 in range(0, q.shape[0], chunk):
        sl = slice(b0, b0 + chunk)
        pk = kernel_probs(q[sl], k[sl],
                          None if key_bias is None else key_bias[sl])
        for key, val in p_causes(pk, s[sl], p32[sl]).items():
            total[key] = max(total[key], val) if key == "largest" \
                else total[key] + val
        del pk
    return total


def grid_qk(b: int, t: int, h: int, dh: int, g, dev, top: int = 8) -> tuple:
    """bf16 q, k (B, H, T, dh) in projection order whose q k^T every f32
    order sums exactly: integers -top ... top (top <= 64) over 4, so each
    product is a multiple of 2^-4 of at most 256 and a sum over dh <= 192
    holds at most 21 bits. The kernel's scores and the plain version's are
    then the same bf16 values, and a P that differs comes from P's own
    arithmetic. At top = 64 a row's scores spread past 44, where exps fall
    below 2^-64 and underflow to 0."""
    return tuple((torch.randint(-top, top + 1, (b, t, h, dh), generator=g)
                  / 4).to(dev, torch.bfloat16).transpose(1, 2)
                 for _ in range(2))


def explain_worst(q, k, v, key_bias) -> dict:
    """Where kernel B's bf16 output is farthest from the plain version's:
    the element (b, h, i, c) and its error, and for each key j whose P
    differs in that row: the kernel's and the plain P, v[j, c], the plain
    score, q_i k_j in the plain bf16 einsum and exactly (f64), and the
    distance of the exact q_i k_j from the nearest bf16 rounding midpoint in
    bf16 steps (a product sum that close can round either way in two f32
    summation orders)."""
    got = attn.multi_head_attention(q, k, v, key_bias=key_bias).float()
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    err = (got - attn.attention_plain(qc, kc, vc, key_bias=key_bias)
           .float()).abs()
    b, h, i, c = (int(x) for x in np.unravel_index(int(err.argmax()),
                                                     err.shape))
    sl = slice(b, b + 1)
    pk = kernel_probs(q[sl], k[sl], key_bias[sl])[0, h, i]
    s, p32 = plain_softmax(qc, kc, key_bias)  # the whole batch, as the check
    s, pp = s[b, h, i], p32[b, h, i].to(torch.bfloat16)
    qk_plain = torch.einsum("bhqd,bhkd->bhqk", qc, kc)[b, h, i]
    qk_exact = kc[b, h].double() @ qc[b, h, i].double()
    keys = []
    for j in torch.nonzero(pk != pp).flatten().tolist():
        x = qk_exact[j].item()
        lo = torch.tensor(x, dtype=torch.float64).to(torch.bfloat16)
        step = _bf16_half_ulp(lo.abs().unsqueeze(0)).item() * 2
        mid = (math.floor(x / step) + 0.5) * step
        keys.append(dict(key=j, p_kernel=pk[j].item(), p_plain=pp[j].item(),
                         v=vc[b, h, j, c].item(), s_plain=s[j].item(),
                         qk_plain=qk_plain[j].item(), qk_exact=x,
                         steps_from_midpoint=abs(x - mid) / step))
    return dict(b=b, h=h, i=i, c=c, err=err[b, h, i, c].item(), keys=keys)


def probe_p(smi: str) -> dict:
    """``--kernel-b``'s P probe at every ToMe T (B = 256, H = 12, dh = 64,
    bf16, ToMe's key bias): p_probe on phase 5d's bf16 draws as
    ``--kernel-b`` makes them (tome_bias_draws from seed 7, bf16 alone), the
    differences by cause, and on grid_qk's draws (seed 8), where the scores
    agree exactly and every difference is P's own; beside each draw's
    worst output (explain_worst) its tie check against ATTN_BOUND (the
    near-tie set, each tie-accepted row's strict error, keys and ulps from
    the midpoint, and a rejected row, which phase_attention_bias fails
    on)."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    g_grid = torch.Generator().manual_seed(8)
    biases = _tome_sizes(BATCH, 197, TOME_R, 12, dev)
    out = {}
    for t, bias, q, k, v in tome_bias_draws(torch.bfloat16, g, biases, dev):
        row = p_probe(q, k, bias)
        worst = explain_worst(q, k, v, bias)
        if worst["err"] > ATTN_BOUND[torch.bfloat16]:
            row["worst"] = worst
            log(f"[B] P probe T={t}: the output farthest from the plain "
                f"version's, {worst['err']:.4g} at (b, h, i, c) = "
                f"{(worst['b'], worst['h'], worst['i'], worst['c'])}; its "
                f"row's differing P: {worst['keys']}")
        ties = bf16_tie_check(attn.multi_head_attention(q, k, v,
                                                        key_bias=bias),
                              q, k, v, bias, bound=ATTN_BOUND[torch.bfloat16])
        row["ties"] = dict(tie_summary(ties), rejected=ties["rejected"])
        log(f"[B] tie check T={t}: strict max|err| {ties['err']:.4g}; "
            f"{tie_text(ties)}" + ("" if ties["ok"] else
                                   f"; REJECTED {ties['rejected']}"))
        for tied in ties["accepted"]:
            log(f"[B]   T={t} accepted by a tie: {tie_row_text(tied)}")
        del q, k, v
        row["grid_differ"] = p_probe(*grid_qk(BATCH, t, 12, 64, g_grid, dev),
                                     bias)["differ"]
        out[f"T{t}"] = row
        log(f"[B] P probe B={BATCH} H=12 T={t} dh=64 bf16 + key bias: "
            f"{row['differ']} of {row['n_p']} P differ from the plain "
            f"version's (scores {row['s']}, P's rounding {row['p']}, other "
            f"{row['other']}; largest {row['largest']:.4g}); on exact "
            f"scores {row['grid_differ']} | {smi}")
    torch.cuda.empty_cache()
    return out


def measure_kernel_b(smi: str) -> dict:
    """``--kernel-b``: the rows of kernel B that its bf16 variants past one
    key tile and its launch path move, in one process, so that two
    checkouts run in turns in one chip call compare on one card: first the
    P probe (probe_p: the kernel's P against the plain version's on ToMe's
    bf16 draws, the differences by cause); bf16 at B = 256, H = 12, T = 197
    and 325, dh = 64, at B = 32, T = 1297, and at B = 32, T = 197, dh = 128
    and 80 (zero-padded to 96), each held to the bf16 plain version and
    timed beside SDPA and its bound; the T <= 25 rows (HOST_ROWS) with
    host microseconds a call (host_us), CUDA-event and device times
    (_device_ms) beside SDPA's, and at the first two the host steps
    (_host_steps); the bf16 forward at B = 512 by torch.profiler (B's
    share) and the bf16 engine's frames/s (_embed_rate); last ToMe's biased
    blocks in bf16 (phase 5d's rows), held to ATTN_BOUND by bf16_tie_check:
    a row beyond it that no near tie explains fails the run once every row
    is logged. Every bf16 row here goes through the tie check. Prints one
    JSON line {"kernel_b": ...}."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    for line in _ptxas_lines("attention.cu", "bf16"):
        log(f"[B] ptxas {line}")
    out = {"p_probe": probe_p(smi)}
    for b, h, t, dh in ((BATCH, 12, 197, 64), (BATCH, 12, 325, 64),
                        (32, 12, 1297, 64), (32, 6, 197, 128),
                        (32, 16, 197, 80)):
        q, k, v = (torch.randn(b, t, h, dh, generator=g).to(
            dev, torch.bfloat16).transpose(1, 2) for _ in range(3))
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        got, variant = b_variants(lambda: attn.multi_head_attention(q, k, v))
        bound_err = ATTN_BOUND[torch.bfloat16] if dh == 64 else \
            2 ** -8 * v.float().abs().max().item()
        errs = bf16_attention_errs(got, q, k, v, bound=bound_err)
        del got
        what = f"bf16 B={b} H={h} T={t} dh={dh}"
        text = check_bf16_attention(errs, what)
        row = dict(
            launched=variant, max_abs_err=errs["err"],
            **tie_summary(errs["ties"]),
            ms=cuda_ms(lambda: attn.multi_head_attention(qc, kc, vc)),
            ms_projection_order=cuda_ms(
                lambda: attn.multi_head_attention(q, k, v)),
            library_ms=cuda_ms(
                lambda: F.scaled_dot_product_attention(qc, kc, vc)),
            **bound(4 * q.numel() * 2, 4 * b * h * t * t * dh, "bf16"))
        log(f"[B] {what}: {variant} {row['ms']:.4f} ms (projection order "
            f"{row['ms_projection_order']:.4f}) | SDPA "
            f"{row['library_ms']:.4f} ms | {bound_text(row)} | {text} | "
            f"{smi}")
        out[f"B{b}_H{h}_T{t}_dh{dh}_bf16"] = row
        del q, k, v, qc, kc, vc
    torch.cuda.empty_cache()
    # where the held variant's occupancy falls: B = 16, bf16, by T
    sweep = {}
    for dh, h, ts in ((64, 12, (197, 325, 453, 581, 837, 1093, 1600)),
                      (96, 8, (197, 325, 581, 837, 1472)),
                      (128, 6, (197, 325, 581, 837, 1408)),
                      (192, 4, (130, 325, 581, 837, 1216))):
        for t in ts:
            q, k, v = (torch.randn(16, h, t, dh, generator=g).to(
                dev, torch.bfloat16) for _ in range(3))
            _, variant = b_variants(lambda: attn.multi_head_attention(q, k, v))
            ms = cuda_ms(lambda: attn.multi_head_attention(q, k, v), reps=3,
                         n=5)
            sweep[f"dh{dh}_T{t}"] = dict(launched=variant, ms=ms)
            log(f"[B] sweep bf16 B=16 H={h} T={t} dh={dh}: {variant} "
                f"{ms:.4f} ms | {smi}")
            del q, k, v
    out["sweep_B16"] = sweep
    for b, h, t, dh, dtype, what in HOST_ROWS:
        q, k, v = (torch.randn(b, t, h, dh, generator=g).to(
            dev, dtype).transpose(1, 2) for _ in range(3))
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        got, variant = b_variants(lambda: attn.multi_head_attention(q, k, v))
        if dtype == torch.float32:
            err = (got - attn.attention_plain(qc, kc, vc)).abs().max().item()
            if not err <= ATTN_BOUND[dtype]:
                raise AssertionError(f"attention {what}: max|err| {err}")
        else:
            errs = bf16_attention_errs(
                got, q, k, v, bound=2 ** -8 * vc.float().abs().max().item())
            err = errs["err"]
            check_bf16_attention(errs, what)

        def call():
            return attn.multi_head_attention(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(qc, kc, vc)

        row = dict(launched=variant, max_abs_err=err, host_us=host_us(call),
                   ms=cuda_ms(call), device_ms=_device_ms(call),
                   library_host_us=host_us(sdpa), library_ms=cuda_ms(sdpa),
                   library_device_ms=_device_ms(sdpa),
                   **bound(4 * q.numel() * q.element_size(),
                           4 * b * h * t * t * dh,
                           "f32" if dtype == torch.float32 else "bf16"))
        name = str(dtype).split(".")[-1]
        log(f"[B] {what}: B={b} H={h} T={t} dh={dh} {name} {variant}: host "
            f"{row['host_us']:.2f} us a call (SDPA "
            f"{row['library_host_us']:.2f})"
            f" | CUDA events {row['ms']:.4f} ms (SDPA {row['library_ms']:.4f})"
            f" | device {_ms(row['device_ms'])} ms (SDPA "
            f"{_ms(row['library_device_ms'])}) | max|err| {err:.3e} | {smi}")
        if (b, t) in ((1, 9), (8, 5)):
            row["host_steps_us"] = _host_steps(q, k, v)
            log(f"[B]   host us a call by step: " + "; ".join(
                f"{k2} {v2:.2f}" for k2, v2 in row["host_steps_us"].items()))
        out[f"B{b}_H{h}_T{t}_dh{dh}_{name}"] = row
        del q, k, v, qc, kc, vc, got
    prof = profile_forward(smi, "bfloat16", 512)
    b_ms = sum(ms for key, ms in prof["kernels_ms"].items()
               if "attn_bf16" in key)
    out["forward_bf16_B512"] = dict(busy_ms=prof["busy_ms"],
                                    wall_ms=prof["wall_ms"], attention_ms=b_ms,
                                    attention_share=b_ms / prof["busy_ms"])
    log(f"[B] bf16 forward B=512: {prof['busy_ms']:.2f} ms of kernels, B "
        f"{b_ms:.2f} ms ({100 * b_ms / prof['busy_ms']:.1f}%) | {smi}")
    rates = [_embed_rate("bfloat16", 512) for _ in range(2)]
    out["engine_bf16_B512_frames_per_s"] = rates
    log(f"[B] bf16 engine B=512: {rates[0]:.1f}, {rates[1]:.1f} frames/s | "
        f"{smi}")
    # last, since a row beyond the bound ends the run once all are logged
    out["tome_bias_bf16"] = phase_attention_bias(
        smi, dtypes=(torch.bfloat16,))["bfloat16"]
    print(json.dumps({"kernel_b": out}), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the forward and the Viterbi decoders "
                    "instead of the smoke phases")
    ap.add_argument("--kernel-b", action="store_true",
                    help="only kernel B's bf16 rows past one key tile and "
                    "its T <= 25 rows with host microseconds a call, the "
                    "bf16 forward and engine (measure_kernel_b)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not (args.profile or args.kernel_b):
        with tempfile.TemporaryDirectory(prefix="vrt_chip_smoke_") as root:
            return smoke(root)
    smi = phase_card()
    if args.profile:
        profile_forward(smi, "float32", BATCH)
        profile_forward(smi, "bfloat16", 512)
        profile_forward(smi, "float32", BATCH, top=24, tome_r=TOME_R,
                        gemm_quant="int8-static")
        time_viterbi(smi)
        for rate in (0.1, 0.0):
            profile_train_step(smi, rate)
        return 0
    measure_kernel_b(smi)
    return 0


def smoke(root: str) -> int:
    """The default run, its files under ``root``."""
    pre = {}
    worker = threading.Thread(target=_host_prework, args=(root, pre),
                              daemon=True)
    worker.start()
    try:
        smi = phase_card()
        pe_summary = phase_patch_embed(smi)
        attn_summary = phase_attention(smi)
        attn_stage1 = phase_attention_stage1(smi)
        attn_widths = phase_attention_widths(smi)
        grads = phase_kernel_grads(smi)
        attn_rag = phase_attention_rag(smi)
        ln_summary = phase_ln_matmul(smi)
    finally:
        worker.join()  # before root can go
    if "error" in pre:
        raise pre["error"]
    main_path = phase_main_path(smi, root, pre)
    backbone_ties = phase_backbone_ties(smi, main_path)
    store_launches = phase_store_path(smi, root, main_path)
    serve_path = phase_serve_path(smi, root, main_path)
    label_path = phase_label_path(smi, root, main_path)
    fast_path = phase_fast_path(smi, root, main_path)
    stage1 = phase_stage1_path(smi, root)
    rag = phase_rag_path(smi, root, main_path)
    stage2 = phase_stage2_path(smi, root, main_path)
    cached = phase_cached_path(smi, root)
    temporal = phase_temporal_path(smi, root, main_path)
    bf16_heads = phase_bf16_heads(smi, root)
    joint = phase_joint_path(smi)
    rag_vit = phase_rag_vit_path(smi)
    remat = phase_remat(smi)
    game = phase_game_store(smi)
    mesh = phase_mesh(smi, root, main_path, game)
    examples = phase_examples(smi, root, game)
    del game
    # each main path's launches, counted from 0 just before it ran; a
    # kernel's "launches" is their sum
    by_path = {"segment": main_path["launches"], "store": store_launches,
               "serve": serve_path["launches"],
               "follow": serve_path["follow_launches"],
               "label": label_path["launches"],
               "fast": fast_path["launches"],
               "stage1": stage1["launches"], "rag": rag["launches"],
               **stage2["launches_by_path"], "cached": cached["launches"],
               "temporal": temporal["launches"], "joint": joint["launches"],
               "rag_vit": rag_vit["launches"],
               "bf16": bf16_heads["launches"], "mesh": mesh["launches"],
               "examples": examples["launches"]}

    def launches(kernel: str) -> dict:
        per = {path: counts[kernel] for path, counts in by_path.items()}
        return dict(launches=sum(per.values()), launches_by_path=per)

    # kernel B's main-path launches by instantiation and variant
    # (ops/attention.py::kernel_name)
    b_by_path = {path: getattr(counts, "by_kernel", None)
                 for path, counts in by_path.items()}
    b_by_path["examples"] = examples["launches_by_kernel"]
    b_total = collections.Counter()
    for counts in b_by_path.values():
        b_total.update(counts or {})
    b_launches = dict(launches_by_kernel=dict(sorted(b_total.items())),
                      launches_by_kernel_by_path=b_by_path)
    log(f"[7] kernel B's main-path launches by variant: "
        f"{b_launches['launches_by_kernel']} ({sum(b_total.values())} of "
        f"{launches('attention')['launches']}; paths without a count: "
        f"{[p for p, c in b_by_path.items() if c is None]})")

    smoke_row = attn_summary.pop("smoke_t313")
    kernels = [
        dict(name="patch_embed", route="cuda",
             source="vit_research_tpu_torch/csrc/patch_embed.cu",
             replaces="vit_research_tpu/ops/patch_embed.py:65",
             **launches("patch_embed"),
             library_call="none; nearest F.conv2d over the normalised "
                          "NCHW batch in the output dtype (f32; bf16 under "
                          "\"bf16\")", **pe_summary,
             grad_rel_err=grads["patch_embed"]),
        dict(name="attention", route="cuda",
             source="vit_research_tpu_torch/csrc/attention.cu",
             replaces="vit_research_tpu/ops/attention.py:51",
             **launches("attention"), **b_launches,
             library_call="F.scaled_dot_product_attention", **attn_summary,
             key_bias=dict(fast_path["attention_key_bias"],
                           library_call="F.scaled_dot_product_attention "
                                        "with a float attn_mask (B, 1, 1, T)"),
             stage1_dh96=attn_stage1, backbone_ties=backbone_ties,
             grad_rel_err={k: v for k, v in grads.items()
                           if k.startswith("attention")},
             stage1_path={k: v for k, v in stage1.items()
                          if k != "launches"},
             rag_dh192=attn_rag["rows"],
             rag_grad_rel_err=attn_rag["grad_rel_err"],
             rag_path={k: v for k, v in rag.items() if k != "launches"},
             stage2_dh96=stage2["attention_dh96"],
             smoke_t313=smoke_row,
             stage2_path={k: v for k, v in stage2.items()
                          if k not in ("launches_by_path",
                                       "attention_dh96")},
             head_widths=attn_widths,
             **{f"{name}_path": {k: v for k, v in part.items()
                                 if k != "launches"}
                for name, part in (("cached", cached),
                                   ("temporal", temporal),
                                   ("joint", joint), ("rag_vit", rag_vit),
                                   ("bf16", bf16_heads), ("mesh", mesh),
                                   ("examples", examples))},
             remat=remat),
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
