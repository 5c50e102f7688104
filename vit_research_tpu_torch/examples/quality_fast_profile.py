"""Quality dossier for the fast (non-parity) embedding profile.

Port of examples/quality_fast_profile.py. The fast profile's levers
(ToMe token merging, static int8 encoder GEMMs, strided embedding with
novelty-gated refinement, and their composites) are measured on a
synthetic world against four downstream metrics of this pipeline:

  fidelity      per-frame cosine vs the parity embedding (both L2)
  segmentation  kNN+HMM clip F1 + boundary drift (frames) vs manual
                truth: corpus and queries from the variant (the
                homogeneous fast deployment)
  retrieval     top-k id overlap vs parity queries against a
                parity-built chunk store (the train-at-parity /
                serve-fast deployment) through the trained stage-1
                encoder
  events        hit@1 / hit@3 + center error of stage-2 event
                localization (evaluate/event_scoring) with a stack
                trained once at parity, scoring live clips through the
                variant embeddings: the `segment --score-events`
                deployment

The world (``build_world``) writes the JAX builder's bytes for the same
arguments: possessions as data/synthetic.py draws them (side-dependent
brightness and tint) plus a visual event, a 6-frame "shot" span each
possession marked with a label-dependent block (make: top, miss:
bottom). One JSON line per variant goes to ``--out`` (the JAX keys), and
a summary line, ``"metric": "quality_fast_profile"``, is the last line of
standard output.

    python -m vit_research_tpu_torch.examples.quality_fast_profile \\
        --out rows.jsonl
    python -m vit_research_tpu_torch.examples.quality_fast_profile \\
        --tiny --device cpu --possessions 2 --frames-per 16 \\
        --stage2-epochs 2

The default runs the seeded ViT-B/16 @224 on the card (112 x 112 world
frames, resized by the engine), the stage-1 ChunkEncoder at 768 wide (8
heads: kernel B at dh = 96) and ToMe's attention through B's key bias;
``--tiny`` the 2-layer 64-wide test ViT with the ToMe radii shrunk.
int8-static scales are calibrated through the engine's own forward on
representative world frames (as the port's ``calibrate-int8``).

Statistical power: the default 4 possessions a game score only 4 event
clips (hit@k quanta of 0.25). The reference configuration is
``--possessions 24`` with ``--only`` cut to the deployment variants:
24 scored clips, hit@k quanta of 1/24.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.examples import _engines


def mark(msg: str) -> None:
    print(f"[quality] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------- world


def _frame(vid, fnum, side, event, size, rng, entropy="low"):
    from vit_research_tpu_torch.data.synthetic import synth_frame

    img = synth_frame(vid, fnum, side, size, rng).astype(np.int32)
    if entropy == "high":
        # Adversarial content for token merging: full-range iid pixel
        # noise blended 50% makes every 16x16 patch token distinct, so
        # ToMe cannot find redundant tokens and must merge dissimilar
        # ones. The default world's large uniform regions are ToMe's best
        # case; measuring both brackets real footage.
        noise = rng.integers(0, 256, size=img.shape)
        img = (img + noise) // 2
    if event is not None:  # label-dependent marker: make=top, miss=bottom
        h, w = size
        bh, bw = max(h // 4, 4), max(w // 4, 4)
        r0 = 0 if event else h - bh
        c0 = (w - bw) // 2
        img[r0:r0 + bh, c0:c0 + bw] = 245
    return np.minimum(img, 255).astype(np.uint8)


def build_world(root, vids=(1, 2), possessions=4, frames_per=32, gap=6,
                lead=4, event_start=18, event_len=6, size=(112, 112),
                entropy="low"):
    """Frames dirs + clip dirs + labels + event template + manual truth.

    Each vid: ``lead`` none frames, then ``possessions`` alternating
    left/right runs of ``frames_per`` frames separated by ``gap`` none
    frames, then ``lead`` none frames. Possession p carries label p%2
    (1=make) and a visual event on frames [event_start, event_start +
    event_len) of the possession."""
    from PIL import Image

    from vit_research_tpu_torch.data import labels as labels_mod
    from vit_research_tpu_torch.data import naming

    world = {"frames": {}, "clip_labels": {}, "events": {},
             "clip_ranges": {}, "manual": labels_mod.ManualIntervals()}
    for vid in vids:
        fdir = os.path.join(root, f"frames_{vid}")
        os.makedirs(fdir, exist_ok=True)
        rng = np.random.default_rng(vid)
        paths, fnum = [], 1

        def emit(side, n, event_span=None, label=None):
            nonlocal fnum
            first = fnum
            for i in range(n):
                ev = (label == 1 if event_span is not None
                      and event_span[0] <= i < event_span[1] else None)
                img = _frame(vid, fnum, side, ev, size, rng,
                             entropy=entropy)
                p = os.path.join(fdir, naming.frame_name(vid, fnum))
                Image.fromarray(img).save(p, quality=90)
                paths.append(p)
                fnum += 1
            world["manual"].intervals[side].append((vid, first, fnum - 1))
            return first

        emit("none", lead)
        for p in range(possessions):
            side = ("left", "right")[p % 2]
            label = p % 2  # alternate make/miss like make_mini_dataset
            first = emit(side, frames_per,
                         event_span=(event_start, event_start + event_len),
                         label=label)
            # clip dir: the same frames linked under the clip name
            croot = os.path.join(root, f"clips_hmm_smooth_{vid}_smart")
            cdir = os.path.join(croot, naming.clip_dir_name(vid, p, side))
            os.makedirs(cdir, exist_ok=True)
            for k in range(frames_per):
                os.link(paths[first - 1 + k],
                        os.path.join(cdir, naming.frame_name(vid,
                                                             first + k)))
            world["clip_labels"][cdir] = label
            ev0 = first + event_start
            key = "event_make" if label == 1 else "event_miss"
            world["events"][cdir] = {
                "event_make": [], "event_miss": [], "event_none": [],
                key: [[ev0, ev0 + event_len - 1]]}
            world["clip_ranges"][(vid, p)] = (first, side,
                                              paths[first - 1:
                                                    first - 1 + frames_per])
            if p < possessions - 1:
                emit("none", gap)
        emit("none", lead)
        world["frames"][vid] = paths
    world["clip_template"] = os.path.join(root, "clips_hmm_smooth_{vid}_smart")
    return world


# ------------------------------------------------------------- variants


def build_engine(tome_r: int, *, tiny: bool, device, batch_size: int = 16,
                 quant: str | None = None, calib_paths=()):
    """The variant's engine on ``device``. ``quant='int8-static'``
    calibrates here on representative world frames (``calib_paths``) and
    bakes the scales: calibration coverage matters (random-pixel
    calibration gives markedly lower fidelity on structured frames)."""
    tiny_cfg = _engines.tiny_vit(64, 2) if tiny else None
    scales = ()
    if quant == "int8-static":
        scales = _calibrate(tome_r, tiny_cfg, device, calib_paths)
    return _engines.build_engine(device, tiny=tiny_cfg,
                                 batch_size=batch_size, tome_r=tome_r,
                                 gemm_quant=quant, gemm_quant_scales=scales)


def _calibrate(tome_r, tiny_cfg, device, calib_paths) -> tuple:
    """One calibration forward of the engine on representative frames
    -> the static scales, one a dense call site."""
    from vit_research_tpu_torch.data.preprocess import load_frames
    from vit_research_tpu_torch.ops.quant import calibration_mode

    if not calib_paths:
        raise ValueError("int8-static calibration needs representative "
                         "frames (calib_paths)")
    eng = _engines.build_engine(device, tiny=tiny_cfg,
                                batch_size=len(calib_paths), tome_r=tome_r,
                                gemm_quant="int8-static")
    imgs = load_frames(list(calib_paths), eng.spec)
    mark(f"calibrating int8-static scales (tome_r={tome_r}, "
         f"{len(imgs)} representative frames, {eng.device} forward)")
    with calibration_mode() as scales:
        eng.embed_batch(imgs)
    return tuple(scales)


def variant_defs(tiny: bool):
    """(name, tome_r, stride, quant, refine): the tome radii shrink in
    --tiny mode (the 2-layer 17-token test ViT can't merge 16 a layer);
    refine='auto' is the novelty-gated strided refinement
    (embed_video_strided's refine_threshold)."""
    if tiny:
        return [("parity", 0, 1, None, None), ("tome2", 2, 1, None, None),
                ("strided2", 0, 2, None, None),
                ("strided2_refined", 0, 2, None, "auto"),
                ("tome2_strided2", 2, 2, None, None),
                ("int8static", 0, 1, "int8-static", None)]
    return [("parity", 0, 1, None, None), ("tome8", 8, 1, None, None),
            ("tome13", 13, 1, None, None), ("tome16", 16, 1, None, None),
            ("strided4", 0, 4, None, None),
            ("strided4_refined", 0, 4, None, "auto"),
            ("tome16_strided4", 16, 4, None, None),
            ("int8static", 0, 1, "int8-static", None),
            ("tome16_int8static", 16, 1, "int8-static", None),
            ("tome16_int8static_strided4", 16, 4, "int8-static", None),
            ("tome16_int8static_strided4r", 16, 4, "int8-static", "auto")]


def embed_variant(engines, tome_r, stride, quant, paths, refine=None,
                  stats=None):
    from vit_research_tpu_torch.parallel.embed import (
        REFINE_THRESHOLD_DEFAULT, embed_video_strided)

    eng = engines[(tome_r, quant)]
    if stride == 1:
        return np.asarray(eng.embed_paths(paths), np.float32)
    thresh = REFINE_THRESHOLD_DEFAULT if refine == "auto" else refine
    return np.asarray(
        embed_video_strided(eng, paths, stride=stride,
                            refine_threshold=thresh, stats=stats),
        np.float32)


# -------------------------------------------------------------- metrics


def _matched_pairs(pred, true, iou=0.5):
    from vit_research_tpu_torch.segment.tune import _iou

    pairs = sorted(((_iou(p, t), i, j) for i, p in enumerate(pred)
                    for j, t in enumerate(true) if p.side == t.side),
                   key=lambda x: -x[0])
    used_p, used_t, out = set(), set(), []
    for score, i, j in pairs:
        if score < iou:
            break
        if i in used_p or j in used_t:
            continue
        used_p.add(i)
        used_t.add(j)
        out.append((pred[i], true[j]))
    return out


def segmentation_metrics(world, embs_by_vid, train_vid, eval_vid, *, k=15,
                         min_len=16, device="cuda"):
    """Homogeneous fast deployment: corpus (labels from manual truth of
    ``train_vid``) and queries both from the variant's embeddings. The
    kNN + HMM runs on ``device`` (the card by default: raises without
    one, like every entry point)."""
    from vit_research_tpu_torch.segment.clips import decoded_runs
    from vit_research_tpu_torch.segment.hmm import STATES
    from vit_research_tpu_torch.segment.pipeline import segment_with_knn_hmm
    from vit_research_tpu_torch.segment.tune import (interval_prf,
                                                     truth_intervals,
                                                     truth_states)

    names = {v: [os.path.basename(p) for p in world["frames"][v]]
             for v in (train_vid, eval_vid)}
    t_train = truth_states(world["manual"], names[train_vid])
    labeled = t_train >= 0
    probs = np.full((int(labeled.sum()), 3), 0.05, np.float32)
    probs[np.arange(len(probs)), t_train[labeled]] = 0.9
    corpus = {"embeddings": embs_by_vid[train_vid][labeled],
              "labels": t_train[labeled], "probs": probs}
    decoded, _, _ = segment_with_knn_hmm(
        names[eval_vid], embs_by_vid[eval_vid], corpus, k=k,
        metric="cosine", device=resolve_device(device))
    pred = [r for r in decoded_runs(decoded)
            if r.side in ("left", "right") and r.end - r.start + 1 >= min_len]
    t_eval = truth_states(world["manual"], names[eval_vid])
    true = truth_intervals(t_eval)
    prf = interval_prf(pred, true)
    acc = float((np.array([STATES.index(d) if d in STATES else -2
                           for d in decoded]) == t_eval)[t_eval >= 0].mean())
    pairs = _matched_pairs(pred, true)
    drift = (float(np.mean([(abs(p.start - t.start) + abs(p.end - t.end)) / 2
                            for p, t in pairs])) if pairs else None)
    return {"clip_f1": round(prf["f1"], 3),
            "clip_precision": round(prf["precision"], 3),
            "clip_recall": round(prf["recall"], 3),
            "frame_accuracy": round(acc, 3),
            "boundary_drift_frames": (None if drift is None
                                      else round(drift, 1)),
            "n_pred": prf["n_pred"], "n_true": prf["n_true"]}


def chunk_embs(chunks, frame_emb_lookup, encode_batch):
    """(N, D) trained-stage-1 chunk embeddings from per-frame lookups."""
    gathered = np.stack([
        np.stack([frame_emb_lookup[os.path.basename(p)] for p in ch["frames"]])
        for ch in chunks])
    emb, _ = encode_batch(gathered)
    emb = np.asarray(emb, np.float32)
    return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)


def retrieval_overlap(store_embs, parity_q, variant_q, *, top_k=8):
    """Mean fraction of shared ids in top-k between parity and variant
    queries against the same (parity-built) store."""
    def topk_ids(q):
        scores = q @ store_embs.T
        return np.argsort(-scores, axis=1)[:, :top_k]

    a, b = topk_ids(parity_q), topk_ids(variant_q)
    return float(np.mean([len(set(r1) & set(r2)) / top_k
                          for r1, r2 in zip(a, b)]))


# --------------------------------------------------------------- stages


def train_stage1(train_chunks, lookup, *, dim, cs, epochs, device):
    """The stage-1 ChunkEncoder trained at parity on the whole training
    set a step (label smoothing, the 0.5 scale, dropout on), as the
    JAX dossier does; returns the frozen encoder as ``encode_batch``."""
    from vit_research_tpu_torch.models.heads import ChunkEncoder
    from vit_research_tpu_torch.models.vit import set_dropout_generator
    from vit_research_tpu_torch.train import losses
    from vit_research_tpu_torch.train.common import dropout_generator
    from vit_research_tpu_torch.train.train_chunk_encoder import (
        make_encode_fn, stage1_optimizer)
    from vit_research_tpu_torch.utils.configs import ChunkEncoderConfig

    enc = ChunkEncoder(ChunkEncoderConfig(embed_dim=dim, mlp_dim=4 * dim,
                                          max_len=cs),
                       generator=torch.Generator().manual_seed(0)).to(device)
    params = list(enc.parameters())
    opt = stage1_optimizer(params, 5e-4)
    x = torch.from_numpy(np.stack([
        np.stack([lookup[os.path.basename(p)] for p in ch["frames"]])
        for ch in train_chunks])).to(device)
    y = torch.tensor([float(ch["label"]) for ch in train_chunks],
                     dtype=torch.float32, device=device)
    enc.train()
    for epoch in range(epochs):
        set_dropout_generator(enc, dropout_generator(0, epoch, device))
        _, logits = enc(x)
        loss = 0.5 * losses.bce_with_logits(y * 0.9 + 0.05, logits)
        opt.step(torch.autograd.grad(loss, params))
    set_dropout_generator(enc, None)
    acc = float(losses.compute_accuracy(y, logits.detach()))
    mark(f"stage-1 final train acc {acc:.2f}")
    return make_encode_fn(enc)


# ------------------------------------------------------------------ main


def main(argv=None) -> dict:
    """Measure every variant; returns the rows, the summary line and the
    JSONL path."""
    ap = _engines.parser(__doc__)
    ap.add_argument("--out", default=None,
                    help="JSONL results path (appended; default "
                         "quality_fast_profile.jsonl under --root)")
    ap.add_argument("--root", default=None)
    ap.add_argument("--possessions", type=int, default=4)
    ap.add_argument("--frames-per", type=int, default=32)
    ap.add_argument("--stage2-epochs", type=int, default=8)
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names to measure "
                         "(parity is always included as the baseline)")
    ap.add_argument("--world-entropy", choices=["low", "high"],
                    default="low",
                    help="'high' blends full-range iid pixel noise into "
                         "every frame: adversarial for token merging "
                         "(every patch token distinct); 'low' is the "
                         "default block-structured world (ToMe's best "
                         "case). Measure both to bracket real footage.")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from vit_research_tpu_torch.data.chunks import build_chunks
    from vit_research_tpu_torch.data.samples import load_samples
    from vit_research_tpu_torch.evaluate.event_scoring import (
        min_event_span, score_event_localization, truth_events_by_clip)
    from vit_research_tpu_torch.evaluate.live import LiveEventScorer
    from vit_research_tpu_torch.retrieval import cache_stage2 as CS
    from vit_research_tpu_torch.store.vector_store import PersistentClient
    from vit_research_tpu_torch.train.train_stage2 import train_stage2
    from vit_research_tpu_torch.utils.configs import (ExperimentConfig,
                                                      HeadConfig,
                                                      RetrievalConfig,
                                                      TrainConfig)

    root = args.root or tempfile.mkdtemp(prefix="vrt_quality_")
    t_start = time.monotonic()
    size = (32, 32) if args.tiny else (112, 112)
    cs, cstride = (6, 3) if args.tiny else (8, 4)
    ks, kc, kt = 3, 3, 2
    event_start = 2 if args.tiny else 18
    mark(f"building world under {root}")
    world = build_world(root, possessions=args.possessions,
                        frames_per=args.frames_per, size=size,
                        event_start=event_start,
                        event_len=(3 if args.tiny else 6),
                        entropy=args.world_entropy)

    samples = load_samples([1, 2], world["clip_template"],
                           world["clip_labels"], world["events"])
    chunks = build_chunks(samples, chunk_size=cs, chunk_stride=cstride)
    train_chunks = [c for c in chunks if c["vid"] == 1]
    eval_chunks = [c for c in chunks if c["vid"] == 2]
    mark(f"{len(train_chunks)} train / {len(eval_chunks)} eval chunks")

    defs = variant_defs(args.tiny)
    if args.only:
        want = {v.strip() for v in args.only.split(",")} | {"parity"}
        known = {d[0] for d in defs}
        unknown = want - known
        if unknown:
            raise SystemExit(
                f"--only: unknown variant(s) {sorted(unknown)} "
                f"(have: {sorted(known)})")
        defs = [d for d in defs if d[0] in want]
    # Sub-stride event guard (mirrors cli segment --event-template): a
    # variant whose stride exceeds the shortest labeled event cannot
    # localize it, by interpolation or refinement, so its event rows
    # would be structurally, not statistically, degraded.
    span = min_event_span(world["events"])
    for name, _r, stride, _q, _refine in defs:
        if span is not None and stride > span:
            mark(f"WARNING: variant {name} stride {stride} exceeds the "
                 f"shortest labeled event ({span} frames): sub-stride "
                 "events are invisible (deployment rule: stride <= "
                 "shortest event)")
    # Calibration frames: per vid-1 possession, its first frame (side
    # signal) and a mid-event frame (the marker block), the two
    # activation regimes scoring will see; vid 2 stays held out.
    calib_paths = []
    for (vid, _clip), (_first, _side, cpaths) in sorted(
            world["clip_ranges"].items()):
        if vid != 1:
            continue
        mid_event = min(event_start + 2, len(cpaths) - 1)
        calib_paths += [cpaths[0], cpaths[mid_event]]
    engines = {}
    for _, r, _, q, _ in defs:
        if (r, q) not in engines:
            engines[(r, q)] = build_engine(r, tiny=args.tiny, device=dev,
                                           quant=q, calib_paths=calib_paths)
    dim = engines[(0, None)].out_dim

    # ---- per-variant frame embeddings (both vids)
    embs, refine_stats = {}, {}
    for name, r, stride, q, refine in defs:
        t0 = time.monotonic()
        st = {1: {}, 2: {}}
        embs[name] = {v: embed_variant(engines, r, stride, q,
                                       world["frames"][v], refine=refine,
                                       stats=st[v]) for v in (1, 2)}
        if refine is not None:
            refine_stats[name] = {
                key: st[1].get(key, 0) + st[2].get(key, 0)
                for key in ("gaps", "keys", "refined_gaps",
                            "refined_frames")}
        mark(f"embedded {name} in {time.monotonic() - t0:.1f}s"
             + (f" (refine: {refine_stats[name]})"
                if refine is not None else ""))
    lookup = {name: {os.path.basename(p): embs[name][v][i]
                     for v in (1, 2)
                     for i, p in enumerate(world["frames"][v])}
              for name, _, _, _, _ in defs}

    # ---- train once at parity: stage-1 encoder, ratt store, stage-2 head
    mark("training stage-1 ChunkEncoder at parity")
    encode_batch = train_stage1(train_chunks, lookup["parity"], dim=dim,
                                cs=cs, epochs=8 if args.tiny else 30,
                                device=dev)

    # ratt-db-schema collection from parity train chunks (the train-time
    # store the fast profile queries against)
    client = PersistentClient(os.path.join(root, "db"), autoflush=False,
                              device=dev)
    col = client.get_or_create_collection(
        "ratt_db", metadata={"hnsw:space": "cosine"})
    store_embs = chunk_embs(train_chunks, lookup["parity"], encode_batch)
    ids, metas = [], []
    for i, ch in enumerate(train_chunks):
        ids.append(f"chunk_{i}")
        metas.append({"vid_num": int(ch["vid"]), "clip_num": int(ch["clip"]),
                      "side": ch["side"], "label": int(ch["label"]),
                      "t_center": float(ch["t_center"]),
                      "t_width": float(ch["t_width"]),
                      "start_idx": int(ch["start_idx"]),
                      "end_idx": int(ch["end_idx"])})
    col.upsert(ids, store_embs, metadatas=metas)

    mark("building stage-2 cache + training RATTHeadV2 at parity")
    chunk_emb_map = {CS.make_chunk_key(ch): e
                     for ch, e in zip(train_chunks, store_embs)}

    def encode_chunk(ch):
        k2 = CS.make_chunk_key(ch)
        if k2 in chunk_emb_map:
            return chunk_emb_map[k2]
        return chunk_embs([ch], lookup["parity"], encode_batch)[0]

    cache = CS.build_stage2_cache(
        train_chunks, encode_chunk, col, k_sim=ks, k_contrast=kc,
        k_temporal=kt, future_step=1, search_k_content=16,
        search_k_temporal=8)
    cfg = ExperimentConfig(
        name="quality",
        head=HeadConfig(embed_dim=dim, k_sim=ks, k_contrast=kc,
                        k_temporal=kt),
        train=TrainConfig(num_epochs=args.stage2_epochs, batch_size=8,
                          chunk_size=cs, chunk_stride=cstride),
        retrieval=RetrievalConfig(collection="ratt_db", top_k=ks))
    head, hist = train_stage2(train_chunks, train_chunks, cache, cfg=cfg,
                              device=dev)
    mark(f"stage-2 final val acc {hist[-1].get('val_acc', 0):.2f}")
    head.eval()

    @torch.no_grad()
    def head_apply(q, s, c, tm):
        return head(*(torch.as_tensor(np.asarray(x, np.float32)).to(dev)
                      for x in (q, s, c, tm)))[0]

    truth = truth_events_by_clip(world["events"])
    out_path = args.out or os.path.join(root, "quality_fast_profile.jsonl")
    n_total = sum(len(world["frames"][v]) for v in (1, 2))
    rows_out = []
    parity_q = None
    for name, r, stride, q, refine in defs:
        t0 = time.monotonic()
        row = {"variant": name, "tome_r": r, "stride": stride,
               "gemm_quant": q, "world_entropy": args.world_entropy}
        if q:
            row["calibration"] = "representative-frames"
        if refine is not None:
            row["stride_refine"] = refine
            rs = refine_stats.get(name, {})
            row["refined_frame_frac"] = round(
                rs.get("refined_frames", 0) / max(n_total, 1), 3)
            row.update({f"refine_{k}": v for k, v in rs.items()})
            # exact forwards paid / total frames: per-video keyframe
            # counts summed plus refined interiors (the throughput story)
            row["exact_embed_frac"] = round(
                (rs.get("keys", 0) + rs.get("refined_frames", 0))
                / max(n_total, 1), 3)
        # fidelity vs parity
        cos = np.sum(embs[name][2] * embs["parity"][2], axis=1)
        row["fidelity_cos_mean"] = round(float(cos.mean()), 4)
        row["fidelity_cos_p5"] = round(float(np.percentile(cos, 5)), 4)
        # segmentation (homogeneous variant corpus + queries)
        row.update(segmentation_metrics(
            world, embs[name], 1, 2, min_len=(4 if args.tiny else 16),
            device=dev))
        # retrieval overlap (parity store, trained stage-1 encoder)
        var_q = chunk_embs(eval_chunks, lookup[name], encode_batch)
        if parity_q is None:
            parity_q = var_q  # defs[0] is parity
        row["retrieval_top8_overlap"] = round(
            retrieval_overlap(store_embs, parity_q, var_q), 3)
        # event localization through the parity-trained stack
        scorer = LiveEventScorer(
            lambda paths, _n=name: np.stack(
                [lookup[_n][os.path.basename(p)] for p in paths]),
            encode_batch, head_apply, col, chunk_size=cs,
            chunk_stride=cstride, k_sim=ks, k_contrast=kc, k_temporal=kt,
            future_step=1)
        ev_rows = []
        for (vid, clip), (_first, side, paths) in sorted(
                world["clip_ranges"].items()):
            if vid != 2:
                continue
            ev_rows.append(scorer.score_clip(paths, side=side,
                                             clip_num=clip, vid=vid))
        ev = score_event_localization(
            [r_ for r_ in ev_rows if r_ is not None], truth)
        h1, h3 = ev["hit_at"].get("1"), ev["hit_at"].get("3")
        row["event_hit@1"] = None if h1 is None else round(h1, 3)
        row["event_hit@3"] = None if h3 is None else round(h3, 3)
        ce = ev.get("center_error_mean")
        row["event_center_err"] = None if ce is None else round(ce, 1)
        row["scored_clips"] = ev.get("clips_scored")
        row["metric_wall_s"] = round(time.monotonic() - t0, 1)
        rows_out.append(row)
        mark(json.dumps(row))
    with open(out_path, "a") as f:
        for row in rows_out:
            f.write(json.dumps(row) + "\n")
    summary = {
        "metric": "quality_fast_profile",
        "variants": {r["variant"]: {
            "clip_f1": r["clip_f1"],
            "boundary_drift": r["boundary_drift_frames"],
            "retrieval_top8_overlap": r["retrieval_top8_overlap"],
            "event_hit@1": r["event_hit@1"],
            "fidelity": r["fidelity_cos_mean"]} for r in rows_out},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "wall_s": round(time.monotonic() - t_start, 1),
        "out": os.path.abspath(out_path)}
    print(json.dumps(summary), flush=True)
    return {"rows": rows_out, "summary": summary, "out": out_path}


if __name__ == "__main__":
    main(sys.argv[1:])
