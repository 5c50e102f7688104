"""Shared CLI plumbing: engine construction, the embedding-profile fence,
world loading and argument groups.

Port of the helpers of vit_research_tpu/cli/common.py that the port's
verbs use. Collections and frame stores are stamped with the reference's
profile string prefixed by ``torch|``: the port's seeded weights span
another embedding space than the JAX package's, so the fence
(``Collection.stamp_embedding_profile``) refuses to write one package's
embeddings into a collection built by the other, and reads across the
two warn.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

PROFILE_PREFIX = "torch|"
#: the backbones ``VRT_BACKBONE`` selects (unset: the first)
BACKBONES = ("vit-b16-224", "siglip-so400m-p14-384")


def backbone() -> str:
    """The backbone of ``VRT_BACKBONE``: ``vit-b16-224`` (the default,
    ViT-B/16 at 224, 768-wide embeddings) or ``siglip-so400m-p14-384``
    (SigLIP's vision tower, 1,152-wide)."""
    name = os.environ.get("VRT_BACKBONE", "").strip() or BACKBONES[0]
    if name not in BACKBONES:
        raise SystemExit(f"VRT_BACKBONE must be one of "
                         f"{', '.join(BACKBONES)}, got {name!r}")
    return name


def _engine_env(require_scales: bool = True) -> dict:
    """Parse the embedding env toggles once for every consumer (the
    engine, calibrate-int8, engine_profile): tome_r (int,
    ``VRT_TOME_R``), gemm_quant (``VRT_GEMM_QUANT``), gemm_scales (read
    and checked from the JSON file ``VRT_GEMM_SCALES`` when gemm_quant is
    ``int8-static``), grayscale (``VRT_GRAYSCALE``).
    ``require_scales=False`` skips the scales file: calibrate-int8 runs
    before it exists (it writes it)."""
    raw_tome = os.environ.get("VRT_TOME_R", "").strip()
    try:
        tome_r = int(raw_tome) if raw_tome else 0
    except ValueError:
        raise SystemExit(
            f"VRT_TOME_R must be an integer, got {raw_tome!r}")
    gemm_quant = os.environ.get("VRT_GEMM_QUANT", "").strip() or None
    if gemm_quant not in (None, "int8", "int8-static"):
        raise SystemExit(
            f"VRT_GEMM_QUANT must be 'int8', 'int8-static' or unset, "
            f"got {gemm_quant!r}")
    gemm_scales: tuple = ()
    if gemm_quant == "int8-static" and require_scales:
        # static scales come from an offline calibration (calibrate-int8);
        # the engine never calibrates on whatever batch comes first
        scales_path = os.environ.get("VRT_GEMM_SCALES", "").strip()
        if not scales_path:
            raise SystemExit(
                "VRT_GEMM_QUANT=int8-static needs VRT_GEMM_SCALES="
                "<scales.json> (produce it with cli calibrate-int8)")
        try:
            with open(scales_path) as f:
                loaded = json.load(f)
        except (OSError, ValueError) as e:
            raise SystemExit(f"VRT_GEMM_SCALES {scales_path!r}: {e}")
        raw_scales = (loaded.get("scales")
                      if isinstance(loaded, dict) else loaded)
        try:
            gemm_scales = tuple(float(s) for s in raw_scales)
        except (TypeError, ValueError):
            raise SystemExit(
                f"VRT_GEMM_SCALES {scales_path!r} must hold a list of "
                "floats (or an object with a 'scales' list)")
        if not gemm_scales:
            raise SystemExit(f"VRT_GEMM_SCALES {scales_path!r} is empty")
    grayscale = os.environ.get("VRT_GRAYSCALE", "").strip() not in ("", "0")
    return {"tome_r": tome_r, "gemm_quant": gemm_quant,
            "gemm_scales": gemm_scales, "grayscale": grayscale}


def _tiny_vit_config(env: dict):
    """The one tiny test-ViT configuration (``VRT_TINY``), the
    reference's, shared by the engine and calibrate-int8."""
    from vit_research_tpu_torch.utils.configs import ViTConfig

    return ViTConfig(image_size=(32, 32), patch_size=8, hidden_size=32,
                     num_layers=1, num_heads=2, mlp_dim=64,
                     use_flash_attention=False, tome_r=env["tome_r"],
                     gemm_quant=env["gemm_quant"],
                     gemm_quant_scales=env["gemm_scales"])


def _engine(batch_size: int, device):
    """The frame embedder for the current env on ``device``: the
    ViT-B/16 @224 engine, SigLIP so400m/14 @384's under
    ``VRT_BACKBONE=siglip-so400m-p14-384`` (parity f32 only: the fast
    profile's toggles are refused there), or the tiny test ViT under
    ``VRT_TINY=1``.
    ``VRT_TOME_R=<r>`` merges r tokens a layer (ops/tome.py),
    ``VRT_GEMM_QUANT=int8`` runs the encoder GEMMs in dynamic int8 and
    ``int8-static`` with the scales of ``VRT_GEMM_SCALES``
    (ops/quant.py); they compose. Every embedding a pipeline compares
    must come from the same settings (engine_profile fences them)."""
    from vit_research_tpu_torch.data.preprocess import PreprocessSpec
    from vit_research_tpu_torch.models.vit import init_vit
    from vit_research_tpu_torch.parallel.embed import (
        EmbeddingEngine, make_hf_frame_embedder, make_siglip_frame_embedder)

    env = _engine_env()
    name = backbone()
    if os.environ.get("VRT_TINY"):
        model = init_vit(_tiny_vit_config(env), seed=0, device="cpu")
        return EmbeddingEngine(
            model, PreprocessSpec(size=(32, 32), grayscale=env["grayscale"]),
            device=device, batch_size=min(batch_size, 16))
    if name == "siglip-so400m-p14-384":
        if env["tome_r"] or env["gemm_quant"]:
            raise SystemExit("VRT_BACKBONE=siglip-so400m-p14-384 runs the "
                             "f32 parity path: unset VRT_TOME_R and "
                             "VRT_GEMM_QUANT")
        return make_siglip_frame_embedder(device=device,
                                          batch_size=batch_size,
                                          grayscale=env["grayscale"])
    return make_hf_frame_embedder(device=device, batch_size=batch_size,
                                  grayscale=env["grayscale"],
                                  tome_r=env["tome_r"],
                                  gemm_quant=env["gemm_quant"],
                                  gemm_quant_scales=env["gemm_scales"])


def engine_profile() -> str:
    """Canonical string for the current embedding settings, ``torch|`` +
    the reference's (e.g. ``torch|tome0|quant-none|gray0``): collections
    and frame stores stamp it at write time and read-side commands warn
    when querying across profiles. A backbone other than the default
    stamps its name after the prefix (``torch|siglip-so400m-p14-384|...``;
    not under ``VRT_TINY``, whose engine is the tiny ViT whatever the
    backbone), so 1,152- and 768-wide embeddings never share a collection
    unannounced; the default's profile is the reference's."""
    env = _engine_env()
    name = backbone()
    quant = env["gemm_quant"] or "none"
    if env["gemm_quant"] == "int8-static":
        # two calibrations are two embedding spaces: the scale values go
        # into the profile, so the fence sees them
        digest = hashlib.sha256(
            ",".join(f"{s:.9e}" for s in env["gemm_scales"])
            .encode()).hexdigest()[:8]
        quant = f"int8-static:{digest}"
    gray = "1" if env["grayscale"] else "0"
    tiny = "tiny|" if os.environ.get("VRT_TINY") else ""
    # the tiny test ViT is the engine under VRT_TINY, whatever the backbone
    net = "" if name == BACKBONES[0] or tiny else f"{name}|"
    return (f"{PROFILE_PREFIX}{tiny}{net}tome{env['tome_r']}|quant-{quant}"
            f"|gray{gray}")


def check_embedding_profile(col, what: str = "collection") -> None:
    """Warn (stderr) when querying a collection whose stored profile
    differs from the current engine settings."""
    stored = getattr(col, "embedding_profile", None)
    current = engine_profile()
    if stored is not None and stored != current:
        print(
            f"WARNING: {what} {getattr(col, 'name', '?')!r} was built "
            f"with embedding profile {stored!r} but this command runs "
            f"{current!r} (VRT_TOME_R/VRT_GEMM_QUANT/VRT_GRAYSCALE) — "
            "distances across profiles are not comparable; rebuild the "
            "collection or match the settings",
            file=sys.stderr, flush=True)


def _stamp_profile(col, profile=None) -> None:
    """Writer-side stamp with the CLI error convention: a profile mismatch
    is a clean SystemExit, not a traceback."""
    try:
        col.stamp_embedding_profile(profile if profile is not None
                                    else engine_profile())
    except ValueError as e:
        raise SystemExit(str(e))


def _load_world(args):
    """(per-frame sample records, chunk dicts) of ``--vids`` under
    ``--clip-root``, with the clip labels and event template if given."""
    from vit_research_tpu_torch.data import chunks as chunks_mod
    from vit_research_tpu_torch.data import labels as labels_mod
    from vit_research_tpu_torch.data import samples as samples_mod

    clip_labels = labels_mod.load_clip_labels(args.clip_labels) \
        if args.clip_labels else {}
    events = labels_mod.load_event_template(args.event_template) \
        if args.event_template else {}
    recs = samples_mod.load_samples(args.vids, args.clip_root, clip_labels,
                                    events)
    chunks = chunks_mod.build_chunks(recs, chunk_size=args.chunk_size,
                                     chunk_stride=args.chunk_stride)
    return recs, chunks


def _chunks_from_index(store, idx, vids=None):
    """Chunk dicts (data/chunks.py's schema) from a stored chunk index,
    optionally only those of ``vids``."""
    want = {int(v) for v in vids} if vids else None
    chunks = []
    for i in range(len(idx["label"])):
        if want is not None and int(idx["vid"][i]) not in want:
            continue
        chunks.append({
            "vid": int(idx["vid"][i]), "clip": int(idx["clip"][i]),
            "start_idx": int(idx["start_idx"][i]),
            "end_idx": int(idx["end_idx"][i]),
            "side": str(idx["side"][i]), "label": int(idx["label"][i]),
            "status_id": int(idx["status_id"][i]),
            "t_center": float(idx["t_center"][i]),
            "t_width": float(idx["t_width"][i]),
            "frames": [str(store.paths[j]) for j in idx["frame_idx"][i]],
        })
    return chunks


def _store_embed(store):
    """Frame paths -> their rows (n, D) of the frame store ``store``."""
    def embed(paths):
        return store.gather_paths([[p] for p in paths])[:, 0]
    return embed


def _split_by_vids(chunks, train_vids, val_vids):
    train = [c for c in chunks if c["vid"] in set(train_vids)]
    val = [c for c in chunks if c["vid"] in set(val_vids)]
    return train, val


def _fence_store_collection(col, store, *, writes: bool) -> None:
    """The profile fence between a frame store and a collection a trainer
    ranks (and with ``writes``, rewrites) its rows against: the two must
    hold one embedding space. A collection stamped with another profile
    than the store's warns on a read and exits on a write (the rows
    written come from the store)."""
    stored = getattr(col, "embedding_profile", None)
    want = store.embedding_profile
    if stored is None or want is None or stored == want:
        return
    msg = (f"collection {col.name!r} holds embeddings of profile "
           f"{stored!r}, the store {want!r}")
    if writes:
        raise SystemExit(msg + ": refusing to write the store's rows into "
                         "it; rebuild into a fresh collection")
    print(f"WARNING: {msg} — distances across profiles are not "
          "comparable", file=sys.stderr, flush=True)


def _labeled_frames(frames_dir: str, manual_csv: str):
    """Sorted frame names with manual-interval side labels ('ignore' for
    unlabeled)."""
    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.data.labels import ManualIntervals

    frames = naming.list_frames(frames_dir)
    mi = ManualIntervals.from_csv(manual_csv)
    return frames, [mi.class_from_frame(f) for f in frames]


def load_corpus(db: str, collection: str, device, *,
                check_profile: bool = True):
    """Open a labelled frame collection of the vector store at ``db``:
    (client, collection, kNN corpus dict of segment/knn.py). Warns when
    the collection was built under another embedding profile, unless
    ``check_profile`` is False (surfaces that rank nothing new against
    the corpus, such as clustering)."""
    from vit_research_tpu_torch.segment.knn import corpus_from_collection
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    client = PersistentClient(db, device=device)
    col = client.get_collection(collection)
    if check_profile:
        check_embedding_profile(col, what="corpus collection")
    try:
        return client, col, corpus_from_collection(col)
    except ValueError as e:
        raise SystemExit(str(e))


def _scoring_call(fn, *a, **kw):
    """Run an evaluate/scoring.py loader, turning its
    ``ScoringUnavailable`` into the CLI's clean exit."""
    from vit_research_tpu_torch.evaluate.scoring import ScoringUnavailable

    try:
        return fn(*a, **kw)
    except ScoringUnavailable as e:
        raise SystemExit(str(e))


def _stage1_encode_batch(dim: int, t: int, ckpt, run_id, *,
                         strict: bool = False, device="cuda"):
    """The frozen stage-1 ChunkEncoder on ``device`` as a raw (B, T, D) ->
    (embs, logits) callable (evaluate/scoring.py, CLI error convention)."""
    from vit_research_tpu_torch.evaluate import scoring

    return _scoring_call(scoring.stage1_encode_batch, dim, t, ckpt, run_id,
                         strict=strict, device=device)


def _stage1_encode(store, idx, ckpt, run_id, device="cuda"):
    """The frozen stage-1 ChunkEncoder for the chunks of a frame store;
    restored from ``run_id`` when given.

    Returns ``(encode_batch, encode_chunk)``: the raw (B, T, D) ->
    (embs, logits) callable and a one-chunk dict -> L2-normalised (D,)
    wrapper."""
    encode_batch = _stage1_encode_batch(
        store.dim, int(idx["frame_idx"].shape[1]), ckpt, run_id,
        device=device)

    def encode_chunk(ch):
        emb, _ = encode_batch(store.gather_paths([ch["frames"]]))
        v = np.asarray(emb[0])
        return v / (np.linalg.norm(v) + 1e-8)

    return encode_batch, encode_chunk


def _stage2_head(dim: int, ckpt, run_id, *, k_sim: int, k_contrast: int,
                 k_temporal: int, strict: bool = False, device="cuda"):
    """The stage-2 RATTHeadV2 on ``device`` as ``apply(query, sim,
    contrast, temporal) -> (B, 1)`` logits (evaluate/scoring.py, CLI
    error convention)."""
    from vit_research_tpu_torch.evaluate import scoring

    return _scoring_call(scoring.stage2_head, dim, ckpt, run_id,
                         k_sim=k_sim, k_contrast=k_contrast,
                         k_temporal=k_temporal, strict=strict, device=device)


def _open_collection(db_path, name, device="cuda"):
    """Open an existing collection for a read-side command
    (evaluate/scoring.py, CLI error convention)."""
    from vit_research_tpu_torch.evaluate import scoring

    return _scoring_call(scoring.open_collection, db_path, name,
                         device=device)


def _live_event_scorer(args, eng, emb_cache_cap=None):
    """The live make/miss scorer of ``segment --score-events`` on the
    engine's device (None when the flag is off): evaluate/scoring.py's
    make_live_scorer with the CLI's flags and error convention."""
    if not getattr(args, "score_events", False):
        return None
    from vit_research_tpu_torch.evaluate import scoring

    return _scoring_call(
        scoring.make_live_scorer, eng.embed_paths, dim=eng.out_dim,
        ckpt=args.score_ckpt, stage1_run_id=args.stage1_run_id,
        stage2_run_id=args.stage2_run_id, db=args.score_db or args.db,
        collection=args.score_collection, chunk_size=args.chunk_size,
        chunk_stride=args.chunk_stride, k_sim=args.k_sim,
        k_contrast=args.k_contrast, k_temporal=args.k_temporal,
        future_step=args.future_step, emb_cache_cap=emb_cache_cap,
        device=eng.device)


def _score_clip_dir(scorer, clip_dir):
    """Score one written clip directory: its eval row, or None for a clip
    shorter than one chunk."""
    from vit_research_tpu_torch.data import naming

    vid, clip_num, side = naming.parse_clip_dir(
        os.path.basename(os.path.normpath(clip_dir)))
    frames = naming.list_frames(clip_dir)
    return scorer.score_clip(
        [os.path.join(clip_dir, f) for f in frames],
        side=side, clip_num=clip_num, vid=vid)


def _event_row_summary(row) -> str:
    top = (row.get("topk_chunks") or [None])[0]
    if top is None:
        return f"{row['clip_key']}: no chunks"
    where = (f"frames {top['start_frame']}..{top['end_frame']}"
             if top.get("start_frame") is not None else
             f"chunk idx {top['chunk_start_idx']}..{top['chunk_end_idx']}")
    return (f"{row['clip_key']} ({row['side']}): top event chunk {where} "
            f"P(make)={top['prob']:.3f} over {row['num_chunks']} chunks")


def _list_clip_dirs(root: str) -> list:
    """The ``vid*_clip_*`` directories under ``root``, sorted by name."""
    from vit_research_tpu_torch.data import naming

    dirs = []
    for d in sorted(os.listdir(root)):
        if not os.path.isdir(os.path.join(root, d)):
            continue
        try:
            naming.parse_clip_dir(d)
        except (IndexError, ValueError):
            continue
        dirs.append(os.path.join(root, d))
    if not dirs:
        raise SystemExit(f"no vid*_clip_* directories under {root}")
    return dirs


def world_args(sp):
    sp.add_argument("--clip-root", dest="clip_root", required=True)
    sp.add_argument("--vids", type=int, nargs="+", required=True)
    sp.add_argument("--clip-labels", dest="clip_labels", default=None)
    sp.add_argument("--event-template", dest="event_template",
                    default=None)
    sp.add_argument("--chunk-size", type=int, default=8)
    sp.add_argument("--chunk-stride", type=int, default=2)


def split_args(sp):
    sp.add_argument("--train-vids", type=int, nargs="+", required=True)
    sp.add_argument("--val-vids", type=int, nargs="+", required=True)


def device_arg(sp):
    sp.add_argument("--device", default="cuda",
                    help="torch device of the engine and the store's "
                         "device queries (cuda or cpu)")
