"""Data production commands: extract-frames, write-frame-db,
write-embeddings, build-frame-store, calibrate-int8.

Port of vit_research_tpu/cli/ingest.py, with the reference's arguments and
outputs plus ``--device`` where a verb embeds.
"""

from __future__ import annotations

import os

from vit_research_tpu_torch.cli import common


def cmd_extract_frames(args):
    """Video -> ``vid{N}_frame_{i}.jpg`` frames (OpenCV; without it the
    verb exits with the reference's RuntimeError)."""
    from vit_research_tpu_torch.data.video import extract_frames

    frame_range = None
    if args.start is not None or args.end is not None:
        if args.start is None or args.end is None:
            raise SystemExit("--start and --end go together")
        frame_range = (args.start, args.end)
    paths = extract_frames(args.video, args.out, args.vid,
                           size=(args.height, args.width), every=args.every,
                           frame_range=frame_range)
    print(f"wrote {len(paths)} frames to {args.out}")


def cmd_calibrate_int8(args):
    """Static-int8 activation scales for ``VRT_GEMM_QUANT=int8-static``
    (ops/quant.py): forwards over representative frames record one scale
    per dense call site. Pass frames drawn from the footage you will
    embed: the scales describe their activation ranges.

    As the reference: a bf16 ViT-B/16 (the port's seeded init, seed 0),
    or the tiny test ViT under ``VRT_TINY``, on an even spread of
    ``--n-frames`` frames, with ToMe at ``--tome-r`` (default
    ``VRT_TOME_R``) and the env's grayscale setting; the same JSON keys.
    Unlike the reference, whose verb feeds the decoded uint8 pixels
    straight into the model's forward, the frames go through the
    engine's own forward (grayscale, normalisation and patch projection
    in kernel A, then the encoder), so the scales describe the
    activations the engine quantizes."""
    import dataclasses
    import json

    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.data.preprocess import load_frames
    from vit_research_tpu_torch.models.vit import init_vit
    from vit_research_tpu_torch.ops.quant import calibration_mode
    from vit_research_tpu_torch.parallel.embed import EmbeddingEngine

    frames = naming.list_frames(args.frames)
    if not frames:
        raise SystemExit(f"no frames found under {args.frames}")
    step = max(len(frames) // max(args.n_frames, 1), 1)
    picked = [os.path.join(args.frames, f) for f in frames[::step]]
    picked = picked[: args.n_frames]

    # calibrate the engine the env describes: ToMe and grayscale change
    # the activation ranges
    env = common._engine_env(require_scales=False)  # this verb writes them
    tome_r = env["tome_r"] if args.tome_r is None else args.tome_r
    if os.environ.get("VRT_TINY"):
        from vit_research_tpu_torch.data.preprocess import PreprocessSpec

        cfg = dataclasses.replace(
            common._tiny_vit_config(env), tome_r=tome_r,
            gemm_quant="int8-static", gemm_quant_scales=())
        spec = PreprocessSpec(size=(32, 32), grayscale=env["grayscale"])
    else:
        from vit_research_tpu_torch.data.preprocess import HF_VIT_SPEC
        from vit_research_tpu_torch.models.hf_import import HF_VIT_B16_224

        cfg = dataclasses.replace(HF_VIT_B16_224, dtype="bfloat16",
                                  tome_r=tome_r, gemm_quant="int8-static",
                                  gemm_quant_scales=())
        spec = (dataclasses.replace(HF_VIT_SPEC, grayscale=True)
                if env["grayscale"] else HF_VIT_SPEC)
    model = init_vit(cfg, seed=0, device="cpu")
    eng = EmbeddingEngine(model, spec, device=args.device,
                          batch_size=max(len(picked), 1))
    imgs = load_frames(picked, spec)
    print(f"calibrating on {len(imgs)} frames (tome_r={tome_r}, "
          f"grayscale={env['grayscale']}, {eng.device} forward)...",
          flush=True)
    with calibration_mode() as scales:
        eng.embed_batch(imgs)
    with open(args.out, "w") as f:
        json.dump({"scales": [float(s) for s in scales],
                   "tome_r": tome_r, "grayscale": env["grayscale"],
                   "n_frames": len(imgs),
                   "frames_dir": os.path.abspath(args.frames)}, f)
    print(f"wrote {len(scales)} site scales -> {args.out}\n"
          f"use: VRT_GEMM_QUANT=int8-static VRT_GEMM_SCALES={args.out} "
          "python -m vit_research_tpu_torch.cli <command>")


def cmd_write_frame_db(args):
    """Manually labelled frames -> labelled frame collection with one-hot
    probability metadata."""
    from vit_research_tpu_torch.db.builders import (
        write_labeled_frame_collection)
    from vit_research_tpu_torch.segment.knn import SIDES
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    frames, sides = common._labeled_frames(args.frames, args.manual_csv)
    keep = [(f, s) for f, s in zip(frames, sides) if s != "ignore"]
    if not keep:
        raise SystemExit("no frames fall inside the manual intervals")
    paths = [os.path.join(args.frames, f) for f, _ in keep]
    labels = [s for _, s in keep]
    probs = [[1.0 if s == t else 0.0 for t in SIDES] for s in labels]
    eng = common._engine(args.batch_size, args.device)
    client = PersistentClient(args.db, device=args.device)
    col = client.get_or_create_collection(
        args.collection, metadata={"hnsw:space": "l2"})
    common._stamp_profile(col)
    n = write_labeled_frame_collection(paths, labels, probs, eng.embed_paths,
                                       col, batch_size=args.batch_size)
    client.flush()
    print(f"wrote {n} labeled frame embeddings into {args.collection}")


def cmd_write_embeddings(args):
    """Per-class npz artifacts ({cls}_embeddings.npz)
    (reference: nba_proj/write_embeddings.py:177-243,
    nba_proj/write_per_video_embeddings.py:167-232)."""
    from vit_research_tpu_torch.db.builders import write_class_npz

    frames, sides = common._labeled_frames(args.frames, args.manual_csv)
    by_class: dict = {}
    for f, s in zip(frames, sides):
        if s != "ignore":
            by_class.setdefault(s, []).append(os.path.join(args.frames, f))
    if not by_class:
        raise SystemExit("no frames fall inside the manual intervals")
    eng = common._engine(args.batch_size, args.device)
    out = write_class_npz(by_class, eng.embed_paths, args.out_template)
    for cls, path in sorted(out.items()):
        print(f"{cls}: {len(by_class[cls])} frames -> {path}")


def cmd_build_frame_store(args):
    """Clip directories -> memmap frame-embedding store + chunk index."""
    from vit_research_tpu_torch.db.frame_store import (FrameStore,
                                                       build_chunk_index)

    recs, chunks = common._load_world(args)
    paths = [r["pth"] for r in recs]
    eng = common._engine(args.batch_size, args.device)
    store = FrameStore.build(paths, eng.embed_paths, args.out,
                             batch_size=1024, verbose=True,
                             embedding_profile=common.engine_profile())
    build_chunk_index(chunks, store, args.out)
    labels = [int(c["label"]) for c in chunks]
    n_unlabeled = sum(1 for v in labels if v < 0)
    if args.clip_labels and n_unlabeled == len(chunks) and chunks:
        print(f"WARNING: all {len(chunks)} chunks are unlabeled (-1) — "
              f"the keys in {args.clip_labels} did not match any clip "
              "directory. Label keys must be the clip-dir paths exactly "
              "as resolved from --clip-root (check relative vs absolute).")
    print(f"frame store: {store.n} frames, {len(chunks)} chunks -> "
          f"{args.out} (labels: {len(chunks) - n_unlabeled} labeled, "
          f"{n_unlabeled} unlabeled)")


def register(sub):
    ef = sub.add_parser("extract-frames")
    ef.add_argument("video")
    ef.add_argument("--out", required=True)
    ef.add_argument("--vid", type=int, required=True)
    ef.add_argument("--height", type=int, default=1080)
    ef.add_argument("--width", type=int, default=1920)
    ef.add_argument("--every", type=int, default=1)
    ef.add_argument("--start", type=int, default=None,
                    help="inclusive first frame index (the reference "
                         "hardcoded per-game windows)")
    ef.add_argument("--end", type=int, default=None,
                    help="inclusive last frame index")
    ef.set_defaults(fn=cmd_extract_frames)

    wf = sub.add_parser(
        "write-frame-db",
        help="manually-labeled frames -> labeled frame collection")
    wf.add_argument("frames")
    wf.add_argument("--manual-csv", required=True)
    wf.add_argument("--db", required=True)
    wf.add_argument("--collection", required=True)
    wf.add_argument("--batch-size", type=int, default=128)
    common.device_arg(wf)
    wf.set_defaults(fn=cmd_write_frame_db)

    we = sub.add_parser(
        "write-embeddings",
        help="per-class npz artifacts ({cls}_embeddings.npz)")
    we.add_argument("frames")
    we.add_argument("--manual-csv", required=True)
    we.add_argument("--out-template", required=True,
                    help="e.g. 'out/{cls}_embeddings.npz'")
    we.add_argument("--batch-size", type=int, default=256)
    common.device_arg(we)
    we.set_defaults(fn=cmd_write_embeddings)

    ci = sub.add_parser(
        "calibrate-int8",
        help="record static-int8 activation scales from representative "
             "frames (VRT_GEMM_QUANT=int8-static + VRT_GEMM_SCALES)")
    ci.add_argument("frames", help="frames dir; an even spread of "
                                   "--n-frames is sampled")
    ci.add_argument("--out", required=True, help="scales JSON path")
    ci.add_argument("--n-frames", type=int, default=8)
    ci.add_argument("--tome-r", type=int, default=None,
                    help="calibrate with token merging active (merged-"
                         "token activations have their own ranges); "
                         "defaults to VRT_TOME_R so calibration matches "
                         "the engine the env describes")
    common.device_arg(ci)
    ci.set_defaults(fn=cmd_calibrate_int8)

    bs = sub.add_parser(
        "build-frame-store",
        help="clip directories -> frame-embedding store + chunk index")
    common.world_args(bs)
    bs.add_argument("--out", required=True)
    bs.add_argument("--batch-size", type=int, default=256)
    common.device_arg(bs)
    bs.set_defaults(fn=cmd_build_frame_store)
