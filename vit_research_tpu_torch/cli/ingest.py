"""Data production commands: extract-frames, write-frame-db,
write-embeddings, build-frame-store.

Port of vit_research_tpu/cli/ingest.py, with the reference's arguments and
outputs plus ``--device`` where a verb embeds. ``calibrate-int8`` comes
with the fast profile.
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

    bs = sub.add_parser(
        "build-frame-store",
        help="clip directories -> frame-embedding store + chunk index")
    common.world_args(bs)
    bs.add_argument("--out", required=True)
    bs.add_argument("--batch-size", type=int, default=256)
    common.device_arg(bs)
    bs.set_defaults(fn=cmd_build_frame_store)
