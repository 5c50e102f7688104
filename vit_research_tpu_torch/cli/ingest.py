"""Data production commands: write-frame-db, build-frame-store.

Port of the two verbs of vit_research_tpu/cli/ingest.py, with the
reference's arguments and outputs plus ``--device``.
"""

from __future__ import annotations

import os

from vit_research_tpu_torch.cli import common


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

    bs = sub.add_parser(
        "build-frame-store",
        help="clip directories -> frame-embedding store + chunk index")
    common.world_args(bs)
    bs.add_argument("--out", required=True)
    bs.add_argument("--batch-size", type=int, default=256)
    common.device_arg(bs)
    bs.set_defaults(fn=cmd_build_frame_store)
