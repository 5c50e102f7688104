"""Vector-store commands: write-ratt-db, search, db-info.

Port of three verbs of vit_research_tpu/cli/db_cmds.py, with the
reference's arguments and output lines plus ``--device``.
"""

from __future__ import annotations

import json

import numpy as np

from vit_research_tpu_torch.cli import common


def cmd_write_ratt_db(args):
    """Chunk-encoder embeddings of every chunk of a frame store into a
    cosine collection, with the encoder of a stage-1 run (``--run-id``;
    fresh weights without one)."""
    from vit_research_tpu_torch.db.builders import write_ratt_chunk_db
    from vit_research_tpu_torch.db.frame_store import (FrameStore,
                                                       load_chunk_index)
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    store = FrameStore(args.store).open()
    idx = load_chunk_index(args.store)
    encode, _ = common._stage1_encode(store, idx, args.ckpt, args.run_id,
                                      args.device)
    client = PersistentClient(args.db, device=args.device)
    col = client.get_or_create_collection(
        args.collection, metadata={"hnsw:space": "cosine"})
    # chunk rows inherit the store's embedding profile (the frames were
    # embedded when the store was built, not now)
    if store.embedding_profile:
        common._stamp_profile(col, store.embedding_profile)
    n = write_ratt_chunk_db(idx, store, encode, col)
    client.flush()
    print(f"wrote {n} chunk embeddings into {args.collection}")


def cmd_search(args):
    """Ad-hoc neighbour lookup: embed frames (or take rows from an .npz)
    and query a collection, printing one JSON line per query."""
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    col = PersistentClient(args.db, device=args.device).get_collection(
        args.collection)
    if args.npz:
        with np.load(args.npz) as data:
            key = args.npz_key or data.files[0]
            q = np.asarray(data[key], np.float32)
        if q.ndim == 3:  # (N, 1, D): the reference's class-npz layout
            q = q[:, 0]
        elif q.ndim == 1:
            q = q[None]
        names = [f"{args.npz}[{key}][{i}]" for i in range(len(q))]
    elif args.frames:
        # the queries are embedded now: warn if the stored rows came
        # from different embedding settings
        common.check_embedding_profile(col)
        eng = common._engine(args.batch_size, args.device)
        q = np.asarray(eng.embed_paths(args.frames))
        names = list(args.frames)
    else:
        raise SystemExit("pass frame paths or --npz")
    where = json.loads(args.where) if args.where else None
    got = col.query(q, n_results=args.k, where=where,
                    include=("metadatas", "distances"))
    for name, ids, dists, metas in zip(names, got["ids"],
                                       got["distances"], got["metadatas"]):
        print(json.dumps({
            "query": name,
            "neighbors": [{"id": i, "distance": round(float(d), 6),
                           "metadata": m}
                          for i, d, m in zip(ids, dists, metas)],
        }))


def cmd_db_info(args):
    """Inspect a vector-store root: per-collection rows, space, dim,
    device quantization, and log-segment state."""
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    client = PersistentClient(args.db, autoflush=False, device=args.device)
    names = client.list_collections()
    if not names:
        raise SystemExit(f"no collections under {args.db}")
    for name in names:
        col = client.get_collection(name)
        segs = len(col._segments)
        print(f"{name}: {col.count()} rows  space={col.space}  "
              f"dim={col._dim}  device_quant={col.device_quant or '-'}  "
              f"profile={col.embedding_profile or '-'}  "
              f"log_segments={segs}")
        if args.compact and segs:
            col.compact()
            print(f"  compacted {segs} segments into a fresh snapshot")


def register(sub):
    wr = sub.add_parser(
        "write-ratt-db",
        help="stage-1 chunk embeddings of a frame store into a collection")
    wr.add_argument("--store", required=True)
    wr.add_argument("--ckpt", required=True)
    wr.add_argument("--db", required=True)
    wr.add_argument("--collection", default="ratt_db")
    wr.add_argument("--run-id", default=None)
    common.device_arg(wr)
    wr.set_defaults(fn=cmd_write_ratt_db)

    se = sub.add_parser(
        "search", help="embed frames (or .npz rows) and print neighbors")
    se.add_argument("frames", nargs="*", help="frame image paths")
    se.add_argument("--db", required=True)
    se.add_argument("--collection", required=True)
    se.add_argument("--k", type=int, default=10)
    se.add_argument("--where", default=None,
                    help='metadata filter as JSON, e.g. \'{"side": "left"}\'')
    se.add_argument("--npz", default=None,
                    help="query embeddings from an .npz instead of frames")
    se.add_argument("--npz-key", default=None)
    se.add_argument("--batch-size", type=int, default=256)
    common.device_arg(se)
    se.set_defaults(fn=cmd_search)

    di = sub.add_parser("db-info",
                        help="inspect a vector-store root's collections")
    di.add_argument("db")
    di.add_argument("--compact", action="store_true",
                    help="merge each collection's append-log into a "
                         "fresh snapshot")
    common.device_arg(di)
    di.set_defaults(fn=cmd_db_info)
