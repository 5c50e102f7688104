"""Vector-store commands: search, db-info.

Port of the two verbs of vit_research_tpu/cli/db_cmds.py, with the
reference's arguments and output lines plus ``--device``.
"""

from __future__ import annotations

import json

import numpy as np

from vit_research_tpu_torch.cli import common


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
