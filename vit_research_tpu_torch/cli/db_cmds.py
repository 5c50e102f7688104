"""Vector-store commands: write-ratt-db, write-rag-db, rebuild-db, search,
db-info.

Port of vit_research_tpu/cli/db_cmds.py, with the reference's arguments
and output lines plus ``--device``.
"""

from __future__ import annotations

import json
import os

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


def cmd_write_rag_db(args):
    """The frame-level RAG DB from the memmap frame store: every frame of
    the world's clips, with side / t_norm / clip / vid metadata
    (reference: nba_proj/write_clips_to_ragdb.py:296-391)."""
    from vit_research_tpu_torch.db.builders import write_frame_ragdb
    from vit_research_tpu_torch.db.frame_store import FrameStore
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    recs, _ = common._load_world(args)
    store = FrameStore(args.store).open()
    client = PersistentClient(args.db, device=args.device)
    col = client.get_or_create_collection(
        args.collection, metadata={"hnsw:space": "cosine"})
    if store.embedding_profile:
        common._stamp_profile(col, store.embedding_profile)
    n = write_frame_ragdb(recs, common._store_embed(store), col,
                          batch_size=args.batch_size)
    client.flush()
    print(f"wrote {n} frame embeddings into {args.collection}")


def _run_projection(args, dim: int):
    """The ProjectionHead of train-rag run ``--run-id`` (its best epoch)
    on ``--device`` as a host (n, dim) -> (n, dim) callable."""
    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.models.heads import ProjectionHead
    from vit_research_tpu_torch.train.checkpoint import CheckpointManager
    from vit_research_tpu_torch.train.common import host_projection

    if args.ckpt is None:
        raise SystemExit("--run-id needs --ckpt (the checkpoint root)")
    if not os.path.isdir(os.path.join(args.ckpt, args.run_id)):
        raise SystemExit(f"--run-id {args.run_id}: no such run under "
                         f"{args.ckpt!r}")
    try:
        restored = CheckpointManager(args.ckpt, args.run_id).restore_best()
    except ValueError as e:  # a run directory of the JAX package
        raise SystemExit(str(e))
    params = (restored or {}).get("params", {})
    proj_state = {k[len("proj."):]: v for k, v in params.items()
                  if k.startswith("proj.")}
    if not proj_state:
        raise SystemExit(f"--run-id {args.run_id}: no best checkpoint with "
                         "ProjectionHead params (expect a train-rag run)")
    dev = resolve_device(args.device)
    proj = ProjectionHead(dim, proj_dim=dim)
    try:
        proj.load_state_dict(proj_state)
    except RuntimeError as e:
        raise SystemExit(f"--run-id {args.run_id}: its ProjectionHead does "
                         f"not fit the store's width {dim}: {e}")
    return host_projection(proj.to(dev).eval(), dev)


def cmd_rebuild_db(args):
    """Standalone frame-level DB rebuild, re-projected with a train-rag
    run's ProjectionHead when ``--run-id`` is given (reference:
    nba_proj/db_maintainence/db_rebuild.py:100-232), then optionally a
    ``reload`` of the collection in the serve daemon at
    ``--notify-socket``."""
    from vit_research_tpu_torch.db.builders import rebuild_frame_db
    from vit_research_tpu_torch.db.frame_store import FrameStore
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    recs, _ = common._load_world(args)
    store = FrameStore(args.store).open()
    project_fn = _run_projection(args, store.dim) if args.run_id else None
    client = PersistentClient(args.db, device=args.device)
    col = client.get_or_create_collection(
        args.collection, metadata={"hnsw:space": "cosine"})
    if store.embedding_profile:
        # projected rows are another space than the store's: the profile
        # says which run projected them
        common._stamp_profile(col, store.embedding_profile + (
            f"|proj:{args.run_id}" if project_fn is not None else ""))
    n = rebuild_frame_db(recs, common._store_embed(store), project_fn, col,
                         batch_size=args.batch_size)
    client.flush()
    print(f"rebuilt {args.collection}: {n} frame embeddings"
          + (" (re-projected)" if project_fn else ""))
    if args.notify_socket:
        # the daemon reopens the flushed collection without an engine
        # restart
        from vit_research_tpu_torch.serve import request as serve_request

        try:
            resp = serve_request(
                args.notify_socket,
                {"op": "reload", "db": args.db,
                 "collection": args.collection}, timeout=300.0)
        except (OSError, ConnectionError) as e:
            raise SystemExit(
                f"rebuild succeeded but the daemon at "
                f"{args.notify_socket!r} did not answer the reload: {e}")
        if not resp.get("ok"):
            raise SystemExit("rebuild succeeded but the daemon reload "
                             f"failed: {resp.get('error')}")
        print(f"daemon reloaded {args.collection}: {resp['rows']} rows "
              f"(was {resp['previous_rows']})")


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

    wg = sub.add_parser(
        "write-rag-db",
        help="the frame-level RAG DB of a world's clips from a frame store")
    common.world_args(wg)
    wg.add_argument("--store", required=True)
    wg.add_argument("--db", required=True)
    wg.add_argument("--collection", default="ragdb")
    wg.add_argument("--batch-size", type=int, default=256)
    common.device_arg(wg)
    wg.set_defaults(fn=cmd_write_rag_db)

    rb = sub.add_parser(
        "rebuild-db", help="standalone frame-level DB rebuild")
    common.world_args(rb)
    rb.add_argument("--store", required=True)
    rb.add_argument("--db", required=True)
    rb.add_argument("--collection", default="ragdb")
    rb.add_argument("--ckpt", default=None)
    rb.add_argument("--run-id", default=None,
                    help="train-rag run whose ProjectionHead re-projects "
                         "the embeddings")
    rb.add_argument("--batch-size", type=int, default=256)
    rb.add_argument("--notify-socket", default=None,
                    help="after the rebuild, hot-reload the collection "
                         "in the serve daemon on this socket")
    common.device_arg(rb)
    rb.set_defaults(fn=cmd_rebuild_db)

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
