"""Serving commands: the warm embed/retrieval daemon and its operator
client (serve, serve-ctl).

Port of vit_research_tpu/cli/serve_cmds.py with the reference's flags
plus ``--device``. ``serve --shard-device`` splits the collection's rows
over a mesh of every visible card (parallel/mesh.py::make_mesh; with
``--device cpu``, of the one CPU).
"""

from __future__ import annotations

import json
import time

from vit_research_tpu_torch.cli import common


def cmd_serve(args):
    """Warm embedding/retrieval daemon (serve.py): one engine on the
    card, no per-script model reload."""
    from vit_research_tpu_torch.serve import EmbedServer, WarmingServer

    # Bind the socket IMMEDIATELY with a warming placeholder: without a
    # socket an operator cannot tell "initializing" from "dead".
    # ping/stats answer with warming/phase/elapsed; engine ops get a
    # warming_up error.
    if args.shard_device and not args.db:
        raise SystemExit("--shard-device shards the daemon's collection: "
                         "it needs --db and --collection")
    warm = WarmingServer(args.socket)
    try:
        coll, mesh = None, None
        if args.db:
            warm.phase = "loading collection"
            if not args.collection:
                raise SystemExit("--collection is required with --db")
            from vit_research_tpu_torch.store.vector_store import \
                PersistentClient

            coll = PersistentClient(args.db, device=args.device
                                    ).get_collection(args.collection)
            # the daemon embeds live queries/pushes against this corpus
            # for its whole lifetime: a cross-profile mismatch deserves
            # a loud startup warning
            common.check_embedding_profile(coll, what="daemon collection")
            if args.shard_device:
                from vit_research_tpu_torch.parallel.mesh import make_mesh

                # every visible card; a CPU daemon's mesh is its one CPU
                mesh = make_mesh(devices=None if args.device.startswith(
                    "cuda") else [args.device])
                coll.shard_device(mesh)
                print(f"collection {args.collection} sharded over "
                      f"{mesh.size} device(s)", flush=True)
            else:
                # at IVF scale the first unfiltered query pays a one-time
                # k-means fit — do it here, while the warming socket
                # reports the phase, not on a user's first request
                warm.phase = f"store index prewarm ({coll.count():,} rows)"
                if coll.prewarm_index():
                    print(f"IVF index ready for {args.collection} "
                          f"({coll.count():,} rows)", flush=True)
        if warm.shutdown_requested:
            print("shutdown requested while warming; exiting before "
                  "engine build", flush=True)
            return
        warm.phase = "engine build"
        engine = common._engine(args.batch_size, args.device)
        if args.warmup and not warm.shutdown_requested:
            # Build and load the CUDA kernel library (nvcc at first use)
            # and run one engine batch BEFORE accepting connections, so
            # no client ever pays the build.
            t0 = time.monotonic()
            if engine.device.type == "cuda":
                from vit_research_tpu_torch.ops import _build

                warm.phase = "kernel build (nvcc)"
                _build.library()
            t_build = time.monotonic() - t0
            warm.phase = "engine warmup (one batch)"
            engine.warmup()
            print(f"engine warmed in {time.monotonic() - t0:.1f}s "
                  f"(kernel build {t_build:.1f}s + batch "
                  f"{engine.batch_size})", flush=True)
        # Honor a shutdown queued during ANY warming phase before binding
        # the real server.
        if warm.shutdown_requested:
            print("shutdown requested while warming; exiting",
                  flush=True)
            return
        server = EmbedServer(engine,
                             engine_profile=common.engine_profile(),
                             collection=coll,
                             coalesce_ms=args.coalesce_ms,
                             # the reload op's defaults: serve-ctl reload
                             collection_source=((args.db, args.collection)
                                                if args.db else None),
                             shard_mesh=mesh)
    finally:
        # idempotent; also runs on startup failure (no card, bad
        # collection, SystemExit) so the placeholder never outlives the
        # startup that bound it
        warm.close()
    print(f"serving on {args.socket}"
          + (f" (collection {args.collection})" if coll else ""),
          flush=True)
    server.serve(args.socket)


def cmd_serve_ctl(args):
    """Operator client for a running daemon: ping / stats / reload /
    reload-weights / shutdown over its unix socket — no engine,
    instant."""
    from vit_research_tpu_torch.serve import request

    # missing-socket pre-check lives in serve.request (shared with the
    # session client); the FileNotFoundError lands in the OSError branch
    if args.timeout is not None:
        timeout = args.timeout
    else:
        # reload reopens the whole collection from disk before replying —
        # minutes for a multi-GB corpus; reload-weights restores
        # checkpoints; everything else answers instantly
        timeout = (300.0 if args.op in ("reload", "reload-weights")
                   else 60.0)
    req = {"op": args.op.replace("-", "_")}
    if args.db or args.collection:
        if args.op != "reload":
            raise SystemExit("--db/--collection only apply to reload")
        if args.db:
            req["db"] = args.db
        if args.collection:
            req["collection"] = args.collection
    weight_args = {"ckpt": args.ckpt, "stage1_run_id": args.stage1_run_id,
                   "stage2_run_id": args.stage2_run_id,
                   "chunk_size": args.chunk_size, "k_sim": args.k_sim,
                   "k_contrast": args.k_contrast,
                   "k_temporal": args.k_temporal}
    if any(v is not None for v in weight_args.values()):
        if args.op != "reload-weights":
            raise SystemExit(
                "--ckpt/--stage*-run-id/--chunk-size/--k-* only apply to "
                "reload-weights")
        req.update({k: v for k, v in weight_args.items() if v is not None})
    try:
        resp = request(args.socket, req, timeout=timeout)
    except (OSError, ConnectionError) as e:
        raise SystemExit(f"daemon at {args.socket!r} did not answer: {e}")
    if not resp.get("ok"):
        raise SystemExit(f"daemon error: {resp.get('error')}")
    print(json.dumps(resp, indent=2, sort_keys=True))


def register(sub):
    sv = sub.add_parser(
        "serve", help="warm embedding/retrieval daemon on a unix socket")
    sv.add_argument("--socket", required=True)
    sv.add_argument("--batch-size", type=int, default=256)
    sv.add_argument("--db", default=None)
    sv.add_argument("--collection", default=None)
    sv.add_argument("--warmup", action="store_true",
                    help="build the CUDA kernel library and run one engine "
                         "batch before accepting connections (first-"
                         "request latency becomes flat; startup pays the "
                         "build instead)")
    sv.add_argument("--shard-device", action="store_true",
                    help="split the collection's device corpus over every "
                         "visible card (exact top-k, each card scores its "
                         "shard — ops/sharded_topk.py)")
    sv.add_argument("--coalesce-ms", type=float, default=2.0,
                    help="micro-batch concurrent embed requests arriving "
                         "within this window into one device batch "
                         "(0 disables)")
    common.device_arg(sv)
    sv.set_defaults(fn=cmd_serve)

    sc = sub.add_parser(
        "serve-ctl", help="operate a running serve daemon: ping, stats, "
                          "reload (hot-swap the collection from disk), "
                          "reload-weights (hot-swap retrained scorer "
                          "checkpoints), shutdown")
    sc.add_argument("op", choices=["ping", "stats", "reload",
                                   "reload-weights", "shutdown"])
    sc.add_argument("--socket", required=True)
    sc.add_argument("--timeout", type=float, default=None,
                    help="reply wait in seconds (default: 300 for reload "
                         "— a big collection takes a while to reopen — "
                         "60 otherwise)")
    sc.add_argument("--db", default=None,
                    help="reload only: store root to reload from "
                         "(default: the daemon's own --db)")
    sc.add_argument("--collection", default=None,
                    help="reload only: collection name "
                         "(default: the daemon's own --collection)")
    sc.add_argument("--ckpt", default=None,
                    help="reload-weights only: narrow to stacks from this "
                         "checkpoint root (with both run ids: preload a "
                         "stack no session has requested yet)")
    sc.add_argument("--stage1-run-id", default=None,
                    help="reload-weights only: narrow/preload by stage-1 "
                         "run id")
    sc.add_argument("--stage2-run-id", default=None,
                    help="reload-weights only: narrow/preload by stage-2 "
                         "run id")
    sc.add_argument("--chunk-size", type=int, default=None,
                    help="reload-weights preload only (default 8)")
    sc.add_argument("--k-sim", type=int, default=None,
                    help="reload-weights preload only (default 8)")
    sc.add_argument("--k-contrast", type=int, default=None,
                    help="reload-weights preload only (default 8)")
    sc.add_argument("--k-temporal", type=int, default=None,
                    help="reload-weights preload only (default 4)")
    sc.set_defaults(fn=cmd_serve_ctl)
