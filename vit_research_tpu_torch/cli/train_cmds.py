"""Training commands: train-stage1 (the ChunkEncoder), train-rag
(ProjectionHead + RAGHead), train-ratt (chunk-statistic projection +
RATTHead), train-cached (RATTHead over the label-conditioned bin cache)
and train-stage2 (RATTHeadV2 over the stage-2 cache).

Port of vit_research_tpu/cli/train_cmds.py, with the reference's
arguments and output lines plus ``--device``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from vit_research_tpu_torch.cli import common


def cmd_train_stage1(args):
    """Train the stage-1 ChunkEncoder on a frame store's chunks (the first
    80% train, the rest validate), checkpointing every epoch under
    ``--ckpt/<run id>``."""
    from vit_research_tpu_torch.db.frame_store import (FrameStore,
                                                       load_chunk_index)
    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.train.checkpoint import CheckpointManager
    from vit_research_tpu_torch.train.train_chunk_encoder import (
        train_chunk_encoder)
    from vit_research_tpu_torch.utils.configs import (ChunkEncoderConfig,
                                                      preset, save_config)

    resolve_device(args.device)  # before the run directory exists
    store = FrameStore(args.store).open()
    idx = load_chunk_index(args.store)
    n = len(idx["label"])
    split = max(int(n * 0.8), 1)
    cfg = preset("chunks_cached")
    # the run id encodes the hyperparameters actually used
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(
            cfg.train, lr_phase1=args.lr, lr_phase2=args.lr,
            weight_decay=args.weight_decay))
    ce_cfg = ChunkEncoderConfig(
        embed_dim=store.dim, mlp_dim=4 * store.dim,
        max_len=int(idx["frame_idx"].shape[1]))
    run_id = args.run_id or f"stage1_{cfg.run_id()}"
    try:
        mngr = CheckpointManager(args.ckpt, run_id)
    except ValueError as e:  # a run directory of the JAX package
        raise SystemExit(str(e))
    save_config(ce_cfg, os.path.join(mngr.dir, "experiment.json"))
    _, _, history = train_chunk_encoder(
        store, idx, list(range(split)), list(range(split, n)),
        config=ce_cfg, num_epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, weight_decay=args.weight_decay, ckpt_manager=mngr,
        resume=args.resume, verbose=True, device=args.device)
    mngr.wait()
    print(f"run {run_id}: best val acc",
          max((h.get("val_acc", 0) for h in history), default=0))


def _open_store(args):
    """(store, chunk index, train chunks, validation chunks) of ``--store``
    split by ``--train-vids`` / ``--val-vids``."""
    from vit_research_tpu_torch.db.frame_store import (FrameStore,
                                                       load_chunk_index)

    store = FrameStore(args.store).open()
    idx = load_chunk_index(args.store)
    chunks = common._chunks_from_index(store, idx)
    train, val = common._split_by_vids(chunks, args.train_vids,
                                       args.val_vids)
    return store, idx, chunks, train, val


def _run_manager(args, cfg):
    """The run's CheckpointManager under ``--ckpt``, with its experiment
    config written beside the checkpoints."""
    from vit_research_tpu_torch.train.checkpoint import CheckpointManager
    from vit_research_tpu_torch.utils.configs import save_config

    run_id = args.run_id or cfg.run_id()
    os.makedirs(args.ckpt, exist_ok=True)
    try:
        mngr = CheckpointManager(args.ckpt, run_id)
    except ValueError as e:  # a run directory of the JAX package
        raise SystemExit(str(e))
    save_config(cfg, os.path.join(mngr.dir, "experiment.json"))
    return run_id, mngr


def _finish(run_id, mngr, history):
    mngr.wait()
    best = max((h.get("val_acc", 0.0) for h in history), default=0.0)
    print(f"run {run_id}: best val acc {best:.4f}")


def cmd_train_rag(args):
    """The RAG loop: ProjectionHead + RAGHead over live frame retrieval
    from ``--collection``, with optional synchronous DB rebuilds
    (``--rebuild sync``: the rows rewritten through the live projection
    every ``--rebuild-every`` epochs; needs the world's ``--clip-root``
    and ``--vids`` for the rows' metadata)."""
    from dataclasses import replace

    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.retrieval.retrievers import FrameRetriever
    from vit_research_tpu_torch.store.vector_store import PersistentClient
    from vit_research_tpu_torch.train.train_rag import (
        chunk_embed_from_store, train_rag)
    from vit_research_tpu_torch.utils.configs import preset

    resolve_device(args.device)  # before the run directory exists
    if args.rebuild == "sync" and not (args.clip_root and args.vids):
        raise SystemExit("--rebuild sync requires --clip-root/--vids "
                         "(per-frame metadata for the DB rewrite)")
    store, _, _, train, val = _open_store(args)
    cfg = preset("cls_only" if args.no_retrieval else "rag")
    cfg = replace(
        cfg,
        head=replace(cfg.head, embed_dim=store.dim),
        retrieval=replace(cfg.retrieval, top_k=args.top_k,
                          collection=args.collection),
        train=replace(cfg.train, num_epochs=args.epochs,
                      batch_size=args.batch_size,
                      rebuild_every=args.rebuild_every),
        train_vids=tuple(args.train_vids), test_vids=tuple(args.val_vids))

    client = PersistentClient(args.db, autoflush=False, device=args.device)
    col = client.get_or_create_collection(args.collection)
    common._fence_store_collection(col, store,
                                   writes=args.rebuild == "sync")
    retriever = FrameRetriever(col, top_k=cfg.retrieval.top_k)

    rebuild_fn = None
    if args.rebuild == "sync":
        from vit_research_tpu_torch.db.builders import rebuild_frame_db

        recs, _ = common._load_world(args)
        embed = common._store_embed(store)

        def rebuild_fn(project_fn):
            n = rebuild_frame_db(recs, embed, project_fn, col)
            client.flush()
            return n

    run_id, mngr = _run_manager(args, cfg)
    _, history = train_rag(
        train, val, chunk_embed_from_store(store), retriever, cfg=cfg,
        use_retrieval=not args.no_retrieval, rebuild_fn=rebuild_fn,
        ckpt_manager=mngr, resume=args.resume, verbose=True,
        device=args.device)
    _finish(run_id, mngr, history)


def cmd_train_ratt(args):
    """Live-retrieval RATT training: 3D-wide chunk statistics ->
    projection -> RattChunkRetriever over ``--collection`` -> RATTHead;
    ``--attention-losses`` adds the CLS-attention terms (the preset
    ``chunks``), ``--rebuild sync`` re-projects every chunk row with the
    live projection every ``--rebuild-every`` epochs."""
    from dataclasses import replace

    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.retrieval.retrievers import \
        RattChunkRetriever
    from vit_research_tpu_torch.store.vector_store import PersistentClient
    from vit_research_tpu_torch.train.train_ratt import train_ratt
    from vit_research_tpu_torch.utils.configs import preset

    resolve_device(args.device)
    store, _, chunks, train, val = _open_store(args)
    # flags default to None, so the preset's values ('chunks': 12 epochs,
    # top_k 12, rebuild_every 3) stand unless given
    cfg = preset("chunks" if args.attention_losses else "ratt")
    cfg = replace(
        cfg,
        head=replace(cfg.head, embed_dim=store.dim),
        retrieval=replace(
            cfg.retrieval, collection=args.collection,
            **({} if args.top_k is None else {"top_k": args.top_k})),
        train=replace(
            cfg.train,
            **{k: v for k, v in (
                ("num_epochs", args.epochs),
                ("batch_size", args.batch_size),
                ("rebuild_every", args.rebuild_every)) if v is not None}),
        train_vids=tuple(args.train_vids), test_vids=tuple(args.val_vids))
    r = cfg.retrieval

    client = PersistentClient(args.db, autoflush=False, device=args.device)
    try:
        # strict: a mistyped --collection must not train against an empty
        # collection created on the spot
        col = client.get_collection(args.collection)
    except ValueError as e:
        raise SystemExit(str(e))
    common._fence_store_collection(col, store,
                                   writes=args.rebuild == "sync")
    retriever = RattChunkRetriever(col, top_k=r.top_k)

    def frame_embs_fn(batch):
        return store.gather_paths([ch["frames"] for ch in batch])

    rebuild_fn = None
    if args.rebuild == "sync":
        from vit_research_tpu_torch.db.builders import reproject_chunk_rows

        def rebuild_fn(project_fn):
            try:
                n = reproject_chunk_rows(chunks, frame_embs_fn, project_fn,
                                         col)
            except ValueError as e:
                raise SystemExit(str(e))
            client.flush()
            print(f"rebuilt {n} chunk rows with the live projection")

    run_id, mngr = _run_manager(args, cfg)
    _, history = train_ratt(
        train, val, frame_embs_fn, retriever, cfg=cfg,
        attention_losses=args.attention_losses,
        contrastive_weight=args.contrastive_weight, rebuild_fn=rebuild_fn,
        ckpt_manager=mngr, resume=args.resume, verbose=True,
        device=args.device)
    _finish(run_id, mngr, history)


def cmd_train_cached(args):
    """RATTHead over the label-conditioned bin cache (built from the
    frozen stage-1 run ``--stage1-run-id`` against ``--collection`` and
    saved to ``--cache`` when that file is missing; the reference's
    nba_proj/train/training_chunk_cached.py:815-1636)."""
    from dataclasses import replace

    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.retrieval import cache_bins as CB
    from vit_research_tpu_torch.store.vector_store import PersistentClient
    from vit_research_tpu_torch.train.train_chunk_cached import \
        train_chunk_cached
    from vit_research_tpu_torch.utils.configs import preset

    resolve_device(args.device)  # before the run directory exists
    store, idx, chunks, train, val = _open_store(args)
    encode_batch, encode_chunk = common._stage1_encode(
        store, idx, args.ckpt, args.stage1_run_id, args.device)
    cfg = preset("chunks_cached")
    cfg = replace(
        cfg,
        head=replace(cfg.head, embed_dim=store.dim),
        retrieval=replace(cfg.retrieval, top_k=args.top_k,
                          collection=args.collection),
        train=replace(cfg.train, num_epochs=args.epochs,
                      batch_size=args.batch_size),
        train_vids=tuple(args.train_vids), test_vids=tuple(args.val_vids))
    r = cfg.retrieval

    col = PersistentClient(args.db, autoflush=False, device=args.device) \
        .get_or_create_collection(args.collection)
    common._fence_store_collection(col, store, writes=False)
    if os.path.exists(args.cache):
        cache = CB.load_cache(args.cache)
        print(f"loaded bin cache ({len(cache)} bins) from {args.cache}")
    else:
        cache = CB.build_bin_cache(
            chunks, encode_chunk, col, train_vids=args.train_vids,
            candidates_per_bin=r.candidates_per_bin,
            query_mult=r.query_mult, max_per_video=r.per_video_cap,
            max_global_appearances=r.global_cap,
            min_time_gap=r.min_time_gap,
            hard_negative_ratio=r.hard_negative_ratio,
            lambda_global=r.lambda_global, delta_t=args.delta_t,
            seed=cfg.train.seed, verbose=True)
        CB.save_cache(cache, args.cache)
        print(f"built bin cache ({len(cache)} bins) -> {args.cache}")

    def chunk_embed(batch):
        emb, _ = encode_batch(
            store.gather_paths([ch["frames"] for ch in batch]))
        emb = np.asarray(emb)
        return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)

    run_id, mngr = _run_manager(args, cfg)
    _, history = train_chunk_cached(
        train, val, chunk_embed, cache, cfg=cfg, delta_t=args.delta_t,
        ckpt_manager=mngr, resume=args.resume, verbose=True,
        device=args.device)
    _finish(run_id, mngr, history)


def cmd_train_stage2(args):
    """Stage 2: RATTHeadV2 trained on the stage-2 cache (built from the
    frozen stage-1 run ``--stage1-run-id`` against ``--collection`` and
    saved to ``--cache`` when that file is missing), validated with live
    retrieval or, with ``--cached-val``, from the cache. ``--preset stage3
    --init-run-id <run>`` continues a stage-2 run's best weights."""
    from dataclasses import replace

    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.retrieval import cache_stage2 as CS
    from vit_research_tpu_torch.store.vector_store import PersistentClient
    from vit_research_tpu_torch.train.checkpoint import CheckpointManager
    from vit_research_tpu_torch.train.train_stage2 import train_stage2
    from vit_research_tpu_torch.utils.configs import preset

    resolve_device(args.device)  # before the run directory exists
    store, idx, chunks, train, val = _open_store(args)
    _, encode_chunk = common._stage1_encode(store, idx, args.ckpt,
                                            args.stage1_run_id, args.device)
    cfg = preset(args.preset)
    cfg = replace(
        cfg,
        head=replace(cfg.head, embed_dim=store.dim, k_sim=args.k_sim,
                     k_contrast=args.k_contrast, k_temporal=args.k_temporal),
        retrieval=replace(cfg.retrieval, collection=args.collection),
        train=replace(cfg.train, num_epochs=args.epochs,
                      batch_size=args.batch_size),
        train_vids=tuple(args.train_vids), test_vids=tuple(args.val_vids),
        pinned_run_id=args.init_run_id or "")

    col = PersistentClient(args.db, autoflush=False, device=args.device) \
        .get_or_create_collection(args.collection)
    if os.path.exists(args.cache):
        cache = CS.load_cache(args.cache)
        print(f"loaded stage-2 cache ({len(cache)} chunks) from {args.cache}")
    else:
        cache = CS.build_stage2_cache(
            chunks, encode_chunk, col, k_sim=cfg.head.k_sim,
            k_contrast=cfg.head.k_contrast, k_temporal=cfg.head.k_temporal,
            future_step=cfg.retrieval.future_chunk_step,
            search_k_content=cfg.retrieval.search_k_content,
            search_k_temporal=cfg.retrieval.search_k_temporal,
            checkpoint_path=args.cache, verbose=True)
        print(f"built stage-2 cache ({len(cache)} chunks) -> {args.cache}")

    init_params = None
    if args.init_run_id:
        if not os.path.isdir(os.path.join(args.ckpt, args.init_run_id)):
            raise SystemExit(
                f"--init-run-id {args.init_run_id}: no such run under "
                f"{args.ckpt}")
        try:
            restored = CheckpointManager(args.ckpt,
                                         args.init_run_id).restore_best()
        except ValueError as e:  # a run directory of the JAX package
            raise SystemExit(str(e))
        if restored is None:
            raise SystemExit(
                f"--init-run-id {args.init_run_id}: no best checkpoint")
        init_params = restored["params"]

    run_id, mngr = _run_manager(args, cfg)
    _, history = train_stage2(
        train, val, cache,
        encode_fn=None if args.cached_val else encode_chunk,
        collection=None if args.cached_val else col,
        cfg=cfg, ckpt_manager=mngr, verbose=True, init_params=init_params,
        resume=args.resume, device=args.device)
    mngr.wait()
    best = max((h.get("val_acc", 0.0) for h in history), default=0.0)
    f1 = max((h.get("val_best_f1", 0.0) for h in history), default=0.0)
    print(f"run {run_id}: best val acc {best:.4f} best f1 {f1:.4f}")


def register(sub):
    t1 = sub.add_parser("train-stage1",
                        help="train the stage-1 ChunkEncoder on a frame "
                             "store")
    t1.add_argument("--store", required=True)
    t1.add_argument("--ckpt", required=True)
    t1.add_argument("--epochs", type=int, default=10)
    t1.add_argument("--batch-size", type=int, default=32)
    t1.add_argument("--lr", type=float, default=5e-5)
    t1.add_argument("--weight-decay", type=float, default=5e-4)
    t1.add_argument("--run-id", default=None,
                    help="name the run dir (required to --resume it later)")
    t1.add_argument("--resume", action="store_true",
                    help="continue --run-id's latest checkpoint")
    common.device_arg(t1)
    t1.set_defaults(fn=cmd_train_stage1)

    tr = sub.add_parser("train-rag",
                        help="train ProjectionHead + RAGHead over live "
                             "frame retrieval")
    common.split_args(tr)
    tr.add_argument("--store", required=True)
    tr.add_argument("--db", required=True)
    tr.add_argument("--ckpt", required=True)
    tr.add_argument("--collection", default="ragdb")
    tr.add_argument("--epochs", type=int, default=24)
    tr.add_argument("--batch-size", type=int, default=8)
    tr.add_argument("--top-k", type=int, default=5)
    tr.add_argument("--no-retrieval", action="store_true")
    tr.add_argument("--rebuild", choices=["none", "sync"], default="none")
    tr.add_argument("--rebuild-every", type=int, default=4)
    tr.add_argument("--run-id", default=None)
    tr.add_argument("--resume", action="store_true")
    # the world's arguments, needed for --rebuild sync only
    tr.add_argument("--clip-root", dest="clip_root", default=None)
    tr.add_argument("--vids", type=int, nargs="+", default=None)
    tr.add_argument("--clip-labels", dest="clip_labels", default=None)
    tr.add_argument("--event-template", dest="event_template", default=None)
    tr.add_argument("--chunk-size", type=int, default=8)
    tr.add_argument("--chunk-stride", type=int, default=2)
    common.device_arg(tr)
    tr.set_defaults(fn=cmd_train_rag)

    tt = sub.add_parser("train-ratt",
                        help="train the chunk projection + RATTHead over "
                             "live chunk retrieval")
    common.split_args(tt)
    tt.add_argument("--store", required=True)
    tt.add_argument("--db", required=True)
    tt.add_argument("--ckpt", required=True)
    tt.add_argument("--collection", default="ratt_db")
    tt.add_argument("--epochs", type=int, default=None,
                    help="override the preset's epoch count "
                         "(ratt: 24, chunks: 12)")
    tt.add_argument("--batch-size", type=int, default=None)
    tt.add_argument("--top-k", type=int, default=None,
                    help="override the preset's top_k (ratt: 8, chunks: 12)")
    tt.add_argument("--attention-losses", action="store_true",
                    help="add the CLS-attention weighted contrastive and "
                         "entropy terms (the training_chunk_works line)")
    tt.add_argument("--contrastive-weight", type=float, default=0.0,
                    help="max-pull retrieval contrastive weight (the "
                         "reference hardcodes 0)")
    tt.add_argument("--rebuild", choices=["none", "sync"], default="none",
                    help="sync: re-project every chunk row with the live "
                         "projection every --rebuild-every epochs")
    tt.add_argument("--rebuild-every", type=int, default=None,
                    help="override the preset's cadence "
                         "(ratt: 4, chunks: 3)")
    tt.add_argument("--run-id", default=None)
    tt.add_argument("--resume", action="store_true")
    common.device_arg(tt)
    tt.set_defaults(fn=cmd_train_ratt)

    tc = sub.add_parser("train-cached",
                        help="train RATTHead over the label-conditioned "
                             "bin cache")
    common.split_args(tc)
    tc.add_argument("--store", required=True)
    tc.add_argument("--db", required=True)
    tc.add_argument("--ckpt", required=True)
    tc.add_argument("--collection", default="ratt_db_chunks")
    tc.add_argument("--cache", required=True,
                    help="bin-cache pickle; built (and saved) if missing")
    tc.add_argument("--stage1-run-id", default=None)
    tc.add_argument("--epochs", type=int, default=24)
    tc.add_argument("--batch-size", type=int, default=8)
    tc.add_argument("--top-k", type=int, default=8)
    tc.add_argument("--delta-t", type=float, default=0.1)
    tc.add_argument("--run-id", default=None,
                    help="name the run dir (required to --resume it later)")
    tc.add_argument("--resume", action="store_true",
                    help="continue --run-id's latest checkpoint")
    common.device_arg(tc)
    tc.set_defaults(fn=cmd_train_cached)

    t2 = sub.add_parser("train-stage2",
                        help="train RATTHeadV2 over the stage-2 "
                             "sim/contrast/temporal cache")
    common.split_args(t2)
    t2.add_argument("--store", required=True)
    t2.add_argument("--db", required=True)
    t2.add_argument("--ckpt", required=True)
    t2.add_argument("--collection", default="ratt_db_s2")
    t2.add_argument("--cache", required=True,
                    help="stage-2 cache pickle; built (and saved) if missing")
    t2.add_argument("--stage1-run-id", default=None)
    t2.add_argument("--preset", choices=["stage2", "stage3"],
                    default="stage2")
    t2.add_argument("--init-run-id", default=None,
                    help="continue a previous stage-2 run's best weights")
    t2.add_argument("--epochs", type=int, default=30)
    t2.add_argument("--batch-size", type=int, default=8)
    t2.add_argument("--k-sim", type=int, default=6)
    t2.add_argument("--k-contrast", type=int, default=6)
    t2.add_argument("--k-temporal", type=int, default=4)
    t2.add_argument("--cached-val", action="store_true",
                    help="validate from the cache instead of live retrieval")
    t2.add_argument("--run-id", default=None,
                    help="name the run dir (required to --resume it later)")
    t2.add_argument("--resume", action="store_true",
                    help="continue --run-id's latest checkpoint "
                         "(weights, optimizer and step)")
    common.device_arg(t2)
    t2.set_defaults(fn=cmd_train_stage2)
