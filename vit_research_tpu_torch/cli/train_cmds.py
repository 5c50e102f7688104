"""Training commands: train-stage1 (the ChunkEncoder).

Port of the first verb of vit_research_tpu/cli/train_cmds.py, with the
reference's arguments and output lines plus ``--device``. The retrieval
trainers (train-rag, train-ratt, train-cached, train-stage2) come with
their slice.
"""

from __future__ import annotations

import dataclasses
import os

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
