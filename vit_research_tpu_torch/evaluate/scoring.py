"""Restore the frozen stage-1 encoder from a training run.

Port of the stage-1 half of vit_research_tpu/evaluate/scoring.py: one
shared loader with strict misconfiguration checks, so a bad run id never
surfaces as a random-weight encoder silently writing plausible rows.
Errors raise :class:`ScoringUnavailable` (a ``ValueError``); the CLI turns
it into a clean exit. The stage-2 head, the collection opener and the
live scorer come with the evaluation slice.
"""

from __future__ import annotations

import os


class ScoringUnavailable(ValueError):
    """A scoring component cannot be loaded as configured (missing or
    unreadable checkpoint run, chunk-size mismatch)."""


def restore_best(what: str, ckpt, run_id, *, strict: bool):
    """The best checkpoint's state of run ``run_id`` under ``ckpt``, or
    None without a run id. A missing run falls back to fresh weights with
    a console note for non-strict callers; strict callers get a
    :class:`ScoringUnavailable`. A run that exists but fails to restore
    (an Orbax run of the JAX package, a torn file) is an error for
    everyone."""
    from vit_research_tpu_torch.train.checkpoint import CheckpointManager

    if not run_id:
        return None
    # the manager creates the run dir: probe first, so a typo'd run id
    # fails instead of materializing an empty run
    run_dir = os.path.join(ckpt, str(run_id))
    if not os.path.isdir(run_dir):
        msg = f"[{what}] no run directory {run_dir}"
        if strict:
            raise ScoringUnavailable(
                msg + " — pass the run id printed by the training command "
                "(ls the --ckpt root)")
        print(msg + "; using fresh params")
        return None
    try:
        restored = CheckpointManager(ckpt, run_id).restore_best()
    except Exception as e:  # noqa: BLE001 - diagnose instead of crash
        raise ScoringUnavailable(
            f"[{what}] checkpoint restore of {run_id!r} failed: {e}")
    if restored is None:
        msg = (f"[{what}] run {run_id!r} under {ckpt!r} has no best "
               "checkpoint (did training finish an epoch?)")
        if strict:
            raise ScoringUnavailable(msg)
        print(msg + "; using fresh params")
    return restored


def stage1_encode_batch(dim: int, t: int, ckpt, run_id, *,
                        strict: bool = False, device="cuda"):
    """The frozen stage-1 ChunkEncoder on ``device`` as a (B, T, D) ->
    (embs, logits) numpy callable, restored from ``run_id`` when given
    (fresh seeded weights otherwise). Raises ScoringUnavailable when the
    run was trained with another chunk size (its position table holds
    ``1 + chunk_size`` rows) or, with ``strict``, when it cannot be
    restored."""
    import torch

    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.models.heads import ChunkEncoder
    from vit_research_tpu_torch.train.train_chunk_encoder import (
        make_encode_fn)
    from vit_research_tpu_torch.utils.configs import ChunkEncoderConfig

    dev = resolve_device(device)
    cfg = ChunkEncoderConfig(embed_dim=dim, mlp_dim=4 * dim, max_len=t)
    model = ChunkEncoder(cfg, generator=torch.Generator().manual_seed(0))
    params = None
    restored = restore_best("stage-1", ckpt, run_id, strict=strict)
    if restored is not None:
        params = restored["params"]
        # the position table encodes the chunk size the encoder was
        # trained with; a smaller window would be sliced silently and
        # scored out of distribution
        pos = params.get("pos_embedding")
        if pos is not None and int(pos.shape[1]) != t + 1:
            raise ScoringUnavailable(
                f"[stage-1] run {run_id!r} was trained with chunk_size "
                f"{int(pos.shape[1]) - 1} (pos_embedding "
                f"{tuple(pos.shape)}), but this command is chunking with "
                f"chunk_size {t} — pass the matching --chunk-size, or "
                "retrain/rebuild with the new size")
    return make_encode_fn(model.to(dev), params)
