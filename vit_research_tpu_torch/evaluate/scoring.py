"""The live event-scoring stack from trained runs.

Port of vit_research_tpu/evaluate/scoring.py, shared by the CLI
(``segment --score-events``, ``eval-clips``, ``write-ratt-db``) and the
serving daemon (``segment_start`` with a ``score_events`` config): restore
the frozen stage-1 ChunkEncoder and the trained stage-2 RATTHeadV2 from
their run checkpoints (the port's own format; a JAX package Orbax run is
refused, naming the format) and bind them, with a retrieval collection,
into an evaluate/live.py ``LiveEventScorer`` on one device.

The loaders check strictly, so a bad run id never surfaces as a
random-weight model silently scoring plausible rows. Errors raise
:class:`ScoringUnavailable` (a ``ValueError``): the CLI turns it into a
clean exit, the daemon into an ``{"ok": false}`` reply.
"""

from __future__ import annotations

import os


class ScoringUnavailable(ValueError):
    """A scoring component cannot be loaded as configured (missing or
    unreadable checkpoint run, absent vector store, chunk-size
    mismatch)."""


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


def stage2_head(dim: int, ckpt, run_id, *, k_sim: int, k_contrast: int,
                k_temporal: int, strict: bool = False, device="cuda"):
    """The stage-2 RATTHeadV2 on ``device`` as ``apply(query, sim,
    contrast, temporal) -> (B, 1)`` logits (a tensor on ``device``; the
    inputs are host arrays or tensors), restored from ``run_id`` when given
    (fresh seeded weights otherwise). The head computes without a graph,
    in eval mode."""
    import numpy as np
    import torch

    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.models.ratt_v2 import RATTHeadV2
    from vit_research_tpu_torch.utils.configs import HeadConfig

    dev = resolve_device(device)
    head = RATTHeadV2(HeadConfig(embed_dim=dim, k_sim=k_sim,
                                 k_contrast=k_contrast,
                                 k_temporal=k_temporal),
                      generator=torch.Generator().manual_seed(0))
    restored = restore_best("stage-2", ckpt, run_id, strict=strict)
    if restored is not None:
        try:
            head.load_state_dict(restored["params"])
        except (RuntimeError, KeyError) as e:
            raise ScoringUnavailable(
                f"[stage-2] run {run_id!r} does not hold a RATTHeadV2 of "
                f"width {dim}: {e}")
    head = head.to(dev).eval()

    @torch.no_grad()
    def apply(query, sim, contrast, temporal):
        return head(*(torch.as_tensor(np.asarray(x, np.float32)).to(dev)
                      for x in (query, sim, contrast, temporal)))[0]

    return apply


def open_collection(db_path, name, device="cuda"):
    """Open an existing collection for read-side consumers, strictly both
    ways: the store root must exist (the client would create it), and a
    missing name is an error, never a new empty collection."""
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    if not os.path.isdir(db_path):
        raise ScoringUnavailable(
            f"no vector store at {db_path!r} — the store root must "
            "already exist (see write-frame-db / write-ratt-db)")
    try:
        return PersistentClient(db_path, autoflush=False,
                                device=device).get_collection(name)
    except ValueError as e:
        raise ScoringUnavailable(str(e))


def load_scorer_stack(*, dim: int, ckpt, stage1_run_id, stage2_run_id,
                      chunk_size: int = 8, k_sim: int = 8,
                      k_contrast: int = 8, k_temporal: int = 4,
                      device="cuda"):
    """``(encode_batch, head_apply)``: the frozen stage-1 encoder and the
    stage-2 head restored from their runs, both strictly (a missing
    checkpoint raises). Callables closing over their own modules, safe to
    share across scoring sessions: the unit the daemon's
    ``reload_weights`` swaps."""
    if chunk_size < 1:
        raise ScoringUnavailable("event scoring needs positive chunk_size")
    encode_batch = stage1_encode_batch(dim, chunk_size, ckpt, stage1_run_id,
                                       strict=True, device=device)
    head_apply = stage2_head(dim, ckpt, stage2_run_id, k_sim=k_sim,
                             k_contrast=k_contrast, k_temporal=k_temporal,
                             strict=True, device=device)
    return encode_batch, head_apply


def make_live_scorer(embed_fn, *, dim: int, ckpt=None, stage1_run_id=None,
                     stage2_run_id=None, db=None, collection,
                     chunk_size: int = 8, chunk_stride: int = 2,
                     k_sim: int = 8, k_contrast: int = 8, k_temporal: int = 4,
                     future_step: int = 2, emb_cache_cap: int | None = None,
                     stack=None, device="cuda"):
    """The live make/miss scorer: the frozen stage-1 encoder and the
    trained stage-2 head (restored strictly, or ``stack``, an already
    restored ``load_scorer_stack`` pair) with live retrieval against
    ``collection`` (a name in ``db``, or an open collection).

    ``embed_fn`` maps frame paths to (N, D) frame embeddings, from the
    engine that built the collection."""
    from vit_research_tpu_torch.evaluate.live import LiveEventScorer

    if chunk_size < 1 or chunk_stride < 1:
        raise ScoringUnavailable(
            "event scoring needs positive chunk_size and chunk_stride")
    col = (collection if hasattr(collection, "query")
           else open_collection(db, collection, device=device))
    if stack is None:
        stack = load_scorer_stack(
            dim=dim, ckpt=ckpt, stage1_run_id=stage1_run_id,
            stage2_run_id=stage2_run_id, chunk_size=chunk_size,
            k_sim=k_sim, k_contrast=k_contrast, k_temporal=k_temporal,
            device=device)
    encode_batch, head_apply = stack
    return LiveEventScorer(
        embed_fn, encode_batch, head_apply, col,
        chunk_size=chunk_size, chunk_stride=chunk_stride,
        k_sim=k_sim, k_contrast=k_contrast, k_temporal=k_temporal,
        future_step=future_step, emb_cache_cap=emb_cache_cap)
