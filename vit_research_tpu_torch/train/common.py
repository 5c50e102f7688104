"""Shared training-loop infrastructure.

Port of vit_research_tpu/train/common.py: a host-side batcher (the same
seeded numpy shuffles, so batches come in the JAX package's order), the
train state (a module, its optimizer and the step count), resume from the
latest run checkpoint, and the per-epoch metric means. The retrieval
trainers' DB-rebuild cadence (``maybe_rebuild_db``, ``finish_rebuilds``)
comes with them.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vit_research_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def checkpoint(self) -> dict:
        """The run checkpoint's state: ``params`` (the model's
        ``state_dict``), ``opt_state`` and ``step``."""
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "step": self.step}


def maybe_resume(ckpt_manager, state: TrainState, resume: bool):
    """Restore the latest checkpoint into ``state`` (the model's weights,
    the optimizer's moments and counts, the step), in place.

    Returns (state, start_epoch): the epoch after the restored one, 0 when
    there is nothing to resume. The optimizer state comes back too, so
    with per-epoch dropout generators the continued run reproduces the
    uninterrupted one. Raises RuntimeError when the saved state does not
    fit the model or the optimizer."""
    if not resume or ckpt_manager is None:
        return state, 0
    latest = ckpt_manager.latest_step()
    if latest is None:
        return state, 0
    try:
        restored = ckpt_manager.restore(latest, template={
            "params": None, "opt_state": None, "step": None})
        state.model.load_state_dict(restored["params"])
        state.optimizer.load_state_dict(restored["opt_state"])
    except (RuntimeError, ValueError, KeyError) as e:
        raise RuntimeError(
            f"--resume could not restore step {latest} from "
            f"{getattr(ckpt_manager, 'dir', ckpt_manager)}: the saved "
            "state does not match the current model/optimizer structure; "
            "restart the run, or warm-start from the checkpoint's params "
            "only") from e
    state.step = int(restored["step"])
    return state, latest + 1


def chunk_metadata_batch(batch_chunks) -> dict:
    """Chunk dicts -> columnar metadata arrays."""
    return {
        "vid": np.asarray([c["vid"] for c in batch_chunks], np.int32),
        "clip": np.asarray([c["clip"] for c in batch_chunks], np.int32),
        "side": np.asarray([c["side"] for c in batch_chunks], dtype=object),
        "t_center": np.asarray([c["t_center"] for c in batch_chunks],
                               np.float32),
        "t_width": np.asarray([c["t_width"] for c in batch_chunks],
                              np.float32),
        "label": np.asarray([c["label"] for c in batch_chunks], np.int32),
        "status_id": np.asarray([c["status_id"] for c in batch_chunks],
                                np.int32),
        "start_idx": np.asarray([c["start_idx"] for c in batch_chunks],
                                np.int32),
    }


def batch_iterator(items, batch_size: int, *, shuffle: bool = True,
                   seed: int = 0, drop_remainder: bool = True):
    """Batches of ``items`` in a seeded numpy shuffle
    (``default_rng(seed).shuffle``, the JAX package's order). With
    ``drop_remainder`` a dataset smaller than one batch yields nothing
    and warns: a run would otherwise look complete without one step."""
    idx = np.arange(len(items))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = len(idx) - (len(idx) % batch_size) if drop_remainder else len(idx)
    if items and end == 0:
        warnings.warn(
            f"batch_iterator: {len(items)} items < batch_size="
            f"{batch_size} with drop_remainder — yielding NO batches",
            RuntimeWarning, stacklevel=2)
    for start in range(0, end, batch_size):
        yield [items[i] for i in idx[start:start + batch_size]]


def num_batches(n_items: int, batch_size: int,
                drop_remainder: bool = True) -> int:
    return n_items // batch_size if drop_remainder else -(-n_items // batch_size)


def tree_finite(tree) -> bool:
    """Whether every tensor or array in ``tree`` (a module, a dict, list
    or tuple of them, or one leaf) is finite."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        return all(tree_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(tree_finite(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return bool(torch.isfinite(tree).all())
    return bool(np.isfinite(np.asarray(tree)).all())


def split_train_val(items, val_frac: float = 0.2, seed: int = 0):
    idx = np.arange(len(items))
    np.random.default_rng(seed).shuffle(idx)
    n_val = max(1, int(len(items) * val_frac))
    val = [items[i] for i in idx[:n_val]]
    train = [items[i] for i in idx[n_val:]]
    return train, val


class MetricAverager:
    """Streaming scalar means (a keras ``Mean`` per key)."""

    def __init__(self):
        self.sums: dict = {}
        self.counts: dict = {}

    def update(self, **metrics):
        for k, v in metrics.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v)
            self.counts[k] = self.counts.get(k, 0) + 1

    def result(self) -> dict:
        return {k: self.sums[k] / max(self.counts[k], 1) for k in self.sums}

    def reset(self):
        self.sums, self.counts = {}, {}
