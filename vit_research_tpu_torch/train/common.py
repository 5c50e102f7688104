"""Shared training-loop infrastructure.

Port of vit_research_tpu/train/common.py: a host-side batcher (the same
seeded numpy shuffles, so batches come in the JAX package's order), the
train state (a module, its optimizer and the step count), resume from the
latest run checkpoint, the per-epoch metric means and dropout
generators, and the retrieval trainers' epoch loop (``run_epochs``) with
its DB-rebuild cadence (``maybe_rebuild_db``, ``finish_rebuilds``),
which stage 2's loop shares.
"""

from __future__ import annotations

import copy
import warnings
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vit_research_tpu_torch.models.vit import set_dropout_generator
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


def dropout_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The epoch's dropout generator on ``device``, seeded from (seed,
    epoch) alone."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(2)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


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


def host_projection(module: nn.Module, device, *, prepare=None,
                    frozen: bool = False):
    """``module`` (after ``prepare`` on its input, when given) as the host
    callable the DB rebuilders take: numpy in, numpy out, run on
    ``device`` without a graph. ``frozen``: through a copy of the weights
    taken now, for an async rebuild, whose thread runs while training
    updates the live weights in place."""
    if frozen:
        module = copy.deepcopy(module)

    @torch.no_grad()
    def fn(x) -> np.ndarray:
        x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
        return module(x if prepare is None else prepare(x)).cpu().numpy()
    return fn


def maybe_rebuild_db(epoch, train_cfg, proj: nn.Module, device, *,
                     prepare=None, rebuild_fn=None, rebuild_scheduler=None,
                     verbose=False) -> None:
    """The retrieval trainers' epoch-end DB rebuild: every
    ``rebuild_every`` epochs, ``(epoch + 1) % R == 0`` (the reference's
    1-indexed ``epoch % R == 0``, nba_proj/train/training.py:479-480).

    ``rebuild_fn(project_fn)`` rebuilds synchronously; a
    train/async_rebuild.py ``RebuildScheduler`` first swaps in a finished
    rebuild, then is kicked with ``project_fn``, through a copy of the
    weights taken at the kick. ``project_fn`` is :func:`host_projection`
    of the trainer's live projection ``proj`` (after ``prepare``):
    train_rag's maps (B, d) chunk embeddings, train_ratt's (B, T, d)
    frame embeddings."""
    due = bool(train_cfg.rebuild_every) and \
        (epoch + 1) % train_cfg.rebuild_every == 0
    if rebuild_scheduler is not None:
        if rebuild_scheduler.maybe_swap() and verbose:
            print(f"epoch {epoch}: swapped in async DB rebuild")
        if due:
            rebuild_scheduler.kick(host_projection(
                proj, device, prepare=prepare, frozen=True))
    elif rebuild_fn is not None and due:
        rebuild_fn(host_projection(proj, device, prepare=prepare))


def finish_rebuilds(rebuild_scheduler) -> None:
    """Drain the async rebuild scheduler at the end of training; a failed
    last rebuild is printed, not raised past the trained weights."""
    if rebuild_scheduler is not None:
        rebuild_scheduler.wait()
        rebuild_scheduler.maybe_swap(raise_on_error=False)


def run_epochs(state: TrainState, train_items, val_items, train_cfg, *,
               start_epoch: int, batch_tensors, train_step, eval_step,
               seed: int, device, proj: nn.Module | None = None,
               prepare=None, val_batch_tensors=None, epoch_metrics=None,
               ckpt_manager=None, rebuild_fn=None, rebuild_scheduler=None,
               verbose: bool = False) -> list[dict]:
    """The retrieval trainers' epoch loop; returns one metrics dict per
    epoch run.

    Each epoch: the training batches in the seeded order
    (``seed + epoch``) under the epoch's dropout generator, each through
    ``train_step(epoch, *batch_tensors(batch)) -> {metric: value}``; the
    validation batches in order through ``eval_step(*val_batch_tensors(
    batch)) -> {metric: value}`` (``val_batch_tensors`` defaults to
    ``batch_tensors``); the means, which ``epoch_metrics(epoch, metrics)``
    may extend in place; a checkpoint (model, optimizer, step) and the
    best ``val_acc`` when a manager is given; then :func:`maybe_rebuild_db`
    with ``proj``. A finished async rebuild is drained at the end."""
    model = state.model
    history = []
    for epoch in range(start_epoch, train_cfg.num_epochs):
        set_dropout_generator(model, dropout_generator(seed, epoch, device))
        m = MetricAverager()
        for batch in batch_iterator(train_items, train_cfg.batch_size,
                                    seed=seed + epoch):
            metrics = train_step(epoch, *batch_tensors(batch))
            state.step += 1
            m.update(**metrics)
        set_dropout_generator(model, None)

        for batch in batch_iterator(val_items, train_cfg.batch_size,
                                    shuffle=False, drop_remainder=False):
            m.update(**eval_step(*(val_batch_tensors or batch_tensors)(
                batch)))

        metrics = m.result()
        if epoch_metrics is not None:
            epoch_metrics(epoch, metrics)
        history.append(metrics)
        if verbose:
            print(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items()))
        if ckpt_manager is not None:
            ckpt_manager.save(epoch, state.checkpoint(), metrics=metrics)
            ckpt_manager.maybe_update_best(epoch, metrics.get("val_acc", 0))
        maybe_rebuild_db(epoch, train_cfg, proj, device, prepare=prepare,
                         rebuild_fn=rebuild_fn,
                         rebuild_scheduler=rebuild_scheduler,
                         verbose=verbose)
    finish_rebuilds(rebuild_scheduler)
    return history
