"""Optimizers, schedules, accumulation.

Port of vit_research_tpu/train/optim.py. The JAX package composes optax
transformations; here one :class:`Optimizer` runs the same chain on a list
of parameter tensors, so that the two packages take the same steps:

- optional gradient accumulation (``optax.MultiSteps``: the running mean
  of ``accum_steps`` micro-batch gradients, one update per cycle);
- clipping: per tensor (:func:`clip_each_by_norm`, ``tf.clip_by_norm`` on
  each gradient, the stage-1 rule) or by the global norm
  (:func:`clip_by_global_norm`, ``optax.clip_by_global_norm``);
- ``torch.optim.AdamW`` (fused) with the keras epsilon 1e-7: the update
  of optax's ``scale_by_adam``, ``add_decayed_weights`` and
  ``scale_by_learning_rate``;
- the learning rate a constant or a schedule of the update count
  (:func:`two_phase_schedule`, ``optax.join_schedules``).

:func:`make_optimizer` builds the retrieval trainers' optimizer from a
``TrainConfig``, with the phase boundary in accumulated-update units.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vit_research_tpu_torch.utils.configs import TrainConfig


def _norms(grads: list) -> torch.Tensor:
    """Each gradient's L2 norm, stacked: one fused launch for the list."""
    return torch.stack(torch._foreach_norm(grads))


def clip_each_by_norm(grads: list, max_norm: float) -> list:
    """Each gradient scaled by ``min(1, max_norm / max(||g||, 1e-20))``
    independently (``tf.clip_by_norm`` per tensor), as opposed to
    :func:`clip_by_global_norm`, which couples all through one factor."""
    if not grads:
        return []
    scale = torch.clamp(max_norm / torch.clamp(_norms(grads), min=1e-20),
                        max=1.0)
    return list(torch._foreach_mul(grads, list(scale.unbind())))


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """Gradients unchanged while their global norm is below ``max_norm``,
    else each as ``(g / norm) * max_norm``."""
    if not grads:
        return []
    norm = torch.linalg.vector_norm(_norms(grads))
    if bool(norm < max_norm):
        return list(grads)
    return list(torch._foreach_mul(torch._foreach_div(grads, norm),
                                   max_norm))


def _join(lr1: float, lr2: float, boundary: int) -> Callable[[int], float]:
    """``lr1`` for update counts below ``boundary``, ``lr2`` from there
    (``optax.join_schedules`` of two constants)."""
    return lambda count: lr1 if count < boundary else lr2


def two_phase_schedule(lr1: float, lr2: float, total_steps: int,
                       split: float = 0.5) -> Callable[[int], float]:
    """``lr1`` for update counts below ``max(int(total_steps * split), 1)``,
    ``lr2`` from there."""
    return _join(lr1, lr2, max(int(total_steps * split), 1))


def phase1_epoch_count(cfg: TrainConfig) -> int:
    """Whole epochs trained at phase-1 settings: the one source of the
    phase boundary, for the LR (:func:`make_optimizer`) and the loops'
    contrastive coefficient alike."""
    return max(int(cfg.num_epochs * cfg.phase_split), 1)


class Optimizer:
    """accumulate -> clip -> ``torch.optim.AdamW`` over ``params`` (a list
    of tensors, updated in place by :meth:`step`).

    AdamW decays from the pre-step parameter and divides the bias-corrected
    first moment by ``sqrt(nu_hat) + eps``: the update of optax's
    ``scale_by_adam`` -> ``add_decayed_weights`` ->
    ``scale_by_learning_rate``. Its decay rates are the float32 values of
    0.9 and 0.999, the ones optax multiplies by (a Python float meets a
    float32 array as float32), so the bias corrections agree too.

    Args:
      params: the parameters, in a fixed order (``model.parameters()``).
      lr: a float, or a schedule: the update count (0 for the first
        update) -> the learning rate.
      clip: None, ``("each", max_norm)`` or ``("global", max_norm)``.
      weight_decay: decoupled weight decay (0: plain Adam).
      eps: Adam's epsilon (1e-7: keras Adam's).
      accum_steps: micro-batches per update (1: every step updates).
    """

    betas = (float(np.float32(0.9)), float(np.float32(0.999)))

    def __init__(self, params, *, lr, clip=None, weight_decay: float = 0.0,
                 eps: float = 1e-7, accum_steps: int = 1):
        self.params = list(params)
        if clip is not None and clip[0] not in ("each", "global"):
            raise ValueError(f"clip must be None, ('each', v) or "
                             f"('global', v), got {clip!r}")
        self.lr = lr
        self.clip = clip
        self.accum_steps = max(int(accum_steps or 1), 1)
        self.count = 0  # updates applied
        self.mini_step = 0  # micro-batches accumulated in this cycle
        self.acc = [torch.zeros_like(p) for p in self.params] \
            if self.accum_steps > 1 else []
        self.adam = torch.optim.AdamW(
            self.params, lr=self.lr_at(0), betas=self.betas, eps=eps,
            weight_decay=weight_decay, fused=True)

    def lr_at(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def step(self, grads) -> bool:
        """Take one micro-batch's gradients (one per parameter, in order).
        Returns True when the parameters were updated (every call without
        accumulation, the last micro-batch of a cycle with it)."""
        grads = list(grads)
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        if self.accum_steps > 1:
            # the running mean acc + (g - acc) / (n + 1)
            n = self.mini_step
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, n + 1)
            torch._foreach_add_(self.acc, delta)
            if n < self.accum_steps - 1:
                self.mini_step += 1
                return False
            grads, self.mini_step = self.acc, 0
            self.acc = [torch.zeros_like(p) for p in self.params]
        if self.clip is not None:
            kind, max_norm = self.clip
            grads = (clip_each_by_norm if kind == "each"
                     else clip_by_global_norm)(grads, max_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.param_groups[0]["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "acc": list(self.acc), "adam": self.adam.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s dict; raises ValueError if its
        moments do not match the parameters' count and shapes."""
        moments = state["adam"]["state"]
        shapes = [tuple(p.shape) for p in self.params]
        got = [[tuple(moments[i][k].shape) for i in sorted(moments)]
               for k in ("exp_avg", "exp_avg_sq")]
        if self.accum_steps > 1:
            got.append([tuple(t.shape) for t in state["acc"]])
        if any(g != shapes for g in got if g) or \
                len(state["adam"]["param_groups"][0]["params"]) \
                != len(self.params):
            raise ValueError("optimizer state does not match the "
                             "parameters")
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.adam.load_state_dict(state["adam"])
        if self.accum_steps > 1:
            self.acc = [t.to(p.device) for t, p in zip(state["acc"],
                                                       self.params)]


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int,
                   params) -> Optimizer:
    """Global-norm clip + Adam (AdamW with ``cfg.weight_decay``) + the
    two-phase LR + accumulation, from one ``TrainConfig``.

    ``steps_per_epoch`` counts micro-batches (what the loop iterates); the
    schedule advances once per ``accum_steps`` micro-batches, so the phase
    boundary, ``phase1_epoch_count`` whole epochs, is converted to
    accumulated-update units (otherwise phase 2 would never engage)."""
    accum = cfg.accum_steps if cfg.accum_steps and cfg.accum_steps > 1 else 1
    boundary = max(int(round(
        phase1_epoch_count(cfg) * steps_per_epoch / accum)), 1)
    return Optimizer(
        params, lr=_join(cfg.lr_phase1, cfg.lr_phase2, boundary),
        clip=("global", cfg.grad_clip_norm) if cfg.grad_clip_norm else None,
        weight_decay=cfg.weight_decay, eps=1e-7, accum_steps=accum)
