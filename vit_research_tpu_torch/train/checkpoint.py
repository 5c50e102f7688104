"""Run checkpoints and portable parameter files.

Port of vit_research_tpu/train/checkpoint.py.

:class:`CheckpointManager` has the JAX manager's API and retention policy
(the newest ``max_to_keep`` steps, plus the best by metric, plus every
``keep_period``-th step) and writes its ``best.json``, ``metrics.jsonl``,
``metrics_<step>.json`` and ``config.json`` in the same format. The step
files themselves are the port's own: ``step_<N>.pt``, one ``torch.save``
of the state dict (the model's ``state_dict`` under ``"params"``, the
optimizer's under ``"opt_state"``, the ``"step"``), written to a temporary
name and renamed, and read back with ``torch.load(weights_only=True)`` on
the CPU. The JAX package writes Orbax step directories, which need jax
and orbax to read; a run directory holding them is refused with a
``ValueError`` that names the format, never read as an empty run.

The npz half: a parameter tree (nested dicts of arrays) saves as one flat
``.npz`` whose keys are the tree paths joined by ``/``
(``params/fc1/kernel``, ...), the format the JAX package's
``save_params_npz`` writes, so a file saved by either package loads in
the other. models/convert.py maps such trees onto the port's modules.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from vit_research_tpu_torch.utils.metrics import MetricsLogger

_STEP_RE = re.compile(r"^step_(\d+)\.pt$")


def _orbax_steps(directory: str) -> list:
    """Names of the Orbax step directories under ``directory`` (an
    integer name, or a ``_CHECKPOINT_METADATA`` file inside)."""
    found = []
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if os.path.isdir(path) and (name.isdigit() or os.path.exists(
                os.path.join(path, "_CHECKPOINT_METADATA"))):
            found.append(name)
    return found


class CheckpointManager:
    """Run checkpoints under ``directory/run_id`` with a retention policy:
    keep the newest ``max_to_keep`` steps (resume), plus the best-by-metric
    step (evaluation), plus every ``keep_period``-th step (archival), so
    the best checkpoint is never swept away from under
    :meth:`restore_best`. Saves are synchronous; :meth:`wait` is there for
    the JAX manager's API.

    Raises ValueError if the run directory holds the JAX package's Orbax
    checkpoints."""

    def __init__(self, directory: str, run_id: str, max_to_keep: int = 5,
                 keep_period: int | None = None):
        self.dir = os.path.abspath(os.path.join(directory, run_id))
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        os.makedirs(self.dir, exist_ok=True)
        orbax = _orbax_steps(self.dir)
        if orbax:
            raise ValueError(
                f"{self.dir} holds Orbax checkpoint directories "
                f"({', '.join(orbax[:4])}) written by the JAX package "
                "(vit_research_tpu); the port reads only its own torch.save "
                "step files (step_<N>.pt) and cannot restore Orbax "
                "checkpoints: train the run with the port, or convert the "
                "params with models/convert.py")
        self.metrics_log = MetricsLogger(
            os.path.join(self.dir, "metrics.jsonl"))
        self._best_metric = -np.inf
        self._best_step = None
        best = os.path.join(self.dir, "best.json")
        if os.path.exists(best):  # resume best-tracking across restarts
            try:
                with open(best) as f:
                    prev = json.load(f)
                self._best_metric = float(prev["metric"])
                self._best_step = int(prev["step"])
            except (ValueError, KeyError):
                pass  # torn write from a crash; tracking restarts

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{int(step)}.pt")

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for name in os.listdir(self.dir)
                      if (m := _STEP_RE.match(name)))

    def save(self, step: int, state: Any, *, metrics: dict | None = None,
             config_json: str | None = None) -> None:
        """Write ``state`` (tensors, numbers, lists and dicts of them) as
        step ``step``, then ``config.json`` and the metrics files if
        given, then apply the retention policy."""
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        if config_json is not None:
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                f.write(config_json)
        if metrics:
            with open(os.path.join(self.dir, f"metrics_{step}.json"),
                      "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f)
            self.metrics_log.log(step, metrics)
        self._sweep()

    def maybe_update_best(self, step: int, metric: float) -> bool:
        """Track the best step by metric (higher is better); writes
        ``best.json`` atomically when it moves."""
        if metric > self._best_metric:
            self._best_metric = metric
            self._best_step = step
            path = os.path.join(self.dir, "best.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "metric": float(metric)}, f)
            os.replace(tmp, path)
            return True
        return False

    @property
    def best(self):
        """(step, metric) of the best checkpoint, or (None, -inf)."""
        return self._best_step, self._best_metric

    def _sweep(self) -> None:
        steps = self.all_steps()
        if self.max_to_keep is None or len(steps) <= self.max_to_keep:
            return
        keep = set(steps[-self.max_to_keep:])
        if self._best_step is not None:
            keep.add(self._best_step)
        if self.keep_period:
            keep.update(s for s in steps if s % self.keep_period == 0)
        for s in steps:
            if s not in keep:
                os.unlink(self._path(s))
                metrics_file = os.path.join(self.dir, f"metrics_{s}.json")
                if os.path.exists(metrics_file):
                    os.unlink(metrics_file)

    def restore(self, step: int | None = None, template: Any = None) -> Any:
        """The state saved at ``step`` (default: the latest), on the CPU,
        or None if there is none. With a ``template`` dict, the restored
        dict must have its keys (ValueError otherwise)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        if template is not None and isinstance(template, dict):
            missing = set(template) - set(state)
            if missing:
                raise ValueError(f"step {step} of {self.dir} lacks "
                                 f"{sorted(missing)}")
        return state

    def restore_best(self, template: Any = None) -> Any:
        """The best step's state (``best.json``), else the latest's."""
        best = os.path.join(self.dir, "best.json")
        if os.path.exists(best):
            try:
                with open(best) as f:
                    step = json.load(f)["step"]
            except (ValueError, KeyError):
                step = None  # torn write: fall back to the latest
            if step is not None:
                return self.restore(step, template)
        return self.restore(template=template)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            out.update(_flatten(tree[key], path + "/"))
        else:
            out[path] = np.asarray(tree[key])
    return out


def save_params_npz(params: dict, path: str) -> None:
    """Flat ``.npz`` export of a nested parameter dict (keys sorted, as a
    JAX tree flattens them)."""
    np.savez(path, **_flatten(params))


def load_params_npz(template, path: str) -> dict:
    """Restore a nested parameter dict saved by :func:`save_params_npz`
    (by either package). With a ``template`` tree, every one of its leaves
    must be present with the same shape (else ValueError); without one,
    the tree is rebuilt from the file's keys."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if template is not None:
        for key, leaf in _flatten(template).items():
            if key not in flat:
                raise ValueError(f"{path} has no parameter {key}")
            if flat[key].shape != np.shape(leaf):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{flat[key].shape} vs {np.shape(leaf)}")
        flat = {k: flat[k] for k in _flatten(template)}
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree
