"""Portable parameter files.

Port of the npz half of vit_research_tpu/train/checkpoint.py: a parameter
tree (nested dicts of arrays) saves as one flat ``.npz`` whose keys are
the tree paths joined by ``/`` (``params/fc1/kernel``, ...), the format
the JAX package's ``save_params_npz`` writes, so a file saved by either
package loads in the other. models/convert.py maps such trees onto the
port's modules. The run checkpoints (optimizer state, retention) come
with training.
"""

from __future__ import annotations

import numpy as np


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
