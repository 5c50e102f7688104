"""Device meshes and placement rules.

Port of vit_research_tpu/parallel/mesh.py. The reference's mesh is JAX's
single-controller ``Mesh``: one process drives every device, and a
``NamedSharding`` says how an array is laid out over the mesh's named
axes. The counterpart here is one process over several ``torch.device``s:

- :class:`Mesh`: named axes over an array of devices (``mesh.shape``,
  ``mesh.axis_names``, ``mesh.devices``, as JAX's);
- :func:`make_mesh`: by default every visible CUDA device on one
  ``data`` axis;
- :func:`data_sharding` / :func:`replicated`: placement descriptions
  (:class:`Sharding`: the mesh and, per array dim, the axis it is split
  over or None), read by the code that places tensors
  (ops/sharded_topk.py, parallel/embed.py);
- :func:`pad_to_multiple`.

An explicit device list may name a device more than once: a mesh of
four entries on ``cuda:0`` runs every shard's work on the one card (the
sharded code paths, on one chip), and a mesh of eight ``cpu`` entries is
what the CPU tests use where the JAX tests use eight virtual CPU devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device


def canonical_device(device) -> torch.device:
    """``resolve_device`` with the current card's index filled in for a
    bare ``'cuda'``, so that a device compares equal to the ``.device``
    of the tensors placed on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Named axes over an n-d array of ``torch.device``s (entries may
    repeat). ``shape`` maps each axis name to its size, in order.
    ``processes``: for a mesh across processes
    (parallel/distributed.py::pod_mesh), the rank that drives each
    entry; None when this process drives them all."""

    def __init__(self, devices, axis_names, processes=None):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = canonical_device(np.asarray(devices, object)[idx])
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        if processes is not None and np.shape(processes) != arr.shape:
            raise ValueError(f"processes of shape {np.shape(processes)} "
                             f"for a mesh of shape {arr.shape}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self.processes = (None if processes is None
                          else np.asarray(processes, np.int64))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, at index 0 of every other axis:
        where the shards of an array split over ``axis`` live (each shard
        is replicated over the other axes; index 0 computes it)."""
        pos = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[pos] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies on a mesh: ``spec[i]`` is the mesh axis that
    array dim ``i`` is split over, or None (replicated along it); dims
    past ``len(spec)`` are replicated. ``spec == ()``: fully
    replicated."""

    mesh: Mesh
    spec: tuple = ()


def make_mesh(shape: tuple | None = None, axes: tuple = ("data",),
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device). The
    default shape puts them all on the first axis. Raises ValueError when
    the shape needs more devices than there are, RuntimeError when no
    devices are given and there is no card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() without devices needs CUDA devices, and "
                "torch.cuda.is_available() is False; pass devices= (e.g. "
                "['cpu'] * 8) for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axes) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.empty(len(devices[:n]), dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(shape), axes)


def data_sharding(mesh: Mesh, ndim: int = 1,
                  axis: str = "data") -> Sharding:
    """Dim 0 split over ``axis``, the rest replicated."""
    return Sharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
