"""Multi-process execution on ``torch.distributed``: the bootstrap, hybrid
meshes, and this process's rows of a global batch.

Port of vit_research_tpu/parallel/distributed.py. The reference runs one
JAX controller per host over ``jax.distributed``; here each process is
one rank of a ``torch.distributed`` process group (gloo on the CPU, NCCL
on CUDA) and drives its own devices:

- :func:`initialize`: the process group from arguments or the
  ``VRT_COORDINATOR_ADDRESS`` / ``VRT_NUM_PROCESSES`` / ``VRT_PROCESS_ID``
  env vars; under ``auto=True`` or ``VRT_AUTO_CLUSTER`` it reads
  torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` (the counterpart of JAX's cluster auto-detection). A
  single process is a no-op that returns False, so every entry point can
  call it;
- :func:`pod_mesh`: a mesh whose cross-process (DCN) axes are outermost,
  the slowest-varying, with the reference's ValueErrors; ``mesh.processes``
  says which rank drives each entry;
- :func:`process_rows` / :func:`shard_items`: this process's part of a
  batch or of a work list;
- :func:`global_batch`: this process's rows on its first device of the
  mesh (the reference's globally-sharded array is, per process, exactly
  these rows);
- :func:`all_gather_to_hosts`: every process's rows, in rank order, as
  one numpy array on every process;
- :func:`barrier`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from vit_research_tpu_torch.parallel.mesh import Mesh, canonical_device

_ENV_COORD = "VRT_COORDINATOR_ADDRESS"
_ENV_NPROC = "VRT_NUM_PROCESSES"
_ENV_PID = "VRT_PROCESS_ID"


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, auto: bool = False,
               backend: str | None = None) -> bool:
    """Join the process group when running multi-process.

    Arguments fall back to the ``VRT_*`` env vars above; the coordinator
    is ``host:port`` of rank 0's TCP store. ``auto=True`` (or
    ``VRT_AUTO_CLUSTER=1``) with no explicit configuration takes
    torchrun's env. ``local_device_ids`` pins this process's card (first
    entry) on CUDA; by default rank % visible cards. ``backend``: the
    process group's, by default NCCL with a card and gloo without; gloo
    also serves several processes on one card, which NCCL refuses.
    Returns True when a multi-process group was joined, False for the
    single-process no-op.
    """
    backend = backend or _backend()
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and os.environ.get(_ENV_NPROC):
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    if coordinator_address is None and num_processes in (None, 1):
        env_auto = os.environ.get("VRT_AUTO_CLUSTER", "").strip().lower()
        if (auto or env_auto not in ("", "0", "false", "no", "off")) \
                and int(os.environ.get("WORLD_SIZE", "1")) > 1:
            _pin_device(int(os.environ["RANK"]), local_device_ids)
            dist.init_process_group(backend, init_method="env://")
            return dist.get_world_size() > 1
        return False  # single process, nothing to do
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator "
                         "address, the process count and this process's "
                         "id (arguments or VRT_* env vars)")
    _pin_device(process_id, local_device_ids)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _pin_device(rank: int, local_device_ids) -> None:
    """On CUDA, this process's card: NCCL's collectives run on it."""
    if torch.cuda.is_available():
        ids = list(local_device_ids) if local_device_ids else None
        torch.cuda.set_device(ids[0] if ids else
                              rank % torch.cuda.device_count())


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_devices() -> list:
    """This process's devices: every visible card, else the CPU."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def pod_mesh(ici: dict[str, int], dcn: dict[str, int] | None = None,
             *, devices=None) -> Mesh:
    """Hybrid mesh: ``ici`` gives each axis's size over this process's
    ``devices`` (default: every visible card, as :func:`local_devices`;
    entries may repeat; without a card and without ``devices`` it raises
    RuntimeError, as ``parallel/mesh.py::make_mesh`` does);
    ``dcn`` the axes that also span processes. Axis order is ``ici``'s
    with the process-spanning axes moved outermost, and along such an
    axis the process index varies slowest (rank-major), so collectives
    on the outer axis cross processes once.

    Example (2 processes x 4 cards, data-parallel across processes)::

        mesh = pod_mesh(ici={"data": 1, "model": 4}, dcn={"data": 2})
        # mesh axes: data=2 (across processes), model=4 (inside one)

    ``mesh.processes`` holds the rank of every entry; a process drives
    only its own."""
    dcn = dict(dcn or {})
    unknown = set(dcn) - set(ici)
    if unknown:
        raise ValueError(f"dcn axes {sorted(unknown)} not in ici axes "
                         f"{sorted(ici)} (use ici={{axis: 1}} for "
                         "DCN-only axes)")
    names = ([a for a in ici if dcn.get(a, 1) > 1]
             + [a for a in ici if dcn.get(a, 1) <= 1])
    ici_shape = [ici[a] for a in names]
    dcn_shape = [dcn.get(a, 1) for a in names]
    need_procs = int(np.prod(dcn_shape))
    n_procs = process_count()
    if need_procs > 1 and n_procs != need_procs:
        raise ValueError(
            f"dcn axes need {need_procs} slices/hosts but the runtime sees "
            f"1 slice(s) across {n_procs} process(es) — did initialize() "
            "run on every host?")
    if devices is None and not torch.cuda.is_available():
        raise RuntimeError(
            "pod_mesh() without devices needs CUDA devices, and "
            "torch.cuda.is_available() is False; pass devices= (e.g. "
            "['cpu'] * n) for a CPU mesh")
    devs = list(devices) if devices is not None else local_devices()
    n_local = int(np.prod(ici_shape))
    if len(devs) < n_local:
        raise ValueError(f"ici axes {dict(zip(names, ici_shape))} need "
                         f"{n_local} devices per process, have {len(devs)}")
    local = np.empty(n_local, dtype=object)
    local[:] = [canonical_device(d) for d in devs[:n_local]]
    # (dcn..., ici...) -> interleave each axis's process and local index,
    # the process index outermost: axis size dcn[a] * ici[a]
    n = len(names)
    grid = np.empty((*dcn_shape, *ici_shape), dtype=object)
    ranks = np.empty(grid.shape, dtype=np.int64)
    local = local.reshape(ici_shape)
    for p in np.ndindex(*dcn_shape):
        rank = int(np.ravel_multi_index(p, dcn_shape))
        for i in np.ndindex(*ici_shape):
            grid[p + i] = local[i]
            ranks[p + i] = rank
    order = [ax for a in range(n) for ax in (a, n + a)]
    shape = [d * i for d, i in zip(dcn_shape, ici_shape)]
    return Mesh(grid.transpose(order).reshape(shape), names,
                processes=ranks.transpose(order).reshape(shape))


def process_rows(n_global: int) -> slice:
    """This process's contiguous rows of a global batch. ``n_global``
    must divide by the process count (keep global batches a multiple of
    processes x local devices)."""
    np_, pid = process_count(), process_index()
    if n_global % np_:
        raise ValueError(f"global batch {n_global} not divisible by "
                         f"{np_} processes")
    per = n_global // np_
    return slice(pid * per, (pid + 1) * per)


def shard_items(items) -> list:
    """This process's part of a work list (e.g. frame paths), split as
    evenly as possible: the first ``n % processes`` take one more."""
    n, np_, pid = len(items), process_count(), process_index()
    base, rem = divmod(n, np_)
    start = pid * base + min(pid, rem)
    return list(items[start:start + base + (1 if pid < rem else 0)])


def global_batch(mesh: Mesh, local_data) -> torch.Tensor:
    """This process's rows of a global batch (its :func:`process_rows`
    slice) as a tensor on its first device of ``mesh``: each process
    loads only its rows, and no process holds another's."""
    mine = (mesh.devices.flat if mesh.processes is None else
            mesh.devices[mesh.processes == process_index()].flat)
    return torch.as_tensor(np.asarray(local_data)).to(next(iter(mine)))


def all_gather_to_hosts(x) -> np.ndarray:
    """Every process's ``x`` (this process's rows), concatenated in rank
    order along dim 0, as numpy on every process. One process: ``x``
    itself."""
    local = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x))
    if process_count() == 1:
        return local
    parts = [None] * process_count()
    dist.all_gather_object(parts, local)
    return np.concatenate(parts, axis=0)


def barrier(name: str = "vrt") -> None:
    """Cross-process sync point (checkpoint commits, DB swaps); a no-op
    in one process. ``name`` labels the call site for a reader."""
    del name
    if process_count() > 1:
        dist.barrier()
