"""The multi-process layer (parallel/distributed.py) against the JAX
package's: the single-process no-op, pod meshes' shapes and errors,
process_rows / shard_items, and a real two-process run over localhost on
torch.distributed's gloo backend (this file is also the worker: ``python
tests/test_torch_distributed.py PID NPROC PORT``), the counterpart of
tests/test_distributed.py's two-process DCN run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the two-process run's own limit, well inside a tier-1 file's minute
WORKER_TIMEOUT = 120


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    from vit_research_tpu.parallel import distributed as JD
    from vit_research_tpu_torch.parallel import distributed as D

    for key in ("VRT_COORDINATOR_ADDRESS", "VRT_NUM_PROCESSES",
                "VRT_PROCESS_ID", "VRT_AUTO_CLUSTER", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert D.initialize() is False and JD.initialize() is False
    monkeypatch.setenv("VRT_NUM_PROCESSES", "1")
    assert D.initialize() is False
    # auto with no torchrun world: still one process
    monkeypatch.setenv("VRT_AUTO_CLUSTER", "1")
    assert D.initialize() is False
    monkeypatch.setenv("VRT_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        D.initialize()
    assert D.process_count() == 1 and D.process_index() == 0


def test_pod_mesh_shapes_match_jax():
    from vit_research_tpu.parallel import distributed as JD
    from vit_research_tpu_torch.parallel import distributed as D

    cpus = ["cpu"] * 8
    for ici in ({"data": 4, "model": 2}, {"data": 8}):
        got = D.pod_mesh(ici=ici, devices=cpus)
        assert got.shape == dict(JD.pod_mesh(ici=ici).shape) == ici
        assert (got.processes == 0).all()
    got = D.pod_mesh(ici={"model": 8, "data": 1}, dcn={"data": 1},
                     devices=cpus)
    want = JD.pod_mesh(ici={"model": 8, "data": 1}, dcn={"data": 1})
    assert got.axis_names == tuple(want.axis_names) == ("model", "data")


def test_pod_mesh_errors_match_jax():
    from vit_research_tpu.parallel import distributed as JD
    from vit_research_tpu_torch.parallel import distributed as D

    for mod in (D, JD):
        with pytest.raises(ValueError, match="not in ici axes"):
            mod.pod_mesh(ici={"model": 8}, dcn={"bogus": 2}, devices=[])
        # a DCN axis of 2 needs two processes
        with pytest.raises(ValueError, match="did initialize"):
            mod.pod_mesh(ici={"data": 1, "model": 4}, dcn={"data": 2})
    with pytest.raises(ValueError, match="need 8 devices"):
        D.pod_mesh(ici={"data": 8}, devices=["cpu"] * 4)


def test_pod_mesh_defaults_to_the_cards(monkeypatch):
    """Without ``devices`` a pod mesh takes every visible card and raises
    where there is none (as parallel/mesh.py::make_mesh), never a silent
    CPU mesh; with CPU entries in ``devices`` it still has the JAX mesh's
    shape (conftest's 8 virtual devices)."""
    import torch

    from vit_research_tpu.parallel import distributed as JD
    from vit_research_tpu_torch.parallel import distributed as D

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices= \(e\.g\. \['cpu'\]"):
        D.pod_mesh(ici={"data": 1})
    with pytest.raises(RuntimeError, match="is_available"):
        D.pod_mesh(ici={"data": 4, "model": 2})
    assert D.pod_mesh(ici={"data": 1}, devices=["cpu"]).shape == {"data": 1}
    got = D.pod_mesh(ici={"data": 4, "model": 2}, devices=["cpu"] * 8)
    assert got.shape == dict(JD.pod_mesh(ici={"data": 4, "model": 2}).shape)
    assert {d.type for d in got.devices.ravel()} == {"cpu"}


def test_process_rows_and_shard_items_match_jax(monkeypatch):
    import jax

    from vit_research_tpu.parallel import distributed as JD
    from vit_research_tpu_torch.parallel import distributed as D

    assert D.process_rows(16) == JD.process_rows(16) == slice(0, 16)
    items = list(range(6))
    assert D.shard_items(items) == JD.shard_items(items) == items
    for n, pid in ((4, 2), (3, 0), (3, 2)):
        monkeypatch.setattr(D, "process_count", lambda: n)
        monkeypatch.setattr(D, "process_index", lambda: pid)
        monkeypatch.setattr(jax, "process_count", lambda: n)
        monkeypatch.setattr(jax, "process_index", lambda: pid)
        for m in (12, 16):
            if m % n == 0:
                assert D.process_rows(m) == JD.process_rows(m)
            else:
                for mod in (D, JD):
                    with pytest.raises(ValueError, match="not divisible"):
                        mod.process_rows(m)
        for length in (0, 5, 7, 10):
            assert D.shard_items(list(range(length))) == \
                JD.shard_items(list(range(length)))


def test_global_batch_and_gather_in_one_process():
    from vit_research_tpu_torch.parallel import distributed as D

    mesh = D.pod_mesh(ici={"data": 8}, devices=["cpu"] * 8)
    full = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    gb = D.global_batch(mesh, full[D.process_rows(32)])
    assert tuple(gb.shape) == (32, 4) and gb.device.type == "cpu"
    np.testing.assert_array_equal(D.all_gather_to_hosts(gb), full)
    D.barrier("single")  # a no-op, must not hang


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_run_over_localhost():
    """Two OS processes joined by initialize over localhost (gloo): the
    pod mesh with its process axis outermost, each process's rows on its
    device, the global batch gathered back on both, a mean across
    processes, shard_items, and the barrier."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for key in ("VRT_COORDINATOR_ADDRESS", "VRT_NUM_PROCESSES",
                "VRT_PROCESS_ID", "VRT_AUTO_CLUSTER"):
        env.pop(key, None)
    workers = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), "2",
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for pid in range(2)]
    outs = []
    try:
        for w in workers:
            out, _ = w.communicate(timeout=WORKER_TIMEOUT)
            outs.append(out)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    for pid, (w, out) in enumerate(zip(workers, outs)):
        assert w.returncode == 0, f"worker{pid} failed:\n{out}"
        assert f"WORKER{pid} OK" in out


def _worker(pid: int, nproc: int, port: str) -> None:
    """One process of the two-process run: 4 CPU entries a process."""
    import torch

    from vit_research_tpu_torch.parallel import distributed as D

    torch.set_num_threads(1)
    assert D.initialize(f"localhost:{port}", nproc, pid)
    assert D.process_count() == nproc and D.process_index() == pid
    # data parallel across the processes, a 4-wide model axis in each
    mesh = D.pod_mesh(ici={"data": 1, "model": 4},
                      dcn={"data": nproc}, devices=["cpu"] * 4)
    assert mesh.shape == {"data": nproc, "model": 4}
    assert (mesh.processes == np.arange(nproc)[:, None]).all()
    n_global = 16
    full = np.arange(n_global * 8, dtype=np.float32).reshape(n_global, 8)
    local = full[D.process_rows(n_global)]
    assert local.shape == (n_global // nproc, 8)
    gb = D.global_batch(mesh, local)
    assert gb.device.type == "cpu" and tuple(gb.shape) == local.shape
    np.testing.assert_array_equal(D.all_gather_to_hosts(gb), full)
    # a mean across processes: each process's sum, reduced over the group
    part = gb.sum(dim=0)
    torch.distributed.all_reduce(part)
    np.testing.assert_allclose(part.numpy() / n_global, full.mean(0),
                               rtol=1e-6)
    items = [f"frame{i}" for i in range(n_global)]
    assert D.shard_items(items) == items[pid * 8:(pid + 1) * 8]
    D.barrier("gloo-test")
    torch.distributed.destroy_process_group()
    print(f"WORKER{pid} OK", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
