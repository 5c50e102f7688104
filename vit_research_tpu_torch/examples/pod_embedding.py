"""Multi-process frame embedding: the pod version of the embedding engine.

Port of examples/pod_embedding.py, on parallel/distributed.py: each
process embeds only its shard of the frame list on its device, and the
embeddings are gathered to every process (process 0 would write the
FrameStore or the vector store). Runs on one machine by starting two
worker processes joined over localhost:

    python -m vit_research_tpu_torch.examples.pod_embedding
    python -m vit_research_tpu_torch.examples.pod_embedding --tiny \\
        --device cpu

On one card both processes embed on that card and join over gloo:
NCCL refuses two ranks on one GPU. On a machine with a card per process,
launch one process per card with ``VRT_COORDINATOR_ADDRESS`` /
``VRT_NUM_PROCESSES`` / ``VRT_PROCESS_ID`` set (or under torchrun with
``VRT_AUTO_CLUSTER=1``), and the default backend, NCCL, takes over.
The default is the seeded ViT-B/16 @224 on 224 x 224 frames; ``--tiny``
the JAX walkthrough's 1-layer 32-wide test ViT.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.examples import _engines

N_FRAMES = 96
N_PROCESSES = 2
#: a worker's limit, seconds (model build, kernel load and 48 frames)
WORKER_TIMEOUT = 600


def make_frames(tiny: bool) -> np.ndarray:
    """The seeded (96, H, W, 3) uint8 frame list all processes share."""
    h, w = _engines.TINY_FRAME_SIZE if tiny else _engines.FULL_FRAME_SIZE
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(N_FRAMES, h, w, 3), dtype=np.uint8)


def build_engine(device, tiny: bool):
    return _engines.build_engine(
        device, tiny=_engines.tiny_vit(32, 1) if tiny else None,
        batch_size=16 if tiny else 64)


def worker(pid: int, nproc: int, port: int, device: str, tiny: bool,
           out: str | None) -> None:
    """One process: join the group, embed this process's shard, gather
    every shard; process 0 saves the gathered rows to ``out``."""
    import torch

    from vit_research_tpu_torch import parallel as par

    dev = resolve_device(device)
    ids = [dev.index or 0] if dev.type == "cuda" else None
    par.initialize(f"localhost:{port}", nproc, pid, local_device_ids=ids,
                   backend="gloo")
    try:
        mesh = par.pod_mesh(ici={"data": 1}, dcn={"data": nproc},
                            devices=[dev])
        eng = build_engine(dev, tiny)
        frames = make_frames(tiny)
        mine = par.shard_items(list(range(len(frames))))
        local_emb = eng.embed_batch(frames[mine])  # this process's rows
        # every process ends up with the full matrix; process 0 persists
        full = par.all_gather_to_hosts(
            par.global_batch(mesh, local_emb.astype(np.float32)))
        par.barrier("embed-done")
        print(f"[process {pid}] embedded {len(mine)} frames on {dev}, "
              f"gathered {full.shape} total", flush=True)
        if pid == 0 and out:
            np.save(out, full)
            print(f"[process 0] would now FrameStore.build / upsert "
                  f"{len(full)} embeddings", flush=True)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> dict:
    """Start the two workers and wait for them; returns the gathered
    (96, D) embeddings and the frames they embedded."""
    import vit_research_tpu_torch

    ap = _engines.parser(__doc__)
    ap.add_argument("--worker", nargs=3, type=int, default=None,
                    metavar=("PID", "NPROC", "PORT"),
                    help="run as one worker (what main starts)")
    ap.add_argument("--out", default=None,
                    help="where process 0 saves the gathered rows (.npy)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.worker:
        worker(*args.worker, args.device, args.tiny, args.out)
        return {}
    out = args.out or os.path.join(tempfile.mkdtemp(prefix="vrt_pod_"),
                                   "gathered.npy")
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(vit_research_tpu_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    for key in ("VRT_COORDINATOR_ADDRESS", "VRT_NUM_PROCESSES",
                "VRT_PROCESS_ID", "VRT_AUTO_CLUSTER"):
        env.pop(key, None)
    port = _free_port()
    cmd = [sys.executable, "-m", "vit_research_tpu_torch.examples."
           "pod_embedding", "--device", args.device, "--out", out]
    if args.tiny:
        cmd.append("--tiny")
    procs = [subprocess.Popen(cmd + ["--worker", str(p), str(N_PROCESSES),
                                     str(port)], env=env)
             for p in range(N_PROCESSES)]
    try:
        rc = [p.wait(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    # signal deaths are negative return codes: max() would mask them
    if any(rc):
        raise RuntimeError(f"pod workers exited with {rc}")
    return {"gathered": np.load(out), "frames": make_frames(args.tiny)}


if __name__ == "__main__":
    main(sys.argv[1:])
