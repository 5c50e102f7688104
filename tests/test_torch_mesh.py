"""Meshes (parallel/mesh.py), the data-parallel embedding engine on a
mesh (parallel/embed.py ``mesh=``) and ``serve --shard-device`` through
the port's CLI, against the JAX package where it has the same function.

The CPU stands in for the cards: a mesh may name a device more than once,
so an 8-entry CPU mesh runs the sharded code paths where the JAX tests
use conftest's 8 virtual devices. Tolerances: embeddings 1e-5 (the same
f32 forward in other summation orders, per share of a batch); store
distances 1e-5.
"""

import contextlib
import json
import os
import shutil
import tempfile
import threading

import numpy as np
import pytest
import torch

from vit_research_tpu.data.preprocess import PreprocessSpec as JaxSpec
from vit_research_tpu.models import vit as jax_vit
from vit_research_tpu.parallel import embed as jax_embed
from vit_research_tpu.parallel import mesh as jax_mesh
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu_torch import cli, serve
from vit_research_tpu_torch.data import synthetic
from vit_research_tpu_torch.data.preprocess import PreprocessSpec
from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.models import vit as tvit
from vit_research_tpu_torch.parallel import embed, mesh
from vit_research_tpu_torch.utils.configs import ViTConfig

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 30.0
TINY = dict(image_size=(32, 32), patch_size=8, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128, use_flash_attention=False)


def test_make_mesh_shapes_and_placements():
    """make_mesh as JAX's: every device on 'data' by default, a given
    shape over the first devices, a ValueError when the shape needs more;
    data_sharding / replicated as specs; a bare 'cuda' needs a card."""
    m = mesh.make_mesh(devices=["cpu"] * 8)
    assert m.shape == {"data": 8} and m.axis_names == ("data",)
    assert m.shape == dict(jax_mesh.make_mesh().shape)
    m2 = mesh.make_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    assert m2.shape == dict(jax_mesh.make_mesh((4, 2),
                                               ("data", "model")).shape)
    assert m2.axis_devices("data") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        mesh.make_mesh((16,), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        jax_mesh.make_mesh((16,))
    assert mesh.data_sharding(m2, 3).spec == ("data", None, None)
    assert mesh.data_sharding(m2, 3, axis="model").spec[0] == "model"
    assert mesh.replicated(m2).spec == () and mesh.replicated(m2).mesh is m2
    assert mesh.pad_to_multiple(5, 4) == jax_mesh.pad_to_multiple(5, 4) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            mesh.make_mesh()
    with pytest.raises(ValueError, match="axis names"):
        mesh.Mesh(np.full((2, 2), "cpu", dtype=object), ("data",))


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, params, port model) with equal weights."""
    jcfg = jax_configs.ViTConfig(**TINY)
    model, params = jax_vit.init_vit(jcfg, seed=0)
    tcfg = ViTConfig(**TINY)
    tm = tvit.VisionTransformer(tcfg)
    tm.load_state_dict(convert.params_to_state_dict(params, tcfg))
    return model, params, tm.eval()


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(n, 32, 32, 3), dtype=np.uint8)


def test_mesh_engine_equals_single_device_engine_and_jax(tiny):
    """The mesh engine (8-entry CPU mesh; 2-entry too) against the
    single-device engine and the JAX engine on JAX's 8-device mesh:
    the batch size padded to the data axis, a batch split into one share
    a device (ragged tails at their true size), the outputs in order, and
    the (N, D) contract at N = 0."""
    model, params, tm = tiny
    spec = PreprocessSpec(size=(32, 32))
    single = embed.EmbeddingEngine(tm, spec, device="cpu", batch_size=5)
    m8 = mesh.make_mesh(devices=["cpu"] * 8)
    eng = embed.EmbeddingEngine(tm, spec, mesh=m8, batch_size=5)
    assert eng.batch_size == 8 and eng.device == torch.device("cpu")
    assert list(eng.replicas) == [torch.device("cpu")]  # one a device
    jeng = jax_embed.EmbeddingEngine(model, params, JaxSpec(size=(32, 32)),
                                     mesh=jax_mesh.make_mesh(), batch_size=5,
                                     use_fused_patch_embed=False)
    assert jeng.batch_size == eng.batch_size
    frames = _frames(19)
    shares = []
    orig = eng._forward
    eng._forward = lambda x: (shares.append(len(x)), orig(x))[1]
    got = eng.embed_batch(frames)
    assert shares == [1] * 8 + [1] * 8 + [1] * 3  # 8 + 8 + a tail of 3
    np.testing.assert_allclose(got, single.embed_batch(frames), **TOL)
    np.testing.assert_allclose(got, jeng.embed_batch(frames), **TOL)
    m2 = mesh.make_mesh(devices=["cpu"] * 2)
    eng2 = embed.EmbeddingEngine(tm, spec, mesh=m2, batch_size=5)
    shares.clear()
    orig2 = eng2._forward
    eng2._forward = lambda x: (shares.append(len(x)), orig2(x))[1]
    np.testing.assert_allclose(eng2.embed_batch(frames[:11]),
                               single.embed_batch(frames[:11]), **TOL)
    assert shares == [3, 3, 3, 2]  # 6 = 3 + 3, then the tail 5 = 3 + 2
    empty = eng.embed_batch(frames[:0])
    assert empty.shape == (0, 64) and empty.dtype == np.float32
    for kw in ({}, dict(device="cpu", mesh=m2)):
        with pytest.raises(TypeError, match="a device or a mesh"):
            embed.EmbeddingEngine(tm, spec, **kw)


# ------------------------------------------------------------- the daemon

SEGMENTS = [("none", 4), ("left", 30), ("none", 4), ("right", 30),
            ("none", 4)]


class _Daemons:
    """Records each EmbedServer the CLI builds and sets an event when its
    socket is bound and serving (the server's own ``ready_event``)."""

    def __init__(self, monkeypatch):
        self.servers, self.ready = {}, {}
        outer, base = self, serve.EmbedServer.serve

        def serve_and_announce(srv, socket_path, *, ready_event=None):
            outer.servers[socket_path] = srv
            event = outer.ready.setdefault(socket_path, threading.Event())
            return base(srv, socket_path, ready_event=event)

        monkeypatch.setattr(serve.EmbedServer, "serve", serve_and_announce)

    @contextlib.contextmanager
    def run(self, argv):
        sock = argv[argv.index("--socket") + 1]
        self.ready.setdefault(sock, threading.Event())
        t = threading.Thread(target=cli.main, args=(argv,), daemon=True)
        t.start()
        try:
            assert self.ready[sock].wait(TIMEOUT), "daemon never served"
            yield self.servers[sock]
        finally:
            serve.request(sock, {"op": "shutdown"}, timeout=TIMEOUT)
            t.join(timeout=TIMEOUT)
            assert not t.is_alive(), "serve thread did not exit"


@pytest.fixture
def world(monkeypatch):
    """The verify skill's synthetic world (the port's synthetic module)
    with a labelled corpus written by the port's CLI on the CPU."""
    root = tempfile.mkdtemp(prefix="vrt", dir="/tmp")
    for key in ("VRT_TOME_R", "VRT_GEMM_QUANT", "VRT_GRAYSCALE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("VRT_TINY", "1")
    monkeypatch.chdir(root)
    synthetic.write_video_frames("frames", 1, SEGMENTS, size=(32, 32))
    synthetic.make_manual_intervals(
        segs=(tuple(SEGMENTS),)).to_csv("manual_intervals.csv")
    cli.main(["write-frame-db", "frames", "--manual-csv",
              "manual_intervals.csv", "--db", "db", "--collection", "corpus",
              "--batch-size", "16", "--device", "cpu"])
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_serve_shard_device_answers_as_the_unsharded_daemon(
        world, monkeypatch, capsys):
    """serve --shard-device (a mesh of the daemon's one CPU) shards its
    collection: query answers equal an unsharded daemon's, filtered and
    not; stats and reload say "sharded"; a reload re-shards the reopened
    collection; --shard-device without a collection is refused."""
    daemons = _Daemons(monkeypatch)
    base = ["serve", "--db", "db", "--collection", "corpus", "--batch-size",
            "16", "--device", "cpu"]
    paths = [os.path.join("frames", f"vid1_frame_{i}.jpg")
             for i in (3, 10, 40, 60, 70)]
    queries = [{"op": "query", "paths": paths, "n_results": 7},
               {"op": "query", "paths": paths, "n_results": 3,
                "where": {"label": {"$ne": "none"}}}]
    with daemons.run(base + ["--socket", "p.sock"]) as plain, \
            daemons.run(base + ["--socket", "s.sock",
                                "--shard-device"]) as sharded:
        assert plain._shard_mesh is None
        assert sharded._shard_mesh.shape == {"data": 1}
        assert sharded.collection._device_mesh is sharded._shard_mesh
        for q in queries:
            want = serve.request("p.sock", q, timeout=TIMEOUT)
            got = serve.request("s.sock", q, timeout=TIMEOUT)
            assert got["ok"] and got["ids"] == want["ids"]
            for a, b in zip(got["distances"], want["distances"]):
                np.testing.assert_allclose(a, b, **TOL)
            assert sharded.collection._device_cache is not None  # the mesh
        capsys.readouterr()
        cli.main(["serve-ctl", "stats", "--socket", "s.sock"])
        assert json.loads(capsys.readouterr().out)["sharded"] is True
        assert serve.request("p.sock", {"op": "stats"},
                             timeout=TIMEOUT)["sharded"] is False
        old = sharded.collection
        cli.main(["serve-ctl", "reload", "--socket", "s.sock"])
        reply = json.loads(capsys.readouterr().out)
        assert reply["sharded"] is True and reply["rows"] == 72
        assert sharded.collection is not old
        assert sharded.collection._device_mesh is sharded._shard_mesh
        got = serve.request("s.sock", queries[0], timeout=TIMEOUT)
        assert got["ids"] == serve.request("p.sock", queries[0],
                                           timeout=TIMEOUT)["ids"]
    with pytest.raises(SystemExit, match="--shard-device shards"):
        cli.main(["serve", "--socket", "x.sock", "--shard-device",
                  "--device", "cpu"])
    assert not os.path.exists("x.sock")
