"""The port's serving daemon (serve.py, cli/serve_cmds.py) and the live
``segment --follow`` loop (cli/segment_cmds.py), side by side with the
JAX package's daemon on a tiny ViT with equal weights, on the CPU.

Tolerances: embeddings 1e-5 (the two engines sum f32 products in other
orders); a request's rows merged with other requests against the same
rows alone 1e-5 (f32 GEMMs over other batch shapes). Query ids, session
clips, binary reply frames of the same reply, clip directories and the
stats counts must be equal.

Sockets live under a short ``mkdtemp`` in /tmp (unix socket paths are
limited to 107 bytes); every client has a timeout of at most 30 s and
every server thread is joined with a timeout and checked for exit.
"""

import argparse
import base64
import contextlib
import io
import json
import os
import shutil
import socket
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from vit_research_tpu import serve as jax_serve
from vit_research_tpu.data import labels as jax_labels
from vit_research_tpu.data import synthetic
from vit_research_tpu.data.preprocess import PreprocessSpec as JaxSpec
from vit_research_tpu.models import vit as jax_vit
from vit_research_tpu.parallel import embed as jax_embed
from vit_research_tpu.store import vector_store as jax_store
from vit_research_tpu.utils.configs import ViTConfig as JaxConfig
from vit_research_tpu_torch import cli, serve
from vit_research_tpu_torch.cli import segment_cmds
from vit_research_tpu_torch.data.preprocess import PreprocessSpec
from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.models import vit as tvit
from vit_research_tpu_torch.parallel import embed as tembed
from vit_research_tpu_torch.store import vector_store as torch_store
from vit_research_tpu_torch.utils.configs import ViTConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=0, atol=1e-5)
TIMEOUT = 30.0
TINY = dict(image_size=(32, 32), patch_size=8, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128, use_flash_attention=False)
SIDES = ("left", "right", "none")


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) with equal weights, batch size 4."""
    jcfg = JaxConfig(**TINY)
    model, params = jax_vit.init_vit(jcfg, seed=0)
    jeng = jax_embed.EmbeddingEngine(model, params, JaxSpec(size=(32, 32)),
                                     batch_size=4,
                                     use_fused_patch_embed=False)
    tcfg = ViTConfig(**TINY)
    tm = tvit.VisionTransformer(tcfg)
    tm.load_state_dict(convert.params_to_state_dict(params, tcfg))
    teng = tembed.EmbeddingEngine(tm.eval(), PreprocessSpec(size=(32, 32)),
                                  device="cpu", batch_size=4)
    return jeng, teng


@pytest.fixture
def sockdir():
    d = tempfile.mkdtemp(prefix="vrt", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@contextlib.contextmanager
def serving(srv, sock):
    """Run ``srv.serve(sock)`` on a thread; stop and join it after."""
    ready = threading.Event()
    t = threading.Thread(target=srv.serve, args=(sock,),
                         kwargs={"ready_event": ready}, daemon=True)
    t.start()
    assert ready.wait(TIMEOUT)
    try:
        yield sock
    finally:
        srv.stop()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), "serve thread did not exit"


def _frames(n, seed, size=(32, 32)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, *size, 3), dtype=np.uint8)


def _pngs(root, frames, prefix="f"):
    """Lossless files, so both packages decode the same pixels."""
    paths = []
    for i, f in enumerate(frames):
        p = os.path.join(root, f"{prefix}{i}.png")
        Image.fromarray(f).save(p)
        paths.append(p)
    return paths


def _blob(frame):
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return buf.getvalue()


def _served_pair(root, engines, space="cosine", n=8):
    """The same seeded rows in a JAX and a port collection, each served
    by its package's daemon."""
    jeng, teng = engines
    rng = np.random.default_rng(0)
    base = rng.normal(size=(n, teng.out_dim)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    cols = []
    for client in (jax_store.PersistentClient(os.path.join(root, "jdb")),
                   torch_store.PersistentClient(os.path.join(root, "tdb"),
                                                device="cpu")):
        col = client.get_or_create_collection(
            "served", metadata={"hnsw:space": space})
        col.upsert([f"id{i}" for i in range(n)], base,
                   metadatas=[{"vid": i % 2} for i in range(n)])
        cols.append(col)
    return (jax_serve.EmbedServer(jeng, collection=cols[0]),
            serve.EmbedServer(teng, collection=cols[1]), base)


# ------------------------------------------------------------ the protocol


def test_embed_replies_match_jax_daemon_in_all_input_forms(engines,
                                                           sockdir):
    jeng, teng = engines
    jsrv, tsrv, _ = _served_pair(sockdir, engines)
    frames = _frames(6, seed=1)
    paths = _pngs(sockdir, frames)
    b64 = [base64.b64encode(_blob(f)).decode() for f in frames]
    odd = _frames(2, seed=2, size=(40, 48))  # resized on the host
    with serving(jsrv, os.path.join(sockdir, "j.sock")) as js, \
            serving(tsrv, os.path.join(sockdir, "t.sock")) as ts:
        replies = {}
        for name, sock in (("jax", js), ("torch", ts)):
            out = [np.asarray(serve.request(sock, {"op": "embed",
                                                   "paths": paths},
                                            timeout=TIMEOUT)["embeddings"],
                              np.float32),
                   np.asarray(serve.request(sock, {"op": "embed",
                                                   "frames_b64": b64},
                                            timeout=TIMEOUT)["embeddings"],
                              np.float32)]
            with serve.SessionClient(sock, timeout=TIMEOUT) as c:
                out.append(c.request_binary({"op": "embed"},
                                            frames=frames)["embeddings"])
                out.append(c.request_binary(
                    {"op": "embed"},
                    jpegs=[_blob(f) for f in frames])["embeddings"])
                out.append(c.request_binary({"op": "embed"},
                                            frames=odd)["embeddings"])
            replies[name] = out
    direct = teng.embed_batch(frames)
    for got, want in zip(replies["torch"], replies["jax"]):
        np.testing.assert_allclose(got, want, **TOL)
    for got in replies["torch"][:4]:  # the four forms, the same frames
        assert got.shape == (6, 64) and got.dtype == np.float32
        np.testing.assert_allclose(got, direct, **TOL)


def test_query_ids_match_jax_daemon(engines, sockdir):
    jsrv, tsrv, base = _served_pair(sockdir, engines)
    paths = _pngs(sockdir, _frames(5, seed=3))
    reqs = [{"op": "query", "paths": paths, "n_results": 3},
            {"op": "query", "embeddings": base[:3].tolist(), "n_results": 4,
             "where": {"vid": 1}}]
    with serving(jsrv, os.path.join(sockdir, "j.sock")) as js, \
            serving(tsrv, os.path.join(sockdir, "t.sock")) as ts:
        for req in reqs:
            want = serve.request(js, req, timeout=TIMEOUT)
            got = serve.request(ts, req, timeout=TIMEOUT)
            assert got["ok"] and want["ok"]
            assert got["metadatas"] == want["metadatas"]
            for gi, wi, gd, wd in zip(got["ids"], want["ids"],
                                      got["distances"], want["distances"]):
                np.testing.assert_allclose(gd, wd, **TOL)
                # tie-aware: an id in one answer only must tie the last
                for i in set(gi) ^ set(wi):
                    d = gd[gi.index(i)] if i in gi else wd[wi.index(i)]
                    assert abs(d - wd[-1]) <= 1e-5
        # a row finds itself through the filter; rows of vid 0 never come
        assert got["ids"][1][0] == "id1"
        assert all(int(i[2:]) % 2 for row in got["ids"] for i in row)


def test_binary_frames_are_byte_identical(engines, sockdir):
    for header, payload in (({"op": "embed", "bin": {"kind": "raw_u8",
                                                     "shape": [1, 2, 2, 3]}},
                             bytes(range(12))),
                            ({"ok": False, "error": "x"}, b"")):
        assert serve.pack_binary_frame(header, payload) == \
            jax_serve.pack_binary_frame(header, payload)
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert serve._encode_binary_reply({"ok": True, "_np": arr}) == \
        jax_serve._encode_binary_reply({"ok": True, "_np": arr})
    jsrv, tsrv, _ = _served_pair(sockdir, engines)

    def raw(sock, data):
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(TIMEOUT)
            s.connect(sock)
            s.sendall(data)
            s.shutdown(socket.SHUT_WR)
            out = b""
            while chunk := s.recv(1 << 16):
                out += chunk
            return out

    wire = [serve.pack_binary_frame({"op": "ping"}),
            serve.pack_binary_frame({"op": "nope"}),
            serve.pack_binary_frame({"op": "embed", "bin": {
                "kind": "raw_u8", "shape": [1, 32, 32, 3]}}, b"\0" * 5),
            b"\xbfX" + bytes(12),  # framing corruption: reply, close
            (json.dumps({"op": "ping"}) + "\n").encode()]
    with serving(jsrv, os.path.join(sockdir, "j.sock")) as js, \
            serving(tsrv, os.path.join(sockdir, "t.sock")) as ts:
        for data in wire:
            got, want = raw(ts, data), raw(js, data)
            assert got == want and got


def test_jax_clients_drive_the_port_daemon(engines, sockdir):
    _, teng = engines
    _, tsrv, _ = _served_pair(sockdir, engines)
    frames = _frames(5, seed=4)
    with serving(tsrv, os.path.join(sockdir, "t.sock")) as ts:
        with jax_serve.SessionClient(ts, timeout=TIMEOUT) as c:
            rb = c.request_binary({"op": "embed"}, frames=frames)
            assert rb["ok"] and rb["embeddings"].shape == (5, 64)
            np.testing.assert_allclose(rb["embeddings"],
                                       teng.embed_batch(frames), **TOL)
            assert c.request({"op": "ping"})["out_dim"] == 64
        q = jax_serve.request_binary(ts, {"op": "query", "n_results": 3},
                                     frames=frames, timeout=TIMEOUT)
        assert q["ok"] and len(q["ids"]) == 5
        assert jax_serve.request(ts, {"op": "stats"},
                                 timeout=TIMEOUT)["frames_embedded"] == 10


# ---------------------------------------------------------- the coalescer


class _CountingEngine:
    """Wraps an engine, counting embed_batch invocations."""

    def __init__(self, engine):
        self._engine = engine
        self.calls = 0

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def embed_batch(self, batch):
        self.calls += 1
        return self._engine.embed_batch(batch)


def _concurrently(fn, args_list):
    results, threads = {}, []

    def run(i, a):
        try:
            results[i] = fn(*a)
        except Exception as e:  # surfaced to the test below
            results[i] = e

    for i, a in enumerate(args_list):
        threads.append(threading.Thread(target=run, args=(i, a)))
        threads[-1].start()
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    return results


def test_coalescer_merges_concurrent_requests(engines):
    _, teng = engines
    counting = _CountingEngine(teng)
    # a wide window: the three client threads must all arrive inside it
    srv = serve.EmbedServer(counting, coalesce_ms=1000.0)
    try:
        frames = _frames(3, seed=5)
        alone = [teng.embed_batch(frames[i:i + 1]) for i in range(3)]
        counting.calls = 0
        res = _concurrently(srv._coalescer.embed,
                            [(frames[i:i + 1],) for i in range(3)])
        assert counting.calls == 1 and srv._coalescer.batches_run == 1
        for i in range(3):
            # merged into one ragged batch of 3: rows equal their own
            # batch-of-1 forward up to the GEMMs' summation order
            np.testing.assert_allclose(res[i], alone[i], **TOL)
    finally:
        srv.stop()


def test_coalescer_full_batch_bypasses_merge_and_linger(engines):
    _, teng = engines
    counting = _CountingEngine(teng)
    srv = serve.EmbedServer(counting, coalesce_ms=5000.0)
    try:
        for n in (4, 9):  # == and > the engine batch size
            t0 = time.monotonic()
            out = srv._coalescer.embed(_frames(n, seed=n))
            assert time.monotonic() - t0 < 4.0  # no 5 s linger
            assert out.shape == (n, 64)
        assert counting.calls == 2 and not srv._coalescer._pending
    finally:
        srv.stop()


def test_coalescer_errors_fail_only_their_requests(engines):
    _, teng = engines
    srv = serve.EmbedServer(teng, coalesce_ms=300.0)
    try:
        with pytest.raises(ValueError):  # wrong rank, raised by the engine
            srv._coalescer.embed(np.zeros((2, 7), np.uint8))
        # a failed concatenate fails the merged requests, not the worker
        res = _concurrently(srv._coalescer.embed,
                            [(np.zeros((1, 32, 32, 3), np.uint8),),
                             (np.zeros((1, 16, 16, 3), np.uint8),)])
        assert any(isinstance(r, Exception) for r in res.values())
        out = srv._coalescer.embed(np.zeros((1, 32, 32, 3), np.uint8))
        assert out.shape == (1, 64)
    finally:
        srv.stop()
    assert not srv._coalescer._thread.is_alive()
    with pytest.raises(RuntimeError, match="shutting down"):
        srv._coalescer.embed(np.zeros((1, 32, 32, 3), np.uint8))


def test_concurrent_clients_through_the_socket(engines, sockdir):
    _, teng = engines
    srv = serve.EmbedServer(teng, coalesce_ms=50.0)
    frames = _frames(8, seed=6)
    with serving(srv, os.path.join(sockdir, "t.sock")) as ts:
        res = _concurrently(
            lambda i: serve.request_binary(
                ts, {"op": "embed"}, frames=frames[2 * i:2 * i + 2],
                timeout=TIMEOUT)["embeddings"],
            [(i,) for i in range(4)])
        stats = serve.request(ts, {"op": "stats"}, timeout=TIMEOUT)
    got = np.concatenate([res[i] for i in range(4)])
    np.testing.assert_allclose(got, teng.embed_batch(frames), **TOL)
    assert stats["frames_embedded"] == 8
    assert 1 <= stats["device_batches"] <= 4
    assert stats["requests"] == {"embed": 4, "stats": 1}


# -------------------------------------------------------- live sessions


def _seg_world(root, eng, store, name="corpus", space="l2", prefix=""):
    """Three distinct frames on disk and a labeled corpus built from the
    engine's own embeddings of them (5 copies each)."""
    paths = {}
    for i, side in enumerate(SIDES):
        img = np.full((32, 32, 3), 40 + 80 * i, np.uint8)
        img[: 8 * (i + 1), :8] = 255
        paths[side] = os.path.join(root, f"{prefix}{side}.png")
        Image.fromarray(img).save(paths[side])
    embs = eng.embed_batch(np.stack([np.asarray(Image.open(paths[s]))
                                     for s in SIDES]))
    kw = {"device": "cpu"} if store is torch_store else {}
    client = store.PersistentClient(os.path.join(root, f"{prefix}segdb"),
                                    **kw)
    col = client.get_or_create_collection(
        name, metadata={"hnsw:space": space})
    ids, rows, metas = [], [], []
    for i, side in enumerate(SIDES):
        probs = {f"{s}_prob": (0.9 if s == side else 0.05) for s in SIDES}
        for c in range(5):
            ids.append(f"{side}{c}")
            rows.append(embs[i])
            metas.append({"label": side, **probs})
    col.upsert(ids, np.asarray(rows), metadatas=metas)
    client.flush()
    return paths, col


def _session(sock, paths, stream, start, sizes=(10, 3, 16)):
    """Drive one session; returns (clips, finish reply, mid-stream?)."""
    clips, mid = [], False
    with serve.SessionClient(sock, timeout=TIMEOUT) as c:
        assert c.request(start)["ok"]
        i, j = 0, 0
        while i < len(stream):
            chunk = stream[i:i + sizes[j % len(sizes)]]
            if j % 2:
                r = c.request({"op": "segment_push",
                               "paths": [paths[s] for s in chunk]})
            else:  # binary pushes mint positional ids
                r = c.request_binary({"op": "segment_push"}, frames=np.stack(
                    [np.asarray(Image.open(paths[s])) for s in chunk]))
            assert r["ok"], r
            clips += r["clips"]
            mid |= bool(r["clips"]) and i + len(chunk) < len(stream)
            i, j = i + len(chunk), j + 1
        fin = c.request({"op": "segment_finish"})
    return clips + fin["clips"], fin, mid


@pytest.mark.parametrize("space", ["l2", "cosine"])
def test_session_clips_match_jax_daemon(engines, sockdir, space):
    jeng, teng = engines
    jpaths, jcol = _seg_world(sockdir, jeng, jax_store, space=space,
                              prefix="j")
    tpaths, tcol = _seg_world(sockdir, teng, torch_store, space=space,
                              prefix="t")
    stream = (["none"] * 6 + ["left"] * 30 + ["none"] * 12 + ["right"] * 25
              + ["none"] * 9)
    start = {"op": "segment_start", "k": 5, "min_len": 20, "pad": 2,
             "max_lag": 16, "drain_every": 4}
    with serving(jax_serve.EmbedServer(jeng, collection=jcol),
                 os.path.join(sockdir, "j.sock")) as js, \
            serving(serve.EmbedServer(teng, collection=tcol),
                    os.path.join(sockdir, "t.sock")) as ts:
        want = _session(js, jpaths, stream, start)
        got = _session(ts, tpaths, stream, start)
        stats = serve.request(ts, {"op": "stats"}, timeout=TIMEOUT)
    assert got[0] == want[0] == [
        {"side": "left", "start": 4, "end": 37},
        {"side": "right", "start": 46, "end": 74}]
    assert got[1] == want[1]  # frames_seen, forced, the tail clips
    assert got[2] and want[2]  # a clip arrived mid-game
    seg = stats["segment"]
    assert (seg["sessions_started"], seg["sessions_finished"],
            seg["sessions_active"], seg["frames_pushed"],
            seg["clips_emitted"]) == (1, 1, 0, len(stream), 2)
    assert stats["frames_embedded"] == len(stream)


def test_session_protocol_errors_and_unported_ops(engines, sockdir):
    _, teng = engines
    paths, col = _seg_world(sockdir, teng, torch_store)
    with serving(serve.EmbedServer(teng, collection=col),
                 os.path.join(sockdir, "t.sock")) as ts:
        with serve.SessionClient(ts, timeout=TIMEOUT) as c:
            r = c.request({"op": "segment_push", "paths": [paths["left"]]})
            assert not r["ok"] and "segment_start first" in r["error"]
            for cfg in ({}, {"ckpt": "c"}):
                r = c.request({"op": "segment_start", "k": 5,
                               "score_events": cfg})
                assert not r["ok"]
                assert "score_events config missing" in r["error"]
            # refused, not half-built: no session was left behind
            r = c.request({"op": "segment_finish"})
            assert not r["ok"] and "no active segment" in r["error"]
            r = c.request({"op": "reload_weights"})
            assert not r["ok"] and "matched no scorer stacks" in r["error"]
            r = c.request({"op": "segment_start", "k": 5,
                           "transitions": [[1.0]]})
            assert not r["ok"] and "'transitions'" in r["error"]
            r = c.request({"op": "segment_start", "write_back": True})
            assert not r["ok"] and "requires 'vid'" in r["error"]
            assert c.request({"op": "segment_start", "k": 5,
                              "score_events": False})["ok"]
            r = c.request({"op": "segment_start", "k": 5})
            assert not r["ok"] and "already active" in r["error"]
        stats = serve.request(ts, {"op": "stats"}, timeout=TIMEOUT)
    # the dropped connection abandoned its open session
    assert stats["segment"]["sessions_abandoned"] == 1
    assert stats["segment"]["sessions_active"] == 0
    assert stats["errors"] == 8 and stats["weights_generation"] == 0


def test_corpus_snapshot_cached_until_mutation(engines, sockdir):
    _, teng = engines
    _, col = _seg_world(sockdir, teng, torch_store, space="cosine")
    srv = serve.EmbedServer(teng, collection=col, coalesce_ms=0)
    a = srv._corpus_snapshot(col)
    assert srv._corpus_snapshot(col) is a
    np.testing.assert_allclose(
        torch.linalg.vector_norm(a["embeddings"], dim=-1).numpy(), 1.0,
        atol=1e-6)  # normalized once, for every cosine session
    before = col._mutations
    col.upsert(["left0"], np.ones((1, 64), np.float32),
               [{"label": "left"}])  # in-place same-id update
    assert col._mutations == before + 1
    assert srv._corpus_snapshot(col) is not a
    srv.stop()


# ------------------------------------------------------ reload and stop


def test_store_mutation_counter_and_pending_match_jax(tmp_path):
    cols = [jax_store.PersistentClient(str(tmp_path / "j")).
            get_or_create_collection("c"),
            torch_store.PersistentClient(str(tmp_path / "t"), device="cpu").
            get_or_create_collection("c")]
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(6, 4)).astype(np.float32)
    for col in cols:
        col.upsert([f"r{i}" for i in range(4)], rows[:4],
                   [{"k": i} for i in range(4)])
        col.flush()
        assert col.pending_mutations() is None
        col.upsert(["r1", "r5"], rows[4:], [{"k": 9}, None])
        col.delete(ids=["r2"])
    assert cols[1]._mutations == cols[0]._mutations == 3
    want, got = cols[0].pending_mutations(), cols[1].pending_mutations()
    assert got["ids"] == want["ids"] == ["r1", "r5"]
    assert got["deleted"] == want["deleted"] == ["r2"]
    assert got["metadatas"] == want["metadatas"]
    np.testing.assert_array_equal(got["embeddings"], want["embeddings"])
    cols[1].detach()  # a swapped-out generation never reaches disk
    cols[1].flush()
    assert cols[1].pending_mutations() is None
    reopened = torch_store.PersistentClient(str(tmp_path / "t"),
                                            device="cpu").get_collection("c")
    assert reopened.count() == 4


def test_reload_pinned_by_write_back_sessions(engines, sockdir):
    _, teng = engines
    paths, col = _seg_world(sockdir, teng, torch_store)
    srv = serve.EmbedServer(teng, coalesce_ms=0, collection=col,
                            collection_source=(os.path.join(sockdir,
                                                            "segdb"),
                                               "corpus"))
    session: dict = {}
    assert srv.handle({"op": "segment_start", "k": 5, "min_len": 3,
                       "pad": 0, "max_lag": 16, "write_back": True,
                       "vid": 9}, session)["ok"]
    with pytest.raises(ValueError, match="write-back"):
        srv.handle({"op": "reload"})
    plain: dict = {}  # plain sessions rank their snapshot: no pin
    assert srv.handle({"op": "segment_start", "k": 5}, plain)["ok"]
    for _ in range(3):
        assert srv.handle({"op": "segment_push",
                           "paths": [paths["left"]] * 4}, session)["ok"]
    srv.handle({"op": "segment_finish"}, session)
    resp = srv.handle({"op": "reload"})
    # the finished session's write-back (left.png, one new id) survived
    assert resp["ok"] and resp["rows"] == 16 and resp["previous_rows"] == 16
    assert resp["carried_pending"] == 0 and resp["sharded"] is False
    assert srv.collection is not col and col._path is None  # detached
    assert srv.handle({"op": "segment_push",
                       "paths": [paths["none"]] * 2}, plain)["ok"]
    assert srv.handle({"op": "segment_finish"}, plain)["ok"]
    # an abandoned write-back session unpins; a failed start never pins
    s2: dict = {}
    assert srv.handle({"op": "segment_start", "k": 5, "write_back": True,
                       "vid": 1}, s2)["ok"]
    srv._connection_closed(s2)
    bad: dict = {}
    with pytest.raises(ValueError, match="transitions"):
        srv.handle({"op": "segment_start", "k": 5, "write_back": True,
                    "vid": 1, "transitions": [[1.0]]}, bad)
    assert srv.handle({"op": "reload"})["ok"] and bad == {}
    srv.stop()


def test_reload_carries_pending_rows_over_an_external_rebuild(engines,
                                                              sockdir):
    _, teng = engines
    db = os.path.join(sockdir, "rdb")
    client = torch_store.PersistentClient(db, autoflush=False, device="cpu")
    col = client.get_or_create_collection("c")
    col.upsert(["a", "b"], np.eye(2, 64, dtype=np.float32))
    client.flush()
    srv = serve.EmbedServer(teng, coalesce_ms=0, collection=col,
                            collection_source=(db, "c"))
    col.upsert(["mine"], np.ones((1, 64), np.float32))  # acked, unflushed
    other = torch_store.PersistentClient(db, autoflush=False, device="cpu")
    ext = other.get_collection("c")
    ext.upsert(["x", "y", "z"], np.zeros((3, 64), np.float32))
    ext.compact()  # an external rebuild: the daemon's view is stale
    resp = srv.handle({"op": "reload"})
    assert resp["ok"] and resp["carried_pending"] == 1
    assert resp["carried_flushed"] and resp["rows"] == 6
    fresh = torch_store.PersistentClient(db, device="cpu").get_collection("c")
    assert sorted(fresh.get()["ids"]) == ["a", "b", "mine", "x", "y", "z"]
    with pytest.raises(ValueError, match="explicit"):
        serve.EmbedServer(teng, coalesce_ms=0).handle({"op": "reload"})
    srv.stop()


def test_daemon_write_back_refused_cross_profile(engines, sockdir):
    _, teng = engines
    _, col = _seg_world(sockdir, teng, torch_store)
    col.stamp_embedding_profile("tiny|tome0|quant-none|gray0")  # JAX-built
    srv = serve.EmbedServer(teng, collection=col, coalesce_ms=0,
                            engine_profile="torch|tiny|tome0|quant-none|"
                                           "gray0")
    session: dict = {}
    with pytest.raises(ValueError, match="mixing embedding spaces"):
        srv.handle({"op": "segment_start", "k": 5, "write_back": True,
                    "vid": 1}, session)
    assert srv._write_back_sessions == 0 and session == {}
    srv.stop()


def test_stop_refuses_new_device_work_and_drains_in_flight(engines,
                                                           sockdir):
    _, teng = engines
    srv = serve.EmbedServer(teng, coalesce_ms=0)
    srv.stop()
    with pytest.raises(RuntimeError, match="shutting down"):
        with srv._device():
            pass
    with pytest.raises(RuntimeError, match="shutting down"):
        srv.handle({"op": "embed", "frames_b64": []})

    srv = serve.EmbedServer(teng, coalesce_ms=2.0)
    sock = os.path.join(sockdir, "q.sock")
    ready = threading.Event()
    t = threading.Thread(target=srv.serve, args=(sock,),
                         kwargs={"ready_event": ready}, daemon=True)
    t.start()
    assert ready.wait(TIMEOUT)
    held, release = threading.Event(), threading.Event()

    def hold_device():  # stands in for a handler mid-forward
        with srv._lock:
            held.set()
            release.wait(TIMEOUT)

    h = threading.Thread(target=hold_device, daemon=True)
    h.start()
    assert held.wait(TIMEOUT)
    resp = serve.request(sock, {"op": "shutdown"}, timeout=TIMEOUT)
    assert resp == {"ok": True, "stopping": True}
    t.join(timeout=1.0)
    assert t.is_alive(), "serve() returned with a device op in flight"
    release.set()
    t.join(timeout=TIMEOUT)
    h.join(timeout=TIMEOUT)
    assert not t.is_alive() and not h.is_alive()
    assert not os.path.exists(sock)
    with pytest.raises(RuntimeError, match="shutting down"):
        srv._coalescer.embed(np.zeros((1, 32, 32, 3), np.uint8))


def test_warming_server_lifecycle(engines, sockdir):
    _, teng = engines
    sock = os.path.join(sockdir, "w.sock")
    warm = serve.WarmingServer(sock)
    try:
        warm.phase = "kernel build (nvcc)"
        r = serve.request(sock, {"op": "ping"}, timeout=TIMEOUT)
        assert r["ok"] and r["warming"] and not r["ready"]
        assert r["phase"] == "kernel build (nvcc)"
        r = serve.request(sock, {"op": "embed", "frames_b64": []},
                          timeout=TIMEOUT)
        assert not r["ok"] and "warming up" in r["error"]
        c = serve.SessionClient(sock, timeout=TIMEOUT)
        with pytest.raises((OSError, ConnectionError)):
            c.request_binary({"op": "embed"},
                             frames=np.zeros((1, 32, 32, 3), np.uint8))
        held = serve.SessionClient(sock, timeout=TIMEOUT)
        assert held.request({"op": "ping"})["warming"]
        r = serve.request(sock, {"op": "shutdown"}, timeout=TIMEOUT)
        assert r["ok"] and warm.shutdown_requested
    finally:
        warm.close()
        warm.close()  # idempotent
    with pytest.raises((OSError, ConnectionError)):
        held.request({"op": "ping"})  # close() severed it
    held.close()
    assert not os.path.exists(sock)
    with serving(serve.EmbedServer(teng), sock):
        r = serve.request(sock, {"op": "ping"}, timeout=TIMEOUT)
        assert r["ok"] and "warming" not in r
        with pytest.raises(RuntimeError, match="live server"):
            serve.EmbedServer(teng).serve(sock)
    with pytest.raises(FileNotFoundError, match="no daemon socket"):
        serve.request(sock, {"op": "ping"}, timeout=TIMEOUT)


def test_follow_backend_reconnects_and_replays(engines, sockdir, capsys):
    _, teng = engines
    paths, col = _seg_world(sockdir, teng, torch_store)
    sock = os.path.join(sockdir, "flap.sock")
    args = argparse.Namespace(
        socket=sock, k=5, confidence_threshold=0.7, min_len=20, pad=2,
        max_lag=64, write_back=False, vid=1, score_events=False)
    stream = ["left"] * 30 + ["none"] * 20
    sp = [paths[s] for s in stream]
    clips = []
    with serving(serve.EmbedServer(teng, collection=col, coalesce_ms=0),
                 sock):
        backend = segment_cmds._DaemonFollowBackend(args)
        clips += backend.push(stream[:20], sp[:20])[0]
        # the daemon dies with the session (a killed daemon severs the
        # client socket; stop() alone leaves the handler serving)
    backend.client._sock.shutdown(socket.SHUT_RDWR)
    with serving(serve.EmbedServer(teng, collection=col, coalesce_ms=0),
                 sock):
        for i in range(20, 50, 10):
            clips += backend.push(stream[i:i + 10], sp[i:i + 10])[0]
        fin, events, forced = backend.finish()
    clips += fin
    assert "reconnecting and replaying" in capsys.readouterr().out
    assert [(c.side, c.start, c.end) for c in clips] == [("left", 0, 31)]
    assert forced == 0 and events is None and not backend.scoring


# --------------------------------------------------------------- the CLI


SEGMENTS = [("none", 4), ("left", 30), ("none", 4), ("right", 30),
            ("none", 4)]


@pytest.fixture
def tiny_world(sockdir, monkeypatch):
    """The verify skill's synthetic world with a labelled corpus written
    by the port's CLI (VRT_TINY engine on the CPU)."""
    for key in ("VRT_TOME_R", "VRT_GEMM_QUANT", "VRT_GRAYSCALE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("VRT_TINY", "1")
    monkeypatch.chdir(sockdir)
    synthetic.write_video_frames("frames", 1, SEGMENTS, size=(32, 32))
    mi = jax_labels.ManualIntervals()
    for side, a, b in [("none", 1, 4), ("left", 5, 34), ("none", 35, 38),
                       ("right", 39, 68), ("none", 69, 72)]:
        mi.intervals[side].append((1, a, b))
    mi.to_csv("manual_intervals.csv")
    cli.main(["write-frame-db", "frames", "--manual-csv",
              "manual_intervals.csv", "--db", "db", "--collection", "corpus",
              "--batch-size", "16", "--device", "cpu"])
    return sockdir


def _listing(root):
    return {d: sorted(os.listdir(os.path.join(root, d)))
            for d in sorted(os.listdir(root)) if d.startswith("vid")}


def _live_frames(src, dst):
    os.makedirs(dst)
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), dst)
    open(os.path.join(dst, "STOP"), "w").close()
    return dst


def test_follow_local_and_socket_write_the_offline_clips(tiny_world,
                                                         capsys):
    common = ["--k", "5", "--min-len", "20", "--pad", "2", "--vid", "1",
              "--batch-size", "16"]
    cli.main(["segment", "frames", "--method", "knn-hmm", "--db", "db",
              "--corpus-collection", "corpus", "--out", "offline",
              "--device", "cpu", *common])
    want = _listing("offline")
    assert sorted(want) == ["vid1_clip_1_left", "vid1_clip_2_right"]
    follow = ["--follow", "--idle-timeout", "20", "--poll-interval", "0.05",
              "--max-lag", "64", *common]
    cli.main(["segment", _live_frames("frames", "live_a"), "--method",
              "knn-hmm", "--db", "db", "--corpus-collection", "corpus",
              "--out", "local", "--device", "cpu", *follow])
    assert "followed 72 frames -> 2 clips (0 forced commits)" in \
        capsys.readouterr().out
    assert _listing("local") == want

    sock = os.path.join(tiny_world, "d.sock")
    t = threading.Thread(target=cli.main, args=([
        "serve", "--socket", sock, "--db", "db", "--collection", "corpus",
        "--batch-size", "16", "--warmup", "--device", "cpu"],), daemon=True)
    t.start()
    try:
        # connect-through-warming: the backend waits out the placeholder
        cli.main(["segment", _live_frames("frames", "live_b"), "--method",
                  "knn-hmm", "--socket", sock, "--out", "daemon", *follow])
        assert _listing("daemon") == want
        out = capsys.readouterr().out
        assert "followed 72 frames -> 2 clips" in out
        assert "engine warmed in" in out and "serving on" in out

        cli.main(["serve-ctl", "stats", "--socket", sock])
        stats = json.loads(capsys.readouterr().out)
        assert stats["segment"]["sessions_finished"] == 1
        assert stats["segment"]["frames_pushed"] == 72
        assert stats["segment"]["clips_emitted"] == 2
        assert stats["engine_profile"] == "torch|tiny|tome0|quant-none|gray0"
        cli.main(["serve-ctl", "ping", "--socket", sock])
        assert json.loads(capsys.readouterr().out)["collection"] == "corpus"
        cli.main(["serve-ctl", "reload", "--socket", sock])
        assert json.loads(capsys.readouterr().out)["rows"] == 72
        with pytest.raises(SystemExit, match="matched no scorer stacks"):
            cli.main(["serve-ctl", "reload-weights", "--socket", sock])
        with pytest.raises(SystemExit, match="only apply to reload"):
            cli.main(["serve-ctl", "ping", "--socket", sock, "--db", "x"])
        cli.main(["serve-ctl", "shutdown", "--socket", sock])
        assert json.loads(capsys.readouterr().out)["stopping"] is True
    finally:
        t.join(timeout=TIMEOUT)
    assert not t.is_alive() and not os.path.exists(sock)


def test_segment_flags_validated_before_the_engine(tiny_world, capsys):
    base = ["segment", "frames", "--out", "o", "--vid", "1"]
    cases = [
        (["--method", "knn-hmm", "--socket", "s"], "requires --follow"),
        (["--method", "knn-hmm", "--follow", "--frame-stride", "2"],
         "offline runs only"),
        (["--method", "streaks", "--follow", "--socket", "s"],
         "--method knn-hmm only"),
        (["--method", "knn-hmm", "--follow", "--socket", "s", "--db", "db"],
         "DAEMON's collection"),
        (["--method", "streaks", "--follow", "--db", "db",
          "--corpus-collection", "corpus"], "--follow supports"),
        (["--method", "streaks", "--db", "db", "--corpus-collection",
          "corpus", "--transitions", "t.json"], "knn-hmm only"),
        (["--method", "knn-hmm"], "needs --db and --corpus-collection"),
        (["--method", "knn-hmm", "--follow", "--socket",
          os.path.join(tiny_world, "none.sock")], "no daemon socket"),
        (["--method", "knn-hmm", "--db", "db", "--corpus-collection",
          "corpus", "--score-events", "--stage1-run-id", "r", "--device",
          "cpu"],
         "--score-events needs"),
        # the default method, temporal, is ported: it needs the manual
        # intervals it trains on
        ([], "--method temporal needs --manual-csv"),
        (["--method", "temporal", "--follow"], "--method knn-hmm only"),
    ]
    for extra, msg in cases:
        with pytest.raises(SystemExit, match=msg):
            cli.main(base + extra)
    assert not os.path.exists("o")  # nothing ran
    capsys.readouterr()
    # --shard-device shards the daemon's collection: without one it is
    # refused before the socket is bound
    with pytest.raises(SystemExit, match="--shard-device shards"):
        cli.main(["serve", "--socket", "s", "--shard-device"])
    assert not os.path.exists("s")


def test_segment_streaks_and_tune_segment_cli(tiny_world, capsys):
    cli.main(["segment", "frames", "--method", "streaks", "--db", "db",
              "--corpus-collection", "corpus", "--k", "5", "--window", "10",
              "--min-len", "20", "--out", "streaks", "--vid", "1",
              "--batch-size", "16", "--device", "cpu"])
    assert "decoded 72 frames -> 2 clips" in capsys.readouterr().out
    assert sorted(_listing("streaks")) == ["vid1_clip_1_left",
                                           "vid1_clip_2_right"]
    rows = open(os.path.join("streaks", "clip_intervals.csv")).read()
    assert rows.startswith("side,start_frame,end_frame\nleft,")
    cli.main(["tune-segment", "frames", "--manual-csv",
              "manual_intervals.csv", "--db", "db", "--corpus-collection",
              "corpus", "--k-grid", "3,5", "--min-len-grid", "10,20",
              "--pad-grid", "0,2", "--out", "tune.json", "--batch-size",
              "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "swept 16 combos over 72 frames" in out
    report = json.load(open("tune.json"))
    assert report["best"]["f1"] == 1.0
    assert set(report["transition_matrices"]) == {"reference", "fitted"}
    # the report feeds back through --transitions
    cli.main(["segment", "frames", "--method", "knn-hmm", "--db", "db",
              "--corpus-collection", "corpus", "--k", "5", "--min-len",
              "20", "--pad", "2", "--out", "tuned", "--vid", "1",
              "--transitions", "tune.json", "--batch-size", "16",
              "--device", "cpu"])
    assert "-> 2 clips" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--k-grid is empty"):
        cli.main(["tune-segment", "frames", "--manual-csv", "m", "--db",
                  "db", "--corpus-collection", "corpus", "--k-grid", ","])
