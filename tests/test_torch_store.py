"""The port's vector store (store/vector_store.py, store/ivf.py) and int8
top-k (ops/topk.py) against the JAX package's, on the CPU.

Both packages share one on-disk format, so each reads what the other
wrote. Queries are compared on each route: the host numpy route (rows x
queries < 2^14, the same numpy code on both sides: equal ids and
distances), the device route (the port on ``device='cpu'`` against the
reference's XLA path on the CPU: the scores come from two f32 matmul
libraries, so ids are compared as tie-aware sets and distances to 1e-5)
and the IVF route. The int8 path is exact integer arithmetic on both
sides, so its quantized values, scores and ids are compared exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_research_tpu.ops import topk as jax_topk
from vit_research_tpu.store import ivf as jax_ivf
from vit_research_tpu.store import vector_store as jax_vs
from vit_research_tpu_torch.ops import topk
from vit_research_tpu_torch.store import ivf, vector_store as vs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SIDES = ("left", "right", "none")


def _rows(n, d=24, seed=0):
    rng = np.random.default_rng(seed)
    embs = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"vid1_frame_{i}.jpg" for i in range(n)]
    metas = [{"label": SIDES[i % 3], "t": i} for i in range(n)]
    return ids, embs, metas


def assert_same_neighbours(got, want, tol=1e-5):
    """Per query: distances equal to ``tol`` rank by rank, and any id in
    one answer but not the other sits within ``tol`` of the last kept
    distance (a near-tie that two matmul libraries may order apart)."""
    assert len(got["ids"]) == len(want["ids"])
    for gi, gd, wi, wd in zip(got["ids"], got["distances"], want["ids"],
                              want["distances"]):
        np.testing.assert_allclose(gd, wd, rtol=0, atol=tol)
        edge = wd[-1]
        for i in set(gi) ^ set(wi):
            d = gd[gi.index(i)] if i in gi else wd[wi.index(i)]
            assert abs(d - edge) <= tol, (i, d, edge)


# ------------------------------------------------------------- int8 top-k


def test_quantize_int8_matches_jax_with_rounding_ties():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    # scale = 127 / 127 = 1: 0.5, 1.5, 2.5, -0.5, -2.5 round half to even
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[1] = 0.0  # an all-zero row: scale 0, q 0
    q, scale = topk.quantize_int8(torch.from_numpy(x))
    wq, wscale = jax_topk.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(wscale))
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("masked", [False, True])
def test_masked_topk_int8_matches_jax_with_planted_ties(masked):
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((50, 32)).astype(np.float32)
    corpus[[7, 19, 33]] = corpus[3]  # four identical rows: exact ties
    queries = rng.standard_normal((5, 32)).astype(np.float32)
    queries[0] = corpus[3]
    mask = (rng.random((5, 50)) > 0.3) if masked else None
    if masked:
        mask[0, [3, 7, 19, 33]] = True
    cq, cs = jax_topk.quantize_int8(jnp.asarray(corpus))
    qq, qs = jax_topk.quantize_int8(jnp.asarray(queries))
    want_s, want_i = jax_topk.masked_topk_int8(
        qq, qs, cq, cs, None if mask is None else jnp.asarray(mask), k=8)
    tq, ts = topk.quantize_int8(torch.from_numpy(queries))
    tcq, tcs = topk.quantize_int8(torch.from_numpy(corpus))
    got_s, got_i = topk.masked_topk_int8(
        tq, ts, tcq, tcs, None if mask is None else torch.from_numpy(mask),
        k=8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_i[0, :4].tolist() == [3, 7, 19, 33]  # lower index first


# ------------------------------------------------------ shared disk format


def _write(client_cls, root, name, ids, embs, metas, **kw):
    client = client_cls(str(root), **kw)
    col = client.get_or_create_collection(name,
                                          metadata={"hnsw:space": "cosine"})
    col.stamp_embedding_profile("tiny|tome0|quant-none|gray0")
    col.upsert(ids[:-5], embs[:-5], metas[:-5])
    client.flush()
    # a second flush appends a log segment: both layouts are read back
    col.upsert(ids[-5:], embs[-5:], metas[-5:])
    col.delete(ids=[ids[0]])
    client.flush()
    return col


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_collections_cross_read_between_packages(tmp_path, writer):
    ids, embs, metas = _rows(40)
    if writer == "jax":
        _write(jax_vs.PersistentClient, tmp_path, "c", ids, embs, metas)
        col = vs.PersistentClient(str(tmp_path), device="cpu") \
            .get_collection("c")
    else:
        _write(vs.PersistentClient, tmp_path, "c", ids, embs, metas,
               device="cpu")
        col = jax_vs.PersistentClient(str(tmp_path)).get_collection("c")
    assert len(col._segments) == 1
    got = col.get(include=("embeddings", "metadatas"))
    assert got["ids"] == ids[1:]
    assert got["metadatas"] == metas[1:]
    np.testing.assert_array_equal(got["embeddings"], embs[1:])
    assert (col.space, col.embedding_profile) == (
        "cosine", "tiny|tome0|quant-none|gray0")


def test_profile_fence_holds_across_packages(tmp_path):
    ids, embs, metas = _rows(6)
    client = vs.PersistentClient(str(tmp_path), device="cpu")
    col = client.get_or_create_collection("c")
    col.stamp_embedding_profile("torch|tiny|tome0|quant-none|gray0")
    col.upsert(ids, embs, metas)
    client.flush()
    other = jax_vs.PersistentClient(str(tmp_path)).get_collection("c")
    with pytest.raises(ValueError, match="mixing embedding spaces"):
        other.stamp_embedding_profile("tiny|tome0|quant-none|gray0")


# ----------------------------------------------------------------- queries


def _pair(tmp_path, n, space, device_quant=None, d=24):
    ids, embs, metas = _rows(n, d=d, seed=n)
    cols = {}
    for name, mod, kw in (("jax", jax_vs, {}), ("torch", vs,
                                                 {"device": "cpu"})):
        client = mod.PersistentClient(str(tmp_path / name), **kw)
        col = client.get_or_create_collection(
            "c", metadata={"hnsw:space": space,
                           "vrt:device_quant": device_quant})
        col.upsert(ids, embs, metas)
        cols[name] = col
    return cols


WHERES = [None, {"label": "left"}, {"t": {"$gte": 20}}]


@pytest.mark.parametrize("space", ["l2", "cosine", "ip"])
@pytest.mark.parametrize("where", WHERES)
def test_query_numpy_route_matches_jax(tmp_path, space, where):
    cols = _pair(tmp_path, 60, space)
    q = np.random.default_rng(9).standard_normal((3, 24)).astype(np.float32)
    assert 60 * 3 < 1 << 14  # the host numpy route on both sides
    got = cols["torch"].query(q, n_results=7, where=where)
    want = cols["jax"].query(q, n_results=7, where=where)
    assert got["ids"] == want["ids"]
    assert got["metadatas"] == want["metadatas"]
    np.testing.assert_array_equal(got["distances"], want["distances"])


@pytest.mark.parametrize("space", ["l2", "cosine"])
@pytest.mark.parametrize("where", WHERES)
def test_query_device_route_on_cpu_matches_jax(tmp_path, space, where):
    cols = _pair(tmp_path, 600, space)
    q = np.random.default_rng(10).standard_normal((32, 24)).astype(np.float32)
    assert 600 * 32 >= 1 << 14  # the device route on both sides
    got = cols["torch"].query(q, n_results=9, where=where)
    want = cols["jax"].query(q, n_results=9, where=where)
    tol = 1e-5 * (1 if space == "cosine" else 100)  # l2 distances ~50
    assert_same_neighbours(got, want, tol=tol)
    if where:
        picked = cols["torch"].get(where=where)["ids"]
        assert all(i in picked for row in got["ids"] for i in row)


@pytest.mark.parametrize("where", [None, {"label": "none"}])
def test_query_device_route_int8_matches_jax(tmp_path, where):
    cols = _pair(tmp_path, 600, "cosine", device_quant="int8", d=32)
    q = np.random.default_rng(11).standard_normal((32, 32)).astype(np.float32)
    got = cols["torch"].query(q, n_results=9, where=where)
    want = cols["jax"].query(q, n_results=9, where=where)
    # int8 scores are exact integers rescaled identically on both sides;
    # only the L2 normalisation before quantizing differs by an ulp.
    assert_same_neighbours(got, want, tol=1e-5)


def test_query_ivf_route_matches_jax(tmp_path):
    cols = _pair(tmp_path, 400, "cosine")
    for col in cols.values():
        col.ivf_threshold = 100
    q = np.random.default_rng(12).standard_normal((40, 24)).astype(np.float32)
    got = cols["torch"].query(q, n_results=5)
    want = cols["jax"].query(q, n_results=5)
    assert got["ids"] == want["ids"]
    np.testing.assert_allclose(got["distances"], want["distances"],
                               rtol=0, atol=1e-6)


def test_device_query_raises_instead_of_answering_on_host(tmp_path,
                                                          monkeypatch):
    cols = _pair(tmp_path, 600, "cosine")
    col = cols["torch"]

    def broken(*a, **k):
        raise RuntimeError("device failure")

    monkeypatch.setattr(vs, "masked_topk", broken)
    q = np.zeros((32, 24), np.float32)
    with pytest.raises(RuntimeError, match="device failure"):
        col.query(q, n_results=3)


def test_cuda_client_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="is_available"):
        vs.PersistentClient(str(tmp_path))


# ------------------------------------------------------------- IVF metas


def _save_meta(path, **override):
    arrays = dict(centroids=np.eye(3, 4, dtype=np.float32),
                  order=np.arange(10), bounds=np.array([0, 3, 6, 10]), n=10,
                  nprobe=2, fingerprint=np.zeros(20, np.uint8))
    arrays.update(override)
    np.savez(path, **arrays)
    return path


def test_ivf_meta_loads_when_well_formed(tmp_path):
    idx, fp = ivf.IVFIndex.load_meta(_save_meta(tmp_path / "ok.npz"))
    assert [c.tolist() for c in idx.cells] == [[0, 1, 2], [3, 4, 5],
                                               [6, 7, 8, 9]]
    assert idx._n == 10 and fp == bytes(20)


@pytest.mark.parametrize("bad,match", [
    (dict(bounds=np.array([0, 6, 3, 10])), "monotone"),
    (dict(bounds=np.array([0, 3, 6, 9])), "bounds end at 9"),
    (dict(order=np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 10])), "outside"),
    (dict(centroids=np.ones(4, np.float32)), "centroids"),
])
def test_ivf_meta_validation_rejects_malformed_metas(tmp_path, bad, match):
    path = _save_meta(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match=match):
        ivf.IVFIndex.load_meta(path)


def test_prewarm_refits_over_a_malformed_meta(tmp_path):
    ids, embs, metas = _rows(300)
    client = vs.PersistentClient(str(tmp_path), device="cpu")
    col = client.get_or_create_collection(
        "c", metadata={"hnsw:space": "cosine"})
    col.ivf_threshold = 100
    col.upsert(ids, embs, metas)
    client.flush()
    # 1-D centroids: the reference let this escape as an IndexError
    _save_meta(os.path.join(str(tmp_path), "c", "ivf_meta.npz"),
               centroids=np.ones(24, np.float32), n=300,
               order=np.arange(300), bounds=np.array([0, 300]))
    assert col.prewarm_index()
    assert col._ivf.centroids.ndim == 2 and col._ivf_persisted


def test_port_adopts_a_jax_persisted_ivf_fit(tmp_path):
    ids, embs, metas = _rows(300)
    client = jax_vs.PersistentClient(str(tmp_path))
    col = client.get_or_create_collection(
        "c", metadata={"hnsw:space": "cosine"})
    col.ivf_threshold = 100
    col.upsert(ids, embs, metas)
    client.flush()
    assert col.prewarm_index()
    port = vs.PersistentClient(str(tmp_path), device="cpu") \
        .get_collection("c")
    port.ivf_threshold = 100
    assert port.prewarm_index() and port._ivf_persisted
    np.testing.assert_array_equal(port._ivf.centroids, col._ivf.centroids)
    q = embs[:20] + 0.01
    assert port.query(q, n_results=4)["ids"] == \
        col.query(q, n_results=4)["ids"]


def test_ivf_search_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((10, 16)).astype(np.float32)
    mine = ivf.IVFIndex(nprobe=3).fit(x)
    ref = jax_ivf.IVFIndex(nprobe=3).fit(x)
    for got, want in zip(mine.search(q, x, 6, extra=np.arange(490, 500)),
                         ref.search(q, x, 6, extra=np.arange(490, 500))):
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- frame store, chunks


def test_frame_store_chunk_index_and_stats_match_jax(tmp_path):
    from vit_research_tpu.db import enrich as jax_enrich
    from vit_research_tpu.db import frame_store as jax_fs
    from vit_research_tpu_torch.db import enrich, frame_store

    rng = np.random.default_rng(14)
    paths = [f"clips/vid1_clip_1_left/vid1_frame_{i}.jpg" for i in range(30)]
    table = {p: rng.standard_normal(16).astype(np.float32) for p in paths}

    def embed(batch):
        return np.stack([table[p] for p in batch])

    chunks = [{"frames": paths[s:s + 6], "label": s % 2, "status_id": 0,
               "vid": 1, "clip": 1, "start_idx": s, "end_idx": s + 5,
               "t_center": s / 30, "t_width": 0.2, "side": "left"}
              for s in range(0, 25, 3)]
    store = frame_store.FrameStore.build(paths + paths[:4], embed,
                                         str(tmp_path / "s"), batch_size=7,
                                         embedding_profile="torch|x")
    frame_store.build_chunk_index(chunks, store, str(tmp_path / "s"))
    ref = jax_fs.FrameStore(str(tmp_path / "s")).open()  # the port's files
    assert (ref.n, ref.dim, ref.embedding_profile) == (30, 16, "torch|x")
    idx = frame_store.load_chunk_index(str(tmp_path / "s"))
    want_idx = jax_fs.load_chunk_index(str(tmp_path / "s"))
    for key in want_idx:
        np.testing.assert_array_equal(idx[key], want_idx[key])
    got = frame_store.gather_chunk_embedding_batch(store, idx, [0, 3, 8])
    want = jax_fs.gather_chunk_embedding_batch(ref, want_idx, [0, 3, 8])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1, 0], table[paths[9]])
    np.testing.assert_array_equal(enrich.chunk_stats(got),
                                  jax_enrich.chunk_stats(want))
