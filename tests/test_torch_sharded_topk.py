"""The mesh-sharded exact top-k (ops/sharded_topk.py) and the store's
sharded device corpus against the JAX package's, and against the port's
flat path.

The JAX side runs on conftest's 8 virtual CPU devices, the port's on an
8-entry mesh of the CPU (parallel/mesh.py: a mesh may name a device more
than once). The cases are tests/test_sharded_topk.py's. Results are exact
as the flat path's: the same indices (ties included: the lower index
first) and scores within 1e-5 (f32 products summed in other orders);
entries filled with NEG_INF agree on being filled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_research_tpu.ops import sharded_topk as jax_sharded
from vit_research_tpu.ops import topk as jax_topk
from vit_research_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vit_research_tpu.store.vector_store import Collection as JaxCollection
from vit_research_tpu_torch.ops import topk
from vit_research_tpu_torch.ops.sharded_topk import (pad_corpus,
                                                     place_sharded,
                                                     sharded_masked_topk,
                                                     sharded_masked_topk_int8)
from vit_research_tpu_torch.parallel.mesh import Mesh, make_mesh
from vit_research_tpu_torch.store.vector_store import (Collection,
                                                       PersistentClient)

torch.set_num_threads(1)

SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def meshes():
    """(the port's 8-entry CPU mesh, JAX's mesh of its 8 devices)."""
    return make_mesh(devices=["cpu"] * 8), jax_make_mesh()


def _np(*xs):
    return [np.asarray(x) for x in xs]


def _same(got, want):
    """(scores, indices) pairs equal as the flat contract says: valid
    entries the same indices and scores within SCORE_TOL; NEG_INF fill
    entries filled on both sides."""
    (gs, gi), (ws, wi) = _np(*got), _np(*want)
    assert gs.shape == ws.shape
    valid = ws > -1e29
    assert ((gs > -1e29) == valid).all()
    np.testing.assert_allclose(gs[valid], ws[valid], rtol=0, atol=SCORE_TOL)
    np.testing.assert_array_equal(gi[valid], wi[valid])


def _three_ways(q, c, mask, k, metric, meshes):
    """The port's sharded answer against its flat answer and JAX's
    sharded answer."""
    mesh, jmesh = meshes
    got = sharded_masked_topk(q, c, mask, k=k, mesh=mesh, metric=metric)
    flat = topk.masked_topk(torch.from_numpy(q), torch.from_numpy(c),
                            None if mask is None else torch.from_numpy(mask),
                            k=k, metric=metric)
    want = jax_sharded.sharded_masked_topk(q, c, mask, k=k, mesh=jmesh,
                                           metric=metric)
    _same(got, flat)
    _same(got, want)
    return got


@pytest.mark.parametrize("n", [64, 61, 8, 5, 3])
@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
def test_parity_shapes_and_masks(meshes, n, metric):
    rng = np.random.default_rng(1234)
    q = rng.normal(size=(7, 16)).astype(np.float32)
    c = rng.normal(size=(n, 16)).astype(np.float32)
    if metric == "cosine":
        q = np.asarray(jax_topk.l2_normalize(q))
        c = np.asarray(jax_topk.l2_normalize(c))
    mask = rng.random((7, n)) > 0.3
    _three_ways(q, c, mask, 6, metric, meshes)
    _three_ways(q, c, None, 6, metric, meshes)


def test_tie_breaking_matches_flat(meshes):
    """Duplicated rows tie across shards: the merged order is the flat
    path's, the lower index first (and JAX's)."""
    rng = np.random.default_rng(1234)
    c = np.repeat(rng.normal(size=(8, 16)).astype(np.float32), 4, axis=0)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    s, i = _three_ways(q, c, None, 12, "ip", meshes)
    i = np.asarray(i)
    for row, srow in zip(i, np.asarray(s)):
        for a in range(len(row) - 1):
            if srow[a] == srow[a + 1]:
                assert row[a] < row[a + 1]


def test_k_larger_than_corpus(meshes):
    rng = np.random.default_rng(1234)
    q = rng.normal(size=(4, 8)).astype(np.float32)
    c = rng.normal(size=(10, 8)).astype(np.float32)
    s, i = _three_ways(q, c, None, 50, "ip", meshes)
    assert s.shape == (4, 10) and i.shape == (4, 10)


def test_fully_masked_rows_fill_neg_inf(meshes):
    rng = np.random.default_rng(1234)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    c = rng.normal(size=(9, 8)).astype(np.float32)
    mask = np.zeros((2, 9), bool)
    mask[1, 3] = True
    s, i = _three_ways(q, c, mask, 4, "ip", meshes)
    s = s.numpy()
    assert (s[0] < -1e29).all()
    assert (s[1, 0] > -1e29) and (s[1, 1:] < -1e29).all()
    assert int(i[1, 0]) == 3


def test_preplaced_padded_corpus_needs_n_valid(meshes):
    """Zero padding rows score 0 under 'ip'; with every true score
    negative they would win unless n_valid rejects them."""
    mesh, jmesh = meshes
    rng = np.random.default_rng(1234)
    q = -np.abs(rng.normal(size=(3, 8))).astype(np.float32)
    c = np.abs(rng.normal(size=(10, 8))).astype(np.float32)
    cp, n = pad_corpus(c, 8)
    assert cp.shape[0] == 16 and n == 10
    placed = place_sharded(cp, mesh)
    assert [s.shape[0] for s in placed.shards] == [2] * 8
    got = sharded_masked_topk(q, placed, None, k=5, mesh=mesh, metric="ip",
                              n_valid=n)
    jcp, _ = jax_sharded.pad_corpus(jnp.asarray(c), 8)
    want = jax_sharded.sharded_masked_topk(
        q, jax_sharded.place_sharded(jcp, jmesh), None, k=5, mesh=jmesh,
        metric="ip", n_valid=n)
    _same(got, want)
    assert (got[1] < n).all()
    with pytest.raises(ValueError, match="pad_corpus"):
        place_sharded(c, mesh)


def test_broadcastable_column_mask_matches_flat(meshes):
    """A (Q, 1) mask broadcasts to (Q, N), as in the flat contract."""
    mesh, _ = meshes
    rng = np.random.default_rng(1234)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    c = rng.normal(size=(16, 8)).astype(np.float32)
    mask = np.ones((3, 1), bool)
    mask[1, 0] = False  # query 1 sees nothing
    _three_ways(q, c, mask, 4, "ip", meshes)
    with pytest.raises(ValueError, match="columns"):
        sharded_masked_topk(q, c, np.ones((3, 7), bool), k=4, mesh=mesh,
                            metric="ip")


def test_int8_parity(meshes):
    mesh, jmesh = meshes
    rng = np.random.default_rng(1234)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    c = rng.normal(size=(50, 32)).astype(np.float32)
    qq, qs = topk.quantize_int8(torch.from_numpy(q))
    cq, cs = topk.quantize_int8(torch.from_numpy(c))
    mask = rng.random((5, 50)) > 0.2
    for m in (mask, None):
        got = sharded_masked_topk_int8(qq, qs, cq, cs, m, k=9, mesh=mesh)
        flat = topk.masked_topk_int8(
            qq, qs, cq, cs, None if m is None else torch.from_numpy(m), k=9)
        want = jax_sharded.sharded_masked_topk_int8(
            *_np(qq, qs, cq, cs), m, k=9, mesh=jmesh)
        _same(got, flat)
        _same(got, want)


def test_2d_mesh_shards_over_named_axis_only(meshes):
    """On a (data x model) mesh the corpus splits over 'data' only (4
    shards, each computed at model index 0) and stays exact."""
    _, jmesh = meshes
    from jax.sharding import Mesh as JaxMesh

    mesh2d = Mesh(np.full((4, 2), "cpu", dtype=object), ("data", "model"))
    jmesh2d = JaxMesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                      ("data", "model"))
    rng = np.random.default_rng(1234)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    c = rng.normal(size=(42, 16)).astype(np.float32)
    mask = rng.random((5, 42)) > 0.3
    placed = place_sharded(pad_corpus(c, 4)[0], mesh2d)
    assert len(placed.shards) == 4
    _three_ways(q, c, mask, 6, "ip", (mesh2d, jmesh2d))


def test_empty_corpus_raises(meshes):
    mesh, _ = meshes
    with pytest.raises(ValueError, match="empty"):
        sharded_masked_topk(np.zeros((1, 4), np.float32),
                            np.zeros((0, 4), np.float32), None, k=3,
                            mesh=mesh)


# ---------------------------------------------------------- Collection

def _mk(space, n=40, d=16, **kw):
    """A port collection on the CPU and the JAX one with the same rows."""
    rng = np.random.default_rng(1234)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    ids = [f"id{i}" for i in range(n)]
    metas = [{"vid_num": f"vid{i % 3}", "t_norm": i / n} for i in range(n)]
    cols = (Collection("t", space=space, device="cpu", **kw),
            JaxCollection("t", space=space, **kw))
    for col in cols:
        col.upsert(ids, emb, metas)
    return cols, rng


def _same_answers(got, want):
    assert got["ids"] == want["ids"]
    for a, b in zip(got["distances"], want["distances"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("space", ["cosine", "l2", "ip"])
def test_collection_sharded_query_parity(meshes, space):
    """A filtered query on the sharded corpus equals the unsharded one and
    the JAX collection sharded over its mesh; unsharding restores the
    routing."""
    mesh, jmesh = meshes
    (col, jcol), rng = _mk(space)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    where = {"vid_num": {"$ne": "vid1"}}
    expected = col.query(q, n_results=5, where=where)
    col.shard_device(mesh)
    jcol.shard_device(jmesh)
    got = col.query(q, n_results=5, where=where)
    _same_answers(got, expected)
    _same_answers(got, jcol.query(q, n_results=5, where=where))
    assert len(col._device_cache.shards) == 8
    col.shard_device(None)
    assert col.query(q, n_results=5, where=where)["ids"] == expected["ids"]


def test_collection_sharded_ships_no_mask_unfiltered(meshes, monkeypatch):
    """An unfiltered query hands the shards no mask: the padding rows are
    rejected by n_valid inside each shard."""
    from vit_research_tpu_torch.ops import sharded_topk as st

    mesh, _ = meshes
    (col, _), rng = _mk("cosine", n=43)
    col.shard_device(mesh)
    seen = []
    orig = st._merge
    monkeypatch.setattr(st, "_merge", lambda fn, c, m, n, k: (
        seen.append((m, n)), orig(fn, c, m, n, k))[1])
    q = rng.normal(size=(2, 16)).astype(np.float32)
    got = col.query(q, n_results=43)
    assert seen == [(None, 43)]
    assert all(len(row) == 43 for row in got["ids"])


def test_collection_sharded_int8(meshes):
    """int8 corpus, quantized on the host in blocks: the same ids as the
    unsharded int8 device path (big enough to take it: n * Q >= 2^14)
    and as JAX's sharded int8."""
    mesh, jmesh = meshes
    (col, jcol), rng = _mk("cosine", n=4101, device_quant="int8")
    q = rng.normal(size=(4, 16)).astype(np.float32)
    expected = col.query(q, n_results=6)
    col.shard_device(mesh)
    jcol.shard_device(jmesh)
    got = col.query(q, n_results=6)
    assert got["ids"] == expected["ids"]
    assert got["ids"] == jcol.query(q, n_results=6)["ids"]
    rows, scales = col._device_cache
    assert rows.shards[0].dtype == torch.int8 and len(scales.shards) == 8
    # host blocks smaller than a shard quantize as one pass does
    small = col._sharded_corpus(block=100)
    for a, b in zip(small[0].shards + small[1].shards,
                    rows.shards + scales.shards):
        assert torch.equal(a, b)


def test_collection_sharded_after_disk_roundtrip(meshes, tmp_path):
    """shard_device composes with persistence: flush, reopen from disk,
    shard the reopened collection, the same answers."""
    mesh, _ = meshes
    rng = np.random.default_rng(1234)
    client = PersistentClient(str(tmp_path / "db"), autoflush=False,
                              device="cpu")
    col = client.get_or_create_collection(
        "c", metadata={"hnsw:space": "cosine"})
    emb = rng.normal(size=(40, 16)).astype(np.float32)
    col.upsert([f"id{i}" for i in range(40)], emb)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    expected = col.query(q, n_results=5)["ids"]
    quant = client.get_or_create_collection(
        "cq", metadata={"hnsw:space": "cosine", "vrt:device_quant": "int8"})
    quant.upsert(["a"], emb[:1])
    client.flush()
    reloaded = PersistentClient(str(tmp_path / "db"), device="cpu")
    col2 = reloaded.get_collection("c")
    col2.shard_device(mesh)
    assert col2.query(q, n_results=5)["ids"] == expected
    assert reloaded.get_collection("cq").device_quant == "int8"


def test_collection_sharded_survives_upsert(meshes):
    mesh, _ = meshes
    (col, _), rng = _mk("cosine")
    col.shard_device(mesh)
    q = rng.normal(size=(2, 16)).astype(np.float32)
    col.query(q, n_results=3)  # builds the sharded corpus
    assert col._device_cache is not None
    new = rng.normal(size=(3, 16)).astype(np.float32)
    col.upsert(["n0", "n1", "n2"], new)  # invalidates it
    assert col._device_cache is None
    assert col.query(new, n_results=1)["ids"] == [["n0"], ["n1"], ["n2"]]
