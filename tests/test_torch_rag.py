"""The retrieval heads, retrievers, builders and async rebuild of the port
against the JAX package: RAGHead, RATTHead and cls_retrieval_importance
through models/convert.py both ways, ProjectionHead at 768 -> 768 and 2304
-> 768 shapes, Enricher and chunk statistics, FrameRetriever and
RattChunkRetriever on the same rows as the JAX retrievers, the five
builders, SwappableCollection and RebuildScheduler.

Inputs are drawn with numpy from fixed seeds; weights come from the flax
init, converted. Tolerances: both sides compute in f32 on the CPU and
differ in summation order: head outputs 1e-5 (two transformer layers of
width 32-64, outputs of order 1), single reductions 1e-6; retrieved rows
and rebuilt rows 1e-6 (one normalisation each); retrieval ids and
metadata exactly.
"""

import threading
import time
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.db import builders as jax_builders
from vit_research_tpu.db import enrich as jax_enrich
from vit_research_tpu.models import heads as jax_heads
from vit_research_tpu.retrieval import retrievers as jax_retrievers
from vit_research_tpu.store.vector_store import Collection as JaxCollection
from vit_research_tpu.train import async_rebuild as jax_async
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu_torch.db import builders, enrich
from vit_research_tpu_torch.models import convert, heads
from vit_research_tpu_torch.retrieval import (FrameRetriever,
                                              RattChunkRetriever)
from vit_research_tpu_torch.store.vector_store import Collection
from vit_research_tpu_torch.train.async_rebuild import (RebuildScheduler,
                                                        SwappableCollection)
from vit_research_tpu_torch.utils import configs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HEAD_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-6, atol=1e-6)
D = 32
# two heads of width 16 (the real heads: 768 / 4 = 192), three queries
HEAD_KW = dict(embed_dim=D, num_layers=2, num_heads=2, mlp_dim=16,
               num_queries=3, max_tokens=16, classifier_dropout=0.0)
HEAD = configs.HeadConfig(**HEAD_KW)
JAX_HEAD = jax_configs.HeadConfig(**HEAD_KW)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _same_tree(a, b) -> bool:
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    return ta == tb and all(np.array_equal(x, y) for x, y in zip(la, lb))


def _inputs(b=3, k=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, D)).astype(np.float32),
            rng.standard_normal((b, k, D)).astype(np.float32))


# ------------------------------------------------------------------ heads


def test_rag_head_matches_jax_through_convert():
    cls, ret = _inputs()
    jm = jax_heads.RAGHead(JAX_HEAD)
    p = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, D)),
                         jnp.zeros((1, 5, D))))
    want_logits, want_fused = jm.apply(p, cls, ret)
    m = heads.RAGHead(HEAD)
    m.load_state_dict(convert.rag_head_to_state_dict(p))
    m.eval()
    with torch.no_grad():
        logits, fused = m(_t(cls), _t(ret))
    assert logits.shape == (3, 1) and fused.shape == (3, D)
    np.testing.assert_allclose(logits.numpy(), want_logits, **HEAD_TOL)
    np.testing.assert_allclose(fused.numpy(), want_fused, **HEAD_TOL)
    assert _same_tree(convert.rag_head_to_params(m.state_dict(), HEAD), p)
    # the port's own seeded init has the flax tree's layout
    fresh = heads.RAGHead(HEAD, generator=torch.Generator().manual_seed(0))
    assert set(fresh.state_dict()) == set(m.state_dict())
    assert jax.tree_util.tree_structure(convert.rag_head_to_params(
        fresh.state_dict(), HEAD)) == jax.tree_util.tree_structure(p)


@pytest.mark.parametrize("relevance,use_retrieval", [
    (False, True), (True, True), (False, False)])
def test_ratt_head_matches_jax_through_convert(relevance, use_retrieval):
    cls, ret = _inputs(seed=1)
    jm = jax_heads.RATTHead(JAX_HEAD, use_relevance_head=relevance)
    p = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, D)),
                         jnp.zeros((1, 5, D))))
    want = jm.apply(p, cls, ret, use_retrieval=use_retrieval)
    m = heads.RATTHead(HEAD, use_relevance_head=relevance)
    m.load_state_dict(convert.ratt_head_to_state_dict(p))
    m.eval()
    with torch.no_grad():
        got = m(_t(cls), _t(ret), use_retrieval=use_retrieval)
    for i in (0, 2):
        np.testing.assert_allclose(got[i].numpy(), want[i], **HEAD_TOL)
    assert (got[1] is None) == (want[1] is None) == (not relevance)
    if relevance:
        np.testing.assert_allclose(got[1].numpy(), want[1], **HEAD_TOL)
    t = 6 if use_retrieval else 1
    assert len(got[3]) == len(want[3]) == 2
    for g, w in zip(got[3], want[3]):
        assert g.shape == (3, 2, t, t)
        np.testing.assert_allclose(g.numpy(), w, **HEAD_TOL)
    if use_retrieval:
        np.testing.assert_allclose(
            heads.cls_retrieval_importance(got[3]).numpy(),
            jax_heads.cls_retrieval_importance(want[3]), **HEAD_TOL)
    assert _same_tree(convert.ratt_head_to_params(m.state_dict(), HEAD), p)


def test_ratt_head_refuses_a_sequence_past_max_tokens():
    cls, ret = _inputs(k=16)
    with pytest.raises(ValueError, match="max_tokens"):
        heads.RATTHead(HEAD)(_t(cls), _t(ret))


@pytest.mark.parametrize("head", ["RAGHead", "RATTHead"])
def test_heads_refuse_bfloat16(head):
    """bf16 is no longer refused: it is a compute dtype over f32
    parameters (tests/test_torch_precision.py holds it against JAX)."""
    m = getattr(heads, head)(configs.HeadConfig(embed_dim=D, num_heads=2,
                                                dtype="bfloat16")).eval()
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    cls, ret = _inputs()
    out = m(_t(cls), _t(ret))
    assert out[0].dtype == torch.bfloat16  # the logits
    assert out[-2 if head == "RATTHead" else 1].dtype == torch.float32


@pytest.mark.parametrize("in_dim,hidden", [(D, 768), (3 * D, D)])
def test_projection_head_matches_jax_through_convert(in_dim, hidden):
    """The RAG projection (d -> d, hidden 768) and the RATT chunk
    projection (3d -> d -> d)."""
    x = np.random.default_rng(2).standard_normal((4, in_dim)) \
        .astype(np.float32)
    jm = jax_heads.ProjectionHead(input_dim=in_dim, hidden_dim=hidden,
                                  proj_dim=D)
    p = _np_tree(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, in_dim))))
    m = heads.ProjectionHead(in_dim, hidden_dim=hidden, proj_dim=D)
    m.load_state_dict(convert.projection_head_to_state_dict(p))
    with torch.no_grad():
        got = m(_t(x)).numpy()
    np.testing.assert_allclose(got, jm.apply(p, x), **HEAD_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert _same_tree(convert.projection_head_to_params(m.state_dict()), p)


def test_rag_head_at_reference_width_gives_kernel_b_dh192():
    """HeadConfig()'s blocks are 768 wide with 4 heads: dh = 192, the width
    kernel B takes since this slice, at T = 1 + num_queries = 5."""
    from vit_research_tpu_torch.ops import attention as attn

    c = configs.HeadConfig()
    assert c.embed_dim // c.num_heads == 192 in attn.KERNEL_HEAD_DIMS
    m = heads.RAGHead(c, generator=torch.Generator().manual_seed(0))
    assert len(m.blocks) == 2 and m.pos_embedding.shape == (1, 5, 768)
    assert m.blocks[0].attn.num_heads == 4
    assert m.blocks[0].mlp.fc1.out_features == 3072


# ------------------------------------------------------- enrich, chunk stats


def test_enricher_matches_jax():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((5, 48)).astype(np.float32)
    t_norm = rng.uniform(0, 1, 5)
    sides = ["left", "right", "left", "none", "right"]
    idx = [3, 17, 40, 2, 9]
    kw = dict(base_dim=48, enrich_dim=24, side_dim=16, hidden=32, seed=7)
    got, want = enrich.Enricher(**kw), jax_enrich.Enricher(**kw)
    np.testing.assert_array_equal(got.projection, want.projection)
    for max_idx in (None, 100):
        np.testing.assert_array_equal(
            got(base, t_norm, sides, idx, max_frame_idx=max_idx),
            want(base, t_norm, sides, idx, max_frame_idx=max_idx))
    default = enrich.Enricher()
    assert default.projection.shape == (768 * 4, 768)


def test_chunk_stats_torch_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 8, D)) \
        .astype(np.float32)
    want = np.asarray(jax_enrich.chunk_stats_jax(jnp.asarray(x)))
    got = enrich.chunk_stats_torch(_t(x))
    assert got.shape == (3, 3 * D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(enrich.chunk_stats(x), want, **TOL)


# ------------------------------------------------------------- retrievers


def _fill(n=120, d=D, seed=0, time_field="t_norm", space="cosine",
          ties=False):
    """The same rows into a JAX and a port collection. With ``ties``,
    rows come in identical pairs (planted exact ties)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    if ties:
        emb[1::2] = emb[0::2]
    metas = [{"vid_num": i % 4, "side": "left" if i % 3 else "right",
              time_field: (i % 10) / 10.0, "clip_num": i % 6}
             for i in range(n)]
    ids = [f"e{i}" for i in range(n)]
    jcol, col = JaxCollection("db", space=space), \
        Collection("db", space=space, device="cpu")
    for c in (jcol, col):
        c.upsert(ids, emb, [dict(m) for m in metas])
    return jcol, col


def _md(vids, sides, t_centers, t_widths):
    return {"vid": np.asarray(vids),
            "side": np.asarray(sides, dtype=object),
            "t_center": np.asarray(t_centers, np.float32),
            "t_width": np.asarray(t_widths, np.float32)}


def _assert_same_rows(got, want):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # zero padding at the same places
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0,
                                  np.abs(want).sum(-1) == 0)


QUERY_MD = _md([0, 1, 2, 3], ["left", "right", "left", "none"],
               [0.42, 0.51, 0.23, 0.5], [0.37, 0.55, 0.21, 1.0])


@pytest.mark.parametrize("cls_name", ["FrameRetriever",
                                      "RattChunkRetriever"])
@pytest.mark.parametrize("space,ties", [("cosine", False), ("cosine", True),
                                        ("l2", False), ("ip", True)])
def test_retrievers_match_jax(cls_name, space, ties):
    """Mask (vid, side, time window), ranking in the collection's space,
    ties to the lower index, zero padding and normalised rows; unknown
    sides ("none") match nothing."""
    field = "t_norm" if cls_name == "FrameRetriever" else "t_center"
    jcol, col = _fill(time_field=field, space=space, ties=ties)
    q = 3.0 * np.random.default_rng(5).normal(size=(4, D)).astype(
        np.float32)
    if ties:  # the queries sit exactly on tied rows
        q[0] = jcol._embeddings[10]
    want = getattr(jax_retrievers, cls_name)(jcol, top_k=7)(q, QUERY_MD)
    got = globals()[cls_name](col, top_k=7)(q, QUERY_MD)
    _assert_same_rows(got, want)
    assert np.abs(want[3]).sum() == 0  # the "none" query: padded


def test_retriever_takes_tensors_and_a_top_k_past_the_rows():
    jcol, col = _fill(n=6)
    q = np.random.default_rng(6).normal(size=(2, D)).astype(np.float32)
    md = _md([9, 9], ["left", "right"], [0.5, 0.5], [2.0, 2.0])
    want = jax_retrievers.FrameRetriever(jcol, top_k=10)(q, md)
    got = FrameRetriever(col, top_k=10)(
        torch.from_numpy(q), {k: torch.as_tensor(v) if k != "side" else v
                              for k, v in md.items()})
    _assert_same_rows(got, want)


def test_retriever_zero_pads_when_nothing_matches():
    jcol, col = _fill(n=8)
    q = np.random.default_rng(3).normal(size=(1, D)).astype(np.float32)
    md = _md([0], ["left"], [0.55], [0.01])
    got = FrameRetriever(col, top_k=6)(q, md)
    want = jax_retrievers.FrameRetriever(jcol, top_k=6)(q, md)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.zeros((1, 6, D)))


@pytest.mark.parametrize("same_id", [False, True])
def test_retriever_refreshes_after_upsert(same_id):
    """A new row, or an in-place re-upsert of an existing id (neither the
    count nor the array changes), is seen by the next call."""
    jcol, col = _fill(n=16)
    q = np.random.default_rng(4).normal(size=(1, D)).astype(np.float32)
    md = _md([9], ["left"], [0.5], [1.0])
    rets = [jax_retrievers.FrameRetriever(jcol, top_k=3),
            FrameRetriever(col, top_k=3)]
    before = [r(q, md) for r in rets]
    target = (q[0] / np.linalg.norm(q[0])).astype(np.float32)
    meta = {"vid_num": 0, "side": "left", "t_norm": 0.5, "clip_num": 0}
    for c in (jcol, col):
        c.upsert(["e1" if same_id else "new"], target[None], [dict(meta)])
    want, got = (r(q, md) for r in rets)
    _assert_same_rows(got, want)
    assert float(got[0, 0] @ torch.from_numpy(target)) > 0.999
    assert not np.allclose(before[1].numpy(), got.numpy())


def test_retriever_ranks_an_l2_collection_by_l2():
    col = Collection("frames", space="l2", device="cpu")
    q = np.zeros((1, 8), np.float32)
    q[0, 0] = 1.0
    a = np.zeros(8, np.float32)
    a[0] = 50.0  # cosine 1, far by L2
    b = np.zeros(8, np.float32)
    b[:2] = (0.9, 0.5)  # lower cosine, near by L2
    meta = {"vid_num": 1, "side": "left", "t_norm": 0.5, "clip_num": 0}
    col.upsert(["a", "b"], np.stack([a, b]), [dict(meta), dict(meta)])
    out = FrameRetriever(col, top_k=1)(q, _md([9], ["left"], [0.5], [1.0]))
    assert float(out[0, 0] @ torch.from_numpy(b / np.linalg.norm(b))) \
        > 0.999


def test_retriever_on_an_empty_collection():
    md = _md([0, 1], ["left", "right"], [0.5, 0.5], [1.0, 1.0])
    q = np.ones((2, 8), np.float32)
    got = RattChunkRetriever(Collection("db", space="cosine",
                                        device="cpu"), top_k=3)(q, md)
    want = jax_retrievers.RattChunkRetriever(
        JaxCollection("db", space="cosine"), top_k=3)(q, md)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (2, 3, 8)


def test_retriever_device_follows_the_collection():
    """The retriever runs on its collection's device, also behind a
    SwappableCollection, and its answer lies there."""
    _, col = _fill(n=8)
    q = np.ones((1, D), np.float32)
    md = _md([9], ["left"], [0.5], [1.0])
    for c in (col, SwappableCollection(col)):
        ret = FrameRetriever(c)
        assert ret.device == col.device == torch.device("cpu")
        assert ret(q, md).device == col.device


def test_device_snapshot_is_a_versioned_copy():
    """``Collection.device_snapshot``: None while the version holds, a
    new version after an in-place same-id upsert, and rows that the
    upsert does not reach into."""
    _, col = _fill(n=8)
    version, rows, cols = col.device_snapshot(("vid_num", "t_norm"))
    assert rows.dtype == torch.float32 and rows.device == col.device
    np.testing.assert_array_equal(rows.numpy(), col.get(
        include=("embeddings",))["embeddings"])
    assert set(cols) == {"vid_num", "t_norm"} and len(cols["vid_num"]) == 8
    assert col.device_snapshot(("vid_num",), since=version) is None
    before = rows.clone()
    meta = {"vid_num": 0, "side": "left", "t_norm": 0.5, "clip_num": 0}
    col.upsert(["e1"], np.full((1, D), 7.0, np.float32), [meta])
    version2, rows2, _ = col.device_snapshot(("vid_num",), since=version)
    assert version2 != version
    torch.testing.assert_close(rows, before, rtol=0, atol=0)
    assert float(rows2.max()) == 7.0


def test_swappable_snapshot_version_moves_on_every_swap():
    """Two collections at the same mutation count still give the
    SwappableCollection a new version when one is swapped in."""
    a, b = _new(), _new()
    _fill_rows(a, 1.0, n=4)
    _fill_rows(b, 2.0, n=4)
    sw = SwappableCollection(a)
    version, rows, _ = sw.device_snapshot(("vid_num",))
    assert sw.device_snapshot(("vid_num",), since=version) is None
    sw.swap(b)
    version2, rows2, _ = sw.device_snapshot(("vid_num",), since=version)
    assert version2 != version
    torch.testing.assert_close(rows2, 2.0 * rows)  # b's rows


# --------------------------------------------------------------- builders


def _samples(n_vids=2, per_vid=7):
    return [{"pth": f"/w/vid{v}/vid{v}_frame_{f}.jpg",
             "side": "left" if f % 2 else "right", "t_norm": f / per_vid,
             "clip_num": 1 + f // 4, "vid_num": v}
            for v in range(1, n_vids + 1) for f in range(1, per_vid + 1)]


def _embed_fn(d=48):
    def embed(paths):
        return np.stack([np.random.default_rng(zlib.crc32(p.encode()))
                         .standard_normal(d) for p in paths]) \
            .astype(np.float32)
    return embed


def _rows(col):
    got = col.get(include=("metadatas", "embeddings"))
    order = np.argsort(got["ids"])
    return ([got["ids"][i] for i in order],
            [got["metadatas"][i] for i in order],
            np.asarray(got["embeddings"])[order])


def _assert_same_collection(col, jcol):
    ids, metas, embs = _rows(col)
    jids, jmetas, jembs = _rows(jcol)
    assert ids == jids and metas == jmetas
    np.testing.assert_allclose(embs, jembs, **TOL)


def _projection(d_in, d_out, seed=8):
    w = np.random.default_rng(seed).standard_normal((d_in, d_out)) \
        .astype(np.float32) / np.sqrt(d_in)
    return lambda x: np.asarray(x, np.float32) @ w


@pytest.mark.parametrize("enriched", [False, True])
def test_write_frame_ragdb_and_rebuild_match_jax(enriched):
    samples = _samples()
    embed = _embed_fn()
    kw = dict(base_dim=48, enrich_dim=16, side_dim=8, hidden=40, seed=3)
    port_enr = enrich.Enricher(**kw) if enriched else None
    jax_enr = jax_enrich.Enricher(**kw) if enriched else None
    dim = 40 if enriched else 48
    proj = _projection(dim, dim)  # the rebuild keeps the collection's width
    col = Collection("rag", space="cosine", device="cpu")
    jcol = JaxCollection("rag", space="cosine")
    assert builders.write_frame_ragdb(samples, embed, col,
                                      enricher=port_enr, batch_size=5) \
        == jax_builders.write_frame_ragdb(samples, embed, jcol,
                                          enricher=jax_enr, batch_size=5) \
        == 14
    _assert_same_collection(col, jcol)
    # the rebuild wipes and writes through the projection
    col.upsert(["stale"], np.ones((1, dim), np.float32))
    assert builders.rebuild_frame_db(samples[:9], embed, proj, col,
                                     enricher=port_enr, batch_size=4) == 9
    jax_builders.rebuild_frame_db(samples[:9], embed, proj, jcol,
                                  enricher=jax_enr, batch_size=4)
    _assert_same_collection(col, jcol)
    assert col.count() == 9


def test_wipe_collection_matches_jax():
    """Every row goes, as with the JAX default, and the wiped collection
    takes new rows."""
    jcol, col = _fill(n=12)
    for c, wipe in ((col, builders.wipe_collection),
                    (jcol, jax_builders.wipe_collection)):
        wipe(c)
    _assert_same_collection(col, jcol)
    assert col.count() == 0
    col.upsert(["x"], np.ones((1, D), np.float32),
               [{"vid_num": 1, "side": "left", "t_norm": 0.5}])
    assert col.count() == 1


def _chunks(n=10, t=4):
    return [{"vid": 1 + i % 2, "clip": i // 4, "start_idx": 2 * i,
             "end_idx": 2 * i + t - 1, "side": "left" if i % 3 else "right",
             "label": i % 2, "status_id": i % 2, "t_center": i / n,
             "t_width": 0.1,
             "frames": [f"/w/c{i}/f{j}.jpg" for j in range(t)]}
            for i in range(n)]


def test_rebuild_chunk_db_matches_jax():
    chunks = _chunks()
    embed, proj = _embed_fn(16), _projection(48, 16)
    col = Collection("ch", space="cosine", device="cpu")
    jcol = JaxCollection("ch", space="cosine")
    for c in (col, jcol):
        c.upsert(["stale"], np.ones((1, 16), np.float32))
    for label in (True, False):
        assert builders.rebuild_chunk_db(chunks, embed, proj, col,
                                         include_label=label,
                                         batch_size=3) == 10
        jax_builders.rebuild_chunk_db(chunks, embed, proj, jcol,
                                      include_label=label, batch_size=3)
        _assert_same_collection(col, jcol)


def test_reproject_chunk_rows_matches_jax_and_refuses_a_mismatch():
    chunks = _chunks()
    rng = np.random.default_rng(9)
    frames = {id(c): rng.standard_normal((4, 16)).astype(np.float32)
              for c in chunks}

    def frame_embs_fn(batch):
        return np.stack([frames[id(c)] for c in batch])

    proj = _projection(3 * 16, 16)

    def project(x):
        return proj(enrich.chunk_stats(x))

    col = Collection("ratt", space="cosine", device="cpu")
    jcol = JaxCollection("ratt", space="cosine")
    # rows 0-5 written with a class logit, 6-9 missing: synthesised
    stored = [{"vid_num": c["vid"], "clip_num": c["clip"],
               "side": c["side"], "label": c["label"],
               "t_center": c["t_center"], "t_width": c["t_width"],
               "class_logit": 0.25 * i, "start_idx": c["start_idx"],
               "end_idx": c["end_idx"]} for i, c in enumerate(chunks[:6])]
    for c in (col, jcol):
        c.upsert([f"chunk_{i}" for i in range(6)],
                 np.zeros((6, 16), np.float32), [dict(m) for m in stored])
    assert builders.reproject_chunk_rows(chunks, frame_embs_fn, project, col,
                                         batch_size=4) == 10
    jax_builders.reproject_chunk_rows(chunks, frame_embs_fn, project, jcol,
                                      batch_size=4)
    _assert_same_collection(col, jcol)
    assert col.get(ids=["chunk_2"])["metadatas"][0]["class_logit"] == 0.5
    shifted = chunks[1:] + chunks[:1]
    with pytest.raises(ValueError, match="different stores or chunkings"):
        builders.reproject_chunk_rows(shifted, frame_embs_fn, project, col)


# ----------------------------------------------------------- async rebuild


def _fill_rows(col, scale, n=32):
    rng = np.random.default_rng(0)
    embs = (scale * rng.normal(size=(n, 8))).astype(np.float32)
    col.upsert([f"e{i}" for i in range(n)], embs,
               [{"vid_num": i % 3, "side": "left", "t_norm": (i % 8) / 8.0}
                for i in range(n)])


def _new():
    return Collection("ragdb", space="cosine", device="cpu")


def test_swap_is_atomic_and_visible():
    base = _new()
    _fill_rows(base, 1.0)
    sw = SwappableCollection(base)
    assert sw.count() == 32 and sw.space == "cosine"
    release = threading.Event()

    def build(col):
        release.wait(5)  # in flight until the second kick is refused
        _fill_rows(col, 2.0, 16)

    sched = RebuildScheduler(sw, _new, build)
    assert sched.kick()
    assert not sched.kick()  # one in flight at a time
    release.set()
    sched.wait()
    assert sw.count() == 32  # the old rows until the swap
    assert sched.maybe_swap()
    assert sw.count() == 16
    assert not sched.maybe_swap()
    assert sched.swaps == 1


def test_retriever_follows_swap_like_jax():
    """The port's retriever over a SwappableCollection sees the swapped-in
    rows, as the JAX retriever over the JAX pair does."""
    q = np.random.default_rng(1).normal(size=(1, 8)).astype(np.float32)
    md = _md([9], ["left"], [0.5], [2.0])
    target = (q[0] / np.linalg.norm(q[0])).astype(np.float32)
    outs = []
    for swap_cls, sched_cls, ret_cls, new in (
            (SwappableCollection, RebuildScheduler, FrameRetriever, _new),
            (jax_async.SwappableCollection, jax_async.RebuildScheduler,
             jax_retrievers.FrameRetriever,
             lambda: JaxCollection("ragdb", space="cosine"))):
        base = new()
        _fill_rows(base, 1.0)
        sw = swap_cls(base)
        ret = ret_cls(sw, top_k=3)
        first = ret(q, md)

        def build(col):
            col.upsert(["hit"], target[None],
                       [{"vid_num": 0, "side": "left", "t_norm": 0.5}])

        sched = sched_cls(sw, new, build)
        sched.kick()
        sched.wait()
        assert sched.maybe_swap()
        outs.append((first, ret(q, md)))
    (p1, p2), (j1, j2) = outs
    _assert_same_rows(p1, j1)
    _assert_same_rows(p2, j2)
    assert float(p2[0, 0] @ torch.from_numpy(target)) > 0.999
    assert float(p2[0, 1:].abs().sum()) == 0


def test_reads_never_see_a_half_built_db():
    base = _new()
    _fill_rows(base, 1.0, n=8)
    sw = SwappableCollection(base)
    started = threading.Event()

    def slow_build(col):
        started.set()
        for i in range(4):
            col.upsert([f"n{i}"], np.ones((1, 8), np.float32),
                       [{"vid_num": 0, "side": "left", "t_norm": 0.1}])
            time.sleep(0.02)

    sched = RebuildScheduler(sw, _new, slow_build)
    sched.kick()
    started.wait(5)
    sizes = set()
    for _ in range(20):
        sizes.add(sw.count())
        time.sleep(0.005)
    sched.wait()
    assert sizes == {8}
    sched.maybe_swap()
    assert sw.count() == 4


def test_rebuild_error_surfaces_at_swap(capsys):
    sw = SwappableCollection(_new())

    def boom(col):
        raise RuntimeError("rebuild exploded")

    sched = RebuildScheduler(sw, _new, boom)
    sched.kick()
    sched.wait()
    with pytest.raises(RuntimeError, match="rebuild exploded"):
        sched.maybe_swap()
    sched.kick()
    sched.wait()
    assert not sched.maybe_swap(raise_on_error=False)
    assert "rebuild exploded" in capsys.readouterr().out
