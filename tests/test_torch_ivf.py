"""The port's IVF out-of-core spill (store/ivf.py: spill, build_spilled,
load, matches, search with x=None) against the JAX package's: the five
spill cases of tests/test_ivf.py on the port, and spills crossing between
the packages both ways with equal answers.
"""

import numpy as np
import pytest

from vit_research_tpu.store.ivf import IVFIndex as JaxIVF
from vit_research_tpu_torch.store.ivf import IVFIndex


def clustered(n, d=32, n_clusters=40, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 4
    assign = rng.integers(0, n_clusters, size=n)
    x = centers[assign] + rng.normal(size=(n, d)).astype(np.float32) * 0.5
    return x.astype(np.float32)


def exact_topk(q, x, k):
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    return np.argsort(-(qn @ xn.T), axis=1)[:, :k]


def test_spilled_search_matches_in_ram(tmp_path):
    x = clustered(12_000, seed=7)
    q = x[:32] + 0.01
    prefix = str(tmp_path / "ivf")
    ivf = IVFIndex(nprobe=8, seed=7).fit(x)
    assert ivf.matches(len(x)) and not ivf.matches(len(x) - 1)
    s_ram, i_ram = ivf.search(q, x, 10)
    ivf.spill(x, prefix)
    s_disk, i_disk = ivf.search(q, None, 10)
    assert np.array_equal(i_ram, i_disk)
    np.testing.assert_allclose(s_ram, s_disk, rtol=1e-5)
    with pytest.raises(ValueError, match="rows"):
        ivf.spill(x[:-1], str(tmp_path / "short"))
    with pytest.raises(ValueError, match="fitted"):
        IVFIndex().spill(x, str(tmp_path / "unfit"))


def test_spilled_load_roundtrip_and_memmap_corpus(tmp_path):
    # build straight from an np.memmap corpus (the larger-than-RAM shape)
    # and reopen the index from disk in a fresh object
    x = clustered(8_000, seed=8)
    corpus = np.memmap(tmp_path / "corpus.dat", mode="w+",
                       dtype=np.float32, shape=x.shape)
    corpus[:] = x
    corpus.flush()
    prefix = str(tmp_path / "ivf")
    IVFIndex.build_spilled(corpus, prefix, nprobe=8, seed=8)
    del corpus
    ivf = IVFIndex.load(prefix)
    assert ivf.matches(len(x))
    q = x[:16] + 0.01
    _, idx = ivf.search(q, None, 10)
    ref = exact_topk(q, x, 10)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(idx, ref)])
    assert recall >= 0.95, recall
    # masks apply out of core too
    mask = np.zeros(len(x), bool)
    mask[2000:4000] = True
    scores, idx = ivf.search(q[:4], None, 5, mask=mask)
    valid = scores > -1e29
    assert valid.any()
    assert np.all((idx[valid] >= 2000) & (idx[valid] < 4000))


def test_spilled_tail_overrides_stale_rows(tmp_path):
    x = clustered(5_000, seed=9)
    prefix = str(tmp_path / "ivf")
    ivf = IVFIndex(nprobe=4, seed=9).fit(x).spill(x, prefix)
    # row 0 was updated after the spill: its fresh value must win and the
    # stale on-disk copy must not appear
    probe = np.full(x.shape[1], 3.0, np.float32)
    fresh = probe * 2.0
    scores, idx = ivf.search(probe[None], None, 3, extra=np.array([0]),
                             extra_rows=fresh[None])
    assert idx[0, 0] == 0
    assert abs(scores[0, 0] - 1.0) < 1e-5  # cosine vs fresh, not stale
    with pytest.raises(ValueError, match="extra_rows"):
        ivf.search(probe[None], None, 3, extra=np.array([0]))


def test_refit_invalidates_spill(tmp_path):
    x = clustered(3_000, seed=10)
    prefix = str(tmp_path / "ivf")
    ivf = IVFIndex(seed=10).fit(x).spill(x, prefix)
    ivf.fit(clustered(2_000, seed=11))  # new fit, new cell order
    with pytest.raises(ValueError, match="spilled"):
        ivf.search(x[:2], None, 3)


def test_spilled_tail_dedup_keeps_last(tmp_path):
    x = clustered(2_000, seed=12)
    prefix = str(tmp_path / "ivf")
    ivf = IVFIndex(nprobe=4, seed=12).fit(x).spill(x, prefix)
    probe = np.full(x.shape[1], 2.0, np.float32)
    stale, fresh = -probe, probe * 3.0
    # row 7 updated twice: the later value wins, and index 7 holds at most
    # one top-k slot
    scores, idx = ivf.search(probe[None], None, 4, extra=np.array([7, 7]),
                             extra_rows=np.stack([stale, fresh]))
    hits = (idx[0] == 7) & (scores[0] > -1e29)
    assert hits.sum() == 1
    assert abs(scores[0][hits][0] - 1.0) < 1e-5  # cosine vs fresh


def _same_answers(a, b, q, x, tail):
    """Equal ids and scores from two indexes, in RAM and out of core, with
    and without a mask and a post-spill tail."""
    mask = np.zeros(len(x), bool)
    mask[::3] = True
    for kw in ({}, {"mask": mask},
               {"extra": tail, "extra_rows": x[tail] * 2.0},
               {"nprobe": 2}):
        sa, ia = a.search(q, None, 7, **kw)
        sb, ib = b.search(q, None, 7, **kw)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(sa, sb, rtol=1e-6)
    sa, ia = a.search(q, x, 7)
    sb, ib = b.search(q, x, 7)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, rtol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spills_cross_between_packages(tmp_path, writer):
    """A spill written by either package loads in the other, with the
    same cells, and both answer alike."""
    x = clustered(6_000, seed=13)
    q = x[10:26] + 0.01
    tail = np.array([3, 40, 3])
    prefix = str(tmp_path / "ivf")
    write, read = (JaxIVF, IVFIndex) if writer == "jax" else (IVFIndex,
                                                              JaxIVF)
    written = write.build_spilled(x, prefix, nprobe=6, seed=13)
    loaded = read.load(prefix)
    assert loaded.matches(len(x))
    np.testing.assert_array_equal(loaded.centroids, written.centroids)
    assert all(np.array_equal(a, b)
               for a, b in zip(loaded.cells, written.cells))
    _same_answers(written, loaded, q, x, tail)


def test_load_rejects_a_malformed_spill(tmp_path):
    x = clustered(1_000, seed=14)
    prefix = str(tmp_path / "ivf")
    IVFIndex.build_spilled(x, prefix, seed=14)
    with np.load(prefix + ".npz") as meta:
        parts = dict(meta)
    parts["order"] = parts["order"][:-1]  # bounds end past order
    np.savez(prefix + ".npz", **parts)
    with pytest.raises(ValueError, match="bounds end"):
        IVFIndex.load(prefix)
