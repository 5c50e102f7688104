"""The port's kNN+HMM path (ops/topk.py, ops/viterbi.py, segment/*)
against the JAX package on the same numpy inputs.

Tolerances: paths, neighbour ids, clip listings and vote arithmetic must
be exactly equal. Scores are f32 matmuls that may sum in another order:
1e-5 (abs and rel). The max-plus recurrences use the same elementwise f32
operations in the same association order, so the forward scores are
compared at 1e-6 relative, which leaves room only for ulp differences in
the two libraries' ``log``.
"""

import itertools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.data import naming
from vit_research_tpu.data.synthetic import synth_frame
from vit_research_tpu.ops import topk as jax_topk
from vit_research_tpu.ops import viterbi as jax_vit
from vit_research_tpu.segment import hmm as jax_hmm
from vit_research_tpu.segment import knn as jax_knn
from vit_research_tpu.segment import pipeline as jax_pipeline
from vit_research_tpu.store.vector_store import PersistentClient
from vit_research_tpu_torch.ops import topk, viterbi
from vit_research_tpu_torch.segment import clips, hmm, knn, pipeline
from vit_research_tpu_torch.store import vector_store as torch_store

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ top-k


def _with_ties(rng, n=40, d=16):
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    # planted exact ties: rows 7 == 3 and 30 == 12 == 21
    corpus[7] = corpus[3]
    corpus[21] = corpus[12]
    corpus[30] = corpus[12]
    queries = rng.standard_normal((6, d)).astype(np.float32)
    queries[0] = corpus[3] * 3.0   # its best match is the tied pair
    queries[1] = corpus[12]        # best match is the triple
    queries[4] = corpus[12] * 2.0  # the triple again, past a block edge
    return queries, corpus


@pytest.mark.parametrize("metric", ["cosine", "ip", "l2"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block_rows", [None, 4])
def test_masked_topk_matches_jax_with_ties(metric, masked, block_rows,
                                           monkeypatch):
    if block_rows is not None:
        # queries 0-3 and 4-5 in two blocks; ties on both sides of the edge
        monkeypatch.setattr(topk, "_BLOCK_ELEMENTS", block_rows * 40)
    rng = np.random.default_rng(0)
    queries, corpus = _with_ties(rng)
    if metric == "cosine":
        queries = np.array(jax_topk.l2_normalize(queries))
        corpus = np.array(jax_topk.l2_normalize(corpus))
    mask = None
    if masked:
        mask = rng.random((6, 40)) > 0.3
        mask[np.ix_([1, 4], [12, 21, 30])] = True
        mask[2, :] = False  # a query with no candidate at all
        mask[2, :3] = True
    ws, wi = jax_topk.masked_topk(jnp.asarray(queries), jnp.asarray(corpus),
                                  None if mask is None else jnp.asarray(mask),
                                  k=8, metric=metric)
    gs, gi = topk.masked_topk(torch.from_numpy(queries),
                              torch.from_numpy(corpus),
                              None if mask is None else torch.from_numpy(mask),
                              k=8, metric=metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    # ties come lower index first
    for row in (1, 4):
        assert gi[row].tolist()[:3] == [12, 21, 30]


def test_masked_topk_k_clipped_to_corpus():
    q = torch.zeros(2, 4)
    s, i = topk.masked_topk(q, torch.ones(3, 4), None, k=10, metric="ip")
    assert s.shape == i.shape == (2, 3)
    assert i.tolist() == [[0, 1, 2], [0, 1, 2]]


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(
        topk.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jax_topk.l2_normalize(jnp.asarray(x))), rtol=1e-6,
        atol=1e-7)


# ---------------------------------------------------------------- viterbi


def _hmm_inputs(seed, t, s=3):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(s), size=t).astype(np.float32)
    trans = rng.dirichlet(np.ones(s), size=s).astype(np.float32)
    trans[0, 1] = 0.0  # one forbidden transition
    trans /= trans.sum(axis=1, keepdims=True)
    prior = rng.dirichlet(np.ones(s)).astype(np.float32)
    return np.log(probs), np.array(jax_vit.log_transition_matrix(trans)), \
        np.log(prior)


def _brute_force(log_emit, log_trans, log_prior):
    t, s = log_emit.shape
    best, best_path = -np.inf, None
    for path in itertools.product(range(s), repeat=t):
        score = log_prior[path[0]] + log_emit[0, path[0]] + sum(
            log_trans[path[i - 1], path[i]] + log_emit[i, path[i]]
            for i in range(1, t))
        if score > best:
            best, best_path = score, path
    return np.asarray(best_path), best


@pytest.mark.parametrize("fn", ["viterbi", "viterbi_parallel"])
@pytest.mark.parametrize("t", [1, 2, 5, 6])
def test_viterbi_matches_brute_force(fn, t):
    log_emit, log_trans, log_prior = _hmm_inputs(t, t)
    # the sequential decoder runs on the host (numpy in and out), the
    # log-depth one on torch tensors
    conv = np.asarray if fn == "viterbi" else torch.from_numpy
    path, score = getattr(viterbi, fn)(conv(log_emit), conv(log_trans),
                                       conv(log_prior))
    want_path, want_score = _brute_force(log_emit.astype(np.float64),
                                         log_trans.astype(np.float64),
                                         log_prior.astype(np.float64))
    path = np.asarray(path)
    assert path.dtype == np.int32
    np.testing.assert_array_equal(path, want_path)
    np.testing.assert_allclose(float(score), want_score, rtol=1e-5)


@pytest.mark.parametrize("fn", ["viterbi", "viterbi_parallel"])
@pytest.mark.parametrize("t", [7, 64, 301])
def test_viterbi_matches_jax(fn, t):
    log_emit, log_trans, log_prior = _hmm_inputs(100 + t, t)
    wp, ws = getattr(jax_vit, fn)(log_emit, log_trans, log_prior)
    gp, gs = getattr(viterbi, fn)(log_emit, log_trans, log_prior)
    np.testing.assert_array_equal(np.asarray(gp), np.asarray(wp))
    np.testing.assert_allclose(float(gs), float(ws), rtol=1e-6)


def test_viterbi_batch_matches_jax():
    log_emit = np.log(np.random.default_rng(2).dirichlet(
        np.ones(3), size=(4, 50)).astype(np.float32))
    _, log_trans, log_prior = _hmm_inputs(3, 1)
    wp, ws = jax_vit.viterbi_batch(log_emit, log_trans, log_prior)
    gp, gs = viterbi.viterbi_batch(log_emit, log_trans, log_prior)
    assert gp.dtype == np.int32 and gs.dtype == np.float32
    np.testing.assert_array_equal(gp, np.asarray(wp))
    np.testing.assert_allclose(gs, np.asarray(ws), rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 37])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_combines_in_jax_order(n, reverse):
    # float addition is not associative: bitwise equality of the prefix
    # sums shows the same combination tree as jax.lax.associative_scan
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 1e3
    want = jax.lax.associative_scan(jnp.add, jnp.asarray(x), reverse=reverse)
    got = viterbi.associative_scan(torch.add, torch.from_numpy(x),
                                   reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_log_helpers_match_jax():
    trans = np.array([[0.5, 0.0, 0.5], [0.1, 0.8, 0.1], [0.0, 0.0, 1.0]],
                     np.float32)
    np.testing.assert_allclose(
        viterbi.log_transition_matrix(trans).numpy(),
        np.asarray(jax_vit.log_transition_matrix(trans)), rtol=1e-6)
    p = np.array([0.0, 1e-9, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(viterbi.masked_log(p).numpy(),
                               np.asarray(jax_vit.masked_log(p)), rtol=1e-6)


# ------------------------------------------------------------ hmm and knn


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_smooth_probabilities_matches_jax(parallel, batched):
    rng = np.random.default_rng(4)
    shape = (3, 200, 3) if batched else (400, 3)
    probs = rng.dirichlet(np.full(3, 0.3), size=shape[:-1]).astype(np.float32)
    probs[..., 5, :] = 0.0  # zero rows take the reference's 1e-6 floor
    trans = np.array([[0.9, 0.0, 0.1], [0.0, 0.9, 0.1], [0.2, 0.2, 0.6]],
                     np.float32)
    for tm in (None, trans):
        want = jax_hmm.smooth_probabilities(probs, transition_matrix=tm,
                                            parallel=parallel)
        got = hmm.smooth_probabilities(probs, transition_matrix=tm,
                                       parallel=parallel, device="cpu")
        np.testing.assert_array_equal(got, want)


def _vote_probs(seed, t, k=10):
    """Emissions as ``write-frame-db`` corpora give them: k-neighbour vote
    fractions (multiples of 1/k, many exact ties) over runs of 80-400
    frames of one side."""
    rng = np.random.default_rng(seed)
    lab = []
    while len(lab) < t:
        lab += [int(rng.integers(0, 3))] * int(rng.integers(80, 401))
    lab = np.asarray(lab[:t])
    p = np.full((t, 3), 0.15)
    p[np.arange(t), lab] = 0.7
    return (np.stack([rng.multinomial(k, row) for row in p]) / k).astype(
        np.float32)


# (T, seed): games on which the log-depth scan breaks a tie otherwise than
# the sequential decoder, so a port that decodes them in log depth fails
F1_GAMES = [(2048, 29), (4096, 1), (6000, 1), (8191, 6)]


@pytest.mark.parametrize("t,seed", F1_GAMES)
@pytest.mark.parametrize("batched", [False, True])
def test_smooth_probabilities_default_routing_matches_jax(t, seed, batched):
    # the reference decodes below 8192 frames sequentially: the port's
    # default must too, tie for tie (exact equality)
    probs = _vote_probs(seed, t)
    if batched:
        probs = np.stack([probs, _vote_probs(seed + 100, t), probs[::-1]])
    want = jax_hmm.smooth_probabilities(probs)
    got = hmm.smooth_probabilities(probs, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # these games are ones where the routing decides the path
    log_depth = hmm.smooth_probabilities(probs, parallel=True, device="cpu")
    assert not np.array_equal(log_depth, want)


def test_smooth_probabilities_log_depth_from_8192_frames():
    probs = _vote_probs(3, 8192)
    want = jax_hmm.smooth_probabilities(probs)
    np.testing.assert_array_equal(
        hmm.smooth_probabilities(probs, device="cpu"), want)
    np.testing.assert_array_equal(
        hmm.smooth_probabilities(probs, parallel=True, device="cpu"), want)
    with pytest.raises(RuntimeError, match="is_available"):
        if not torch.cuda.is_available():
            hmm.smooth_probabilities(probs[:10], device="cuda")
        else:
            raise RuntimeError("is_available: a card is present")


def _vote_world(probs, k=10, seed=0):
    """Embeddings and a one-hot corpus whose k-NN votes are ``probs``: one
    anchor per vote mix, k corpus rows around it with that mix's labels,
    each frame next to the anchor of its row's mix."""
    rng = np.random.default_rng(seed)
    counts = np.rint(probs * k).astype(np.int64)
    mixes = sorted({tuple(c) for c in counts})
    d = len(mixes)
    embs, labels = [], []
    for a, mix in enumerate(mixes):
        anchor = np.zeros(d, np.float32)
        anchor[a] = 10.0
        for side, n in enumerate(mix):
            for _ in range(n):
                embs.append(anchor + rng.normal(0, 0.01, d))
                labels.append(side)
    labels = np.asarray(labels, np.int64)
    corpus = {"embeddings": np.asarray(embs, np.float32), "labels": labels,
              "probs": np.eye(3, dtype=np.float32)[labels]}
    where = {mix: a for a, mix in enumerate(mixes)}
    queries = np.zeros((len(counts), d), np.float32)
    queries[np.arange(len(counts)), [where[tuple(c)] for c in counts]] = 10.0
    queries += rng.normal(0, 0.001, queries.shape).astype(np.float32)
    return queries, corpus


@pytest.mark.parametrize("t,seed", F1_GAMES[1:3])
def test_segment_with_knn_hmm_vote_ties_match_jax_and_live(tmp_path, t,
                                                           seed):
    probs = _vote_probs(seed, t)
    queries, corpus = _vote_world(probs)
    names = [naming.frame_name(1, i + 1) for i in range(t)]
    kw = dict(k=10, min_len=100, pad=10, vid=1)
    want, want_dirs, want_fused = jax_pipeline.segment_with_knn_hmm(
        names, queries, corpus, out_root=str(tmp_path / "jax"),
        src_dir=str(tmp_path), **kw)
    got, got_dirs, fused = pipeline.segment_with_knn_hmm(
        names, queries, corpus, out_root=str(tmp_path / "torch"),
        src_dir=str(tmp_path), device="cpu", **kw)
    # the emissions are the planted vote fractions
    np.testing.assert_array_equal(fused["emissions"].astype(np.float32),
                                  probs)
    np.testing.assert_array_equal(fused["emissions"],
                                  want_fused["emissions"])
    assert got == want
    assert [os.path.basename(d) for d in got_dirs] == \
        [os.path.basename(d) for d in want_dirs]
    # the live session (sequential, unbounded lag) cuts the same clips
    offline = clips.clip_intervals_from_decoded(got, min_len=100, pad=10)
    live = list(pipeline.segment_knn_hmm_stream(
        ((names[s:s + 256], queries[s:s + 256]) for s in range(0, t, 256)),
        corpus, device="cpu", k=10, min_len=100, pad=10, max_lag=10 ** 9))
    assert live == offline


def test_hmm_constants_and_validation_match_jax():
    np.testing.assert_array_equal(hmm.DEFAULT_TRANSITIONS,
                                  jax_hmm.DEFAULT_TRANSITIONS)
    np.testing.assert_array_equal(hmm.UNIFORM_PRIOR, jax_hmm.UNIFORM_PRIOR)
    assert hmm.STATES == jax_hmm.STATES and knn.SIDES == jax_knn.SIDES
    # the default routing is the reference's: sequential below 8192 frames
    assert hmm._PARALLEL_THRESHOLD == jax_hmm._PARALLEL_THRESHOLD == 8192
    probs = np.random.default_rng(5).dirichlet(
        np.full(3, 0.3), size=300).astype(np.float32)
    np.testing.assert_array_equal(
        hmm.smooth_probabilities(probs, device="cpu"),
        jax_hmm.smooth_probabilities(probs))
    for bad in (np.ones((2, 3)), np.full((3, 3), 0.5), -np.eye(3)):
        with pytest.raises(ValueError):
            hmm.validate_transition_matrix(bad)


def test_fused_confidence_and_votes_match_jax():
    rng = np.random.default_rng(5)
    nl = rng.integers(-1, 3, size=(30, 7))
    nl[0] = 1  # unanimous row
    probs = rng.dirichlet(np.ones(3), size=(30, 7)).astype(np.float32)
    want = jax_knn.fused_confidence(nl, probs, top_n=7,
                                    confidence_threshold=0.4)
    got = knn.fused_confidence(nl, probs, top_n=7, confidence_threshold=0.4)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(knn.vote_counts(nl),
                                  jax_knn.vote_counts(nl))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_knn_labels_matches_jax(metric):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((25, 16)).astype(np.float32)
    c = rng.standard_normal((60, 16)).astype(np.float32) * 3
    labels = rng.integers(0, 3, size=60)
    want = jax_knn.knn_labels(q, c, labels, 5, metric=metric)
    got = knn.knn_labels(q, c, labels, 5, metric=metric, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------------ whole segmentation


SEGMENTS = [("none", 15), ("left", 40), ("none", 12), ("right", 45),
            ("none", 10), ("left", 8), ("none", 20)]


def _world(tmp_path, seed=7, d=24):
    """A game of frames on disk plus seeded embeddings with side-dependent
    means, and a labelled corpus drawn the same way."""
    rng = np.random.default_rng(seed)
    means = {s: rng.standard_normal(d).astype(np.float32) * 2
             for s in ("left", "right", "none")}
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    names, embs = [], []
    fnum = 1
    for side, n in SEGMENTS:
        for _ in range(n):
            name = naming.frame_name(3, fnum)
            np.save(frames_dir / name, synth_frame(3, fnum, side, (8, 8)))
            os.rename(frames_dir / (name + ".npy"), frames_dir / name)
            names.append(name)
            embs.append(means[side] + rng.standard_normal(d) * 1.2)
            fnum += 1
    corpus_embs, corpus_labels = [], []
    for i, side in enumerate(("left", "right", "none")):
        corpus_embs.append(means[side] + rng.standard_normal((30, d)) * 1.2)
        corpus_labels += [i] * 30
    corpus_labels = np.asarray(corpus_labels, np.int64)
    probs = np.full((90, 3), 0.05, np.float32)
    probs[np.arange(90), corpus_labels] = 0.9
    corpus = {"embeddings": np.concatenate(corpus_embs).astype(np.float32),
              "labels": corpus_labels, "probs": probs}
    return str(frames_dir), names, np.asarray(embs, np.float32), corpus


def _listing(root):
    return {d: sorted(os.listdir(os.path.join(root, d)))
            for d in sorted(os.listdir(root))}


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_segment_with_knn_hmm_matches_jax_pipeline(tmp_path, metric):
    src, names, embs, corpus = _world(tmp_path)
    kw = dict(src_dir=src, k=9, min_len=20, pad=3, vid=3, metric=metric)
    want = jax_pipeline.segment_with_knn_hmm(
        names, embs, corpus, out_root=str(tmp_path / "jax"), **kw)
    got = pipeline.segment_with_knn_hmm(
        names, embs, corpus, out_root=str(tmp_path / "torch"), device="cpu",
        **kw)
    assert got[0] == want[0]
    assert [os.path.basename(p) for p in got[1]] == \
        [os.path.basename(p) for p in want[1]]
    assert _listing(tmp_path / "torch") == _listing(tmp_path / "jax")
    for key in want[2]:
        np.testing.assert_array_equal(got[2][key], want[2][key])
    # the planted possessions are recovered (the short left streak is not
    # a clip: 8 < min_len)
    assert [d.split("_")[-1] for d in _listing(tmp_path / "torch")] == \
        ["left", "right"]


def test_confident_writeback_matches_jax(tmp_path):
    src, names, embs, corpus = _world(tmp_path, seed=8)
    cols = {}
    for side, client_cls, kw in (("jax", PersistentClient, {}),
                                 ("torch", torch_store.PersistentClient,
                                  {"device": "cpu"})):
        client = client_cls(str(tmp_path / f"db_{side}"), **kw)
        col = client.get_or_create_collection("corpus")
        col.upsert(names[:5], embs[:5], [{"label": "none"}] * 5)
        cols[side] = col
    kw = dict(k=9, min_len=20, pad=3, vid=3, confidence_threshold=0.6)
    jax_pipeline.segment_with_knn_hmm(names, embs, corpus,
                                      collection=cols["jax"], **kw)
    pipeline.segment_with_knn_hmm(names, embs, corpus, device="cpu",
                                  collection=cols["torch"], **kw)
    want = cols["jax"].get(include=("embeddings", "metadatas"))
    got = cols["torch"].get(include=("embeddings", "metadatas"))
    assert got["ids"] == want["ids"] and len(got["ids"]) > 5
    assert got["metadatas"] == want["metadatas"]
    np.testing.assert_array_equal(got["embeddings"], want["embeddings"])


def test_clip_intervals_match_reference_rules():
    from vit_research_tpu.segment import clips as jax_clips

    decoded = (["none"] * 5 + ["left"] * 30 + ["none"] * 3 + ["right"] * 4
               + ["none"] * 2 + ["right"] * 25)
    for min_len, pad in ((20, 0), (4, 3), (1, 100)):
        got = clips.clip_intervals_from_decoded(decoded, min_len=min_len,
                                                pad=pad)
        want = jax_clips.clip_intervals_from_decoded(decoded, min_len=min_len,
                                                     pad=pad)
        assert [(c.side, c.start, c.end) for c in got] == \
            [(c.side, c.start, c.end) for c in want]
    assert [(r.side, r.start, r.end) for r in clips.decoded_runs(decoded)] \
        == [(r.side, r.start, r.end)
            for r in jax_clips.decoded_runs(decoded)]
