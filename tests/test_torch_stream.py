"""The port's live segmentation (segment/hmm.py StreamingViterbi and HMM,
segment/clips.py StreamingClipExtractor, segment/pipeline.py
KnnHmmStreamSession, segment_knn_hmm_stream and segment_with_knn_streaks,
segment/tune.py) against the JAX package on the same numpy inputs.

Tolerances: emitted states, forced counts, clip intervals, written-back
ids and metadata and the tuning results must be exactly equal (the host
decoders do the same f32 operations in the same order; the top-k ranks
the same neighbours on worlds without near-ties). Transition matrices
from the counting fit: 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from vit_research_tpu.data.labels import ManualIntervals as JaxManual
from vit_research_tpu.segment import clips as jax_clips
from vit_research_tpu.segment import hmm as jax_hmm
from vit_research_tpu.segment import pipeline as jax_pipeline
from vit_research_tpu.segment import tune as jax_tune
from vit_research_tpu.store.vector_store import Collection as JaxCollection
from vit_research_tpu_torch.data.labels import ManualIntervals
from vit_research_tpu_torch.segment import clips, hmm, pipeline, streaks
from vit_research_tpu_torch.segment import tune
from vit_research_tpu_torch.store.vector_store import Collection

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

INF_LAG = 10 ** 9


def _stream_probs(seed, t=420):
    """Decisive possessions with ambiguous stretches (near-uniform rows)
    of 80-120 frames, longer than the smaller lags: those force
    commits."""
    rng = np.random.default_rng(seed)
    rows = []
    while sum(len(r) for r in rows) < t:
        kind = rng.integers(4)
        n = int(rng.integers(20, 60))
        if kind == 3:
            n = int(rng.integers(80, 120))
            block = (np.full((n, 3), 1 / 3, np.float32)
                     + rng.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32))
        else:
            block = np.full((n, 3), 0.02, np.float32)
            block[:, kind] = 0.96
            block += rng.uniform(0, 0.02, (n, 3)).astype(np.float32)
        rows.append(block / block.sum(axis=1, keepdims=True))
    return np.concatenate(rows)[:t].astype(np.float32)


def _run(sv, probs):
    pushes, pending = [], []
    for row in probs:
        pushes.append(list(sv.push(row)))
        pending.append(sv.pending)
    pushes.append(list(sv.finish()))
    return pushes, pending


@pytest.mark.parametrize("max_lag", [8, 64, INF_LAG])
@pytest.mark.parametrize("drain_every", [1, 8, 32])
def test_streaming_viterbi_matches_jax(max_lag, drain_every):
    for seed in (0, 1):
        probs = _stream_probs(seed)
        want = jax_hmm.StreamingViterbi(max_lag=max_lag,
                                        drain_every=drain_every)
        got = hmm.StreamingViterbi(max_lag=max_lag, drain_every=drain_every)
        w_push, w_pend = _run(want, probs)
        g_push, g_pend = _run(got, probs)
        assert g_push == w_push  # the same states from the same pushes
        assert g_pend == w_pend
        assert (got.forced, got.emitted) == (want.forced, want.emitted)
        if max_lag == 8:
            assert got.forced > 0  # the ambiguous stretches forced commits
        if max_lag == INF_LAG:
            assert got.forced == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_streaming_viterbi_infinite_lag_equals_offline_decode(seed):
    probs = _stream_probs(seed)
    sv = hmm.StreamingViterbi(max_lag=INF_LAG, drain_every=8)
    got = [s for push in _run(sv, probs)[0] for s in push]
    want = hmm.smooth_probabilities(probs, parallel=False, device="cpu")
    assert got == want.tolist()
    # uniform rows: every step ties, first-argmax everywhere
    flat = np.full((50, 3), 1 / 3, np.float32)
    sv = hmm.StreamingViterbi(max_lag=INF_LAG, drain_every=5)
    got = [s for push in _run(sv, flat)[0] for s in push]
    assert got == hmm.smooth_probabilities(flat, parallel=False,
                                           device="cpu").tolist()


def test_streaming_viterbi_custom_transitions_dicts_and_errors():
    trans = np.array([[0.9, 0.0, 0.1], [0.0, 0.9, 0.1], [0.3, 0.3, 0.4]],
                     np.float32)
    probs = _stream_probs(3, t=150)
    rows = [dict(zip(hmm.STATES, map(float, r))) for r in probs]
    want = jax_hmm.StreamingViterbi(max_lag=16, transition_matrix=trans,
                                    drain_every=4)
    got = hmm.StreamingViterbi(max_lag=16, transition_matrix=trans,
                               drain_every=4)
    assert _run(got, rows) == _run(want, rows)
    assert got.finish() == [] and got.forced == want.forced
    with pytest.raises(RuntimeError):
        got.push(rows[0])
    with pytest.raises(ValueError):
        hmm.StreamingViterbi(max_lag=0)


def test_hmm_lattice_api_matches_jax():
    probs = _stream_probs(4, t=200)
    want, got = jax_hmm.HMM(cap_count=8), hmm.HMM(cap_count=8)
    for h in (want, got):
        h.add_first(dict(zip(hmm.STATES, map(float, probs[0]))))
        for row in probs[1:50]:
            h.add_col_to_lattice(row)
        h.add_cols(probs[50:])  # grows past the initial buffer
    assert got.count == want.count == 200
    assert got.decode_sequence() == want.decode_sequence()
    np.testing.assert_array_equal(got.decode_indices(), want.decode_indices())
    assert hmm.HMM().decode_indices().shape == (0,)


@pytest.mark.parametrize("seed", range(4))
def test_streaming_clip_extractor_matches_jax(seed):
    rng = np.random.default_rng(seed)
    decoded = []
    while len(decoded) < 500:
        decoded += [hmm.STATES[rng.integers(3)]] * int(rng.integers(1, 60))
    decoded = decoded[:500]
    for min_len, pad in [(20, 10), (1, 0), (30, 100), (500, 5)]:
        want_ex = jax_clips.StreamingClipExtractor(min_len=min_len, pad=pad)
        got_ex = clips.StreamingClipExtractor(min_len=min_len, pad=pad)
        want, got = [], []
        for i, s in enumerate(decoded):
            state = i % 2 and hmm.STATES.index(s) or s  # ints and strings
            w, g = want_ex.push(state), got_ex.push(state)
            assert [(c.side, c.start, c.end) for c in g] == \
                [(c.side, c.start, c.end) for c in w]
            want += w
            got += g
        want += want_ex.finish()
        got += got_ex.finish()
        assert [(c.side, c.start, c.end) for c in got] == \
            [(c.side, c.start, c.end) for c in want]
        assert got == clips.clip_intervals_from_decoded(
            decoded, min_len=min_len, pad=pad)


# ----------------------------------------------------------- the session


def _corpus_world(seed=7, d=16, noise=0.35, ambiguous=60):
    """A labelled corpus around three class centres and a stream of
    possessions drawn the same way, with a stretch of frames halfway
    between left and none."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, d)).astype(np.float32) * 2.0
    corpus, labels = [], []
    for c in range(3):
        corpus.append(centers[c] + noise * rng.standard_normal((40, d)))
        labels += [c] * 40
    corpus = np.concatenate(corpus).astype(np.float32)
    labels = np.asarray(labels, np.int64)
    probs = np.full((len(labels), 3), 0.05, np.float32)
    probs[np.arange(len(labels)), labels] = 0.9
    probs[::7] = [0.5, 0.2, 0.3]  # some rows with softer stored probs
    frames = []
    for side, n in [(2, 30), (0, 150), (2, 30), (1, 140), (2, 20)]:
        frames.append(centers[side] + noise * rng.standard_normal((n, d)))
    mid = (centers[0] + centers[2]) / 2
    frames.append(mid + noise * rng.standard_normal((ambiguous, d)))
    frames.append(centers[0] + noise * rng.standard_normal((120, d)))
    frames = np.concatenate(frames).astype(np.float32)
    names = [f"vid9_frame_{i + 1}.jpg" for i in range(len(frames))]
    return {"embeddings": corpus, "labels": labels, "probs": probs}, \
        frames, names


def _ragged(names, frames, sizes):
    i, j = 0, 0
    while i < len(frames):
        n = sizes[j % len(sizes)]
        yield names[i:i + n], frames[i:i + n]
        i, j = i + n, j + 1


def _ivs(seq):
    return [(c.side, c.start, c.end) for c in seq]


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("write_back", [False, True])
def test_stream_session_matches_jax(metric, write_back):
    corpus, frames, names = _corpus_world()
    kw = dict(k=15, min_len=60, pad=12, max_lag=32, drain_every=8, vid=9,
              metric=metric, confidence_threshold=0.8)
    cols = {}
    if write_back:
        cols = {"jax": JaxCollection("jax", space=metric),
                "torch": Collection("torch", space=metric, device="cpu")}
        for col in cols.values():  # a seed row the guard must not touch
            col.upsert([names[40]], frames[40:41], [{"label": "none"}])
    want_s = jax_pipeline.KnnHmmStreamSession(
        corpus, collection=cols.get("jax"), **kw)
    got_s = pipeline.KnnHmmStreamSession(
        corpus, collection=cols.get("torch"), device="cpu", **kw)
    want, got = [], []
    for b_names, b_frames in _ragged(names, frames, (37, 1, 64, 128, 5)):
        w = want_s.push_batch(b_names, b_frames)
        g = got_s.push_batch(b_names, b_frames)
        assert _ivs(g) == _ivs(w)  # the same clips from the same push
        want += w
        got += g
    want += want_s.finish()
    got += got_s.finish()
    assert _ivs(got) == _ivs(want) and len(got) >= 2
    assert got_s.forced == want_s.forced
    assert got_s.frames_seen == want_s.frames_seen == len(frames)
    assert got_s.corpus_size == want_s.corpus_size == 120
    if write_back:
        w = cols["jax"].get(limit=10 ** 6, include=("metadatas",
                                                    "embeddings"))
        g = cols["torch"].get(limit=10 ** 6, include=("metadatas",
                                                      "embeddings"))
        assert g["ids"] == w["ids"] and len(g["ids"]) > 100
        assert g["metadatas"] == w["metadatas"]
        np.testing.assert_array_equal(g["embeddings"], w["embeddings"])
        assert {"label": "none"} in g["metadatas"]  # the seed row kept


def test_stream_session_forces_commits_like_jax():
    corpus, frames, names = _corpus_world(seed=3, ambiguous=200,
                                          noise=0.6)
    kw = dict(k=25, min_len=40, pad=5, max_lag=8, drain_every=1)
    want = list(jax_pipeline.segment_knn_hmm_stream(
        _ragged(names, frames, (64,)), corpus, **kw))
    want_s = jax_pipeline.KnnHmmStreamSession(corpus, **kw)
    got_s = pipeline.KnnHmmStreamSession(corpus, device="cpu", **kw)
    for b_names, b_frames in _ragged(names, frames, (64,)):
        want_s.push_batch(b_names, b_frames)
        got_s.push_batch(b_names, b_frames)
    want_s.finish()
    got_s.finish()
    assert got_s.forced == want_s.forced > 0
    got = list(pipeline.segment_knn_hmm_stream(
        _ragged(names, frames, (64,)), corpus, device="cpu", **kw))
    assert _ivs(got) == _ivs(want)


def test_stream_session_prestaged_corpus_and_errors():
    corpus, frames, names = _corpus_world(seed=5)
    staged = dict(corpus, embeddings=torch.nn.functional.normalize(
        torch.from_numpy(corpus["embeddings"]), dim=-1))
    kw = dict(k=9, min_len=60, pad=12, metric="cosine")
    a = pipeline.KnnHmmStreamSession(staged, device="cpu",
                                     corpus_prenormalized=True, **kw)
    assert a._corpus_dev is staged["embeddings"]  # no copy of the tensor
    b = pipeline.KnnHmmStreamSession(corpus, device="cpu", **kw)
    got_a = [c for n, f in _ragged(names, frames, (100,))
             for c in a.push_batch(n, f)] + a.finish()
    got_b = [c for n, f in _ragged(names, frames, (100,))
             for c in b.push_batch(n, f)] + b.finish()
    assert _ivs(got_a) == _ivs(got_b)
    assert a.push_batch([], np.zeros((0, 16), np.float32)) == []
    with pytest.raises(ValueError, match="unknown metric"):
        pipeline.KnnHmmStreamSession(corpus, device="cpu", metric="dot")


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_segment_with_knn_streaks_matches_jax(tmp_path, metric):
    corpus, frames, names = _corpus_world(seed=11)
    src = tmp_path / "frames"
    src.mkdir()
    for n in names:
        (src / n).write_bytes(b"x")
    cols = {"jax": JaxCollection("jax", space=metric),
            "torch": Collection("torch", space=metric, device="cpu")}
    kw = dict(src_dir=str(src), k=9, window=30, min_len=40, pad=4, vid=9,
              metric=metric, confidence_threshold=0.85)
    want = jax_pipeline.segment_with_knn_streaks(
        names, frames, corpus, out_root=str(tmp_path / "jax"),
        collection=cols["jax"], intervals_csv=str(tmp_path / "jax.csv"),
        **kw)
    got = pipeline.segment_with_knn_streaks(
        names, frames, corpus, device="cpu", out_root=str(tmp_path / "pt"),
        collection=cols["torch"], intervals_csv=str(tmp_path / "pt.csv"),
        **kw)
    assert got[0] == want[0]
    assert got[2] == want[2] and len(got[2]) >= 2
    assert [os.path.basename(p) for p in got[1]] == \
        [os.path.basename(p) for p in want[1]]
    assert (tmp_path / "pt.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    w = cols["jax"].get(limit=10 ** 6)
    g = cols["torch"].get(limit=10 ** 6)
    assert g["ids"] == w["ids"] and g["metadatas"] == w["metadatas"]
    # and the window rule itself, on decisions with flagged frames
    from vit_research_tpu.segment.streaks import streak_intervals

    rng = np.random.default_rng(2)
    dec = np.repeat([2, 0, 2, 1, 0, 1], [20, 60, 10, 70, 5, 40])
    conf = rng.uniform(0.5, 1.0, len(dec))
    for window, dominance in ((10, 0.8), (50, 0.5)):
        kw = dict(window=window, dominance=dominance, min_len=20)
        assert streaks.streak_intervals(dec, conf, **kw) == \
            streak_intervals(dec, conf, **kw)


def _manual_pair(names):
    """The same manual intervals in both packages' readers: the planted
    possessions, with the ambiguous stretch unlabeled."""
    spans = [("none", 1, 30), ("left", 31, 180), ("none", 181, 210),
             ("right", 211, 350), ("none", 351, 370), ("left", 431, 550)]
    want, got = JaxManual(), ManualIntervals()
    for side, a, b in spans:
        want.intervals[side].append((9, a, b))
        got.intervals[side].append((9, a, b))
    assert got.label_array(names) == want.label_array(names)
    return want, got


def test_tune_knn_hmm_matches_jax():
    corpus, frames, names = _corpus_world(seed=13)
    j_manual, t_manual = _manual_pair(names)
    kw = dict(ks=(5, 15, 40), min_lens=(40, 100), pads=(0, 10),
              metric="l2", iou=0.5)
    w_res, w_trans, w_knn = jax_tune.tune_knn_hmm(
        names, frames, corpus, j_manual, **kw)
    g_res, g_trans, g_knn = tune.tune_knn_hmm(
        names, frames, corpus, t_manual, device="cpu", **kw)
    assert [r.to_json() for r in g_res] == [r.to_json() for r in w_res]
    assert g_res[0].f1 > 0.9
    assert set(g_trans) == set(w_trans) == {"reference", "fitted"}
    for name in w_trans:
        np.testing.assert_allclose(g_trans[name], w_trans[name], rtol=0,
                                   atol=1e-6)
    for key in w_knn:
        np.testing.assert_array_equal(g_knn[key], np.asarray(w_knn[key]))
    truth = tune.truth_states(t_manual, names)
    np.testing.assert_array_equal(truth, jax_tune.truth_states(j_manual,
                                                               names))
    rng = np.random.default_rng(3)
    emissions = rng.dirichlet(np.ones(3), size=len(truth))
    decision = np.where(rng.random(len(truth)) < 0.9, np.maximum(truth, 0),
                        rng.integers(0, 3, len(truth)))
    for target in (0.5, 0.9, 1.01):
        assert tune.writeback_threshold(
            emissions, decision, truth, target_precision=target) == \
            jax_tune.writeback_threshold(
                emissions, decision, truth, target_precision=target)
    # a k past the corpus is clamped to it (ranks 60+ hold near-ties, so
    # only the sweep's results are compared there)
    kw.update(ks=(500,), pads=(3,))
    assert [r.to_json() for r in tune.tune_knn_hmm(
        names, frames, corpus, t_manual, device="cpu", **kw)[0]] == \
        [r.to_json() for r in jax_tune.tune_knn_hmm(
            names, frames, corpus, j_manual, **kw)[0]]
    with pytest.raises(ValueError, match="empty parameter grid"):
        tune.tune_knn_hmm(names, frames, corpus, t_manual, device="cpu",
                          pads=())


def test_tune_helpers_match_jax():
    seqs = [np.array([0, 0, 2, -1, 2, 1, 1, 1, 2, 0]), np.array([2, 2, 1])]
    np.testing.assert_allclose(tune.fit_transition_matrix(seqs),
                               jax_tune.fit_transition_matrix(seqs),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tune.fit_transition_matrix(seqs, smoothing=0.0,
                                   structural_zeros=None),
        jax_tune.fit_transition_matrix(seqs, smoothing=0.0,
                                       structural_zeros=None),
        rtol=0, atol=1e-6)
    truth = np.array([2, 0, 0, 0, -1, 0, 1, 1, 1, 1, 2])
    got_iv = tune.truth_intervals(truth)
    assert _ivs(got_iv) == _ivs(jax_tune.truth_intervals(truth))
    pred = [clips.ClipInterval("left", 1, 2), clips.ClipInterval("left", 0, 3),
            clips.ClipInterval("right", 6, 9), clips.ClipInterval("right",
                                                                  20, 30)]
    jpred = [jax_clips.ClipInterval(c.side, c.start, c.end) for c in pred]
    jtrue = jax_tune.truth_intervals(truth)
    for iou in (0.3, 0.5, 0.9):
        assert tune.interval_prf(pred, got_iv, iou=iou) == \
            jax_tune.interval_prf(jpred, jtrue, iou=iou)
    assert tune.interval_prf([], []) == jax_tune.interval_prf([], [])
