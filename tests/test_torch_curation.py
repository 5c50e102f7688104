"""The port's labelling and clip-curation path against the JAX package on
the same numpy inputs: two-pass self-labelling, per-clip finalize, clip
merging, change points, clustering and the side classifier, its npz files,
the fresh-test dump, the per-class npz writer, the label writers, the file
helpers, the preprocessing specs and frame extraction; then the seven
verbs (self-label, finalize-clips, merge-clips, clustering, fresh-test,
write-embeddings, extract-frames) as subprocesses of the port's CLI
(``VRT_TINY=1 --device cpu``) against the JAX package's verbs fed the same
embeddings through the same seed corpus.

Tolerances: labels, keep masks, clip listings, file bytes and vote
arithmetic must be exactly equal (the same numpy operations on the same
inputs). The side classifier's training, from the JAX init carried
across: parameters and loss/accuracy history within 1e-5 after 3 epochs
(Adam's update is the same formula, evaluated in another order by each
library). Logits of one saved classifier in both packages: 1e-5.
"""

import csv
import dataclasses
import io
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.cli import common as jax_common
from vit_research_tpu.cli import ingest as jax_ingest
from vit_research_tpu.cli import segment_cmds as jax_segment_cmds
from vit_research_tpu.data import labels as jax_labels
from vit_research_tpu.data import preprocess as jax_pre
from vit_research_tpu.data import synthetic
from vit_research_tpu.data import video as jax_video
from vit_research_tpu.db import builders as jax_builders
from vit_research_tpu.evaluate import fresh_test as jax_fresh
from vit_research_tpu.segment import changepoint as jax_cp
from vit_research_tpu.segment import clips as jax_clips
from vit_research_tpu.segment import clustering as jax_clu
from vit_research_tpu.segment import knn as jax_knn
from vit_research_tpu.store.vector_store import PersistentClient
from vit_research_tpu.train import checkpoint as jax_ckpt
from vit_research_tpu.utils import fileops as jax_fileops
from vit_research_tpu_torch.data import labels, preprocess, video
from vit_research_tpu_torch.db import builders
from vit_research_tpu_torch.evaluate import fresh_test
from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.segment import changepoint, clips, clustering, knn
from vit_research_tpu_torch.train import checkpoint
from vit_research_tpu_torch.utils import fileops

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ self-label


def _anchored(rng, mixes, per_query=3, d=12, spread=0.05):
    """A corpus of one cluster per vote mix (counts of left/right/none
    rows around an anchor) and ``per_query`` queries at each anchor, plus
    queries halfway between neighbouring anchors (their votes come from
    both clusters, and from pass-1 frames in pass 2)."""
    embs, labs, queries = [], [], []
    anchors = []
    for a, mix in enumerate(mixes):
        anchor = np.zeros(d, np.float32)
        anchor[a % d] = 4.0
        anchor[(a + 1) % d] = 1.0 * a
        anchors.append(anchor)
        for side, n in enumerate(mix):
            for _ in range(n):
                embs.append(anchor + rng.normal(0, spread, d))
                labs.append(side)
        for _ in range(per_query):
            queries.append(anchor + rng.normal(0, spread, d))
    for a, b in zip(anchors, anchors[1:]):
        queries.append((a + b) / 2 + rng.normal(0, spread, d))
    return (np.asarray(queries, np.float32), np.asarray(embs, np.float32),
            np.asarray(labs, np.int64))


# vote mixes of 25 rows: unanimous, accepted at 20, and planted ties
# (10/10/5, 12/12/1, 5/10/10: argmax takes the first maximum)
MIXES = [(25, 0, 0), (20, 5, 0), (10, 10, 5), (12, 12, 1), (0, 20, 5),
         (5, 10, 10), (2, 3, 20)]


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_two_pass_self_label_matches_jax_with_vote_ties(metric):
    q, c, lab = _anchored(np.random.default_rng(0), MIXES)
    want = jax_knn.two_pass_self_label(q, c, lab, k=25, min_votes=20,
                                       temperature=7.0, metric=metric)
    got = knn.two_pass_self_label(q, c, lab, k=25, min_votes=20,
                                  temperature=7.0, metric=metric,
                                  device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    labels_, _, accepted = got
    # both passes ran, and tied votes were decided
    assert accepted.any() and (~accepted).any()
    counts = knn.vote_counts(knn.knn_labels(q, c, lab, 25, device="cpu",
                                            metric=metric)[0])
    tied = (counts == counts.max(axis=1, keepdims=True)).sum(axis=1) > 1
    assert tied.any()


def test_classify_passes_and_temp_softmax_match_jax():
    nl = np.random.default_rng(1).integers(-1, 3, size=(40, 25))
    nl[:4, :20] = 1  # accepted in pass 1
    nl[4, :] = np.repeat([0, 1, 2, -1], [10, 10, 4, 1])  # a tie
    for g, w in zip(knn.classify_pass1(nl, 20, 7.0),
                    jax_knn.classify_pass1(nl, 20, 7.0)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(knn.classify_pass2(nl, 3.0),
                    jax_knn.classify_pass2(nl, 3.0)):
        np.testing.assert_array_equal(g, w)
    x = np.random.default_rng(2).normal(size=(5, 3)) * 20
    np.testing.assert_array_equal(knn.temp_softmax(x, 7.0),
                                  jax_knn.temp_softmax(x, 7.0))


# ------------------------------------------------------ finalize and merge


def _votes5(seed, t, side):
    """5-NN vote fractions (multiples of 0.2) of a clip of ``side`` with
    stretches of other sides, as finalize-clips feeds finalize_clip."""
    rng = np.random.default_rng(seed)
    lab = np.full(t, ("left", "right", "none").index(side))
    for _ in range(3):
        s = int(rng.integers(0, t - 20))
        lab[s:s + int(rng.integers(5, 40))] = rng.integers(0, 3)
    p = np.full((t, 3), 0.2)
    p[np.arange(t), lab] = 0.6
    return np.stack([rng.multinomial(5, row) for row in p]) / 5


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("side", ["left", "right", "none"])
def test_finalize_clip_matches_jax_on_5nn_votes(seed, side):
    probs = _votes5(seed, 300 + 97 * seed, side)
    want = jax_clips.finalize_clip(probs, side)
    got = clips.finalize_clip(probs, side, device="cpu")
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)


def _clip_tree(root, spec):
    """Clip dirs of empty frame files: spec = [(dir name, first, last)]."""
    dirs = []
    for name, a, b in spec:
        vid = int(name.split("_")[0][3:])
        d = os.path.join(root, name)
        os.makedirs(d)
        for n in range(a, b + 1):
            with open(os.path.join(d, f"vid{vid}_frame_{n}.jpg"), "w") as f:
                f.write(f"{vid}:{n}")
        dirs.append(d)
    return dirs


def _listing(root):
    return {d: sorted(os.listdir(os.path.join(root, d)))
            for d in sorted(os.listdir(root))}


def test_finalize_clip_dirs_matches_jax_and_skips_existing(tmp_path):
    dirs = _clip_tree(str(tmp_path / "clips"), [
        ("vid1_clip_1_left", 10, 190), ("vid1_clip_2_right", 200, 420),
        ("vid2_clip_1_none", 5, 60)])
    calls = []

    def frame_probs(paths):
        calls.append(len(paths))
        side = os.path.basename(os.path.dirname(paths[0])).split("_")[-1]
        return _votes5(len(paths), len(paths), side)

    want = jax_clips.finalize_clip_dirs(dirs, frame_probs,
                                        str(tmp_path / "jax"))
    got = clips.finalize_clip_dirs(dirs, frame_probs,
                                   str(tmp_path / "torch"), device="cpu")
    assert [os.path.basename(d) for d in got] == \
        [os.path.basename(d) for d in want]
    assert _listing(tmp_path / "torch") == _listing(tmp_path / "jax")
    # some frames were dropped, and an existing destination is skipped
    # before any embedding work
    assert sum(len(v) for v in _listing(tmp_path / "torch").values()) < \
        sum(calls[:3])
    n = len(calls)
    again = clips.finalize_clip_dirs(dirs, frame_probs,
                                     str(tmp_path / "torch"), device="cpu")
    assert again == got and len(calls) == n


@pytest.mark.parametrize("max_gap", [0, 30])
def test_merge_clip_ranges_matches_jax(max_gap):
    rng = np.random.default_rng(max_gap)
    ranges = []
    for _ in range(40):
        s = int(rng.integers(0, 2000))
        ranges.append((str(rng.choice(["left", "right"])), s,
                       s + int(rng.integers(10, 120))))
    assert clips.merge_clip_ranges(ranges, max_gap=max_gap) == \
        jax_clips.merge_clip_ranges(ranges, max_gap=max_gap)
    assert clips.merge_clip_ranges([]) == []


@pytest.mark.parametrize("drop_none", [True, False])
def test_merge_clip_dirs_across_vids_matches_jax(tmp_path, drop_none):
    spec = [("vid1_clip_1_left", 10, 40), ("vid1_clip_2_left", 60, 90),
            ("vid1_clip_3_none", 91, 120), ("vid1_clip_4_right", 130, 160),
            ("vid2_clip_1_left", 30, 50), ("vid2_clip_2_left", 95, 99)]
    dirs = _clip_tree(str(tmp_path / "clips"), spec)
    pool = tmp_path / "pool"
    pool.mkdir()
    for vid in (1, 2):
        for n in range(1, 171):
            (pool / f"vid{vid}_frame_{n}.jpg").write_text(f"{vid}:{n}")
    want = jax_clips.merge_clip_dirs(dirs, str(pool), str(tmp_path / "jax"),
                                     drop_none=drop_none)
    got = clips.merge_clip_dirs(dirs, str(pool), str(tmp_path / "torch"),
                                drop_none=drop_none)
    assert [os.path.basename(d) for d in got] == \
        [os.path.basename(d) for d in want]
    assert _listing(tmp_path / "torch") == _listing(tmp_path / "jax")
    # vid 1's left clips merge (gap 19); vid 2's (gap 44) do not
    assert "vid1_clip_1_left" in _listing(tmp_path / "torch")
    assert len(_listing(tmp_path / "torch")["vid1_clip_1_left"]) == 81


# ----------------------------------------------------------- change point


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_changepoint_matches_jax(threshold):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(2, 0.5, 150), rng.normal(-2, 0.5, 120),
                        rng.normal(1, 0.5, 200)])
    np.testing.assert_array_equal(changepoint.proximity_weights(25, 0.9),
                                  jax_cp.proximity_weights(25, 0.9))
    np.testing.assert_array_equal(changepoint.changepoint_scores(x),
                                  jax_cp.changepoint_scores(x))
    got = changepoint.detect_changepoints(x, threshold=threshold)
    np.testing.assert_array_equal(
        got, jax_cp.detect_changepoints(x, threshold=threshold))
    assert len(got) >= 2


# ------------------------------------------------------ clustering + MLP


def _labelled(seed, n=64, d=16):
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, :3] += 3.0 * np.eye(3, dtype=np.float32)[y]
    return x, y


@pytest.mark.parametrize("route", ["numpy", "sklearn"])
def test_clustering_routes_match_jax(monkeypatch, route):
    x, y = _labelled(4, n=90)
    assert clustering.class_mean_separation(x, y) == \
        jax_clu.class_mean_separation(x, y)
    if route == "numpy":  # the route without sklearn (the card's)
        monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    gc, ga = clustering.kmeans_with_class_means(x, y, n_iter=20)
    wc, wa = jax_clu.kmeans_with_class_means(x, y, n_iter=20)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(ga, wa)
    assert (ga == y).mean() > 0.9


def _jax_side_init(d, n_classes=3, seed=0):
    model = jax_clu.SideMLP(num_classes=n_classes)
    return model, model.init(jax.random.PRNGKey(seed), jnp.zeros((1, d)))


def _tree_close(got, want, tol):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), atol=tol,
                                                rtol=tol), got, want)


@pytest.mark.parametrize("batch_size", [64, 16])
def test_train_side_classifier_matches_jax_from_its_init(batch_size,
                                                         monkeypatch):
    x, y = _labelled(5)
    _, init = _jax_side_init(16)
    model = clustering.SideMLP(16, 3)
    model.load_state_dict(convert.side_mlp_to_state_dict(
        jax.tree_util.tree_map(np.asarray, init)))
    # the training starts from the JAX init carried across
    monkeypatch.setattr(clustering, "SideMLP", lambda *a, **k: model)
    jmodel, jparams, jhist = jax_clu.train_side_classifier(
        x, y, num_epochs=3, batch_size=batch_size, seed=0)
    model, hist = clustering.train_side_classifier(
        x, y, num_epochs=3, batch_size=batch_size, seed=0, device="cpu")
    _tree_close(convert.side_mlp_to_params(model.state_dict()), jparams,
                1e-5)
    assert len(hist) == len(jhist) == 3
    for g, w in zip(hist, jhist):
        assert abs(g["loss"] - w["loss"]) <= 1e-5
        assert abs(g["acc"] - w["acc"]) <= 1e-5
    np.testing.assert_array_equal(
        clustering.classify_sides(model, x, device="cpu"),
        jax_clu.classify_sides(jmodel, jparams, x))


def test_side_classifier_seeded_init_and_shapes():
    a = clustering.SideMLP(16, 3, generator=torch.Generator().manual_seed(1))
    b = clustering.SideMLP(16, 3, generator=torch.Generator().manual_seed(1))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    _, init = _jax_side_init(16)
    shapes = jax.tree_util.tree_map(np.shape, init)
    assert jax.tree_util.tree_map(
        np.shape, convert.side_mlp_to_params(a.state_dict())) == shapes
    # the init's spread is the Flax Dense init's (LeCun truncated normal)
    w = a.fc1.weight.detach().numpy()
    assert abs(w.std() - np.asarray(init["params"]["fc1"]["kernel"]).std()) \
        < 0.02
    assert not a.fc1.bias.detach().any()


def test_side_classifier_npz_loads_in_both_packages(tmp_path):
    x, _ = _labelled(6, n=10)
    # JAX -> port
    jmodel, jparams = _jax_side_init(16, seed=3)
    jpath = str(tmp_path / "jax.npz")
    jax_ckpt.save_params_npz(jparams, jpath)
    tree = checkpoint.load_params_npz(None, jpath)
    model = clustering.SideMLP(16, 3)
    model.load_state_dict(convert.side_mlp_to_state_dict(tree))
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # port -> JAX, and the key format is the JAX package's
    model = clustering.SideMLP(16, 3, generator=torch.Generator()
                               .manual_seed(7))
    tpath = str(tmp_path / "torch.npz")
    checkpoint.save_params_npz(
        convert.side_mlp_to_params(model.state_dict()), tpath)
    with np.load(tpath) as a, np.load(jpath) as b:
        assert a.files == b.files
    loaded = jax_ckpt.load_params_npz(jparams, tpath)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(jmodel.apply(loaded, x)), want,
                               atol=1e-5, rtol=1e-5)
    # a template checks the shapes
    with pytest.raises(ValueError, match="shape mismatch"):
        bad = jax.tree_util.tree_map(lambda a: np.zeros((2,)), jparams)
        checkpoint.load_params_npz(bad, tpath)


# ------------------------------------------- dumps, writers, file helpers


def _frames(root, n=12, size=(32, 32)):
    return synthetic.write_video_frames(str(root), 1,
                                        [("left", n // 2),
                                         ("right", n - n // 2)], size=size)


def test_dump_classified_frames_matches_jax(tmp_path):
    paths = _frames(tmp_path / "frames")
    embs = np.random.default_rng(7).normal(size=(len(paths), 8))

    def classify(e):
        return np.asarray(e)[:, :3].argmax(axis=1)

    want = jax_fresh.dump_classified_frames(paths, lambda p: embs, classify,
                                            str(tmp_path / "jax"))
    got = fresh_test.dump_classified_frames(paths, lambda p: embs, classify,
                                            str(tmp_path / "torch"))
    assert got == want
    assert _listing(tmp_path / "torch") == _listing(tmp_path / "jax")


def test_write_class_npz_matches_jax(tmp_path):
    paths = _frames(tmp_path / "frames")
    by_class = {"left": paths[:6], "right": paths[6:]}
    rng = np.random.default_rng(8)
    table = {p: rng.normal(size=5).astype(np.float32) for p in paths}

    def embed(ps):
        return np.stack([table[p] for p in ps])

    want = jax_builders.write_class_npz(
        by_class, embed, str(tmp_path / "jax_{cls}.npz"))
    got = builders.write_class_npz(
        by_class, embed, str(tmp_path / "torch_{cls}.npz"))
    assert sorted(got) == sorted(want) == ["left", "right"]
    for cls in got:
        with np.load(got[cls]) as g, np.load(want[cls]) as w:
            assert g.files == w.files
            for key in g.files:
                np.testing.assert_array_equal(g[key], w[key])
                assert g[key].dtype == w[key].dtype


def test_label_writers_write_the_jax_bytes(tmp_path):
    def read(p):
        with open(p, "rb") as f:
            return f.read()

    pairs = [(labels.ManualIntervals(), jax_labels.ManualIntervals())]
    for mi, jmi in pairs:
        for side, iv in (("left", [(1, 5, 34), (2, 3, 9)]),
                         ("right", [(1, 39, 68)]), ("none", [])):
            mi.intervals[side].extend(iv)
            jmi.intervals[side].extend(iv)
        mi.to_csv(str(tmp_path / "t.csv"))
        jmi.to_csv(str(tmp_path / "j.csv"))
    assert read(tmp_path / "t.csv") == read(tmp_path / "j.csv")
    back = labels.ManualIntervals.from_csv(str(tmp_path / "t.csv"))
    assert back.intervals == pairs[0][0].intervals

    clip_labels = {"clips/vid1_clip_1_left": 1, "clips/vid1_clip_2_right": 0,
                   "clips/vid2_clip_1_left": -1}
    labels.save_clip_labels(clip_labels, str(tmp_path / "t_labels.csv"))
    jax_labels.save_clip_labels(clip_labels, str(tmp_path / "j_labels.csv"))
    assert read(tmp_path / "t_labels.csv") == read(tmp_path / "j_labels.csv")
    assert labels.load_clip_labels(str(tmp_path / "t_labels.csv")) == \
        clip_labels

    template = {"clips/vid1_clip_1_left": {"event_make": [[3, 9]],
                                           "event_miss": [],
                                           "event_none": [[10, 20]]}}
    labels.save_event_template(template, str(tmp_path / "t.json"))
    jax_labels.save_event_template(template, str(tmp_path / "j.json"))
    assert read(tmp_path / "t.json") == read(tmp_path / "j.json")
    assert labels.load_event_template(str(tmp_path / "t.json")) == template


@pytest.mark.parametrize("copy", [True, False])
def test_fileops_match_jax(tmp_path, copy):
    for pkg, mod in (("torch", fileops), ("jax", jax_fileops)):
        src = tmp_path / pkg / "src"
        _frames(src, n=10)
        (src / "notes.txt").write_text("x")
        moved = mod.move_frames(str(src), str(tmp_path / pkg / "dst"),
                                pattern="frame", limit=7, copy=copy)
        assert moved == 7
        res = tmp_path / pkg / "results"
        (res / "old").mkdir(parents=True)
        mod.clear_dirs(str(res), str(tmp_path / pkg / "fresh"))
    assert _listing(tmp_path / "torch") == _listing(tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "torch" / "results")) == []


def test_specs_and_normalize_host_match_jax():
    for name in ("HF_VIT_SPEC", "HF_VIT_SPEC_NO_RESCALE",
                 "RANDOM_VIT_SPEC_RAW", "RANDOM_VIT_SPEC_UNIT"):
        assert dataclasses.asdict(getattr(preprocess, name)) == \
            dataclasses.asdict(getattr(jax_pre, name))
    batch = np.random.default_rng(9).integers(0, 256, (3, 8, 8, 3),
                                              dtype=np.uint8)
    for name in ("HF_VIT_SPEC", "RANDOM_VIT_SPEC_UNIT"):
        for gray in (False, True):
            spec = dataclasses.replace(getattr(preprocess, name),
                                       grayscale=gray)
            jspec = dataclasses.replace(getattr(jax_pre, name),
                                        grayscale=gray)
            got = preprocess.normalize_host(batch, spec)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(
                got, jax_pre.normalize_host(batch, jspec))


def _tiny_video(path, n=9, hw=(24, 40)):
    import cv2

    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                          (hw[1], hw[0]))
    rng = np.random.default_rng(10)
    for _ in range(n):
        out.write(rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    out.release()
    return str(path)


def test_extract_frames_matches_jax(tmp_path):
    vid = _tiny_video(tmp_path / "game.avi")
    kw = dict(size=(16, 32), frame_range=(2, 8), every=2)
    want = jax_video.extract_frames(vid, str(tmp_path / "jax"), 3, **kw)
    got = video.extract_frames(vid, str(tmp_path / "torch"), 3, **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == \
        [f"vid3_frame_{i}.jpg" for i in (3, 5, 7)]
    for g, w in zip(got, want):
        with open(g, "rb") as a, open(w, "rb") as b:
            assert a.read() == b.read()
    assert video.download_video("https://example.invalid/v",
                                str(tmp_path / "v.mp4")) is False


def test_extract_frames_without_cv2_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV required"):
        video.extract_frames("game.avi", str(tmp_path / "out"), 1)


# ------------------------------------------------------------ the verbs


def _run(args, cwd, check=True, path=()):
    env = dict(os.environ, VRT_TINY="1",
               PYTHONPATH=os.pathsep.join([*path, REPO]),
               OMP_NUM_THREADS="1")
    for key in ("VRT_TOME_R", "VRT_GEMM_QUANT", "VRT_GRAYSCALE"):
        env.pop(key, None)
    proc = subprocess.run(
        [sys.executable, "-m", "vit_research_tpu_torch.cli", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    if check and proc.returncode != 0:
        raise AssertionError(f"{args[0]} failed ({proc.returncode}):\n"
                             f"{proc.stdout}\n{proc.stderr}")
    return proc


@pytest.fixture(scope="module")
def verbs(tmp_path_factory):
    """A seed corpus (vid 1, written by the port's write-frame-db) and a
    query game (vid 2), the port's tiny engine in this process, and the
    JAX package's verbs patched to embed with it: both packages' verbs
    then see the same embeddings and the same corpus rows."""
    wd = tmp_path_factory.mktemp("verbs")
    synthetic.write_video_frames(str(wd / "frames"), 1,
                                 [("none", 4), ("left", 30), ("none", 4),
                                  ("right", 30), ("none", 4)], size=(32, 32))
    synthetic.write_video_frames(str(wd / "game"), 2,
                                 [("left", 26), ("none", 6), ("right", 22)],
                                 size=(32, 32))
    mi = labels.ManualIntervals()
    for side, a, b in [("none", 1, 4), ("left", 5, 34), ("none", 35, 38),
                       ("right", 39, 68), ("none", 69, 72)]:
        mi.intervals[side].append((1, a, b))
    mi.to_csv(str(wd / "manual.csv"))
    mp = pytest.MonkeyPatch()
    mp.setenv("VRT_TINY", "1")
    for key in ("VRT_TOME_R", "VRT_GEMM_QUANT", "VRT_GRAYSCALE"):
        mp.delenv(key, raising=False)
    from vit_research_tpu_torch import cli
    from vit_research_tpu_torch.cli import common as port_common

    # the seed corpus (write-frame-db has its own subprocess test in
    # tests/test_torch_cli.py)
    with redirect_stdout(io.StringIO()):
        cli.main(["write-frame-db", str(wd / "frames"), "--manual-csv",
                  str(wd / "manual.csv"), "--db", str(wd / "db"),
                  "--collection", "corpus", "--batch-size", "16",
                  "--device", "cpu"])

    engine = port_common._engine(16, "cpu")
    mp.setattr(jax_common, "_engine", lambda batch_size: engine)
    yield SimpleNamespace(wd=wd, engine=engine)
    mp.undo()


def _jax_verb(fn, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(SimpleNamespace(**kw))
    return buf.getvalue()


def test_verbs_self_label_and_upsert_match_jax(verbs):
    wd = str(verbs.wd)
    shutil.copytree(os.path.join(wd, "db"), os.path.join(wd, "db_jax"))
    out = _run(["self-label", "game", "--db", "db", "--collection", "corpus",
                "--out", "labels_t.csv", "--k", "25", "--min-votes", "20",
                "--batch-size", "16", "--upsert", "--device", "cpu"], wd)
    _jax_verb(jax_segment_cmds.cmd_self_label, frames=os.path.join(wd, "game"),
              db=os.path.join(wd, "db_jax"), collection="corpus",
              out=os.path.join(wd, "labels_j.csv"), k=25, min_votes=20,
              temperature=7.0, upsert=False, batch_size=16)
    with open(os.path.join(wd, "labels_t.csv"), "rb") as a, \
            open(os.path.join(wd, "labels_j.csv"), "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    rows = list(csv.DictReader(io.StringIO(got.decode())))
    n_pass1 = sum(r["pass"] == "1" for r in rows)
    assert f"labeled 54 frames ({n_pass1} pass-1" in out.stdout
    assert 0 < n_pass1 < 54
    # --upsert added the pass-1 frames (new ids only) and kept the seed rows
    col = PersistentClient(os.path.join(wd, "db")).get_collection("corpus")
    assert col.count() == 72 + n_pass1
    assert col.embedding_profile == "torch|tiny|tome0|quant-none|gray0"
    seed = col.get(ids=["vid1_frame_10.jpg"])["metadatas"][0]
    assert seed["label"] == "left" and seed["left_prob"] == 1.0
    from vit_research_tpu_torch import cli

    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["self-label", os.path.join(wd, "game"), "--db",
                  os.path.join(wd, "db"), "--collection", "corpus", "--out",
                  os.path.join(wd, "labels_t2.csv"), "--k", "5",
                  "--min-votes", "5", "--batch-size", "16", "--upsert",
                  "--device", "cpu"])
    again = SimpleNamespace(stdout=buf.getvalue())
    # a second pass on the grown corpus keeps every row it already holds
    # and adds only the frames it accepts anew
    with open(os.path.join(wd, "labels_t2.csv")) as f:
        rows2 = list(csv.DictReader(f))
    first = {r["frame"] for r in rows if r["pass"] == "1"}
    second = {r["frame"] for r in rows2 if r["pass"] == "1"}
    assert first <= second
    assert f"kept {len(first)} existing corpus rows (not overwritten)" in \
        again.stdout
    assert PersistentClient(os.path.join(wd, "db")).get_collection(
        "corpus").count() == 72 + len(second)


def test_verbs_finalize_and_merge_clips_match_jax(verbs, tmp_path):
    wd = str(verbs.wd)
    clip_root = tmp_path / "clips"
    for name, a, b in [("vid2_clip_1_left", 1, 30),
                       ("vid2_clip_2_right", 29, 54)]:
        (clip_root / name).mkdir(parents=True)
        for n in range(a, b + 1):
            shutil.copy(os.path.join(wd, "game", f"vid2_frame_{n}.jpg"),
                        clip_root / name)
    _run(["finalize-clips", "--clips", str(clip_root), "--db", "db",
          "--collection", "corpus", "--out", str(tmp_path / "fin_t"),
          "--batch-size", "16", "--device", "cpu"], wd)
    _jax_verb(jax_segment_cmds.cmd_finalize_clips, clips=str(clip_root),
              db=os.path.join(wd, "db"), collection="corpus",
              out=str(tmp_path / "fin_j"), k=5, batch_size=16)
    fin = _listing(tmp_path / "fin_t")
    assert fin == _listing(tmp_path / "fin_j")
    assert sorted(fin) == ["vid2_clip_1_left", "vid2_clip_2_right"]
    assert 0 < len(fin["vid2_clip_1_left"]) < 30

    out = _run(["merge-clips", "--clips", str(tmp_path / "fin_t"),
                "--frame-pool", "game", "--out", str(tmp_path / "mer_t"),
                "--max-gap", "30"], wd)
    _jax_verb(jax_segment_cmds.cmd_merge_clips,
              clips=str(tmp_path / "fin_t"),
              frame_pool=os.path.join(wd, "game"),
              out=str(tmp_path / "mer_j"), max_gap=30)
    assert _listing(tmp_path / "mer_t") == _listing(tmp_path / "mer_j")
    assert "merged 2 clips -> 2 under" in out.stdout


def test_verbs_write_embeddings_match_jax(verbs, tmp_path):
    wd = str(verbs.wd)
    out = _run(["write-embeddings", "frames", "--manual-csv", "manual.csv",
                "--out-template", str(tmp_path / "t_{cls}.npz"),
                "--batch-size", "16", "--device", "cpu"], wd)
    _jax_verb(jax_ingest.cmd_write_embeddings,
              frames=os.path.join(wd, "frames"),
              manual_csv=os.path.join(wd, "manual.csv"),
              out_template=str(tmp_path / "j_{cls}.npz"), batch_size=16)
    assert "left: 30 frames ->" in out.stdout
    for cls in ("left", "right", "none"):
        with np.load(tmp_path / f"t_{cls}.npz") as g, \
                np.load(tmp_path / f"j_{cls}.npz") as w:
            for key in ("embeddings", "frame_ids"):
                np.testing.assert_array_equal(g[key], w[key])
            assert g["embeddings"].shape[1:] == (1, 32)


def test_verbs_clustering_and_fresh_test(verbs, tmp_path):
    wd = str(verbs.wd)
    params = str(tmp_path / "side.npz")
    shutil.copytree(os.path.join(wd, "db"), os.path.join(wd, "db_clu"))
    # a corpus of the seed rows only (self-label may have grown "db")
    clu = PersistentClient(os.path.join(wd, "db_clu"))
    col = clu.get_collection("corpus")
    extra = [i for i in col.get()["ids"] if i.startswith("vid2_")]
    if extra:
        col.delete(ids=extra)
        clu.flush()
    # both verbs on the k-means route of a machine without sklearn (the
    # card's; the sklearn route is held to the JAX package's above)
    hide = tmp_path / "no_sklearn" / "sklearn"
    hide.mkdir(parents=True)
    (hide / "__init__.py").write_text("raise ImportError('hidden')\n")
    out = _run(["clustering", "--db", "db_clu", "--collection", "corpus",
                "--out", params, "--epochs", "4", "--batch-size", "16",
                "--device", "cpu"], wd, path=[str(hide.parent)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "sklearn.cluster", None)
        want = _jax_verb(jax_segment_cmds.cmd_clustering,
                         db=os.path.join(wd, "db_clu"), collection="corpus",
                         out=str(tmp_path / "side_jax.npz"), epochs=1,
                         batch_size=16, seed=0)
    # the study's lines are the JAX verb's; the classifier is the port's
    # own training (its init is a torch.Generator's, not jax.random's)
    keep = ("class-mean", "kmeans")
    assert [ln for ln in out.stdout.splitlines() if ln.startswith(keep)] \
        == [ln for ln in want.splitlines() if ln.startswith(keep)]
    from vit_research_tpu_torch.segment.knn import corpus_from_collection
    from vit_research_tpu_torch.store.vector_store import (
        PersistentClient as PortClient)

    corpus = corpus_from_collection(
        PortClient(os.path.join(wd, "db_clu"), device="cpu")
        .get_collection("corpus"))
    model, hist = clustering.train_side_classifier(
        corpus["embeddings"], corpus["labels"], num_epochs=4,
        batch_size=16, seed=0, device="cpu")
    saved = checkpoint.load_params_npz(None, params)
    _tree_close(saved, convert.side_mlp_to_params(model.state_dict()), 0)
    assert f"side MLP final train acc {hist[-1]['acc']:.3f}" in out.stdout

    # fresh-test with the port's npz, in both packages (the JAX verb
    # loads the port's file)
    out = _run(["fresh-test", "game", "--params", params, "--out",
                str(tmp_path / "fresh_t"), "--batch-size", "16", "--device",
                "cpu"], wd)
    want = _jax_verb(jax_segment_cmds.cmd_fresh_test,
                     frames=os.path.join(wd, "game"), params=params,
                     out=str(tmp_path / "fresh_j"), batch_size=16)
    assert out.stdout.splitlines()[-1].split("(")[1] == \
        want.splitlines()[-1].split("(")[1]
    assert _listing(tmp_path / "fresh_t") == _listing(tmp_path / "fresh_j")
    assert sum(len(v) for v in _listing(tmp_path / "fresh_t").values()) \
        == 54


def test_verb_extract_frames_matches_jax(tmp_path):
    vid = _tiny_video(tmp_path / "game.avi")
    args = ["--vid", "4", "--height", "16", "--width", "32", "--every", "3",
            "--start", "1", "--end", "9"]
    out = _run(["extract-frames", vid, "--out", str(tmp_path / "t"), *args],
               str(tmp_path))
    _jax_verb(jax_ingest.cmd_extract_frames, video=vid,
              out=str(tmp_path / "j"), vid=4, height=16, width=32, every=3,
              start=1, end=9)
    assert out.stdout.strip() == f"wrote 3 frames to {tmp_path / 't'}"
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j")) == \
        ["vid4_frame_1.jpg", "vid4_frame_4.jpg", "vid4_frame_7.jpg"]
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes()
    from vit_research_tpu_torch import cli

    with pytest.raises(SystemExit, match="--start and --end go together"):
        cli.main(["extract-frames", vid, "--out", str(tmp_path / "x"),
                  "--vid", "4", "--start", "2"])
