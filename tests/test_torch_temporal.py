"""The port's temporal-head segmentation against the JAX package:
TemporalHead's forward and its flax weight map, masked_cross_entropy
(every label ignored too), 50 epochs of train_temporal_head from one
init, predict_probs, temporal_head.npz files crossing both ways,
segment_with_temporal_head on a planted game, and ``segment --method
temporal`` through the CLI (the default method, --manual-csv's exit, the
clips of the JAX verb on the same embeddings and weights).

Inputs are drawn with numpy from fixed seeds and fed to both packages;
weights cross through models/convert.py. Tolerances: the forward, the
losses and the probabilities 1e-5 (f32 on the CPU in other summation
orders: Conv1d as XLA's and as torch's convolution); the training
losses at every epoch 1e-6 relative of a float64 run of the loop and
1e-4 relative of the JAX scan's (which drifts 4.3e-5 from the float64
run by epoch 50), the trained weights 2e-5 of the float64 run's and lr a
step of the JAX package's. Decoded paths and clips equal.
"""

import argparse
import io
import os
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.cli import segment_cmds as jax_segment_cmds
from vit_research_tpu.cli import common as jax_common
from vit_research_tpu.data import labels as jax_labels
from vit_research_tpu.data import synthetic
from vit_research_tpu.models import temporal_head as jax_th
from vit_research_tpu.segment import pipeline as jax_pipeline
from vit_research_tpu.train import checkpoint as jax_ckpt
from vit_research_tpu.train import train_temporal as jax_tt
from vit_research_tpu_torch import cli
from vit_research_tpu_torch.cli import common as port_common
from vit_research_tpu_torch.data import labels as labels_mod
from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.models import temporal_head as th
from vit_research_tpu_torch.segment import pipeline
from vit_research_tpu_torch.train import checkpoint as ckpt
from vit_research_tpu_torch.train import train_temporal as tt

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
D = 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_init(seed, d=D):
    return _np_tree(jax_th.TemporalHead(embed_dim=d).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, d))))


def _port_head(params, d=D):
    model = th.TemporalHead(d)
    model.load_state_dict(convert.temporal_head_to_state_dict(params))
    return model.eval()


def _game(seed=0, t=60, d=D):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((t, d)).astype(np.float32)
    labels = rng.integers(0, 3, size=t).astype(np.int64)
    labels[::5] = -1
    return emb, labels


def test_forward_and_weight_map_match_jax():
    """The forward on (B, T, D) at the kernel widths 9/7/5/3/1 with
    'same' padding (sequences shorter than a kernel too), and the weight
    map both ways (every flax leaf, Conv kernels (k, in, out))."""
    params = _jax_init(1)
    model = _port_head(params)
    sd = model.state_dict()
    assert len(sd) == 10
    back = convert.temporal_head_to_params(sd)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    for shape in ((2, 37, D), (1, 3, D)):
        x = rng.standard_normal(shape).astype(np.float32)
        want = jax_th.TemporalHead(embed_dim=D).apply(params, jnp.asarray(x))
        with torch.no_grad():
            got = model(torch.from_numpy(x))
        assert got.shape == (*shape[:2], 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_seeded_init_is_flax_shaped():
    a = th.TemporalHead(D, generator=torch.Generator().manual_seed(0))
    b = th.TemporalHead(D, generator=torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any()
    got = convert.temporal_head_to_params(a.state_dict())
    assert jax.tree_util.tree_map(np.shape, got) == \
        jax.tree_util.tree_map(np.shape, _jax_init(0))


@pytest.mark.parametrize("ignored", ["some", "all", "none"])
def test_masked_cross_entropy_matches_jax(ignored):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 11, 3)).astype(np.float32)
    labels = rng.integers(0, 3, size=(2, 11)).astype(np.int64)
    if ignored == "some":
        labels[:, ::3] = -1
    elif ignored == "all":
        labels[:] = -1
    got = th.masked_cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    want = jax_th.masked_cross_entropy(jnp.asarray(logits),
                                       jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    if ignored == "all":
        assert float(got) == 0.0


class _RecordingNumpy:
    """numpy, with every ``asarray`` result recorded: the JAX trainer
    turns its scan's per-epoch losses into a host array with it."""

    def __init__(self):
        self.arrays = []

    def __getattr__(self, name):
        return getattr(np, name)

    def asarray(self, *a, **kw):
        out = np.asarray(*a, **kw)
        self.arrays.append(out)
        return out


#: The JAX scan's f32 losses drift from a float64 run of the same loop by
#: 4.3e-5 relative at epoch 50 (the port's by 2.5e-7), so the port is held
#: to the float64 run at 1e-6 and to the JAX package at this bound.
JAX_LOSS_RTOL = 1e-4


def _float64_run(emb, labels, init):
    """The training loop in float64 (the same module, Adam and loss), the
    oracle for both packages' f32 runs: (losses, state_dict)."""
    model = th.TemporalHead(D).double()
    model.load_state_dict(convert.temporal_head_to_state_dict(init))
    opt = torch.optim.Adam(model.parameters(), lr=1e-5, betas=tt._BETAS,
                           eps=1e-8)
    x = torch.from_numpy(emb).double()[None].transpose(1, 2)
    y = torch.from_numpy(labels)[None]
    out = []
    for _ in range(50):
        h = x
        for conv in model.convs()[:-1]:
            h = torch.relu(conv(h))
        loss = th.masked_cross_entropy(model.conv_out(h).transpose(1, 2), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        out.append(loss.item())
    return np.asarray(out), model.state_dict()


def test_training_matches_jax_for_50_epochs(monkeypatch):
    """train_temporal_head from the JAX package's init at the reference's
    lr 1e-5, 50 epochs: every epoch's loss within 1e-6 relative of the
    same loop in float64 and within JAX_LOSS_RTOL of the JAX scan's; the
    trained weights within 2e-5 of the float64 run's (Adam turns the
    rounding noise of a near-zero gradient into a step of up to lr) and
    within lr a step of the JAX package's; predict_probs of equal weights
    within 1e-5."""
    emb, labels = _game()
    init = _jax_init(4)
    rec = _RecordingNumpy()
    monkeypatch.setattr(jax_tt, "np", rec)
    jmodel, jparams, jloss = jax_tt.train_temporal_head(
        emb, labels, epochs=50, init_params=init)
    want_losses = rec.arrays[-1]
    model, losses = tt.train_temporal_head(emb, labels, epochs=50,
                                           init_params=init, device="cpu")
    assert losses.shape == want_losses.shape == (50,)
    assert losses[-1] < losses[0]
    moved = model.conv_0.weight.detach().numpy().transpose(2, 1, 0) - \
        init["params"]["conv_0"]["kernel"]
    assert np.abs(moved).max() > 1e-4
    f64_losses, f64_weights = _float64_run(emb, labels, init)
    np.testing.assert_allclose(losses, f64_losses, rtol=1e-6, atol=0)
    np.testing.assert_allclose(losses, want_losses, rtol=JAX_LOSS_RTOL,
                               atol=0)
    assert float(losses[-1]) == pytest.approx(jloss, rel=JAX_LOSS_RTOL)
    want_sd = convert.temporal_head_to_state_dict(_np_tree(jparams))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), f64_weights[name].numpy(),
                                   rtol=0, atol=2e-5, err_msg=name)
        assert np.abs(p.numpy() - want_sd[name].numpy()).max() <= \
            1e-5 * 50, name
    np.testing.assert_allclose(
        tt.predict_probs(_port_head(jparams), emb),
        jax_tt.predict_probs(jmodel, jparams, emb), **TOL)
    assert not model.training


def test_temporal_head_npz_crosses_both_ways(tmp_path):
    """A temporal_head.npz written by segment_with_temporal_head in either
    package loads in the other (the flax tree's keys), with equal
    probabilities and decoded paths."""
    emb, labels = _game(5, t=60)
    names = [f"vid1_frame_{i + 1}.jpg" for i in range(len(emb))]
    mi = labels_mod.ManualIntervals()
    mi.intervals["left"].append((1, 1, 20))
    mi.intervals["none"].append((1, 21, 40))
    mi.intervals["right"].append((1, 41, 60))
    jmi = jax_labels.ManualIntervals()
    jmi.intervals = mi.intervals
    p_path, j_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    dec_p, _, probs_p = pipeline.segment_with_temporal_head(
        names, emb, mi, device="cpu", params_path=p_path, epochs=5)
    dec_j, _, probs_j = jax_pipeline.segment_with_temporal_head(
        names, emb, jmi, params_path=j_path, epochs=5)
    with np.load(p_path) as a, np.load(j_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)
    # each package reads the other's file (epochs=1: no training runs)
    dec_pj, _, probs_pj = pipeline.segment_with_temporal_head(
        names, emb, mi, device="cpu", params_path=j_path, epochs=1)
    dec_jp, _, probs_jp = jax_pipeline.segment_with_temporal_head(
        names, emb, jmi, params_path=p_path, epochs=1)
    np.testing.assert_allclose(probs_pj, probs_j, **TOL)
    np.testing.assert_allclose(probs_jp, probs_p, **TOL)
    assert dec_pj == dec_j and dec_jp == dec_p
    template = convert.temporal_head_to_params(th.TemporalHead(D)
                                               .state_dict())
    ckpt.load_params_npz(template, j_path)
    jax_ckpt.load_params_npz(_jax_init(0), p_path)


def test_segment_with_temporal_head_on_a_planted_game(tmp_path):
    """Three possessions of separable embeddings: both packages decode
    the planted sides frame for frame and cut the same clips."""
    rng = np.random.default_rng(7)
    centers = np.eye(3, D) * 3.0
    segs = [("left", 40), ("none", 16), ("right", 40)]
    side_ids = {"left": 0, "right": 1, "none": 2}
    emb = np.concatenate([centers[side_ids[s]] + 0.2 * rng.normal(size=(n, D))
                          for s, n in segs]).astype(np.float32)
    truth = [s for s, n in segs for _ in range(n)]
    names = [f"vid1_frame_{i + 1}.jpg" for i in range(len(truth))]
    src = tmp_path / "frames"
    src.mkdir()
    for n in names:
        (src / n).write_bytes(b"")
    mi = labels_mod.ManualIntervals()
    for side, a, b in (("left", 1, 40), ("none", 41, 56),
                       ("right", 57, 96)):
        mi.intervals[side].append((1, a, b))
    jmi = jax_labels.ManualIntervals()
    jmi.intervals = mi.intervals
    kw = dict(epochs=60, lr=3e-3, min_len=30, pad=2, vid=1)
    dec, dirs, probs = pipeline.segment_with_temporal_head(
        names, emb, mi, device="cpu", src_dir=str(src),
        out_root=str(tmp_path / "p"), **kw)
    jdec, jdirs, _ = jax_pipeline.segment_with_temporal_head(
        names, emb, jmi, src_dir=str(src), out_root=str(tmp_path / "j"),
        **kw)
    assert dec == jdec == truth
    assert probs.shape == (96, 3)
    assert [os.path.basename(d) for d in dirs] == \
        [os.path.basename(d) for d in jdirs] == \
        ["vid1_clip_1_left", "vid1_clip_2_right"]
    for d, jd in zip(dirs, jdirs):
        assert sorted(os.listdir(d)) == sorted(os.listdir(jd))


SEGMENTS = [("none", 4), ("left", 30), ("none", 4), ("right", 30),
            ("none", 4)]


@pytest.fixture(scope="module")
def temporal_world(tmp_path_factory):
    """The verify skill's synthetic game (JPEG frames and manual
    intervals) and the port's VRT_TINY engine on the CPU."""
    root = tmp_path_factory.mktemp("temporal")
    mp = pytest.MonkeyPatch()
    mp.setenv("VRT_TINY", "1")
    for key in ("VRT_TOME_R", "VRT_GEMM_QUANT", "VRT_GRAYSCALE"):
        mp.delenv(key, raising=False)
    mp.chdir(root)
    synthetic.write_video_frames("frames", 1, SEGMENTS, size=(32, 32))
    mi = jax_labels.ManualIntervals()
    for side, a, b in [("none", 1, 4), ("left", 5, 34), ("none", 35, 38),
                       ("right", 39, 68), ("none", 69, 72)]:
        mi.intervals[side].append((1, a, b))
    mi.to_csv("manual_intervals.csv")
    yield root, port_common._engine(16, "cpu"), mp
    mp.undo()


def test_segment_method_temporal_cli_matches_the_jax_verb(temporal_world):
    """``segment`` without --method runs the temporal path (the JAX
    default): the port's verb trains and writes temporal_head.npz; the
    JAX verb, embedding with the port's engine and given that file,
    loads it and cuts the same clips; a second port run reuses it."""
    root, engine, mp = temporal_world
    base = ["frames", "--manual-csv", "manual_intervals.csv", "--vid", "1",
            "--epochs", "10", "--batch-size", "16", "--min-len", "20",
            "--pad", "2"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(["segment", *base, "--out", "clips_p", "--device", "cpu"])
    out = buf.getvalue()
    assert "decoded 72 frames -> " in out
    npz = os.path.join("clips_p", "temporal_head.npz")
    os.makedirs("clips_j")
    shutil.copy(npz, "clips_j")
    mp.setattr(jax_common, "_engine", lambda batch_size: engine)
    args = jax_segment_cmds.register  # the JAX parser's defaults
    parser = argparse.ArgumentParser()
    args(parser.add_subparsers())
    ns = parser.parse_args(["segment", *base, "--out", "clips_j"])
    jbuf = io.StringIO()
    with redirect_stdout(jbuf):
        jax_segment_cmds.cmd_segment(ns)
    assert jbuf.getvalue() == out.replace("clips_p", "clips_j")

    def listing(r):
        return {d: sorted(os.listdir(os.path.join(r, d)))
                for d in sorted(os.listdir(r)) if d.startswith("vid")}

    assert listing("clips_p") == listing("clips_j")
    before = os.path.getmtime(npz)
    with redirect_stdout(io.StringIO()):
        cli.main(["segment", *base, "--out", "clips_p", "--epochs", "1",
                  "--device", "cpu"])
    assert os.path.getmtime(npz) == before  # loaded, not retrained


def test_segment_temporal_needs_manual_csv(temporal_world):
    with pytest.raises(SystemExit, match="--method temporal needs "
                                         "--manual-csv"):
        cli.main(["segment", "frames", "--out", "o", "--vid", "1",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="--socket supports --method "
                                         "knn-hmm only"):
        cli.main(["segment", "frames", "--out", "o", "--vid", "1",
                  "--follow", "--socket", "s", "--manual-csv", "m.csv"])
    assert not os.path.exists("o")
