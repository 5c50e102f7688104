"""Stage-1 training of the port against the JAX package: configs and run
ids, the metrics ledger, losses, diagnostics, the optimizer (against the
optax chains), the loop helpers, run checkpoints, the ChunkEncoder
trajectory, resume, and the train-stage1 / write-ratt-db verbs.

Inputs are drawn with numpy from fixed seeds and fed to both packages;
the encoder starts from the flax seeded init, converted
(models/convert.py). Tolerances: both sides compute in f32 on the CPU and
differ in summation order, ~1e-7 relative per operation: single
functions are held to 1e-6 (rel) / 1e-6 (abs), optimizer steps over 10
to 40 updates to 1e-6, the 2-epoch training trajectory (losses, and
parameters that Adam moves by ~lr a step) to 1e-5 rel / 1e-6 abs, with
confusion counts exact; where Adam scales rounding noise in a
near-zero gradient up to a step (see the trajectory test), a parameter
element is held to lr a step.
"""

import dataclasses
import json
import os
import uuid

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vit_research_tpu.db import builders as jax_builders
from vit_research_tpu.db import frame_store as jax_fs
from vit_research_tpu.models import heads as jax_heads
from vit_research_tpu.store.vector_store import Collection as JaxCollection
from vit_research_tpu.train import checkpoint as jax_ckpt
from vit_research_tpu.train import common as jax_common
from vit_research_tpu.train import diagnostics as jax_diag
from vit_research_tpu.train import losses as jax_losses
from vit_research_tpu.train import optim as jax_optim
from vit_research_tpu.train import train_chunk_encoder as jax_tce
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu.utils import metrics as jax_metrics
from vit_research_tpu_torch import cli
from vit_research_tpu_torch.db.frame_store import FrameStore, load_chunk_index
from vit_research_tpu_torch.models import convert, heads
from vit_research_tpu_torch.store.vector_store import PersistentClient
from vit_research_tpu_torch.train import checkpoint as ckpt
from vit_research_tpu_torch.train import common
from vit_research_tpu_torch.train import diagnostics as diag
from vit_research_tpu_torch.train import losses
from vit_research_tpu_torch.train import optim
from vit_research_tpu_torch.train import train_chunk_encoder as tce
from vit_research_tpu_torch.utils import configs
from vit_research_tpu_torch.utils import metrics

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-6, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
D, T = 192, 6
# head width 96, as the real encoder's (768 / 8 heads)
CE = configs.ChunkEncoderConfig(embed_dim=D, num_layers=1, num_heads=2,
                                mlp_dim=2 * D, max_len=T, dropout_rate=0.0)
PRESETS = ("rag", "cls_only", "ratt", "chunks", "chunks_cached", "stage2",
           "fast", "stage3")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- configs


def test_config_json_round_trips_across_packages(tmp_path):
    cfg = configs.ExperimentConfig(
        name="custom",
        vit=configs.ViTConfig(image_size=(432, 768), patch_size=32),
        train=configs.TrainConfig(batch_size=16, chunk_size=8),
        retrieval=configs.RetrievalConfig(collection="xyz", top_k=7),
        train_vids=(1, 2, 3), test_vids=(9,))
    path = str(tmp_path / "cfg.json")
    configs.save_config(cfg, path)
    assert configs.load_config(path) == cfg
    from_jax = jax_configs.load_config(path)
    assert from_jax.to_json() == cfg.to_json()
    jax_configs.save_config(from_jax, path)
    assert configs.load_config(path) == cfg
    for name in PRESETS:
        assert configs.preset(name).to_json() == \
            jax_configs.preset(name).to_json()
    ce = configs.ChunkEncoderConfig()
    assert (ce.embed_dim, ce.num_layers, ce.num_heads, ce.mlp_dim,
            ce.max_len) == (768, 3, 8, 3072, 24)


@pytest.mark.parametrize("name", PRESETS)
def test_run_id_equals_jax_for_every_preset(name, monkeypatch):
    fixed = uuid.UUID("0123456789abcdef0123456789abcdef")
    monkeypatch.setattr(uuid, "uuid4", lambda: fixed)
    now = 1_790_000_000.25
    got = configs.make_run_id(configs.preset(name), now=now)
    assert got == jax_configs.make_run_id(jax_configs.preset(name), now=now)
    assert got.startswith(f"{name}_20260921-141320_012345_")


# ---------------------------------------------------------------- metrics


def test_metrics_logger_repairs_torn_tail_like_jax(tmp_path):
    rows = {}
    for pkg, mod in (("port", metrics), ("jax", jax_metrics)):
        path = str(tmp_path / pkg / "metrics.jsonl")
        mod.MetricsLogger(path).log(0, {"loss": 1.5}, note="a")
        with open(path, "a") as f:
            f.write('{"step": 1, "loss"')  # a crash mid-append
        mod.MetricsLogger(path).log(2, {"loss": np.float32(0.25),
                                        "conf": {"tp": 3}, "obj": object})
        mod.MetricsLogger(path).log(0, loss=0.75)  # a re-run epoch
        rows[pkg] = [mod2.read_metrics(path, latest_per_step=latest)
                     for mod2 in (metrics, jax_metrics)
                     for latest in (True, False)]
    strip = [[{k: v for k, v in r.items() if k != "ts"} for r in rs]
             for rs in rows["port"]]
    assert strip == [[{k: v for k, v in r.items() if k != "ts"}
                      for r in rs] for rs in rows["jax"]]
    assert [r["step"] for r in strip[0]] == [0, 2] and strip[0][0]["loss"] \
        == 0.75


# ----------------------------------------------------------------- losses


def _loss_inputs(rng):
    b, k, d = 6, 4, 8
    z = rng.standard_normal((b, d)).astype(np.float32)
    unit = z / np.linalg.norm(z, axis=-1, keepdims=True)
    ret = rng.standard_normal((b, k, d)).astype(np.float32)
    imp = rng.dirichlet(np.ones(k), size=b).astype(np.float32)
    labels = np.asarray([0, 1, 1, 0, 1, 1], np.float32)
    logits = rng.standard_normal((b, 1)).astype(np.float32) * 3
    hard = np.asarray([[0, 1, -1, 0], [1, 1, 1, -1], [0, 0, 1, 1],
                       [0, -1, -1, -1], [1, 0, 1, 0], [0, 1, 0, 1]],
                      np.int32)
    return dict(z=z, unit=unit, ret=ret, imp=imp, labels=labels,
                logits=logits, hard=hard)


LOSS_CASES = {
    "bce": lambda m, x: m.bce_with_logits(x["labels"], x["logits"]),
    "bce_smoothed_weighted": lambda m, x: m.bce_with_logits(
        x["labels"], x["logits"], pos_weight=m.sqrt_pos_weight(x["labels"]),
        label_smoothing=0.1),
    "sqrt_pos_weight": lambda m, x: m.sqrt_pos_weight(x["labels"]),
    "accuracy": lambda m, x: m.compute_accuracy(x["labels"], x["logits"]),
    "simple_contrastive": lambda m, x: m.simple_retrieval_contrastive(
        x["unit"], x["ret"]),
    "max_contrastive": lambda m, x: m.max_retrieval_contrastive(
        x["unit"], x["ret"]),
    "attention_contrastive": lambda m, x: m.attention_weighted_contrastive(
        x["unit"], x["ret"], x["imp"]),
    "attention_entropy": lambda m, x: m.attention_entropy(x["imp"]),
    "infonce": lambda m, x: m.in_batch_infonce(x["z"]),
    "supcon": lambda m, x: m.supervised_contrastive(x["unit"], x["labels"]),
    "margin": lambda m, x: m.retrieval_margin(x["z"], x["ret"], x["hard"]),
    "l2_normalize": lambda m, x: m.l2_normalize(x["z"]),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_losses_match_jax(case):
    x = _loss_inputs(np.random.default_rng(0))
    want = LOSS_CASES[case](jax_losses, {k: jnp.asarray(v)
                                         for k, v in x.items()})
    got = LOSS_CASES[case](losses, {k: _t(v) for k, v in x.items()})
    if isinstance(want, tuple):  # retrieval_margin: (loss, diagnostics)
        np.testing.assert_allclose(got[0].numpy(), _np(want[0]), **TOL)
        assert sorted(got[1]) == sorted(want[1])
        for k in want[1]:
            np.testing.assert_allclose(got[1][k].numpy(), _np(want[1][k]),
                                       **TOL)
    else:
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_find_best_f1_matches_jax():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, 40)
    probs = rng.uniform(size=40)
    assert losses.find_best_f1(labels, probs) == \
        jax_losses.find_best_f1(labels, probs)


# ------------------------------------------------------------ diagnostics


def test_diagnostics_match_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((6, 8)).astype(np.float32)
    b = rng.standard_normal((6, 8)).astype(np.float32)
    ret = rng.standard_normal((6, 4, 8)).astype(np.float32)
    ret[1, 2] = 0.0  # a padded row
    rlab = np.asarray([[0, 1, -1, 1], [1, 1, 1, -1], [0, 0, 0, 0],
                       [-1, -1, -1, -1], [1, 0, 1, 0], [0, 1, 0, 1]])
    labels = np.asarray([0, 1, 1, 0, 1, 0])
    imp = rng.dirichlet(np.ones(4), size=6).astype(np.float32)
    logits = rng.standard_normal(6).astype(np.float32)

    def close(got, want):
        np.testing.assert_allclose(_np(got), _np(want), **TOL)

    for key in ("mean", "std"):
        close(diag.cosine_stats(_t(a), _t(b))[key],
              jax_diag.cosine_stats(a, b)[key])
    close(diag.retrieval_purity(_t(a), _t(ret)),
          jax_diag.retrieval_purity(a, ret))
    close(diag.label_agreement(_t(rlab), _t(labels)),
          jax_diag.label_agreement(rlab, labels))
    got = diag.attention_mass_by_label(_t(imp), _t(rlab), _t(labels))
    want = jax_diag.attention_mass_by_label(imp, rlab, labels)
    for key in want:
        close(got[key], want[key])
    got = diag.confusion_counts(_t(labels), _t(logits))
    want = jax_diag.confusion_counts(labels, logits)
    assert {k: int(v) for k, v in got.items()} == \
        {k: int(v) for k, v in want.items()}
    sides = np.asarray(["left", "right", "left", "left", "right", "left"])
    t_c = np.asarray([0.1, 0.12, 0.2, 0.15, 0.2, 0.9])
    vids = np.asarray([1, 2, 2, 3, 1, 2])
    got = diag.conditioned_separation(a, labels, sides, t_c, vids)
    want = jax_diag.conditioned_separation(a, labels, sides, t_c, vids)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    grads = {"support": {"w": a, "b": b[0]}, "query": {"w": ret},
             "other": {"w": b}}
    got = diag.gradient_rms_by_branch(
        {f"{br}/{k}": _t(v) for br, sub in grads.items()
         for k, v in sub.items()})
    want = jax_diag.gradient_rms_by_branch(grads)
    assert got.keys() == want.keys()
    for key in want:
        close(got[key], want[key])


# -------------------------------------------------------------- optimizer


def _tree(params):
    return {f"p{i}": jnp.asarray(p) for i, p in enumerate(params)}


def _seeded_grads(rng, shapes, scale):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


SHAPES = [(4, 3), (3,), (5,), (2, 2, 2)]


@pytest.mark.parametrize("weight_decay", [0.0, 5e-4])
def test_stage1_optimizer_matches_optax_chain(weight_decay):
    """Per-tensor clip (norm 1) + AdamW (eps 1e-7) over 10 steps of seeded
    gradients, half of them large enough to clip: the port's parameters
    after every step against the optax chain's."""
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    lr = 1e-2
    tx = jax_tce.stage1_optimizer(lr, 1.0, weight_decay)
    update = jax.jit(tx.update)
    jp = _tree(init)
    state = tx.init(jp)
    params = [_t(p) for p in init]
    opt = tce.stage1_optimizer(params, lr, 1.0, weight_decay)
    for step in range(10):
        g = _seeded_grads(rng, SHAPES, 3.0 if step % 2 else 0.1)
        upd, state = update(_tree(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        assert opt.step([_t(x) for x in g])
        for i, p in enumerate(params):
            np.testing.assert_allclose(p.numpy(), _np(jp[f"p{i}"]), **TOL)
    assert opt.count == 10


@pytest.mark.parametrize("accum,weight_decay,clip", [
    (4, 0.0, 1.0), (4, 1e-3, 0.5), (1, 0.0, 1.0), (3, 0.0, 0.0)])
def test_make_optimizer_matches_optax_multisteps(accum, weight_decay, clip):
    """make_optimizer's accumulation, global-norm clip, AdamW and
    two-phase LR against the JAX make_optimizer (optax.MultiSteps) over
    2 epochs of 12 micro-batches."""
    cfg = configs.TrainConfig(accum_steps=accum, num_epochs=2,
                              lr_phase1=1e-2, lr_phase2=1e-4,
                              weight_decay=weight_decay,
                              grad_clip_norm=clip)
    jcfg = jax_configs.TrainConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(4)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    tx = jax_optim.make_optimizer(jcfg, 12)
    update = jax.jit(tx.update)
    jp = _tree(init)
    state = tx.init(jp)
    params = [_t(p) for p in init]
    opt = optim.make_optimizer(cfg, 12, params)
    updated = 0
    for micro in range(24):
        g = _seeded_grads(rng, SHAPES, 2.0)
        upd, state = update(_tree(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        updated += opt.step([_t(x) for x in g])
        for i, p in enumerate(params):
            np.testing.assert_allclose(p.numpy(), _np(jp[f"p{i}"]), **TOL)
    assert updated == opt.count == 24 // accum


def test_phase2_lr_engages_under_accumulation():
    """The phase boundary is in accumulated-update units: with 4-step
    accumulation, 40 micro-steps give 10 updates, 5 at each LR."""
    cfg = configs.TrainConfig(accum_steps=4, num_epochs=2, lr_phase1=1e-3,
                              lr_phase2=1e-5, phase_split=0.5)
    w = torch.ones(3)
    opt = optim.make_optimizer(cfg, 20, [w])
    deltas = []
    for _ in range(40):
        before = w.clone()
        if opt.step([torch.ones(3)]):
            deltas.append(float((w - before).abs().max()))
        else:
            assert torch.equal(w, before)
    assert len(deltas) == 10
    assert all(d > 3e-4 for d in deltas[:5]), deltas
    assert all(d < 3e-5 for d in deltas[5:]), deltas


def test_schedules_and_clips_match_jax():
    sched = jax_optim.two_phase_schedule(1e-3, 1e-5, 10, split=0.3)
    port = optim.two_phase_schedule(1e-3, 1e-5, 10, split=0.3)
    assert [np.float32(port(c)) for c in range(10)] == \
        [np.float32(sched(c)) for c in range(10)]
    for epochs, split in ((24, 0.5), (3, 0.5), (1, 0.2), (10, 0.25)):
        cfg = configs.TrainConfig(num_epochs=epochs, phase_split=split)
        jcfg = jax_configs.TrainConfig(num_epochs=epochs, phase_split=split)
        assert optim.phase1_epoch_count(cfg) == \
            jax_optim.phase1_epoch_count(jcfg)
    g = _seeded_grads(np.random.default_rng(5), SHAPES, 2.0)
    want, _ = jax_optim.clip_each_by_norm(1.0).update(_tree(g), None)
    for i, got in enumerate(optim.clip_each_by_norm([_t(x) for x in g], 1.0)):
        np.testing.assert_allclose(got.numpy(), _np(want[f"p{i}"]), **TOL)
    want, _ = optax.clip_by_global_norm(1.0).update(_tree(g), None)
    for i, got in enumerate(optim.clip_by_global_norm([_t(x) for x in g],
                                                      1.0)):
        np.testing.assert_allclose(got.numpy(), _np(want[f"p{i}"]), **TOL)
    small = [x * 1e-3 for x in g]
    assert all(torch.equal(a, _t(b)) for a, b in zip(
        optim.clip_by_global_norm([_t(x) for x in small], 1.0), small))


def test_optimizer_state_round_trips_through_a_checkpoint(tmp_path):
    w = torch.ones(3)
    opt = optim.make_optimizer(configs.TrainConfig(accum_steps=2), 4, [w])
    for i in range(3):
        opt.step([torch.full((3,), float(i + 1))])
    mngr = ckpt.CheckpointManager(str(tmp_path), "run")
    mngr.save(0, {"params": {"w": w}, "opt_state": opt.state_dict(),
                  "step": 3})
    back = mngr.restore(0)
    w2 = back["params"]["w"].clone()
    opt2 = optim.make_optimizer(configs.TrainConfig(accum_steps=2), 4, [w2])
    opt2.load_state_dict(back["opt_state"])
    for o, p in ((opt, w), (opt2, w2)):
        o.step([torch.full((3,), 7.0)])
    assert torch.equal(w, w2) and opt2.count == opt.count == 2
    with pytest.raises(ValueError, match="does not match"):
        optim.make_optimizer(configs.TrainConfig(), 4,
                             [torch.ones(4)]).load_state_dict(
            back["opt_state"])


# ----------------------------------------------------------- loop helpers


def test_loop_helpers_match_jax():
    items = list(range(23))
    for seed in (0, 7):
        for kw in (dict(), dict(shuffle=False, drop_remainder=False),
                   dict(drop_remainder=False)):
            assert list(common.batch_iterator(items, 5, seed=seed, **kw)) \
                == list(jax_common.batch_iterator(items, 5, seed=seed, **kw))
        assert common.split_train_val(items, 0.3, seed) == \
            jax_common.split_train_val(items, 0.3, seed)
    with pytest.warns(RuntimeWarning, match="NO batches"):
        assert list(common.batch_iterator([1, 2], 5)) == []
    for n, b, drop in ((23, 5, True), (23, 5, False), (20, 5, False)):
        assert common.num_batches(n, b, drop) == \
            jax_common.num_batches(n, b, drop)
    m, jm = common.MetricAverager(), jax_common.MetricAverager()
    for i in range(4):
        m.update(loss=torch.tensor(i * 0.5), acc=i)
        jm.update(loss=jnp.asarray(i * 0.5), acc=i)
    assert m.result() == jm.result()
    chunks = [dict(vid=1, clip=2, side="left", t_center=0.5, t_width=0.1,
                   label=1, status_id=1, start_idx=4),
              dict(vid=3, clip=1, side="none", t_center=0.25, t_width=0.2,
                   label=0, status_id=0, start_idx=0)]
    got = common.chunk_metadata_batch(chunks)
    want = jax_common.chunk_metadata_batch(chunks)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert common.tree_finite({"a": torch.ones(2), "b": [np.zeros(3)]})
    assert not common.tree_finite(heads.ChunkEncoder(CE).cls_token.detach()
                                  * float("nan"))


# ------------------------------------------------------------ checkpoints


def test_checkpoint_manager_round_trip_retention_and_best(tmp_path):
    """Round trip; the best step survives retention; best.json and
    metrics.jsonl carry across a restart; the files of best/metrics are
    the JAX manager's format."""
    mngr = ckpt.CheckpointManager(str(tmp_path), "run", max_to_keep=2)
    state = lambda i: {"params": {"w": torch.full((2, 3), float(i))},  # noqa
                       "opt_state": {"count": i}, "step": i}
    accs = [0.5, 0.9, 0.6, 0.7, 0.4]
    for step, acc in enumerate(accs):
        mngr.save(step, state(step), metrics={"val_acc": acc})
        mngr.maybe_update_best(step, acc)
    mngr.wait()
    assert mngr.all_steps() == [1, 3, 4]  # newest 2 + the best
    assert mngr.best == (1, 0.9) and mngr.latest_step() == 4
    assert torch.equal(mngr.restore()["params"]["w"], state(4)["params"]["w"])
    assert mngr.restore_best()["step"] == 1
    assert not os.path.exists(os.path.join(mngr.dir, "metrics_2.json"))
    with open(os.path.join(mngr.dir, "best.json")) as f:
        assert json.load(f) == {"step": 1, "metric": 0.9}
    with open(os.path.join(mngr.dir, "metrics_3.json")) as f:
        assert json.load(f) == {"val_acc": 0.7}
    again = ckpt.CheckpointManager(str(tmp_path), "run", max_to_keep=2)
    assert again.best == (1, 0.9)
    assert not again.maybe_update_best(5, 0.8)
    rows = jax_metrics.read_metrics(os.path.join(mngr.dir, "metrics.jsonl"))
    assert [r["val_acc"] for r in rows] == accs
    with pytest.raises(ValueError, match="lacks"):
        mngr.restore(4, template={"params": None, "extra": None})
    keep = ckpt.CheckpointManager(str(tmp_path), "kp", max_to_keep=1,
                                  keep_period=2)
    for step in range(5):
        keep.save(step, state(step))
    assert keep.all_steps() == [0, 2, 4]


def test_checkpoint_manager_refuses_an_orbax_run(tmp_path):
    """A run directory written by the JAX package's Orbax manager is
    refused with a ValueError that names the format, never read as an
    empty run; the loader surfaces it as ScoringUnavailable."""
    from vit_research_tpu_torch.evaluate import scoring

    jm = jax_ckpt.CheckpointManager(str(tmp_path), "jaxrun")
    jm.save(0, {"params": {"w": jnp.ones(3)}, "step": 1},
            metrics={"val_acc": 0.5})
    jm.maybe_update_best(0, 0.5)
    jm.wait()
    with pytest.raises(ValueError, match="Orbax"):
        ckpt.CheckpointManager(str(tmp_path), "jaxrun")
    with pytest.raises(scoring.ScoringUnavailable, match="Orbax"):
        scoring.stage1_encode_batch(8, 4, str(tmp_path), "jaxrun",
                                    device="cpu")


# ------------------------------------------------------------- trajectory


def _world(root, n_vids=2, clips=2, per_clip=4, seed=0):
    """A frame store of seeded embeddings whose labels leave a learnable
    trace (label 1 frames are shifted along one direction), and its chunk
    index; built by the JAX package, read by both (one format)."""
    rng = np.random.default_rng(seed)
    direction = rng.standard_normal(D).astype(np.float32)
    chunks, embs = [], {}
    for vid in range(1, n_vids + 1):
        for clip in range(1, clips + 1):
            side = "left" if clip % 2 else "right"
            for c in range(per_clip):
                start = c * 2
                label = int(rng.integers(0, 2))
                frames = [f"/v{vid}/c{clip}/f{start + i}.jpg"
                          for i in range(T)]
                for p in frames:
                    if p not in embs:
                        embs[p] = rng.standard_normal(D).astype(np.float32)
                    if label:
                        embs[p] = embs[p] + 0.5 * direction
                chunks.append(dict(
                    vid=vid, clip=clip, start_idx=start,
                    end_idx=start + T - 1, side=side, label=label,
                    status_id=label, t_center=(start + 3) / 20.0,
                    t_width=0.2, frames=frames))
    paths = sorted(embs)
    store = jax_fs.FrameStore.build(
        paths, lambda ps: np.stack([embs[p] for p in ps]), root)
    jax_fs.build_chunk_index(chunks, store, root)
    return FrameStore(root).open(), load_chunk_index(root), len(chunks)


class _NoDropClassifier(jax_heads.ClassifierMLP):
    dropout_rate: float = 0.0


def test_trajectory_matches_jax_at_dropout_0(tmp_path, monkeypatch):
    """The JAX train_chunk_encoder and the port's, dropout 0 (config and
    class head), from one set of flax initial weights, 2 epochs: every
    epoch's metrics and the final parameters agree."""
    store, idx, n = _world(str(tmp_path / "store"))
    train_ids, val_ids = list(range(n - 5)), list(range(n - 5, n))
    kw = dict(num_epochs=2, batch_size=4, lr=1e-3, seed=3)
    jcfg = jax_configs.ChunkEncoderConfig(**dataclasses.asdict(CE))
    monkeypatch.setattr(jax_heads, "ClassifierMLP", _NoDropClassifier)
    jm = jax_ckpt.CheckpointManager(str(tmp_path / "ckpt"), "jax")
    _, _, want = jax_tce.train_chunk_encoder(
        jax_fs.FrameStore(str(tmp_path / "store")).open(), idx, train_ids,
        val_ids, config=jcfg, ckpt_manager=jm, **kw)
    jm.wait()
    want_final = jm.restore(1)["params"]
    init = jax_heads.ChunkEncoder(jcfg).init(
        jax.random.PRNGKey(kw["seed"]), jnp.zeros((1, T, D)))
    model = heads.ChunkEncoder(CE)
    model.class_head.dropout.p = 0.0
    model.load_state_dict(convert.chunk_encoder_to_state_dict(
        jax.tree_util.tree_map(np.asarray, init)))
    got_model, _, got = tce.train_chunk_encoder(
        store, idx, train_ids, val_ids, config=CE, device="cpu",
        model=model, **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in ("val_tp", "val_tn", "val_fp", "val_fn"):
            assert g[key] == w[key], key
        for key in ("train_loss", "train_acc", "val_loss", "val_acc",
                    "separation_gap"):
            np.testing.assert_allclose(g[key], w[key], **TRAJ_TOL,
                                       err_msg=key)
    want_sd = convert.chunk_encoder_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_final))
    steps = kw["num_epochs"] * (len(train_ids) // kw["batch_size"])
    for name, p in got_model.state_dict().items():
        # Adam divides each gradient by its running RMS, so where a
        # gradient is rounding noise (the key projection's bias, which adds
        # one constant to a query's scores that the softmax removes; a
        # rare element near zero) the two packages' noise becomes steps of
        # up to ~lr in either direction. Every element stays within that
        # (lr a step); all others, all but 1e-4 of a tensor, within
        # TRAJ_TOL.
        got_p, want_p = p.numpy(), want_sd[name].numpy()
        diff = np.abs(got_p - want_p)
        assert diff.max() <= kw["lr"] * steps, name
        if not name.endswith("attn.key.bias"):
            off = diff > TRAJ_TOL["atol"] + TRAJ_TOL["rtol"] * np.abs(want_p)
            assert off.mean() <= 1e-4, (name, int(off.sum()))


def test_resume_reproduces_the_uninterrupted_trajectory(tmp_path):
    """Dropout 0.1: 2 epochs, then --resume for 2 more, equals 4
    uninterrupted epochs (weights, optimizer and step restored; the
    dropout generators are seeded per epoch)."""
    store, idx, n = _world(str(tmp_path / "store"))
    cfg = dataclasses.replace(CE, dropout_rate=0.1)
    args = (store, idx, list(range(n - 4)), list(range(n - 4, n)))
    kw = dict(config=cfg, batch_size=4, seed=5, device="cpu", lr=1e-3)
    ref_model, ref_best, ref = tce.train_chunk_encoder(*args, num_epochs=4,
                                                       **kw)
    mngr = ckpt.CheckpointManager(str(tmp_path), "run")
    tce.train_chunk_encoder(*args, num_epochs=2, ckpt_manager=mngr, **kw)
    mngr2 = ckpt.CheckpointManager(str(tmp_path), "run")
    model, best, hist = tce.train_chunk_encoder(
        *args, num_epochs=4, ckpt_manager=mngr2, resume=True, **kw)
    assert len(hist) == 2 and mngr2.latest_step() == 3
    assert mngr2.restore()["step"] == 4 * ((n - 4) // 4)
    for h_ref, h in zip(ref[2:], hist):
        for key in ("train_loss", "val_loss", "val_acc"):
            np.testing.assert_allclose(h[key], h_ref[key], rtol=1e-6)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(),
                                   ref_model.state_dict()[name].numpy(),
                                   rtol=1e-6, atol=1e-7)
    # dropout is live: the same run without it takes other steps
    _, _, plain = tce.train_chunk_encoder(
        *args, num_epochs=1, **{**kw, "config": CE})
    assert plain[0]["train_loss"] != ref[0]["train_loss"]


# -------------------------------------------------------------------- CLI


def test_train_stage1_then_write_ratt_db_cli(tmp_path, capsys):
    """train-stage1 (with --resume) and write-ratt-db through the port's
    CLI on the CPU: the rows' ids, metadata and embeddings equal the JAX
    write_ratt_chunk_db fed the port's restored encoder; the rows carry
    the store's profile; a store chunked otherwise exits with the
    pos_embedding message."""
    root = str(tmp_path / "store")
    store, idx, n = _world(root, n_vids=2, clips=1, per_clip=6)
    ck, db = str(tmp_path / "ckpt"), str(tmp_path / "db")
    if not torch.cuda.is_available():
        # no silent CPU run: the card is asked for and missing
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["train-stage1", "--store", root, "--ckpt", ck,
                      "--run-id", "s1"])
        assert not os.path.exists(ck)
    cli.main(["train-stage1", "--store", root, "--ckpt", ck, "--epochs",
              "1", "--batch-size", "4", "--run-id", "s1", "--device",
              "cpu"])
    cli.main(["train-stage1", "--store", root, "--ckpt", ck, "--epochs",
              "2", "--batch-size", "4", "--run-id", "s1", "--resume",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert "epoch 0:" in out and "epoch 1:" in out and "run s1:" in out
    mngr = ckpt.CheckpointManager(ck, "s1")
    assert mngr.all_steps() == [0, 1]
    assert mngr.restore(1)["step"] == 2 * ((int(n * 0.8)) // 4)
    with open(os.path.join(mngr.dir, "experiment.json")) as f:
        assert json.load(f)["max_len"] == T
    cli.main(["write-ratt-db", "--store", root, "--ckpt", ck, "--db", db,
              "--run-id", "s1", "--device", "cpu"])
    assert f"wrote {n} chunk embeddings into ratt_db" in \
        capsys.readouterr().out
    col = PersistentClient(db, device="cpu").get_collection("ratt_db")
    ids = [f"chunk_{i}" for i in range(n)]
    got = col.get(ids=ids, include=("metadatas", "embeddings"))

    encode = tce.make_encode_fn(
        heads.ChunkEncoder(configs.ChunkEncoderConfig(
            embed_dim=D, mlp_dim=4 * D, max_len=T)),
        mngr.restore_best()["params"])
    want_col = JaxCollection("ratt_db", space="cosine")
    assert jax_builders.write_ratt_chunk_db(
        idx, jax_fs.FrameStore(root).open(), encode, want_col) == n
    want = want_col.get(ids=ids, include=("metadatas", "embeddings"))
    assert got["ids"] == want["ids"] == ids
    assert got["metadatas"] == want["metadatas"]
    np.testing.assert_allclose(np.asarray(got["embeddings"]),
                               np.asarray(want["embeddings"]), **TOL)
    assert col.embedding_profile == store.embedding_profile

    other = str(tmp_path / "store4")
    os.makedirs(other)
    for name in os.listdir(root):
        if name != "chunk_index.npz":
            os.symlink(os.path.join(root, name), os.path.join(other, name))
    short = dict(idx, frame_idx=idx["frame_idx"][:, :4])
    np.savez(os.path.join(other, "chunk_index.npz"), **short)
    with pytest.raises(SystemExit, match="pos_embedding"):
        cli.main(["write-ratt-db", "--store", other, "--ckpt", ck, "--db",
                  db, "--run-id", "s1", "--device", "cpu"])


def test_bf16_encoder_trains_f32_weights_and_encodes(tmp_path):
    """ChunkEncoderConfig(dtype='bfloat16'): stage 1 trains the f32
    weights through bf16 compute (the losses take their f32 casts) to the
    f32 run's metrics within bf16's reach, and make_encode_fn reads the
    bf16 logits back as f32."""
    store, idx, n = _world(str(tmp_path / "store"))
    train_ids, val_ids = list(range(n - 5)), list(range(n - 5, n))
    kw = dict(num_epochs=1, batch_size=4, lr=1e-3, seed=3, device="cpu")
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(CE, dtype=dtype)
        runs[dtype] = tce.train_chunk_encoder(store, idx, train_ids, val_ids,
                                              config=cfg, **kw)
    model, best, hist = runs["bfloat16"]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {v.dtype for v in best.values()} == {torch.float32}
    ref = runs["float32"][2]
    assert hist[0].keys() == ref[0].keys()
    for key in ("train_loss", "val_loss"):
        assert np.isfinite(hist[0][key])
        # 8 significant bits through one block: a loss within 2^-5
        np.testing.assert_allclose(hist[0][key], ref[0][key], rtol=2 ** -5,
                                   err_msg=key)
    emb, logit = tce.make_encode_fn(model)(
        store.gather(idx["frame_idx"][:3].reshape(-1)).reshape(3, T, D))
    assert emb.dtype == logit.dtype == np.float32
    assert emb.shape == (3, D) and logit.shape == (3, 1)
