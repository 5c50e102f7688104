"""Stage 2 of the port against the JAX package: RATTHeadV2 (its logits,
summaries, every layer's attention scores and the branch diagnostics),
the flax-to-port weight map, the stage-2 cache's branch selections on
both store routes with planted ties and unlabelled rows, a cache pickled
by the JAX package read by the port, and train_stage2 with live and
cached validation, --resume and the stage-3 continuation.

Inputs are drawn with numpy from fixed seeds; weights cross through
models/convert.py. Tolerances: the head's outputs and scores 1e-5 (f32
on the CPU in other summation orders); cache embeddings 1e-6 (rows copied
out of the stores, the query embeddings are the same arrays); branch
selections exactly equal. Trajectories, at dropout 0: per-epoch metrics
within 1e-5 relative / 1e-6 absolute, parameters every element within lr
a step and at most 1e-4 of the elements outside the attention key biases
beyond 1e-5 relative / 1e-6 absolute (tests/test_torch_rag_train.py's
bounds). A resumed run equals the uninterrupted one exactly.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.models import ratt_v2 as jax_ratt_v2
from vit_research_tpu.retrieval import cache_stage2 as jax_cs
from vit_research_tpu.store.vector_store import Collection as JaxCollection
from vit_research_tpu.train import train_stage2 as jax_train_stage2
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu_torch.models import convert, ratt_v2
from vit_research_tpu_torch.retrieval import cache_stage2 as cs
from vit_research_tpu_torch.store.vector_store import Collection
from vit_research_tpu_torch.train import checkpoint as ckpt
from vit_research_tpu_torch.train import train_stage2
from vit_research_tpu_torch.utils import configs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HEAD_TOL = dict(rtol=0, atol=1e-5)
EMB_TOL = dict(rtol=0, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
OFF_SHARE = 1e-4
D = 32
KS, KC, KT = 3, 3, 2
HEAD_KW = dict(embed_dim=D, num_layers=2, num_heads=2, mlp_dim=16,
               k_sim=KS, k_contrast=KC, k_temporal=KT,
               classifier_dropout=0.0)
# 2 micro-batches an update; 24 training chunks in batches of 4
TRAIN_KW = dict(batch_size=4, num_epochs=2, accum_steps=2, lr_phase1=1e-3,
                lr_phase2=3e-4, chunk_size=4, chunk_stride=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _head_inputs(seed, b=5, ks=KS, kc=KC, kt=KT):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, D), (b, ks, D), (b, kc, D), (b, kt, D))]


@pytest.mark.parametrize("ks,kc,kt", [(KS, KC, KT), (6, 6, 4)])
def test_ratt_v2_matches_jax(ks, kc, kt):
    """Eval mode, dropout 0: the logits, cls_out, the four aux summaries,
    every layer's attention scores and branch_attention_diagnostics."""
    kw = dict(HEAD_KW, k_sim=ks, k_contrast=kc, k_temporal=kt)
    inputs = _head_inputs(1, ks=ks, kc=kc, kt=kt)
    jhead = jax_ratt_v2.RATTHeadV2(jax_configs.HeadConfig(**kw))
    params = _jax_init(3, ks, kc, kt)
    jl, jc, ja = jax.jit(jhead.apply)(params, *inputs)
    head = ratt_v2.RATTHeadV2(configs.HeadConfig(**kw))
    head.load_state_dict(convert.ratt_v2_to_state_dict(_np_tree(params)))
    head.eval()
    with torch.no_grad():
        pl, pc, pa = head(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **HEAD_TOL)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **HEAD_TOL)
    assert sorted(pa) == sorted(ja)  # jit returns its dict sorted
    for key in ("support_summary", "contrast_summary", "temporal_summary",
                "local_out"):
        np.testing.assert_allclose(pa[key].numpy(), np.asarray(ja[key]),
                                   **HEAD_TOL, err_msg=key)
    t = 5 + ks + kc + kt
    assert len(pa["attn_scores"]) == len(ja["attn_scores"]) == 2
    for got, want in zip(pa["attn_scores"], ja["attn_scores"]):
        assert got.shape == (5, 2, t, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **HEAD_TOL)
    gd = ratt_v2.branch_attention_diagnostics(pa["attn_scores"], ks, kc, kt)
    jd = jax_ratt_v2.branch_attention_diagnostics(ja["attn_scores"], ks, kc,
                                                  kt)
    assert list(gd) == list(jd)
    for key in jd:
        np.testing.assert_allclose(float(gd[key]), float(jd[key]),
                                   **HEAD_TOL, err_msg=key)


def test_ratt_v2_weight_map_covers_every_parameter():
    """Every flax leaf maps to one port parameter of its shape, and every
    port parameter is mapped: the converted dict loads strictly."""
    params = _np_tree(_jax_init(0))
    sd = convert.ratt_v2_to_state_dict(params)
    head = ratt_v2.RATTHeadV2(configs.HeadConfig(**HEAD_KW))
    want = head.state_dict()
    assert sorted(sd) == sorted(want)
    for name, v in sd.items():
        assert v.shape == want[name].shape, name
    leaves = jax.tree_util.tree_leaves(params)
    assert len(leaves) == len(sd)
    assert sum(x.size for x in leaves) == sum(v.numel() for v in sd.values())
    head.load_state_dict(sd, strict=True)
    assert len(ratt_v2.TOKENS) == 12


def test_ratt_v2_refuses_bfloat16():
    """bf16 is no longer refused: it is a compute dtype over f32
    parameters (tests/test_torch_precision.py holds it against JAX)."""
    head = ratt_v2.RATTHeadV2(configs.HeadConfig(**HEAD_KW, dtype="bfloat16"))
    assert {p.dtype for p in head.parameters()} == {torch.float32}
    d = HEAD_KW["embed_dim"]
    logit, cls_out, aux = head.eval()(torch.zeros(2, d), torch.zeros(2, 3, d),
                                      torch.zeros(2, 3, d),
                                      torch.zeros(2, 2, d))
    assert logit.dtype == torch.bfloat16 and cls_out.dtype == torch.float32


# ------------------------------------------------------- the stage-2 cache

def _chunk(vid, clip, start, side, label, t_center):
    return {"vid": vid, "clip": clip, "start_idx": start,
            "end_idx": start + 3, "side": side, "label": label,
            "t_center": t_center, "t_width": 0.2, "status_id": label,
            "frames": [f"/v{vid}/c{clip}/f{start + i}.jpg"
                       for i in range(4)]}


def _world():
    """3 vids x 2 clips x 6 chunks; vids 1-2 train, 3 validates."""
    chunks = [_chunk(vid, clip, 2 * s, "left" if clip == 0 else "right",
                     int(s >= 3), (s + 0.5) / 6)
              for vid in (1, 2, 3) for clip in range(2) for s in range(6)]
    return chunks, [c for c in chunks if c["vid"] <= 2], \
        [c for c in chunks if c["vid"] == 3]


def _emb(ch):
    """A chunk's stage-1 embedding stand-in (L2-normalised): label and
    side directions plus seeded noise."""
    rng = np.random.default_rng(ch["vid"] * 101 + ch["clip"] * 13
                                + ch["start_idx"])
    v = 0.6 * rng.standard_normal(D)
    v[ch["label"]] += 2.0
    v[4 + (ch["side"] == "right")] += 1.0
    return (v / np.linalg.norm(v)).astype(np.float32)


def _rows(chunks, n_fill):
    """ratt_db rows of ``chunks`` plus planted ties and unlabelled rows,
    and ``n_fill`` rows of another side that rank but never select."""
    ids, embs, metas = [], [], []

    def add(i, e, m):
        ids.append(i)
        embs.append(e)
        metas.append(m)

    for i, c in enumerate(chunks):
        meta = {"vid_num": c["vid"], "clip_num": c["clip"],
                "side": c["side"], "label": c["label"],
                "t_center": c["t_center"], "t_width": c["t_width"],
                "start_idx": c["start_idx"], "end_idx": c["end_idx"],
                "class_logit": 0.0}
        add(f"chunk_{i}", _emb(c), meta)
        if i % 5 == 0:
            # a tie: the same row under another game (kept; the stable
            # order decides which comes first) ...
            add(f"dup_{i}", _emb(c), dict(meta, vid_num=c["vid"] + 10))
            # ... and under the same signature (dropped as a duplicate)
            add(f"sig_{i}", _emb(c), dict(meta, clip_num=c["clip"] + 5))
        if i % 4 == 1:
            # unlabelled (no label key): never a contrast row
            add(f"nolabel_{i}", _emb(c) * 0.99 + 0.01,
                {k: v for k, v in meta.items() if k != "label"})
    rng = np.random.default_rng(7)
    for j in range(n_fill):
        v = rng.standard_normal(D)
        add(f"fill_{j}", (v / np.linalg.norm(v)).astype(np.float32),
            {"vid_num": 50, "clip_num": j, "side": "none", "label": 0,
             "t_center": 0.5, "t_width": 0.1, "start_idx": j,
             "end_idx": j + 3})
    return ids, np.stack(embs), metas


def _collections(chunks, n_fill):
    ids, embs, metas = _rows(chunks, n_fill)
    col = Collection("ratt_db", space="cosine", device="cpu")
    jcol = JaxCollection("ratt_db", space="cosine")
    col.upsert(ids, embs, metas)
    jcol.upsert(ids, embs, metas)
    return col, jcol


BRANCH_KW = dict(k_sim=KS, k_contrast=KC, k_temporal=KT, future_step=2,
                 search_k_content=16, search_k_temporal=8)
# under 2^14 rows a single query ranks on the host, from 2^14 on the device
ROUTES = {"host": 0, "device": 1 << 14}


def _same_entries(got, want):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        for meta in ("query_meta", "sim_meta", "contrast_meta",
                     "temporal_meta"):
            assert g[meta] == w[meta], (key, meta)
        for arr in ("query_emb", "future_emb", "sim_embs", "contrast_embs",
                    "temporal_embs"):
            np.testing.assert_allclose(g[arr], w[arr], **EMB_TOL)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_cache_and_live_batches_match_jax(route, tmp_path):
    """build_stage2_cache (with its periodic checkpoints) and
    fetch_live_batch against the JAX package on the same rows: the same
    branch selections (planted ties, signature duplicates, unlabelled
    rows; queries with a retrieval_label and without), on both store
    routes."""
    chunks, _, val = _world()
    for i, ch in enumerate(chunks):
        if i % 3 == 0:
            ch["retrieval_label"] = 1 - ch["label"]
    col, jcol = _collections(chunks, ROUTES[route])
    path = str(tmp_path / "s2.pkl")
    got = cs.build_stage2_cache(chunks, _emb, col, checkpoint_path=path,
                                checkpoint_every=5, **BRANCH_KW)
    want = jax_cs.build_stage2_cache(chunks, _emb, jcol, **BRANCH_KW)
    _same_entries(got, want)
    assert not os.path.exists(path + ".partial")
    _same_entries(cs.load_cache(path), want)
    # the selections hold what they should: a planted twin of another
    # game among the sim rows, no unlabelled contrast row, PAD padding
    sims = [m for e in got.values() for m in e["sim_meta"]]
    assert any(m["vid"] >= 10 for m in sims)
    assert all(m["label"] >= 0 for e in got.values()
               for m in e["contrast_meta"] if m["side"] != "PAD")
    assert any(m["label"] == -1 for e in got.values()
               for m in e["temporal_meta"] if m["side"] != "PAD")

    pool = {cs.make_chunk_key(c): _emb(c) for c in val}
    for kw in ({}, {"exclude_self": False, "self_sim_cap": 0.9999}):
        g = cs.fetch_live_batch(val[:5], _emb, col, all_chunks=val,
                                pool_embs=pool, **BRANCH_KW, **kw)
        w = jax_cs.fetch_live_batch(val[:5], _emb, jcol, all_chunks=val,
                                    **BRANCH_KW, **kw)
        assert g.keys() == w.keys()
        for key in w:
            if w[key].dtype == np.int32:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                np.testing.assert_allclose(g[key], w[key], **EMB_TOL)


def test_cache_pickled_by_jax_loads_in_the_port(tmp_path):
    """A cache the JAX package pickled loads in the port and stacks into
    the JAX package's arrays; the port's partial checkpoints resume."""
    chunks, train, _ = _world()
    _, jcol = _collections(chunks, 0)
    path = str(tmp_path / "jax.pkl")
    jax_cs.build_stage2_cache(chunks, _emb, jcol, checkpoint_path=path,
                              **BRANCH_KW)
    cache = cs.load_cache(path)
    for batch in (train[:4], train[4:9]):
        got = cs.fetch_cache_batch(cache, batch)
        want = jax_cs.fetch_cache_batch(jax_cs.load_cache(path), batch)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    # a partial file is resumed, not rebuilt: its entries come back as
    # they were saved
    part = str(tmp_path / "port.pkl")
    marked = {k: dict(v, marker=1) for k, v in list(cache.items())[:7]}
    cs.save_cache(marked, part + ".partial")
    col, _ = _collections(chunks, 0)
    resumed = cs.build_stage2_cache(chunks, _emb, col, checkpoint_path=part,
                                    **BRANCH_KW)
    assert sum("marker" in e for e in resumed.values()) == 7
    assert not os.path.exists(part + ".partial")


# ----------------------------------------------------------- train_stage2

def _cfgs(**train):
    out = []
    for mod in (configs, jax_configs):
        out.append(mod.ExperimentConfig(
            name="stage2", head=mod.HeadConfig(**HEAD_KW),
            train=mod.TrainConfig(**dict(TRAIN_KW, **train)),
            retrieval=mod.RetrievalConfig(search_k_content=16,
                                          search_k_temporal=8)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_head_init(ks, kc, kt):
    """One jitted flax init a branch size: it compiles once, whatever the
    seed (the weights do not depend on the batch)."""
    return jax.jit(jax_ratt_v2.RATTHeadV2(jax_configs.HeadConfig(
        **dict(HEAD_KW, k_sim=ks, k_contrast=kc, k_temporal=kt))).init)


def _jax_init(seed, ks=KS, kc=KC, kt=KT):
    return _jax_head_init(ks, kc, kt)(
        jax.random.PRNGKey(seed), jnp.zeros((1, D)), jnp.zeros((1, ks, D)),
        jnp.zeros((1, kc, D)), jnp.zeros((1, kt, D)))


@pytest.mark.parametrize("live", [True, False])
def test_train_stage2_matches_jax(live):
    """2 epochs at dropout 0 from the JAX loop's initial weights: the same
    per-epoch metrics (losses, accuracies, the branches' gradient RMS, the
    best F1 and its threshold) and parameters, with live validation
    (against the collection) and with cached validation."""
    chunks, train, val = _world()
    col, jcol = _collections(chunks, 0)
    cfg, jcfg = _cfgs()
    cache = cs.build_stage2_cache(chunks, _emb, col, **BRANCH_KW)
    jcache = jax_cs.build_stage2_cache(chunks, _emb, jcol, **BRANCH_KW)
    init = _jax_init(4)
    logged = {"port": [], "jax": []}

    def log(key):
        return lambda epoch, labels, probs: logged[key].append(
            (epoch, labels.tolist(), probs))

    want_params, want = jax_train_stage2.train_stage2(
        train, val, jcache, encode_fn=_emb if live else None,
        collection=jcol if live else None, cfg=jcfg, seed=5,
        init_params=init, log_probs_fn=log("jax"))
    head, got = train_stage2.train_stage2(
        train, val, cache, encode_fn=_emb if live else None,
        collection=col if live else None, cfg=cfg, seed=5,
        init_params=convert.ratt_v2_to_state_dict(_np_tree(init)),
        log_probs_fn=log("port"), device="cpu")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            np.testing.assert_allclose(g[key], float(w[key]), **TRAJ_TOL,
                                       err_msg=key)
    assert {"grad_rms_support", "grad_rms_contrast", "grad_rms_temporal",
            "grad_rms_query", "val_best_f1"} <= set(got[0])
    for (ge, gl, gp), (we, wl, wp) in zip(logged["port"], logged["jax"]):
        assert (ge, gl) == (we, wl)
        np.testing.assert_allclose(gp, wp, **TRAJ_TOL)
    want_sd = convert.ratt_v2_to_state_dict(_np_tree(want_params))
    steps = 2 * len(train) // TRAIN_KW["batch_size"] \
        // TRAIN_KW["accum_steps"]
    off, total = 0, 0
    for name, p in head.state_dict().items():
        diff = np.abs(p.numpy() - want_sd[name].numpy())
        assert diff.max() <= TRAIN_KW["lr_phase1"] * steps, name
        if not name.endswith("attn.key.bias"):
            off += int((diff > TRAJ_TOL["atol"] + TRAJ_TOL["rtol"]
                        * np.abs(want_sd[name].numpy())).sum())
            total += diff.size
    assert off <= OFF_SHARE * total, (off, total)


def test_train_stage2_resume_equals_the_uninterrupted_run(tmp_path):
    """Classifier dropout 0.2: 4 epochs stopped after 2 (by its
    log_probs_fn in the third epoch, before that epoch's checkpoint) and
    resumed equal 4 uninterrupted epochs (weights, optimizer with its
    accumulator and LR phase, step, per-epoch dropout generators)."""
    chunks, train, val = _world()
    col, _ = _collections(chunks, 0)
    cache = cs.build_stage2_cache(chunks, _emb, col, **BRANCH_KW)
    cfg, _ = _cfgs(num_epochs=4)
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, classifier_dropout=0.2))
    args = (train, val, cache)
    kw = dict(encode_fn=_emb, collection=col, seed=3, device="cpu")
    ref, ref_hist = train_stage2.train_stage2(*args, cfg=cfg, **kw)
    mngr = ckpt.CheckpointManager(str(tmp_path), "s2")

    def stop(epoch, labels, probs):
        if epoch == 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        train_stage2.train_stage2(*args, cfg=cfg, ckpt_manager=mngr,
                                  log_probs_fn=stop, **kw)
    assert mngr.all_steps() == [0, 1]
    head, hist = train_stage2.train_stage2(*args, cfg=cfg, ckpt_manager=mngr,
                                           resume=True, **kw)
    assert len(hist) == 2 and hist == ref_hist[2:]
    for name, p in ref.state_dict().items():
        assert torch.equal(p, head.state_dict()[name]), name
    assert mngr.restore(3)["step"] == 4 * len(train) // 4
    assert mngr.all_steps() == [0, 1, 2, 3]


def test_stage3_continuation_starts_from_the_pinned_weights():
    """init_params: the head starts from the pinned run's weights (no
    epoch run: they come back as given, not the seeded init). The
    trajectory from given weights is held to the JAX loop's in
    test_train_stage2_matches_jax, which starts both from init_params."""
    chunks, train, val = _world()
    col, _ = _collections(chunks, 0)
    cache = cs.build_stage2_cache(chunks, _emb, col, **BRANCH_KW)
    sd = convert.ratt_v2_to_state_dict(_np_tree(_jax_init(8)))
    cfg, _ = _cfgs(num_epochs=0)
    head, hist = train_stage2.train_stage2(train, val, cache, cfg=cfg,
                                           init_params=sd, device="cpu")
    assert hist == []
    fresh = train_stage2.build_head(cfg, 12).state_dict()
    for name, p in head.state_dict().items():
        assert torch.equal(p, sd[name]), name
    assert not torch.equal(head.state_dict()["cls_token"], fresh["cls_token"])


def test_train_stage2_runs_a_bf16_head():
    """HeadConfig(dtype='bfloat16'): train_stage2 steps the f32 weights
    through bf16 compute, its validation probabilities reach the host as
    f32, and its losses stay within bf16's reach of the f32 run's."""
    chunks, train, val = _world()
    col, _ = _collections(chunks, 0)
    cache = cs.build_stage2_cache(chunks, _emb, col, **BRANCH_KW)
    runs, probs = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg, _ = _cfgs(num_epochs=1)
        cfg = dataclasses.replace(cfg, head=dataclasses.replace(
            cfg.head, dtype=dtype))
        runs[dtype] = train_stage2.train_stage2(
            train, val, cache, encode_fn=None, collection=None, cfg=cfg,
            seed=5, device="cpu", log_probs_fn=lambda e, lab, p, d=dtype:
            probs.setdefault(d, p))
    head, hist = runs["bfloat16"]
    assert {p.dtype for p in head.parameters()} == {torch.float32}
    assert probs["bfloat16"].dtype == np.float32
    for key in ("train_loss", "val_loss"):
        assert np.isfinite(hist[0][key])
        np.testing.assert_allclose(hist[0][key], runs["float32"][1][0][key],
                                   rtol=2 ** -5, err_msg=key)
