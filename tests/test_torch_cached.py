"""The port's cached RATT path against the JAX package: the bin cache
(retrieval/cache_bins.py: coarse bins through float32, keys, greedy
diversity selection with planted ties, build_bin_cache on both store
routes, the batch lookup, pickles crossing both ways), train_chunk_cached
against the JAX loop at dropout 0 with --resume and the per-epoch
refresh, and the train-cached verb on --device cpu.

Inputs are drawn with numpy from fixed seeds and fed to both packages.
Tolerances: bins, keys and selections exactly equal (host numpy and
Python in both packages); cache embeddings 1e-6 (rows copied out of the
stores). Trajectories, at dropout 0: per-epoch metrics within 1e-5
relative / 1e-6 absolute, parameters every element within lr a step and
at most 1e-4 of the elements outside the attention key biases beyond
1e-5 relative / 1e-6 absolute (tests/test_torch_rag_train.py's bounds).
A resumed run equals the uninterrupted one exactly.
"""

import dataclasses
import os
from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.models import heads as jax_heads
from vit_research_tpu.retrieval import cache_bins as jax_cb
from vit_research_tpu.store.vector_store import Collection as JaxCollection
from vit_research_tpu.train import train_chunk_cached as jax_tcc
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu_torch import cli
from vit_research_tpu_torch.data import chunks as chunks_mod
from vit_research_tpu_torch.data import labels as labels_mod
from vit_research_tpu_torch.data import samples as samples_mod
from vit_research_tpu_torch.db.frame_store import (FrameStore,
                                                   build_chunk_index)
from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.retrieval import cache_bins as cb
from vit_research_tpu_torch.store.vector_store import Collection
from vit_research_tpu_torch.train import checkpoint as ckpt
from vit_research_tpu_torch.train import train_chunk_cached as tcc
from vit_research_tpu_torch.utils import configs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EMB_TOL = dict(rtol=0, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
OFF_SHARE = 1e-4
D, TOP_K = 32, 4
HEAD_KW = dict(embed_dim=D, num_layers=1, num_heads=2, mlp_dim=16,
               max_tokens=16, classifier_dropout=0.0)
# 32 training chunks in batches of 8, two micro-batches an update
TRAIN_KW = dict(batch_size=8, num_epochs=2, accum_steps=2, lr_phase1=1e-3,
                lr_phase2=3e-4)
BIN_KW = dict(candidates_per_bin=6, query_mult=4, max_per_video=3,
              max_global_appearances=3, min_time_gap=0.01,
              hard_negative_ratio=0.3, lambda_global=0.1, delta_t=0.25,
              seed=11)


def _chunk(vid, clip, start, side, label, t_center):
    return {"vid": vid, "clip": clip, "start_idx": start,
            "end_idx": start + 3, "side": side, "label": label,
            "t_center": t_center, "t_width": 0.2, "status_id": label,
            "frames": [f"/v{vid}/c{clip}/f{start + i}.jpg"
                       for i in range(4)]}


def _world():
    """4 vids x 2 clips x 6 chunks; vids 1-3 train, 4 validates. The
    t_centers land on bin edges of delta_t = 0.25 (0.25, 0.5, 0.75 and
    float64 values that floor differently after float32)."""
    centers = (0.05, 0.25, 0.3, 0.5, 0.7, 0.75)
    chunks = [_chunk(vid, clip, 2 * s, "left" if clip == 0 else "right",
                     int(s >= 3), centers[s])
              for vid in (1, 2, 3, 4) for clip in range(2) for s in range(6)]
    return chunks, [c for c in chunks if c["vid"] <= 3], \
        [c for c in chunks if c["vid"] == 4]


def _emb(ch):
    """A chunk's stage-1 embedding stand-in (L2-normalised): label and
    side directions plus seeded noise."""
    rng = np.random.default_rng(ch["vid"] * 101 + ch["clip"] * 13
                                + ch["start_idx"])
    v = 0.6 * rng.standard_normal(D)
    v[ch["label"]] += 2.0
    v[4 + (ch["side"] == "right")] += 1.0
    return (v / np.linalg.norm(v)).astype(np.float32)


def chunk_embed_fn(batch):
    return np.stack([_emb(c) for c in batch])


def _rows(chunks, n_fill, ties=True):
    """ratt_db-style rows of ``chunks``, with ``ties`` planted ties (a
    twin under another game, a twin under the same signature), an
    unlabelled row, and ``n_fill`` rows of a side no bin asks for."""
    ids, embs, metas = [], [], []
    for i, c in enumerate(chunks):
        meta = {"vid_num": c["vid"], "clip_num": c["clip"],
                "side": c["side"], "label": c["label"],
                "t_center": c["t_center"], "start_idx": c["start_idx"]}
        rows = [(f"chunk_{i}", _emb(c), meta)]
        if ties and i % 5 == 0:
            rows += [(f"dup_{i}", _emb(c), dict(meta, vid_num=c["vid"] % 3
                                                + 1)),
                     (f"sig_{i}", _emb(c), dict(meta, clip_num=7))]
        if i % 7 == 1:  # t_center not a chunk's: label -1 in the cache
            rows.append((f"nolabel_{i}", _emb(c) * 0.99 + 0.01,
                         dict(meta, t_center=c["t_center"] + 0.01)))
        for r in rows:
            ids.append(r[0])
            embs.append(r[1])
            metas.append(r[2])
    rng = np.random.default_rng(7)
    for j in range(n_fill):
        v = rng.standard_normal(D)
        ids.append(f"fill_{j}")
        embs.append((v / np.linalg.norm(v)).astype(np.float32))
        metas.append({"vid_num": 1, "clip_num": j, "side": "none",
                      "label": 0, "t_center": 0.5, "start_idx": j})
    return ids, np.stack(embs), metas


def _collections(chunks, n_fill, ties=True):
    ids, embs, metas = _rows(chunks, n_fill, ties)
    col = Collection("ratt_db", space="cosine", device="cpu")
    jcol = JaxCollection("ratt_db", space="cosine")
    col.upsert(ids, embs, metas)
    jcol.upsert(ids, embs, metas)
    return col, jcol


def _by_signature(pool):
    """A pool's rows in (vid, t_center) order: their signature's (the
    side is the pool's)."""
    order = np.lexsort((pool["t_center"], pool["vid"]))
    return {name: col[order] for name, col in pool.items()}


def _same_cache(got, want, ordered=True):
    """Equal bins and pools; ``ordered=False`` compares each pool's rows
    as a set (see test_bin_cache_and_lookup_match_jax)."""
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        assert g.keys() == w.keys(), key
        if not ordered:
            g, w = _by_signature(g), _by_signature(w)
        for name in w:
            assert g[name].dtype == w[name].dtype, (key, name)
            if name == "embeddings":
                np.testing.assert_allclose(g[name], w[name], **EMB_TOL)
            else:
                np.testing.assert_array_equal(g[name], w[name],
                                              err_msg=str((key, name)))


# ------------------------------------------------------------- the cache


def test_bins_and_keys_match_jax():
    """coarse_time_bin goes through float32 first (0.2 // 0.1 is 1.0 in
    float64, 2.0 after the float32 round trip) and make_key rounds to
    KEY_PRECISION: equal to the JAX package's for edges and their float32
    neighbours."""
    rng = np.random.default_rng(0)
    values = [0.0, 0.1, 0.2, 0.3, 0.7, 0.9999999, 1.0, 0.25, 0.5] + \
        [float(np.nextafter(np.float32(x), np.float32(d)))
         for x in (0.2, 0.3, 0.6) for d in (0, 1)] + \
        list(rng.uniform(0, 1, 200))
    for delta in (0.1, 0.25, 0.05):
        got = [cb.coarse_time_bin(v, delta) for v in values]
        assert got == [jax_cb.coarse_time_bin(v, delta) for v in values]
    assert cb.coarse_time_bin(0.2, 0.1) == 2
    assert cb.KEY_PRECISION == jax_cb.KEY_PRECISION == 5
    for v in values:
        assert cb.make_key(3, "left", v) == jax_cb.make_key(3, "left", v)
        assert cb.make_key(np.int64(3), b"x".decode(), np.float32(v)) == \
            jax_cb.make_key(np.int64(3), "x", np.float32(v))


@pytest.mark.parametrize("kw", [
    dict(max_per_video=2, max_global_appearances=2, min_time_gap=0.05),
    dict(max_per_video=10, max_global_appearances=1, min_time_gap=0.0,
         lambda_global=0.0),
    dict(max_per_video=1, max_global_appearances=5, min_time_gap=0.2,
         lambda_global=2.0),
])
def test_greedy_selection_matches_jax_with_ties(kw):
    """Planted ties in the base scores (and in the adjusted scores once
    the global counts penalise), per-video caps, time gaps, and state
    carried across two calls: the same picks in the same order."""
    rng = np.random.default_rng(1)
    cands = []
    for i in range(40):
        vid = int(rng.integers(1, 5))
        t = round(float(rng.choice([0.1, 0.15, 0.3, 0.32, 0.6])), 5)
        cands.append({"vid": vid, "t_center": t,
                      "sig": (vid, "left", t + i * 1e-5),
                      "base_score": float(rng.choice([-0.1, -0.2, -0.25]))})
    sigs = [c["sig"] for c in cands]
    for got_mod, name in ((cb, "port"), (jax_cb, "jax")):
        counts = Counter({s: int(i % 3 == 0) for i, s in enumerate(sigs)})
        state = dict(video_counts={}, video_times={})
        first = got_mod.greedy_select_candidates(cands, 6, counts, **kw,
                                                 **state)
        second = got_mod.greedy_select_candidates(
            [c for c in cands if c not in first], 5, counts, **kw, **state)
        if name == "port":
            want = (first, second, counts, state)
        else:
            assert [c["sig"] for c in want[0]] == [c["sig"] for c in first]
            assert [c["sig"] for c in want[1]] == \
                [c["sig"] for c in second]
            assert want[2] == counts and want[3] == state
    assert want[0]  # something was selected


# under 2^14 rows x queries a bin's query ranks on the host, from 2^14 on
# the device
ROUTES = {"host": 0, "device": 6000}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bin_cache_and_lookup_match_jax(route, tmp_path):
    """build_bin_cache from the same rows in each package's store: the
    same bins, pools and flags, and the pickles crossing both ways. The
    host route scores in numpy in both packages, bit for bit, so it takes
    the planted ties (twins under another game and under one signature)
    and its pools come in one order: get_retrieval_cache is equal there.
    The device route's GEMMs, torch's and XLA's, round the cosines
    differently by ~1e-7, so near ties rank in either order: every
    anchor is a row of the collection, and the anchors' self-matches
    (distance 0 +- an ulp) head each bin's candidates. The greedy sweep
    then keeps the same rows in another order before the seeded
    permutation: the device route runs without planted ties and compares
    each pool as a set."""
    chunks, _, val = _world()
    host = route == "host"
    col, jcol = _collections(chunks, ROUTES[route], ties=host)
    got = cb.build_bin_cache(chunks, _emb, col, train_vids=[1, 2, 3],
                             **BIN_KW)
    want = jax_cb.build_bin_cache(chunks, _emb, jcol, train_vids=[1, 2, 3],
                                  **BIN_KW)
    _same_cache(got, want, ordered=host)
    flags = np.concatenate([p["is_hard_negative"] for p in got.values()])
    assert {0, 1} <= set(flags.tolist())  # both quotas filled somewhere
    # rows of no known chunk (label -1) rank but are never kept
    assert all(-1 not in p["label"] for p in got.values())

    p_path, j_path = str(tmp_path / "p.pkl"), str(tmp_path / "j.pkl")
    cb.save_cache(got, p_path)
    jax_cb.save_cache(want, j_path)
    _same_cache(jax_cb.load_cache(p_path), got)
    _same_cache(cb.load_cache(j_path), want)
    if not host:
        return

    from vit_research_tpu_torch.train.common import chunk_metadata_batch
    md = chunk_metadata_batch(val + chunks[:6])
    g = cb.get_retrieval_cache(md, got, top_k=TOP_K, delta_t=0.25, dim=D)
    w = jax_cb.get_retrieval_cache(md, want, top_k=TOP_K, delta_t=0.25,
                                   dim=D)
    np.testing.assert_allclose(g[0], w[0], **EMB_TOL)
    np.testing.assert_array_equal(g[1], w[1])
    np.testing.assert_array_equal(g[2], w[2])
    assert (g[1][:6] != -1).any()


def test_empty_collection_gives_empty_pools():
    chunks, _, _ = _world()
    col = Collection("ratt_db", space="cosine", device="cpu")
    got = cb.build_bin_cache(chunks, _emb, col, train_vids=[1], **BIN_KW)
    assert got and all(len(p["vid"]) == 0 and p["embeddings"].shape ==
                       (0, 768) for p in got.values())
    assert got.keys() == jax_cb.build_bin_cache(
        chunks, _emb, JaxCollection("r", space="cosine"), train_vids=[1],
        **BIN_KW).keys()


# ---------------------------------------------------------- the training


def _cfgs(**train):
    out = []
    for mod in (configs, jax_configs):
        out.append(mod.ExperimentConfig(
            name="chunks_cached", head=mod.HeadConfig(**HEAD_KW),
            train=mod.TrainConfig(**dict(TRAIN_KW, **train)),
            retrieval=mod.RetrievalConfig(top_k=TOP_K)))
    return out


def _jax_init(cfg, seed):
    return jax_heads.RATTHead(cfg.head).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, D)),
        jnp.zeros((1, TOP_K, D)))


@pytest.fixture(scope="module")
def cached_world():
    chunks, train, val = _world()
    col, jcol = _collections(chunks, 0)
    cache = cb.build_bin_cache(chunks, _emb, col, train_vids=[1, 2, 3],
                               **BIN_KW)
    jcache = jax_cb.build_bin_cache(chunks, _emb, jcol,
                                    train_vids=[1, 2, 3], **BIN_KW)
    return train, val, cache, jcache


def test_train_chunk_cached_matches_jax(cached_world, monkeypatch):
    """train_chunk_cached against the JAX loop from the JAX loop's initial
    weights (its PRNGKey(seed) draw, converted), 2 epochs with
    accumulation and the phase switch, a refresh after every epoch that
    swaps in the other package's (equal) cache."""
    train, val, cache, jcache = cached_world
    cfg, jcfg = _cfgs()
    seed = 5
    init = _jax_init(jcfg, seed)
    refreshed = {"port": [], "jax": []}

    def refresh(key, new):
        def fn(epoch):
            refreshed[key].append(epoch)
            return new
        return fn

    want_params, want = jax_tcc.train_chunk_cached(
        train, val, chunk_embed_fn, jcache, cfg=jcfg, seed=seed,
        delta_t=0.25, refresh_fn=refresh("jax", jcache))
    build = tcc.build_model

    def converted(c, s):
        head = build(c, s)
        head.load_state_dict(convert.ratt_head_to_state_dict(
            jax.tree_util.tree_map(np.asarray, init)))
        return head

    monkeypatch.setattr(tcc, "build_model", converted)
    head, got = tcc.train_chunk_cached(
        train, val, chunk_embed_fn, cache, cfg=cfg, seed=seed, delta_t=0.25,
        refresh_fn=refresh("port", jcache), device="cpu")
    assert refreshed == {"port": [0, 1], "jax": [0, 1]}
    assert set(got[0]) == {
        "train_loss", "train_acc", "agreement", "attn_mass_same",
        "attn_mass_diff", "loss_cls", "loss_margin", "ret_pos_score",
        "ret_neg_score", "ret_valid_frac", "val_loss", "val_acc"}
    assert got[0]["ret_valid_frac"] > 0 and got[0]["agreement"] > 0
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_allclose(g[key], float(w[key]), **TRAJ_TOL,
                                       err_msg=key)
    want_sd = convert.ratt_head_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_params))
    lr, steps = TRAIN_KW["lr_phase1"], 2 * 2
    off, total = 0, 0
    for name, p in head.state_dict().items():
        diff = np.abs(p.numpy() - want_sd[name].numpy())
        assert diff.max() <= lr * steps, name
        if not name.endswith("attn.key.bias"):
            off += int((diff > TRAJ_TOL["atol"] + TRAJ_TOL["rtol"]
                        * np.abs(want_sd[name].numpy())).sum())
            total += diff.size
    assert off <= OFF_SHARE * total, (off, total)


def test_train_chunk_cached_resume_equals_the_uninterrupted_run(
        cached_world, tmp_path):
    """Classifier dropout 0.2: 1 epoch, then --resume to 3, equals 3
    uninterrupted epochs (weights, optimizer, step, per-epoch dropout
    generators, the phase switch at epoch 1)."""
    train, val, cache, _ = cached_world
    cfg, _ = _cfgs(num_epochs=3)
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, classifier_dropout=0.2, dropout_rate=0.1))
    args = (train, val, chunk_embed_fn, cache)
    ref, ref_hist = tcc.train_chunk_cached(*args, cfg=cfg, seed=3,
                                           delta_t=0.25, device="cpu")
    mngr = ckpt.CheckpointManager(str(tmp_path), "cc")
    short = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=1))
    tcc.train_chunk_cached(*args, cfg=short, seed=3, delta_t=0.25,
                           ckpt_manager=mngr, device="cpu")
    head, hist = tcc.train_chunk_cached(*args, cfg=cfg, seed=3, delta_t=0.25,
                                        ckpt_manager=mngr, resume=True,
                                        device="cpu")
    assert len(hist) == 2 and hist == ref_hist[1:]
    for (name, p), q in zip(head.state_dict().items(),
                            ref.state_dict().values()):
        assert torch.equal(p, q), name
    assert mngr.all_steps() == [0, 1, 2]


# -------------------------------------------------------------- the verb


def _verb_world(root):
    """Two games of three clips (empty JPEG names: the store holds the
    rows), clip labels and a port frame store."""
    clip_labels = {}
    for vid in (1, 2):
        for clip, side in ((1, "left"), (2, "right"), (3, "left")):
            cd = os.path.join(root, f"clips_{vid}",
                              f"vid{vid}_clip_{clip}_{side}")
            os.makedirs(cd)
            for f in range(10 * clip, 10 * clip + 8):
                open(os.path.join(cd, f"vid{vid}_frame_{f}.jpg"), "w").close()
            clip_labels[cd] = int(side == "left")
    recs = samples_mod.load_samples([1, 2], os.path.join(root, "clips_{vid}"),
                                    clip_labels)
    chunks = chunks_mod.build_chunks(recs, chunk_size=4, chunk_stride=2)
    rng = np.random.default_rng(0)
    table = {r["pth"]: rng.standard_normal(D).astype(np.float32)
             + (r["side"] == "left") for r in recs}
    store_dir = os.path.join(root, "store")
    store = FrameStore.build(list(table), lambda ps: np.stack(
        [table[p] for p in ps]), store_dir,
        embedding_profile="torch|tiny|tome0|quant-none|gray0")
    build_chunk_index(chunks, store, store_dir)
    labels_mod.save_clip_labels(clip_labels, os.path.join(root, "labels.csv"))
    return store_dir


def test_train_cached_verb_on_cpu(tmp_path, capsys):
    """train-stage1 -> write-ratt-db -> train-cached (build the bin cache,
    2 epochs) -> train-cached --resume (load the cache, epoch 2 only), in
    this process on --device cpu; the cache the verb pickled loads in the
    JAX package and equals a build from the same rows."""
    root = str(tmp_path)
    store_dir = _verb_world(root)
    ck, db = os.path.join(root, "ck"), os.path.join(root, "db")
    cache = os.path.join(root, "bins.pkl")
    cli.main(["train-stage1", "--store", store_dir, "--ckpt", ck,
              "--epochs", "1", "--batch-size", "4", "--run-id", "s1",
              "--device", "cpu"])
    cli.main(["write-ratt-db", "--store", store_dir, "--ckpt", ck, "--db",
              db, "--run-id", "s1", "--device", "cpu"])
    tc = ["train-cached", "--store", store_dir, "--db", db, "--ckpt", ck,
          "--collection", "ratt_db", "--cache", cache, "--stage1-run-id",
          "s1", "--train-vids", "1", "--val-vids", "2", "--batch-size", "4",
          "--top-k", "3", "--delta-t", "0.5", "--run-id", "cc",
          "--device", "cpu"]
    capsys.readouterr()
    cli.main(tc + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "built bin cache (" in out and "epoch 1:" in out
    assert "run cc: best val acc" in out
    cli.main(tc + ["--epochs", "3", "--resume"])
    out = capsys.readouterr().out
    assert "loaded bin cache" in out and "epoch 0:" not in out \
        and "epoch 2:" in out
    assert ckpt.CheckpointManager(ck, "cc").all_steps() == [0, 1, 2]
    built = jax_cb.load_cache(cache)
    assert built and all(isinstance(k[0], str) for k in built)
    with pytest.raises(SystemExit) as e:  # --cache is required
        cli.main(tc[:8] + tc[10:])
    assert e.value.code == 2
