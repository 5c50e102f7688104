"""The retrieval trainers of the port against the JAX package: train_rag,
its cls_only ablation and train_ratt (with and without the attention
losses) from one set of flax initial weights, 2 epochs with gradient
accumulation, the two-phase LR (and contrastive weight) and a DB rebuild
through the live projection after every epoch; --resume; and the verbs
write-rag-db, train-rag, train-ratt and rebuild-db on --device cpu, with
the profile fence and rebuild-db --run-id.

Inputs are drawn with numpy from fixed seeds. The classifier dropout is
0 (``classifier_dropout=0.0``), so both packages compute one function.
Tolerances: f32 on the CPU in other summation orders, ~1e-7 relative per
operation. Per-epoch metrics within 1e-5 relative / 1e-6 absolute (the
JAX package's own trajectory tests' bound, tests/test_torch_train.py);
parameters: every element within lr a step, and at most 1e-4 of the
elements outside the attention key biases beyond 1e-5 relative / 1e-6
absolute (counted over the model, as chip_smoke.py counts them: a tensor
of these tiny widths holds ~1,000 elements, and Adam scales rounding
noise in an element's near-zero gradient up to a step). The key biases'
gradient is rounding noise throughout (the softmax removes a per-query
constant). Rows the CLI writes: 1e-6 against a host computation of the
same function.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu.db import builders as jax_builders
from vit_research_tpu.models import heads as jax_heads
from vit_research_tpu.retrieval import retrievers as jax_retrievers
from vit_research_tpu.store.vector_store import Collection as JaxCollection
from vit_research_tpu.train import train_rag as jax_train_rag
from vit_research_tpu.train import train_ratt as jax_train_ratt
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu_torch import cli
from vit_research_tpu_torch.data import chunks as chunks_mod
from vit_research_tpu_torch.data import labels as labels_mod
from vit_research_tpu_torch.data import samples as samples_mod
from vit_research_tpu_torch.db import builders
from vit_research_tpu_torch.db.enrich import chunk_stats
from vit_research_tpu_torch.db.frame_store import (FrameStore,
                                                   build_chunk_index,
                                                   load_chunk_index)
from vit_research_tpu_torch.models import convert, heads
from vit_research_tpu_torch.retrieval import (FrameRetriever,
                                              RattChunkRetriever)
from vit_research_tpu_torch.store.vector_store import (Collection,
                                                       PersistentClient)
from vit_research_tpu_torch.train import checkpoint as ckpt
from vit_research_tpu_torch.train import train_rag, train_ratt
from vit_research_tpu_torch.utils import configs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
ROW_TOL = dict(rtol=1e-6, atol=1e-6)
OFF_SHARE = 1e-4
D, T = 32, 6
# tests/test_training_loops.py's heads, with the classifier dropout off
HEAD_KW = dict(embed_dim=D, num_layers=1, num_heads=2, mlp_dim=16,
               num_queries=2, max_tokens=16, classifier_dropout=0.0)
# 48 training chunks in batches of 8, two micro-batches an update: 3
# updates an epoch; the phase boundary (1 epoch) switches the LR and the
# contrastive weight before epoch 1
TRAIN_KW = dict(batch_size=8, num_epochs=2, accum_steps=2, lr_phase1=1e-3,
                lr_phase2=3e-4, rebuild_every=1, contrastive_weight=0.1,
                contrastive_weight_phase2=0.05)
TOP_K = 4


def _cfgs(name):
    """(port, JAX) ExperimentConfigs of the tiny heads."""
    out = []
    for mod in (configs, jax_configs):
        out.append(mod.ExperimentConfig(
            name=name, head=mod.HeadConfig(**HEAD_KW),
            train=mod.TrainConfig(**TRAIN_KW),
            retrieval=mod.RetrievalConfig(top_k=TOP_K)))
    return out


def _chunk(vid, clip, start, side, label, t_center):
    return {"vid": vid, "clip": clip, "start_idx": start,
            "end_idx": start + T - 1, "side": side, "label": label,
            "t_center": t_center, "t_width": 0.3, "status_id": label,
            "frames": [f"/v{vid}/c{clip}/f{start + i}.jpg"
                       for i in range(T)]}


def _world():
    """tests/test_training_loops.py's world: 4 vids x 2 clips x 8 chunks,
    label-dependent frame embeddings; vids 1-3 train, 4 validates."""
    chunks = [_chunk(vid, clip, s * 4, "left" if clip % 2 == 0 else "right",
                     int(s >= 4), (s + 0.5) / 8)
              for vid in range(1, 5) for clip in range(2) for s in range(8)]
    return chunks, [c for c in chunks if c["vid"] <= 3], \
        [c for c in chunks if c["vid"] == 4]


def frame_embs_fn(batch):
    out = np.zeros((len(batch), T, D), np.float32)
    for i, ch in enumerate(batch):
        rng = np.random.default_rng(ch["vid"] * 131 + ch["clip"] * 17
                                    + ch["start_idx"])
        base = np.zeros(D)
        base[ch["label"]] = 2.0
        base[4 + (0 if ch["side"] == "left" else 1)] = 1.0
        out[i] = base + 0.3 * rng.normal(size=(T, D))
    return out


def chunk_embed_fn(batch):
    emb = frame_embs_fn(batch).mean(axis=1)
    return emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-8)


def _frame_samples(chunks):
    """One sample per chunk frame (the frame-level RAG rows): t_norm is
    the chunk's centre."""
    out = {}
    for ch in chunks:
        for p in ch["frames"]:
            out.setdefault(p, {"pth": p, "side": ch["side"],
                               "t_norm": ch["t_center"],
                               "clip_num": ch["clip"], "vid_num": ch["vid"]})
    return list(out.values())


def _frame_embed(chunks):
    table = {}
    for ch in chunks:
        for p, e in zip(ch["frames"], frame_embs_fn([ch])[0]):
            table.setdefault(p, e)
    return lambda paths: np.stack([table[p] for p in paths])


def _ratt_rows(chunks, col):
    """``chunk_<i>`` rows as write_ratt_chunk_db writes them (the chunk
    embedding stands in for the stage-1 encoder's)."""
    col.upsert([f"chunk_{i}" for i in range(len(chunks))],
               chunk_embed_fn(chunks),
               [{"vid_num": c["vid"], "clip_num": c["clip"],
                 "side": c["side"], "label": c["label"],
                 "t_center": c["t_center"], "t_width": c["t_width"],
                 "class_logit": 0.0, "start_idx": c["start_idx"],
                 "end_idx": c["end_idx"]} for c in chunks])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state_dict(params, head_fn):
    """A JAX trainer's {"proj", "head"} params -> the port's state_dict."""
    sd = {f"proj.{k}": v for k, v in
          convert.projection_head_to_state_dict(params["proj"]).items()}
    sd.update({f"head.{k}": v for k, v in head_fn(params["head"]).items()})
    return sd


def _assert_same_trajectory(got_hist, want_hist, got_model, want_sd,
                            steps):
    assert len(got_hist) == len(want_hist) == 2
    for g, w in zip(got_hist, want_hist):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_allclose(g[key], float(w[key]), **TRAJ_TOL,
                                       err_msg=key)
    lr = TRAIN_KW["lr_phase1"]
    off, total = 0, 0
    for name, p in got_model.state_dict().items():
        got_p, want_p = p.numpy(), want_sd[name].numpy()
        diff = np.abs(got_p - want_p)
        assert diff.max() <= lr * steps, name
        if not name.endswith("attn.key.bias"):
            off += int((diff > TRAJ_TOL["atol"]
                        + TRAJ_TOL["rtol"] * np.abs(want_p)).sum())
            total += diff.size
    assert off <= OFF_SHARE * total, (off, total)


@pytest.mark.parametrize("use_retrieval", [True, False])
def test_train_rag_matches_jax(use_retrieval):
    """train_rag (and train_cls_only) against the JAX loop: the same
    frame-level collection in each package, rebuilt through each loop's
    live projection after every epoch (rebuild_frame_db)."""
    chunks, train, val = _world()
    cfg, jcfg = _cfgs("rag" if use_retrieval else "cls_only")
    samples, embed = _frame_samples(chunks), _frame_embed(chunks)
    col = Collection("ragdb", space="cosine", device="cpu")
    jcol = JaxCollection("ragdb", space="cosine")
    builders.write_frame_ragdb(samples, embed, col)
    jax_builders.write_frame_ragdb(samples, embed, jcol)
    rebuilds = {"port": 0, "jax": 0}

    def rebuild(mod, c, key):
        def fn(project_fn):
            rebuilds[key] += 1
            mod.rebuild_frame_db(samples, embed, project_fn, c)
        return fn

    seed = 5
    key = jax.random.PRNGKey(seed)
    init = {"proj": jax_heads.ProjectionHead(input_dim=D, proj_dim=D).init(
                key, jnp.zeros((1, D))),
            "head": jax_heads.RAGHead(jcfg.head).init(
                key, jnp.zeros((1, D)), jnp.zeros((1, TOP_K, D)))}
    jax_fn = jax_train_rag.train_rag if use_retrieval else \
        jax_train_rag.train_cls_only
    want_params, want = jax_fn(
        train, val, chunk_embed_fn,
        jax_retrievers.FrameRetriever(jcol, top_k=TOP_K), cfg=jcfg,
        rebuild_fn=rebuild(jax_builders, jcol, "jax"), seed=seed,
        init_params=init)
    port_fn = train_rag.train_rag if use_retrieval else \
        train_rag.train_cls_only
    model, got = port_fn(
        train, val, chunk_embed_fn, FrameRetriever(col, top_k=TOP_K),
        cfg=cfg, rebuild_fn=rebuild(builders, col, "port"), seed=seed,
        init_params=_state_dict(_np_tree(init),
                                convert.rag_head_to_state_dict),
        device="cpu")
    assert rebuilds == {"port": 2, "jax": 2}
    assert set(got[0]) == {"train_loss", "train_acc", "loss_cls",
                           "loss_contrastive", "val_loss", "val_acc",
                           "retr_sim", "comb_sim", "comb_sim_std"}
    if use_retrieval:
        assert got[-1]["retr_sim"] != 0.0  # rows were retrieved
    _assert_same_trajectory(
        got, want, model,
        _state_dict(_np_tree(want_params), convert.rag_head_to_state_dict),
        steps=2 * 3)
    # the collections were rebuilt alike through the trained projections
    ids = sorted(col.get()["ids"])
    assert ids == sorted(jcol.get()["ids"])
    np.testing.assert_allclose(
        np.asarray(col.get(ids=ids, include=("embeddings",))["embeddings"]),
        np.asarray(jcol.get(ids=ids, include=("embeddings",))
                   ["embeddings"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attention_losses,contrastive_weight",
                         [(False, 0.0), (True, 0.05)])
def test_train_ratt_matches_jax(attention_losses, contrastive_weight,
                                monkeypatch):
    """train_ratt against the JAX loop, the chunk rows re-projected by
    each loop's live projection after every epoch
    (reproject_chunk_rows). The port's loop starts from the JAX loop's
    initial weights (its PRNGKey(seed) draw), converted, in place of its
    own seeded init."""
    chunks, train, val = _world()
    cfg, jcfg = _cfgs("ratt")
    col = Collection("ratt_db", space="cosine", device="cpu")
    jcol = JaxCollection("ratt_db", space="cosine")
    _ratt_rows(chunks, col)
    _ratt_rows(chunks, jcol)

    def rebuild(mod, c):
        return lambda project_fn: mod.reproject_chunk_rows(
            chunks, frame_embs_fn, project_fn, c)

    seed = 6
    key = jax.random.PRNGKey(seed)
    init = {"proj": jax_heads.ProjectionHead(
                input_dim=3 * D, hidden_dim=D, proj_dim=D).init(
                key, jnp.zeros((1, 3 * D))),
            "head": jax_heads.RATTHead(jcfg.head).init(
                key, jnp.zeros((1, D)), jnp.zeros((1, TOP_K, D)))}
    want_params, want = jax_train_ratt.train_ratt(
        train, val, frame_embs_fn,
        jax_retrievers.RattChunkRetriever(jcol, top_k=TOP_K), cfg=jcfg,
        attention_losses=attention_losses,
        contrastive_weight=contrastive_weight,
        rebuild_fn=rebuild(jax_builders, jcol), seed=seed)
    build = train_ratt.build_model

    def converted(c, s):
        model = build(c, s)
        model.load_state_dict(_state_dict(_np_tree(init),
                                          convert.ratt_head_to_state_dict))
        return model

    monkeypatch.setattr(train_ratt, "build_model", converted)
    model, got = train_ratt.train_ratt(
        train, val, frame_embs_fn, RattChunkRetriever(col, top_k=TOP_K),
        cfg=cfg, attention_losses=attention_losses,
        contrastive_weight=contrastive_weight,
        rebuild_fn=rebuild(builders, col), seed=seed, device="cpu")
    terms = {"loss_cls", "loss_ibn"} | (
        {"loss_attn_contrastive", "loss_attn_entropy"}
        if attention_losses else set()) | (
        {"loss_contrastive"} if contrastive_weight else set())
    assert set(got[0]) == {"train_loss", "train_acc", "val_loss",
                           "val_acc"} | terms
    _assert_same_trajectory(
        got, want, model,
        _state_dict(_np_tree(want_params), convert.ratt_head_to_state_dict),
        steps=2 * 3)
    ids = [f"chunk_{i}" for i in range(len(chunks))]
    g, w = (c.get(ids=ids, include=("embeddings", "metadatas"))
            for c in (col, jcol))
    assert g["metadatas"] == w["metadatas"]
    np.testing.assert_allclose(np.asarray(g["embeddings"]),
                               np.asarray(w["embeddings"]), rtol=1e-5,
                               atol=1e-5)


def test_train_rag_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Classifier dropout 0.2: a 4-epoch run stopped after its second
    epoch (by its rebuild hook), then resumed, equals 4 uninterrupted
    epochs (weights, optimizer with its accumulator, step; per-epoch
    dropout generators; the phase boundary at epoch 2)."""
    chunks, train, val = _world()
    cfg, _ = _cfgs("rag")
    cfg = dataclasses.replace(
        cfg, head=dataclasses.replace(cfg.head, classifier_dropout=0.2),
        train=dataclasses.replace(cfg.train, num_epochs=4, rebuild_every=2))
    col = Collection("ragdb", space="cosine", device="cpu")
    builders.write_frame_ragdb(_frame_samples(chunks), _frame_embed(chunks),
                               col)
    args = (train, val, chunk_embed_fn, FrameRetriever(col, top_k=TOP_K))
    ref_model, ref = train_rag.train_rag(*args, cfg=cfg, seed=3,
                                         device="cpu",
                                         rebuild_fn=lambda proj: None)

    class Stop(Exception):
        pass

    def stop(project_fn):
        raise Stop

    with pytest.raises(Stop):
        train_rag.train_rag(*args, cfg=cfg, seed=3, device="cpu",
                            rebuild_fn=stop, ckpt_manager=ckpt.
                            CheckpointManager(str(tmp_path), "run"))
    mngr = ckpt.CheckpointManager(str(tmp_path), "run")
    assert mngr.latest_step() == 1
    model, hist = train_rag.train_rag(*args, cfg=cfg, seed=3, device="cpu",
                                      ckpt_manager=mngr, resume=True,
                                      rebuild_fn=lambda proj: None)
    assert len(hist) == 2 and mngr.latest_step() == 3
    assert mngr.restore()["step"] == 4 * 6
    assert all(k.startswith(("proj.", "head."))
               for k in mngr.restore()["params"])
    for h_ref, h in zip(ref[2:], hist):
        for key in ("train_loss", "val_loss", "val_acc"):
            np.testing.assert_allclose(h[key], h_ref[key], rtol=1e-6)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(),
                                   ref_model.state_dict()[name].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_train_rag_with_the_async_rebuild():
    """A RebuildScheduler in place of rebuild_fn: each epoch kicks a
    rebuild of a shadow collection through a copy of the live projection
    and swaps the finished one in at the next epoch boundary (the last at
    the end); the rows the retriever reads at the end are the final
    projection of the frame rows."""
    from vit_research_tpu_torch.train.async_rebuild import (
        RebuildScheduler, SwappableCollection)

    chunks, train, val = _world()
    cfg, _ = _cfgs("rag")
    samples, embed = _frame_samples(chunks), _frame_embed(chunks)

    def new():
        return Collection("ragdb", space="cosine", device="cpu")

    base = new()
    builders.write_frame_ragdb(samples, embed, base)
    swappable = SwappableCollection(base)
    projections = []

    def rebuild(shadow, project_fn):
        projections.append(project_fn)
        builders.write_frame_ragdb(samples, embed, shadow,
                                   project_fn=project_fn)

    sched = RebuildScheduler(swappable, new, rebuild)
    model, hist = train_rag.train_rag(
        train, val, chunk_embed_fn, FrameRetriever(swappable, top_k=TOP_K),
        cfg=cfg, rebuild_scheduler=sched, seed=4, device="cpu")
    assert len(hist) == 2 and len(projections) == 2
    assert sched.swaps == 2 and swappable.active is not base
    ids = [s["pth"] for s in samples]
    with torch.no_grad():
        want = model["proj"](torch.from_numpy(embed(ids))).numpy()
    got = swappable.get(ids=ids, include=("embeddings",))["embeddings"]
    np.testing.assert_allclose(np.asarray(got), want, **ROW_TOL)
    # the first kick's copy kept the weights of its epoch, not the final
    first = projections[0](embed(ids[:4]))
    assert not np.allclose(first, want[:4], atol=1e-6)


# -------------------------------------------------------------------- CLI


PROFILE = "torch|tiny|tome0|quant-none|gray0"


def _cli_world(root):
    """Clip directories of two games (empty JPEG names suffice: the store
    holds the embeddings), their clip labels, and a frame store with its
    chunk index, stamped with a port profile."""
    clip_labels = {}
    for vid in (1, 2):
        for clip, side in ((1, "left"), (2, "right"), (3, "left")):
            d = os.path.join(root, f"clips_{vid}", f"vid{vid}_clip_{clip}_"
                             f"{side}")
            os.makedirs(d)
            for f in range(10 * clip, 10 * clip + 8):
                open(os.path.join(d, f"vid{vid}_frame_{f}.jpg"), "w").close()
            clip_labels[d] = int(side == "left")
    labels_csv = os.path.join(root, "labels.csv")
    labels_mod.save_clip_labels(clip_labels, labels_csv)
    template = os.path.join(root, "clips_{vid}")
    recs = samples_mod.load_samples([1, 2], template, clip_labels)
    chunks = chunks_mod.build_chunks(recs, chunk_size=4, chunk_stride=2)
    rng = np.random.default_rng(0)
    paths = [r["pth"] for r in recs]
    table = {p: rng.standard_normal(D).astype(np.float32)
             + 0.5 * (r["side"] == "left") for p, r in zip(paths, recs)}
    store_dir = os.path.join(root, "store")
    store = FrameStore.build(paths, lambda ps: np.stack([table[p]
                                                         for p in ps]),
                             store_dir, embedding_profile=PROFILE)
    build_chunk_index(chunks, store, store_dir)
    world = ["--clip-root", template, "--vids", "1", "2", "--clip-labels",
             labels_csv, "--chunk-size", "4", "--chunk-stride", "2"]
    return FrameStore(store_dir).open(), store_dir, recs, world


def test_rag_verbs_on_cpu(tmp_path, capsys):
    """write-rag-db (rows equal the JAX builder's), train-rag with
    --rebuild sync and --resume, rebuild-db --run-id (rows equal the
    restored ProjectionHead on the store rows, profile '|proj:<run>'),
    train-ratt --attention-losses --rebuild sync (rows re-projected, their
    metadata kept), and the profile fence."""
    store, store_dir, recs, world = _cli_world(str(tmp_path))
    db, ck = str(tmp_path / "db"), str(tmp_path / "ckpt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["train-rag", "--store", store_dir, "--db", db,
                      "--ckpt", ck, "--train-vids", "1", "--val-vids", "2"])
        assert not os.path.exists(ck)

    cli.main(["write-rag-db", *world, "--store", store_dir, "--db", db,
              "--device", "cpu"])
    n = len(recs)
    assert f"wrote {n} frame embeddings into ragdb" in \
        capsys.readouterr().out
    col = PersistentClient(db, device="cpu").get_collection("ragdb")
    want = JaxCollection("ragdb", space="cosine")
    jax_builders.write_frame_ragdb(
        recs, lambda ps: store.gather_paths([[p] for p in ps])[:, 0], want)
    ids = sorted(want.get()["ids"])
    g, w = (c.get(ids=ids, include=("embeddings", "metadatas"))
            for c in (col, want))
    assert g["ids"] == w["ids"] and g["metadatas"] == w["metadatas"]
    np.testing.assert_array_equal(np.asarray(g["embeddings"]),
                                  np.asarray(w["embeddings"]))
    assert col.embedding_profile == PROFILE and col.space == "cosine"

    rag = ["train-rag", "--store", store_dir, "--db", db, "--ckpt", ck,
           "--train-vids", "1", "--val-vids", "2", "--batch-size", "4",
           "--top-k", "3", "--run-id", "r1", "--rebuild", "sync",
           "--rebuild-every", "1", *world, "--device", "cpu"]
    cli.main(rag + ["--epochs", "2"])
    cli.main(rag + ["--epochs", "3", "--resume"])
    out = capsys.readouterr().out
    assert out.count("epoch 0:") == out.count("epoch 2:") == 1
    assert "run r1: best val acc" in out
    mngr = ckpt.CheckpointManager(ck, "r1")
    assert mngr.all_steps() == [0, 1, 2]
    n_train = sum(1 for i in load_chunk_index(store_dir)["vid"] if i == 1)
    assert mngr.restore(2)["step"] == 3 * (n_train // 4)
    with open(os.path.join(mngr.dir, "experiment.json")) as f:
        assert configs.ExperimentConfig.from_json(f.read()).head.embed_dim \
            == D

    cli.main(["rebuild-db", *world, "--store", store_dir, "--db", db,
              "--collection", "ragdb_proj", "--ckpt", ck, "--run-id", "r1",
              "--device", "cpu"])
    assert f"rebuilt ragdb_proj: {n} frame embeddings (re-projected)" in \
        capsys.readouterr().out
    proj = heads.ProjectionHead(D, proj_dim=D)
    proj.load_state_dict({k[5:]: v for k, v in
                          mngr.restore_best()["params"].items()
                          if k.startswith("proj.")})
    rows = PersistentClient(db, device="cpu").get_collection("ragdb_proj")
    got = rows.get(ids=ids, include=("embeddings",))
    with torch.no_grad():
        want_rows = proj(torch.from_numpy(np.asarray(w["embeddings"])))
    np.testing.assert_allclose(np.asarray(got["embeddings"]),
                               want_rows.numpy(), **ROW_TOL)
    assert rows.embedding_profile == PROFILE + "|proj:r1"

    # the fence: a collection of another profile takes no rows
    jax_col = PersistentClient(db, device="cpu").get_or_create_collection(
        "jaxrows", metadata={"hnsw:space": "cosine"})
    jax_col.stamp_embedding_profile("tome0|quant-none|gray0")
    jax_col.flush()
    with pytest.raises(SystemExit, match="profile"):
        cli.main(["write-rag-db", *world, "--store", store_dir, "--db", db,
                  "--collection", "jaxrows", "--device", "cpu"])
    with pytest.raises(SystemExit, match="refusing to write"):
        cli.main(["train-rag", "--store", store_dir, "--db", db, "--ckpt",
                  ck, "--collection", "jaxrows", "--train-vids", "1",
                  "--val-vids", "2", "--rebuild", "sync", *world,
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="no such run"):
        cli.main(["rebuild-db", *world, "--store", store_dir, "--db", db,
                  "--collection", "x", "--ckpt", ck, "--run-id", "t1",
                  "--device", "cpu"])

    # train-ratt over chunk rows (a stand-in stage-1 encoding: the mean)
    idx = load_chunk_index(store_dir)
    client = PersistentClient(db, device="cpu")
    ratt = client.get_or_create_collection(
        "ratt_db", metadata={"hnsw:space": "cosine"})
    ratt.stamp_embedding_profile(PROFILE)
    builders.write_ratt_chunk_db(
        idx, store, lambda x: (x.mean(axis=1), np.arange(len(x))[:, None]),
        ratt)
    client.flush()
    cli.main(["train-ratt", "--store", store_dir, "--db", db, "--ckpt", ck,
              "--train-vids", "1", "--val-vids", "2", "--batch-size", "4",
              "--top-k", "3", "--epochs", "1", "--attention-losses",
              "--rebuild", "sync", "--rebuild-every", "1", "--run-id", "t1",
              "--device", "cpu"])
    out = capsys.readouterr().out
    n_chunks = len(idx["label"])
    assert f"rebuilt {n_chunks} chunk rows with the live projection" in out
    assert "loss_attn_entropy" in out and "run t1:" in out
    with open(os.path.join(ck, "t1", "experiment.json")) as f:
        assert configs.ExperimentConfig.from_json(f.read()).name == "chunks"
    sd = ckpt.CheckpointManager(ck, "t1").restore(0)["params"]
    chunk_proj = heads.ProjectionHead(3 * D, hidden_dim=D, proj_dim=D)
    chunk_proj.load_state_dict({k[5:]: v for k, v in sd.items()
                                if k.startswith("proj.")})
    from vit_research_tpu_torch.db.frame_store import \
        gather_chunk_embedding_batch
    frames = gather_chunk_embedding_batch(store, idx, np.arange(n_chunks))
    with torch.no_grad():
        z = chunk_proj(torch.from_numpy(chunk_stats(frames))).numpy()
    z /= np.linalg.norm(z, axis=1, keepdims=True) + 1e-8
    cids = [f"chunk_{i}" for i in range(n_chunks)]
    got = PersistentClient(db, device="cpu").get_collection("ratt_db").get(
        ids=cids, include=("embeddings", "metadatas"))
    np.testing.assert_allclose(np.asarray(got["embeddings"]), z, **ROW_TOL)
    assert [m["class_logit"] for m in got["metadatas"]] == \
        list(range(n_chunks))
    # a train-ratt run's projection (3D -> D) does not re-project frames
    with pytest.raises(SystemExit, match="does not fit"):
        cli.main(["rebuild-db", *world, "--store", store_dir, "--db", db,
                  "--collection", "x", "--ckpt", ck, "--run-id", "t1",
                  "--device", "cpu"])
