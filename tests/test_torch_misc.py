"""The port's modules that no verb reaches, against the JAX package: the
joint ViT + RAGHead train step, RAG-ViT (forward, weight map, the
retrieval module), the candidate reranker with ties, the chunk dataset
and oversampling, and the weight writers' npz files in both directions.

Inputs are drawn with numpy from fixed seeds and fed to both packages;
weights cross through models/convert.py. Tolerances: forwards and
scores 1e-5 (f32 on the CPU in other summation orders); the joint step
at tests/test_misc_components.py's TINY config over 2 Adam steps: losses
1e-5 relative, parameters every element within lr a step and at most
1e-4 of the elements outside the attention key biases beyond 1e-5
relative / 1e-6 absolute (tests/test_torch_rag_train.py's bounds).
Retrieval rows, batches, labels and lists exactly equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vit_research_tpu.data import chunks as jax_chunks
from vit_research_tpu.data import pipeline as jax_pipeline
from vit_research_tpu.data import synthetic
from vit_research_tpu.data.preprocess import PreprocessSpec as JaxSpec
from vit_research_tpu.db import writers as jax_writers
from vit_research_tpu.models import heads as jax_heads
from vit_research_tpu.models import rag_vit as jax_rag_vit
from vit_research_tpu.models import vit as jax_vit
from vit_research_tpu.models.reranker import \
    CandidateReranker as JaxReranker
from vit_research_tpu.store.vector_store import Collection as JaxCollection
from vit_research_tpu.train import checkpoint as jax_ckpt
from vit_research_tpu.train import train_step as jax_train_step
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu_torch.data import chunks as chunks_mod
from vit_research_tpu_torch.data import pipeline
from vit_research_tpu_torch.data import samples as samples_mod
from vit_research_tpu_torch.data.preprocess import PreprocessSpec
from vit_research_tpu_torch.db import writers
from vit_research_tpu_torch.models import convert, heads, rag_vit
from vit_research_tpu_torch.models.reranker import CandidateReranker
from vit_research_tpu_torch.models.vit import VisionTransformer
from vit_research_tpu_torch.store.vector_store import Collection
from vit_research_tpu_torch.train import checkpoint as ckpt
from vit_research_tpu_torch.train.optim import Optimizer
from vit_research_tpu_torch.train.train_step import make_joint_train_step
from vit_research_tpu_torch.utils import configs

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)
OFF_SHARE = 1e-4
# tests/test_misc_components.py:30
TINY_KW = dict(image_size=(32, 32), patch_size=8, hidden_size=32,
               num_layers=1, num_heads=2, mlp_dim=64,
               use_flash_attention=False)
TINY, JAX_TINY = configs.ViTConfig(**TINY_KW), jax_configs.ViTConfig(**TINY_KW)
HEAD_KW = dict(embed_dim=32, num_layers=1, num_heads=2, mlp_dim=16,
               num_queries=2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dense_sd(tree, name):
    return {f"{name}.weight": torch.from_numpy(
                np.asarray(tree[name]["kernel"]).T.copy()),
            f"{name}.bias": torch.from_numpy(
                np.array(tree[name]["bias"], np.float32))}


# ------------------------------------------------------ the joint step


def test_joint_train_step_matches_jax():
    """make_joint_train_step against the JAX step (optax.adam(1e-3); the
    port's Optimizer with eps 1e-8) from one set of weights, 2 steps:
    the losses, and every parameter (the ViT's included: gradients flow
    through the backbone)."""
    key = jax.random.PRNGKey(0)
    jvit, vit_params = jax_vit.init_vit(JAX_TINY, seed=0)
    jproj = jax_heads.ProjectionHead(input_dim=32, hidden_dim=32,
                                     proj_dim=32)
    jhead = jax_heads.RAGHead(jax_configs.HeadConfig(**HEAD_KW))
    params = {"vit": vit_params,
              "proj": jproj.init(key, jnp.zeros((1, 32))),
              "head": jhead.init(key, jnp.zeros((1, 32)),
                                 jnp.zeros((1, 3, 32)))}
    tx = optax.adam(1e-3)
    jstep = jax_train_step.make_joint_train_step(jvit, jproj, jhead, tx)

    vit = VisionTransformer(TINY)
    vit.load_state_dict(convert.params_to_state_dict(
        _np_tree(params["vit"]), TINY))
    proj = heads.ProjectionHead(32, hidden_dim=32, proj_dim=32)
    proj.load_state_dict(convert.projection_head_to_state_dict(
        _np_tree(params["proj"])))
    head = heads.RAGHead(configs.HeadConfig(**HEAD_KW))
    head.load_state_dict(convert.rag_head_to_state_dict(
        _np_tree(params["head"])))
    modules = (vit, proj, head)
    opt = Optimizer([p for m in modules for p in m.parameters()], lr=1e-3,
                    eps=1e-8)
    step = make_joint_train_step(vit, proj, head, opt)

    rng = np.random.default_rng(0)
    opt_state = tx.init(params)
    for i in range(2):
        frames = rng.standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
        retrieved = rng.standard_normal((2, 3, 32)).astype(np.float32)
        labels = np.asarray([0.0, 1.0], np.float32)
        params, opt_state, want = jstep(params, opt_state,
                                        jnp.asarray(frames),
                                        jnp.asarray(retrieved),
                                        jnp.asarray(labels))
        got = step(torch.from_numpy(frames), torch.from_numpy(retrieved),
                   torch.from_numpy(labels))
        assert not got.requires_grad
        np.testing.assert_allclose(float(got), float(want), **TRAJ_TOL)
    want_sd = {**{f"vit.{k}": v for k, v in convert.params_to_state_dict(
                   _np_tree(params["vit"]), TINY).items()},
               **{f"proj.{k}": v for k, v in
                  convert.projection_head_to_state_dict(
                      _np_tree(params["proj"])).items()},
               **{f"head.{k}": v for k, v in convert.rag_head_to_state_dict(
                   _np_tree(params["head"])).items()}}
    got_sd = {f"{n}.{k}": v for n, m in zip(("vit", "proj", "head"),
                                            modules)
              for k, v in m.state_dict().items()}
    assert got_sd.keys() == want_sd.keys()
    off = total = 0
    moved = 0.0
    for name, p in got_sd.items():
        w = want_sd[name].numpy()
        diff = np.abs(p.numpy() - w)
        assert diff.max() <= 1e-3 * 2, name
        if name.startswith("vit.blocks"):
            moved = max(moved, float(np.abs(
                p.numpy() - convert.params_to_state_dict(
                    _np_tree(vit_params), TINY)[name[4:]].numpy()).max()))
        if not name.endswith("attn.key.bias"):
            off += int((diff > TRAJ_TOL["atol"]
                        + TRAJ_TOL["rtol"] * np.abs(w)).sum())
            total += diff.size
    assert off <= OFF_SHARE * total, (off, total)
    assert moved > 1e-4  # the backbone trained


# ------------------------------------------------------------- RAG-ViT


def _rag_rows():
    rng = np.random.default_rng(1)
    embs = rng.normal(size=(20, 32)).astype(np.float32)
    metas = [{"side": "left" if i % 2 == 0 else "right", "t_norm": i / 20,
              "clip_num": i % 3, "vid_num": i % 2} for i in range(20)]
    return [f"f{i}" for i in range(20)], embs, metas


@pytest.mark.parametrize("window", [0.5, 0.12])
def test_retrieval_module_matches_jax(window):
    """Side and t_norm window filters, same-clip exclusion and zero
    padding past the hits: equal rows to the JAX module's."""
    ids, embs, metas = _rag_rows()
    col = Collection("ragdb", space="cosine", device="cpu")
    jcol = JaxCollection("ragdb", space="cosine")
    col.upsert(ids, embs, metas)
    jcol.upsert(ids, embs, metas)
    args = (embs[:4], ["left", "right", "left", "right"],
            [0.5, 0.5, 0.1, 0.9], [0, 1, 2, 0], [0, 1, 0, 1])
    got = rag_vit.RetrievalModule(col, top_k=4, time_window=window)(*args)
    want = jax_rag_vit.RetrievalModule(jcol, top_k=4,
                                       time_window=window)(*args)
    assert got.shape == (4, 4, 32) and np.abs(got).sum() > 0
    np.testing.assert_array_equal(got, want)
    if window < 0.2:
        assert not got[:, -1].any()  # fewer hits than top_k: zero rows


def test_rag_vit_forward_and_weight_map_match_jax():
    """build_rag_vit's tokens are [CLS, 16 patches, 3 retrieval tokens]:
    every endpoint within 1e-5 of the JAX model's from the same weights,
    at the config's grid and at another one (position resize); the
    weight map round-trips."""
    jmodel, jparams = jax_rag_vit.build_rag_vit(JAX_TINY,
                                                num_retrieval_tokens=3,
                                                seed=0)
    jparams = _np_tree(jparams)
    model = rag_vit.build_rag_vit(TINY, num_retrieval_tokens=3, seed=0)
    sd = convert.rag_vit_to_state_dict(jparams, TINY)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    model.eval()
    back = convert.rag_vit_to_params(model.state_dict(), TINY)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    for hw, tokens in (((32, 32), 20), ((40, 48), 34)):
        imgs = rng.standard_normal((2, *hw, 3)).astype(np.float32)
        retrieved = rng.standard_normal((2, 5, 32)).astype(np.float32)
        want = jmodel.apply(jparams, jnp.asarray(imgs),
                            jnp.asarray(retrieved))
        with torch.no_grad():
            got = model(torch.from_numpy(imgs), torch.from_numpy(retrieved))
        assert got.keys() == want.keys()
        assert got["encoded_tokens"].shape == (2, tokens, 32)
        assert got["retrieval_tokens"].shape == (2, 3, 32)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **TOL, err_msg=k)


# ------------------------------------------------------------ reranker


def test_reranker_matches_jax_with_ties():
    """Scores within 1e-5; the rerank order with planted ties (equal
    candidates score equal) is the JAX package's: ties keep their
    retrieved order."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 8)).astype(np.float32)
    c = rng.normal(size=(2, 6, 8)).astype(np.float32)
    c[0, 3] = c[0, 1]
    c[0, 5] = c[0, 1]
    c[1, 4] = c[1, 0]
    jr = JaxReranker(embed_dim=8, hidden_dim=16)
    jp = _np_tree(jr.init(jax.random.PRNGKey(0), jnp.asarray(q),
                          jnp.asarray(c)))
    rr = CandidateReranker(embed_dim=8, hidden_dim=16)
    assert rr.state_dict().keys() == {"fc1.weight", "fc1.bias",
                                      "score.weight", "score.bias"}
    rr.load_state_dict({**_dense_sd(jp["params"], "fc1"),
                        **_dense_sd(jp["params"], "score")})
    with torch.no_grad():
        scores = rr(torch.from_numpy(q), torch.from_numpy(c))
    want = jr.apply(jp, jnp.asarray(q), jnp.asarray(c))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), **TOL)
    # the JAX order on the port's (bit-equal for the tied rows) scores
    s = scores.numpy()
    assert s[0, 1] == s[0, 3] == s[0, 5] and s[1, 0] == s[1, 4]
    for top_k in (None, 3):
        got = CandidateReranker.rerank(scores, torch.from_numpy(c), top_k)
        ref = JaxReranker.rerank(jnp.asarray(s), jnp.asarray(c), top_k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    order = torch.sort(scores, dim=1, descending=True, stable=True)[1]
    ties = [int(i) for i in order[0] if int(i) in (1, 3, 5)]
    assert ties == [1, 3, 5]


# ------------------------------------------------------------ the data


def test_chunk_dataset_matches_jax(tmp_path):
    """chunk_dataset's batches (uint8 frames, metadata, labels) equal the
    JAX package's for one seed, with and without prefetch."""
    template, clip_labels, events = synthetic.make_mini_dataset(
        str(tmp_path), vids=(1,), clips_per_vid=3, frames_per_clip=12)
    recs = samples_mod.load_samples((1,), template, clip_labels, events)
    chs = chunks_mod.build_chunks(recs, chunk_size=8, chunk_stride=2)
    kw = dict(batch_size=3, seed=4, num_workers=2)
    got = list(pipeline.chunk_dataset(chs, PreprocessSpec(size=(24, 32)),
                                      **kw))
    want = list(jax_pipeline.chunk_dataset(chs, JaxSpec(size=(24, 32)),
                                           **kw))
    plain = list(pipeline.chunk_dataset(chs, PreprocessSpec(size=(24, 32)),
                                        prefetch=False, **kw))
    assert len(got) == len(want) == len(plain) == len(chs) // 3
    for (f, md, y), (jf, jmd, jy), (pf, _, _) in zip(got, want, plain):
        assert f.shape == (3, 8, 24, 32, 3) and f.dtype == np.uint8
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(f, pf)
        np.testing.assert_array_equal(y, jy)
        assert y.dtype == jy.dtype == np.float32
        assert md.keys() == jmd.keys()
        for k in md:
            np.testing.assert_array_equal(md[k], jmd[k], err_msg=k)
    assert len(set(float(y) for _, _, ys in got for y in ys)) == 2


@pytest.mark.parametrize("target", ["max", 1.5, 0.5])
def test_oversample_chunk_samples_matches_jax(target):
    rng = np.random.default_rng(3)
    samples = [{"i": i, "status_id": int(s)}
               for i, s in enumerate(rng.choice(3, size=40,
                                                p=[0.7, 0.2, 0.1]))]
    got = chunks_mod.oversample_chunk_samples(samples, target, seed=9)
    want = jax_chunks.oversample_chunk_samples(samples, target, seed=9)
    assert [s["i"] for s in got] == [s["i"] for s in want]
    assert len(got) > len(samples) or target == 0.5


# ---------------------------------------------------------- the writers


def test_projection_head_npz_crosses_both_ways(tmp_path):
    p_path, j_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    model = writers.init_projection_head(p_path, input_dim=16,
                                         hidden_dim=12, proj_dim=8, seed=1)
    jmodel, jparams = jax_writers.init_projection_head(
        j_path, input_dim=16, hidden_dim=12, proj_dim=8, seed=1)
    x = np.random.default_rng(0).normal(size=(3, 16)).astype(np.float32)
    # the port's file in the JAX package
    loaded = jax_ckpt.load_params_npz(_np_tree(jparams), p_path)
    with torch.no_grad():
        mine = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(jmodel.apply(loaded, x)), mine,
                               **TOL)
    # the JAX package's file in the port
    template = convert.projection_head_to_params(model.state_dict())
    other = heads.ProjectionHead(16, hidden_dim=12, proj_dim=8)
    other.load_state_dict(convert.projection_head_to_state_dict(
        ckpt.load_params_npz(template, j_path)))
    with torch.no_grad():
        np.testing.assert_allclose(other(torch.from_numpy(x)).numpy(),
                                   np.asarray(jmodel.apply(jparams, x)),
                                   **TOL)


def test_random_vit_weights_cross_both_ways(tmp_path):
    """save/load_random_vit_weights at TINY (the default config is
    VIT_P32_432x768): each package loads the other's file and embeds
    alike."""
    p_path, j_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    model = writers.save_random_vit_weights(p_path, config=TINY, seed=2)
    jmodel, jparams = jax_writers.save_random_vit_weights(
        j_path, config=JAX_TINY, seed=2)
    imgs = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    _, loaded = jax_writers.load_random_vit_weights(p_path, config=JAX_TINY)
    with torch.no_grad():
        mine = model(torch.from_numpy(imgs))["pooled"].numpy()
    np.testing.assert_allclose(
        np.asarray(jmodel.apply(loaded, jnp.asarray(imgs))["pooled"]), mine,
        **TOL)
    other = writers.load_random_vit_weights(j_path, config=TINY,
                                            device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(
            other(torch.from_numpy(imgs))["pooled"].numpy(),
            np.asarray(jmodel.apply(jparams, jnp.asarray(imgs))["pooled"]),
            **TOL)
    assert not other.training
    import inspect
    assert inspect.signature(writers.save_random_vit_weights) \
        .parameters["config"].default is None
    assert os.path.getsize(p_path) > 0
