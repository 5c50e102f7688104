"""The port's walkthroughs (vit_research_tpu_torch/examples/) with
``--tiny --device cpu``, each held against the JAX package:

- full_pipeline: the engine's embeddings of the walkthrough's own frames
  against the JAX EmbeddingEngine with the same weights (carried over by
  models/convert.py, 1e-5), and tests/test_end_to_end.py's asserts (two
  clips a game with both planted sides, a row for every validation clip,
  the event scoring);
- live_segmentation: the streamed clips equal the offline clips of the
  same embeddings, the JAX ``segment_knn_hmm_stream``'s and the daemon
  session's;
- sharded_search: ids equal the JAX sharded query on its 8 virtual
  devices (``Collection.query`` after ``shard_device``) on the same rows
  and queries, ties included;
- serving: the replies' structure, and the daemon's embeddings equal to
  the in-process engine's;
- pod_embedding: two gloo processes; the gathered rows equal a single
  process engine's.
"""

import json
import os

import numpy as np
import pytest
import torch

from vit_research_tpu_torch.examples import (full_pipeline,
                                             live_segmentation,
                                             pod_embedding, serving,
                                             sharded_search)

torch.set_num_threads(1)

#: embeddings of one tiny ViT by two frameworks (f32, different op order)
EMBED_TOL = 1e-5


@pytest.fixture
def flush_denormals():
    """Subnormal floats flushed to zero, as XLA's CPU backend computes:
    the tiny temporal head's 200 Adam epochs on one thread otherwise run
    ~4x slower in subnormal arithmetic."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _clip_tuples(clips):
    return [(c.side, c.start, c.end) if hasattr(c, "side")
            else (c["side"], c["start"], c["end"]) for c in clips]


def test_full_pipeline_tiny_matches_jax_engine(tmp_path, flush_denormals):
    from vit_research_tpu.data.preprocess import PreprocessSpec as JaxSpec
    from vit_research_tpu.evaluate.event_scoring import (
        score_event_localization, truth_events_by_clip)
    from vit_research_tpu.models.vit import VisionTransformer as JaxViT
    from vit_research_tpu.parallel.embed import EmbeddingEngine as JaxEngine
    from vit_research_tpu.utils.configs import ViTConfig as JaxViTConfig
    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.models import convert

    res = full_pipeline.main(["--tiny", "--device", "cpu",
                              str(tmp_path / "demo")])
    eng = res["engine"]
    cfg = eng.model.config
    jcfg = JaxViTConfig(image_size=(32, 32), patch_size=8, hidden_size=32,
                        num_layers=1, num_heads=2, mlp_dim=64,
                        use_flash_attention=False)
    assert (cfg.hidden_size, cfg.num_layers, cfg.mlp_dim) == (32, 1, 64)
    # the port's weights, no JAX init to compile
    params = convert.state_dict_to_params(eng.model.state_dict(), cfg)
    jeng = JaxEngine(JaxViT(jcfg), params, JaxSpec(size=(32, 32)),
                     batch_size=16, use_fused_patch_embed=False)
    for vid, paths in res["frames"].items():
        np.testing.assert_allclose(eng.embed_paths(paths),
                                   np.asarray(jeng.embed_paths(paths)),
                                   rtol=0, atol=EMBED_TOL)
    # tests/test_end_to_end.py's asserts on the same stages
    for vid, clip_dirs in res["clip_dirs"].items():
        assert len(clip_dirs) >= 2, f"vid{vid}: expected 2 clips"
        sides = {naming.parse_clip_dir(os.path.basename(c))[2]
                 for c in clip_dirs}
        assert {"left", "right"} <= sides
    rows = res["rows"]
    assert {(r["vid"], r["clip"]) for r in rows} == \
        {(c["vid"], c["clip"]) for c in res["val_chunks"]}
    assert rows and all(r["num_chunks"] >= 1 for r in rows)
    assert os.path.getsize(res["results"]) > 0
    with open(res["results"]) as f:
        assert len(json.load(f)) == len(rows)
    assert all(c["start_frame"] is not None
               for r in rows for c in r["topk_chunks"])
    # the JAX scorer reads the port's rows (one labelled event a clip)
    rep = score_event_localization(rows, truth_events_by_clip(res["events"]),
                                   ks=(1, 3))
    assert rep["clips_scored"] == len(rows)
    assert rep["clips_without_frame_numbers"] == 0
    for v in rep["hit_at"].values():
        assert v is not None and 0.0 <= v <= 1.0
    assert rep["hit_at"]["3"] >= rep["hit_at"]["1"]
    assert np.isfinite(rep["center_error_mean"])


def test_live_segmentation_tiny_stream_equals_offline_and_jax(tmp_path):
    from vit_research_tpu.segment.pipeline import (
        segment_knn_hmm_stream as jax_stream)
    from vit_research_tpu_torch.segment.clips import (
        clip_intervals_from_decoded)
    from vit_research_tpu_torch.segment.knn import corpus_from_collection
    from vit_research_tpu_torch.segment.pipeline import segment_with_knn_hmm

    res = live_segmentation.main(["--tiny", "--device", "cpu",
                                  str(tmp_path / "live")])
    streamed = _clip_tuples(res["streamed"])
    assert [s for s, _, _ in streamed] == ["left", "right"]
    batches = list(live_segmentation.stream_batches(res["engine"],
                                                    res["paths"]))
    names = [n for b, _ in batches for n in b]
    embs = np.concatenate([e for _, e in batches])
    corpus = corpus_from_collection(res["collection"])
    decoded, _, _ = segment_with_knn_hmm(names, embs, corpus, device="cpu",
                                         k=5)
    offline = _clip_tuples(clip_intervals_from_decoded(decoded, min_len=100,
                                                       pad=20))
    assert streamed == offline
    want = list(jax_stream(iter(batches), corpus, k=5, min_len=100, pad=20,
                           drain_every=8, max_lag=128))
    assert streamed == _clip_tuples(want)
    assert _clip_tuples(res["served"]) == streamed


def test_sharded_search_tiny_equals_jax_sharded_query():
    from vit_research_tpu.parallel.mesh import make_mesh as jax_mesh
    from vit_research_tpu.store.vector_store import Collection as JaxCol

    res = sharded_search.main(["--tiny", "--device", "cpu"])
    assert res["mesh"].devices.size == 8
    assert res["sharded"]["ids"] == res["flat"]["ids"]
    corpus, queries = res["corpus"], res["queries"]
    n = len(corpus)
    col = JaxCol("demo", space="cosine", device_quant="int8")
    col.upsert([f"row{i}" for i in range(n)], corpus,
               [{"bucket": i % 4} for i in range(n)])
    col.shard_device(jax_mesh())
    want = col.query(queries, n_results=4)
    assert res["sharded"]["ids"] == want["ids"]
    np.testing.assert_allclose(np.asarray(res["sharded"]["distances"]),
                               np.asarray(want["distances"]), rtol=0,
                               atol=1e-6)
    filt = col.query(queries[:1], n_results=4, where={"bucket": {"$eq": 0}})
    assert res["filtered"]["ids"] == filt["ids"]


def test_serving_tiny_replies_and_embeddings(tmp_path):
    res = serving.main(["--tiny", "--device", "cpu", str(tmp_path / "s")])
    paths, ops = res["paths"], res["ops"]
    want = res["engine"].embed_paths([paths[s] for s in
                                      live_segmentation.SIDES])
    np.testing.assert_array_equal(
        np.asarray(ops["embed"]["embeddings"], np.float32), want)
    assert ops["embed"]["ok"] and ops["query"]["ok"]
    assert ops["query"]["ids"][0][0].startswith("left")
    assert ops["stats"]["requests"] == {"embed": 1, "query": 1, "stats": 1}
    clips = [c for r in res["session"] for c in r["clips"]]
    events = [e for r in res["session"] for e in r.get("events", [])]
    assert [c["side"] for c in clips] == ["left", "right"]
    assert len(events) == len(clips)
    assert all(e["topk_chunks"] for e in events)
    for vid in (1, 2):
        assert res["followed"][vid] == [f"vid{vid}_clip_1_left",
                                        f"vid{vid}_clip_2_right"]
        with open(tmp_path / "s" / f"clips_game{vid}" / "events.jsonl") as f:
            assert len(f.read().splitlines()) == 2
    seg = res["stats"]["segment"]
    assert seg["sessions_started"] == seg["sessions_finished"] == 3
    assert seg["clips_emitted"] == seg["events_scored"] == 6
    assert seg["event_errors"] == 0


def test_pod_embedding_tiny_two_gloo_processes(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = pod_embedding.main(["--tiny", "--device", "cpu", "--out",
                              str(tmp_path / "gathered.npy")])
    single = pod_embedding.build_engine("cpu", True).embed_batch(
        res["frames"])
    assert res["gathered"].shape == (pod_embedding.N_FRAMES, 32)
    # the processes embed 48-frame shards, one process 16-frame batches
    # of all 96: equal rows up to the GEMMs' blocking
    np.testing.assert_allclose(res["gathered"], single, rtol=0,
                               atol=EMBED_TOL)
