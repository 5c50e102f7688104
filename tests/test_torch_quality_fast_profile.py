"""The port's fast-profile quality dossier
(vit_research_tpu_torch/examples/quality_fast_profile.py): the tiny
dossier end to end with tests/test_quality_fast_profile.py's assertions,
``build_world``'s bytes against the JAX builder's, and the metric helpers
(``_matched_pairs``, ``segmentation_metrics``, ``retrieval_overlap``)
against the JAX example's on the same numpy inputs. The JAX example is
loaded by path: it imports jax only inside its functions.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from vit_research_tpu_torch.examples import quality_fast_profile as qfp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tiny world of the JAX dossier's test
TINY_WORLD = dict(possessions=2, frames_per=16, size=(32, 32),
                  event_start=2, event_len=3)


@pytest.fixture(scope="module")
def jax_qfp():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_fast_profile",
        os.path.join(REPO, "examples", "quality_fast_profile.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tiny_dossier_end_to_end(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    qfp.main(["--tiny", "--device", "cpu", "--possessions", "2",
              "--frames-per", "16", "--stage2-epochs", "2", "--out",
              str(out), "--root", str(tmp_path / "world")])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["metric"] == "quality_fast_profile"
    rows = [json.loads(line) for line in open(out)]
    by_name = {row["variant"]: row for row in rows}
    assert set(by_name) == {"parity", "tome2", "strided2",
                            "strided2_refined", "tome2_strided2",
                            "int8static"}
    assert set(summary["variants"]) == set(by_name)
    ref = by_name["strided2_refined"]
    assert ref["stride_refine"] == "auto"
    assert 0.0 <= ref["refined_frame_frac"] <= 1.0
    assert ref["exact_embed_frac"] <= 1.0
    # refinement only swaps interpolations for exact embeddings, so
    # fidelity can't drop below the plain strided run's
    assert (ref["fidelity_cos_mean"]
            >= by_name["strided2"]["fidelity_cos_mean"] - 1e-6)
    par = by_name["parity"]
    # parity vs itself is exact by construction
    assert par["fidelity_cos_mean"] == 1.0
    assert par["retrieval_top8_overlap"] == 1.0
    for row in rows:
        assert 0.0 <= row["clip_f1"] <= 1.0
        assert 0.0 <= row["retrieval_top8_overlap"] <= 1.0
        assert row["scored_clips"] >= 1
        # every variant scored the same truth world
        assert row["n_true"] == par["n_true"]
    assert by_name["int8static"]["calibration"] == "representative-frames"


def _relative_files(root):
    got = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                got[os.path.relpath(p, root)] = fh.read()
    return got


def _relative_world(world, root):
    def rel(p):
        return os.path.relpath(p, root)

    return {
        "frames": {v: [rel(p) for p in ps]
                   for v, ps in world["frames"].items()},
        "clip_labels": {rel(k): v for k, v in world["clip_labels"].items()},
        "events": {rel(k): v for k, v in world["events"].items()},
        "clip_ranges": {k: (first, side, [rel(p) for p in ps])
                        for k, (first, side, ps)
                        in world["clip_ranges"].items()},
        "manual": {s: list(v) for s, v in world["manual"].intervals.items()},
        "clip_template": rel(world["clip_template"])}


@pytest.mark.parametrize("kw", [
    TINY_WORLD,
    dict(possessions=2, frames_per=24, entropy="high"),  # 112 x 112
], ids=["tiny", "default-size-high-entropy"])
def test_build_world_bytes_equal_jax(tmp_path, jax_qfp, kw):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    wp = qfp.build_world(str(mine), **kw)
    wj = jax_qfp.build_world(str(theirs), **kw)
    assert _relative_world(wp, str(mine)) == _relative_world(wj, str(theirs))
    files = _relative_files(str(mine))
    assert len(files) == sum(len(v) for v in wp["frames"].values()) + \
        kw["possessions"] * kw["frames_per"] * 2
    assert files == _relative_files(str(theirs))


def test_matched_pairs_equal_jax(jax_qfp):
    from vit_research_tpu.segment.clips import ClipInterval as JaxClip
    from vit_research_tpu_torch.segment.clips import ClipInterval

    rng = np.random.default_rng(0)
    for _ in range(20):
        spans = [(("left", "right")[int(rng.integers(2))],
                  int(a), int(a + rng.integers(5, 40)))
                 for a in rng.integers(0, 200, size=int(rng.integers(1, 7)))]
        true = [(("left", "right")[i % 2], 30 * i, 30 * i + 20)
                for i in range(5)]

        def run(fn, cls):
            pairs = fn([cls(s, a, b) for s, a, b in spans],
                       [cls(s, a, b) for s, a, b in true])
            return [((p.side, p.start, p.end), (t.side, t.start, t.end))
                    for p, t in pairs]

        assert run(qfp._matched_pairs, ClipInterval) == \
            run(jax_qfp._matched_pairs, JaxClip)


def test_segmentation_and_retrieval_metrics_equal_jax(tmp_path, jax_qfp):
    wp = qfp.build_world(str(tmp_path / "port"), **TINY_WORLD)
    wj = jax_qfp.build_world(str(tmp_path / "jax"), **TINY_WORLD)
    eng = qfp.build_engine(0, tiny=True, device="cpu")
    parity = {v: eng.embed_paths(wp["frames"][v]) for v in (1, 2)}
    rng = np.random.default_rng(1)
    # noisy embedding sets: at 0.3 the decoded boundaries drift (~2
    # frames, frame accuracy ~0.8), at 0.6 the clips no longer match
    noisy = [{v: e + scale * rng.normal(size=e.shape).astype(np.float32)
              for v, e in parity.items()} for scale in (0.3, 0.6)]
    for embs in [parity] + noisy:
        got = qfp.segmentation_metrics(wp, embs, 1, 2, min_len=4,
                                       device="cpu")
        want = jax_qfp.segmentation_metrics(wj, embs, 1, 2, min_len=4)
        assert got == want
    store = rng.normal(size=(40, 16)).astype(np.float32)
    pq = rng.normal(size=(12, 16)).astype(np.float32)
    for scale in (0.0, 0.3, 3.0):
        vq = pq + scale * rng.normal(size=pq.shape).astype(np.float32)
        assert qfp.retrieval_overlap(store, pq, vq) == \
            jax_qfp.retrieval_overlap(store, pq, vq)


def test_segmentation_metrics_defaults_to_the_card(tmp_path, monkeypatch,
                                                   jax_qfp):
    """Without ``device`` the kNN + HMM asks for the card and raises where
    there is none (no silent CPU run); with ``device="cpu"`` it still
    equals the JAX helper."""
    wp = qfp.build_world(str(tmp_path / "port"), **TINY_WORLD)
    wj = jax_qfp.build_world(str(tmp_path / "jax"), **TINY_WORLD)
    rng = np.random.default_rng(3)
    embs = {v: rng.normal(size=(len(wp["frames"][v]), 16)).astype(np.float32)
            for v in (1, 2)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        qfp.segmentation_metrics(wp, embs, 1, 2, min_len=4)
    assert qfp.segmentation_metrics(wp, embs, 1, 2, min_len=4,
                                    device="cpu") == \
        jax_qfp.segmentation_metrics(wj, embs, 1, 2, min_len=4)
