"""Each cell's whole run at a tiny size on the CPU, through the port's
plain paths (the harness's look for a card skipped), and each fault a
cell can have planted under the timed path: ``correct`` has to come out
false."""

import json

import numpy as np
import pytest
import torch

from conftest import TINY
from harness import manifest, runner, traffic, weights

SEED = 2 ** 33 + 5  # seeds may pass 32 bits


def run(name, traced=False, seed=SEED, after_setup=None):
    cfg, t = TINY[name]
    return runner.run(name, seed, 0.3, traced, device="cpu", cfg_over=cfg,
                      traffic_over=t, after_setup=after_setup)


@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_runs_and_is_correct(name):
    out = run(name)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"setup_s"} and len(out["metrics"]) == 2
    for c in out["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    json.dumps(out)


@pytest.mark.parametrize("name", sorted(TINY))
def test_traced_cell_reads_nothing_off_the_card(name):
    out = run(name, traced=True)
    assert out["correct"]
    # a CPU run has no device trace: no device metric is written
    assert out["metrics"] == {}
    assert out["device"]["busy_s"] == 0 and out["breakdown"]["device_ops"] == []


def test_seed_makes_the_inputs():
    t = {**manifest.workload("embed-b16-f32"), **TINY["embed-b16-f32"][1]}
    a = traffic.frames((32, 32), t, SEED, "cpu")
    assert np.array_equal(a, traffic.frames((32, 32), t, SEED, "cpu"))
    assert not np.array_equal(a, traffic.frames((32, 32), t, SEED + 1, "cpu"))
    assert a.dtype == np.uint8 and 60 <= a.min() and a.max() <= 255


def test_store_rows_hold_runs_and_frozen_frames():
    t = {**manifest.workload("search-200k-f32"), **TINY["search-200k-f32"][1]}
    rows, ids, metas = traffic.game_rows({**t, "frozen_share": 0.05}, 32,
                                         SEED, "cpu")
    assert rows.shape == (3000, 32) and len(ids) == len(set(ids)) == 3000
    same = np.all(rows[1:] == rows[:-1], axis=1)
    assert 0.02 < same.mean() < 0.08  # exact ties
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    cos = np.sum(unit[1:] * unit[:-1], axis=1)
    assert np.median(cos) > 0.95  # consecutive frames are near-duplicates
    assert metas[0] == {"vid_num": 1, "frame_num": 1, "side": metas[0]["side"],
                        "t_norm": 0.0}


def test_weights_are_the_ports_parameters():
    from harness.entries.embed import vit_config
    from vit_research_tpu_torch.models.vit import VisionTransformer

    cfg = {**manifest.config(manifest.load(), "vit-b32-432x768"),
           **TINY["embed-b32-432-f32"][0]}
    w = weights.vit_weights(cfg, SEED, "cpu")
    model = VisionTransformer(vit_config(cfg))
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        k: tuple(v.shape) for k, v in model.named_parameters()}


# ---- planted faults


def _embed_half_left_out(entry):
    fwd = entry.engine._forward

    def half(images):
        out = fwd(images[: len(images) // 2])
        return torch.cat([out, out.mean(0, keepdim=True).expand(
            len(images) - len(out), -1)])
    entry.engine._forward = half


def _embed_answer_altered(entry):
    fwd = entry.engine._forward

    def altered(images):
        out = fwd(images).clone()
        out[0, 0] += 1e-3
        return out
    entry.engine._forward = altered


def _search_half_left_out(entry):
    col = entry.col
    keep = col._ids[: len(col._ids) // 2]
    real = col._query_device

    def half(q, mask, k):
        mask = mask.copy()
        mask[len(keep):] = False
        return real(q, mask, k)
    col._query_device = half


def _search_answer_altered(entry):
    col = entry.col
    real = col._query_device

    def altered(q, mask, k):
        scores, idx = real(q, mask, k)
        idx = idx.copy()
        idx[0, 0] = (idx[0, 0] + len(col._ids) // 2) % len(col._ids)
        return scores, idx
    col._query_device = altered


def _search_queries_halved(entry):
    col = entry.col
    real = col._query_device

    def halved(q, mask, k):
        h = len(q) // 2
        scores, idx = real(q[:h], mask, k)
        return np.concatenate([scores, scores]), np.concatenate([idx, idx])
    col._query_device = halved


@pytest.mark.parametrize("name,fault", [
    ("embed-b16-f32", _embed_half_left_out),
    ("embed-b16-f32", _embed_answer_altered),
    ("embed-b32-432-f32", _embed_half_left_out),
    ("embed-b32-432-f32", _embed_answer_altered),
    ("search-200k-f32", _search_half_left_out),
    ("search-200k-f32", _search_answer_altered),
    ("search-200k-f32", _search_queries_halved),
])
def test_a_planted_fault_is_not_correct(name, fault):
    out = run(name, after_setup=fault)
    assert not out["correct"], out["checks"]
