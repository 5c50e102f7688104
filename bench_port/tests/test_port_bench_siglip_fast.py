"""The ``embed-siglip-so400m-f32`` and ``embed-fast-b16`` cells: each
whole run at a tiny size on the CPU through the port's plain paths, the
faults a cell can have planted under the timed path (``correct`` has to
come out false), their operation counts against hand-worked values, the
reference's pieces against their definitions, and the
``library_linear_ms.embed`` reader on hand-made records."""

import json

import numpy as np
import pytest
import torch

from harness import cost, fast, manifest, runner, siglip, trace, weights
from test_port_bench_cells import (SEED, _embed_answer_altered,
                                   _embed_half_left_out)
from test_port_bench_trace import GEMM, _Ev

SIGLIP = "embed-siglip-so400m-f32"
FAST = "embed-fast-b16"
#: heads of 24 (padded to 32 on the card), an MLP of 40 (off the GEMM's
#: tiles), patch 14 on a 2 x 2 grid: every part of the tower
TINY = {
    SIGLIP: ({"hidden_size": 48, "num_attention_heads": 2,
              "intermediate_size": 40, "num_hidden_layers": 2, "batch": 4,
              "image_size": 28, "patch_size": 14},
             {"pool_frames": 8, "sample_rows_per_call": 4}),
    # T = 17 merging 2 a block: 17, 15, 13. On the CPU the program and the
    # reference run the same float operations (rows and scales 1e-7
    # apart), so the limits are 1e-3 here, not the card's, which int8
    # rounding flips of the card's arithmetic set
    FAST: ({"hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 2, "intermediate_size": 64, "batch": 4,
            "image_size": 32, "patch_size": 8},
           {"pool_frames": 8, "sample_rows_per_call": 4, "tome_r": 2,
            "calibration_frames": 8,
            "limits": {"scale_gap": 1e-3, "embed_dist": 1e-3,
                       "mean_dist": 1e-3, "tie_dist": 1e-3}}),
}
MAN = manifest.load()


def run(name, traced=False, seed=SEED, after_setup=None):
    cfg, t = TINY[name]
    return runner.run(name, seed, 0.3, traced, device="cpu", cfg_over=cfg,
                      traffic_over=t, after_setup=after_setup)


@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_runs_and_is_correct(name):
    out = run(name)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "embed_fps"}
    for c in out["checks"].values():
        assert 0 <= c["value"] <= c["limit"]
    launches = out["launches"]
    assert set(launches) >= {"kernel_a", "kernel_b", "linear"}
    json.dumps(out)


@pytest.mark.parametrize("name", sorted(TINY))
def test_traced_cell_reads_nothing_off_the_card(name):
    out = run(name, traced=True)
    assert out["correct"] and out["metrics"] == {}


def _fast_scales_reversed(entry):
    dg = entry.engine.model.dot_general
    dg.scales = tuple(reversed(dg.scales))
    dg._on_device.clear()


def _fast_answer_altered(entry):
    """One row moved by 0.05, past the int8 path's own spread (a correct
    row lies 0.018-0.025 from the reference on the card)."""
    fwd = entry.engine._forward

    def altered(images):
        out = fwd(images).clone()
        out[0, 0] += 5e-2
        return out
    entry.engine._forward = altered


def _fast_calibration_shifted(entry):
    """Scales recorded one site late (a wrong site order), and used so."""
    dg = entry.engine.model.dot_general
    entry.scales = dg.scales = dg.scales[1:] + dg.scales[:1]
    dg._on_device.clear()


def _fast_calibration_on_other_activations(entry):
    """Scales 10% under the definition's, as a calibration from another
    statistic or other activations would give, and used so."""
    dg = entry.engine.model.dot_general
    entry.scales = dg.scales = tuple(0.9 * s for s in dg.scales)
    dg._on_device.clear()


def _fast_no_merging(entry):
    for block in entry.engine.model.blocks:
        block.r = 0


def _siglip_no_head_residual(entry):
    """The head's y = a + MLP(LN(a)) made MLP(LN(a))."""
    head = entry.engine.model.head
    seen = {}
    head.out.register_forward_hook(lambda mod, args, out: seen.update(a=out))
    mlp = head.mlp

    class Less(torch.nn.Module):
        def forward(self, y):
            return mlp(y) - seen["a"]
    head.mlp = Less()


@pytest.mark.parametrize("name,fault", [
    (SIGLIP, _embed_half_left_out),
    (SIGLIP, _embed_answer_altered),
    (SIGLIP, _siglip_no_head_residual),
    (FAST, _embed_half_left_out),
    (FAST, _fast_answer_altered),
    (FAST, _fast_scales_reversed),
    (FAST, _fast_no_merging),
    (FAST, _fast_calibration_shifted),
    (FAST, _fast_calibration_on_other_activations),
])
def test_a_planted_fault_is_not_correct(name, fault):
    out = run(name, after_setup=fault)
    assert not out["correct"], out["checks"]


def test_siglip_weights_are_the_ports_parameters():
    from harness.entries.embed_siglip import vit_config
    from vit_research_tpu_torch.models.vit import VisionTransformer

    cfg = {**manifest.config(MAN, "siglip-so400m-p14-384"), **TINY[SIGLIP][0]}
    w = siglip.weights(cfg, SEED, "cpu")
    model = VisionTransformer(vit_config(cfg))
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        k: tuple(v.shape) for k, v in model.named_parameters()}


def test_siglip_counts():
    cfg = manifest.config(MAN, "siglip-so400m-p14-384")
    assert siglip.tokens(cfg) == 729
    t, d, m, k = 729, 1152, 4304, 14 * 14 * 3
    hand = 2 * (t * d * k + 27 * (4 * t * d * d + 2 * t * t * d
                                  + 2 * t * d * m)
                + 2 * d * d + 2 * t * d * d + 2 * t * d + 2 * d * m)
    assert siglip.flops_per_frame(cfg) == hand
    assert siglip.flops_per_frame(cfg) / 1e9 == pytest.approx(670, abs=1)
    rows = 64 * t
    # compute-bound at B = 64: every product's operations over the peak,
    # but the head's short ones, which are bound by their bytes
    big = 27 * 2 * rows * d * (4 * d + 2 * m) + 2 * 2 * rows * d * d
    assert siglip.linear_bound_s(cfg, 64) == pytest.approx(
        big / 495e12, rel=1e-3)
    assert siglip.attention_bound_s(cfg, 64) == pytest.approx(
        27 * cost.attention_bound_s(64, 16, 729, 72, "float32"))


def test_fast_counts():
    cfg = manifest.config(MAN, "vit-b16-224")
    ts = fast.merged_tokens(197, 16, 12)
    assert ts == [197, 181, 165, 149, 133, 117, 101, 85, 69, 53, 37, 21, 11]
    d, m = 768, 3072
    hand = 196 * d * 768 + sum(4 * t * d * d + 2 * t * t * d
                               + 2 * ta * d * m
                               for t, ta in zip(ts[:-1], ts[1:]))
    assert fast.flops_per_frame(cfg, 16) == 2 * hand
    assert fast.attention_bound_s(cfg, 256, 16) == pytest.approx(sum(
        cost.attention_bound_s(256, 12, t, 64, "float32") for t in ts[:-1]))


def test_int8_dense_is_exact_integer_products():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(5, 3072, generator=g) * 3
    w = torch.randn(7, 3072, generator=g) * 0.02
    b = torch.randn(7, generator=g)
    s = torch.tensor(float(x.abs().max()) / 127)
    got = fast.int8_dense(x, w, b, s)
    rs = w.abs().amax(1) / 127
    xq = torch.clamp(torch.round(x / s), -127, 127).long()
    wq = torch.clamp(torch.round(w / rs[:, None]), -127, 127).long()
    acc = (xq @ wq.T).to(torch.float32)  # int64: exact
    assert torch.equal(got, acc * (s * rs) + b)
    # 7-bit activations: another (coarser) result
    assert not torch.equal(fast.int8_dense(x, w, b, s, act_bits=7), got)


def test_calibration_is_the_dynamic_forwards_abs_max():
    """One block, no merging: q, k and v read the same LayerNorm output,
    whose max|x| / 127 their scales are; the scales of two blocks of
    frames are the larger of each; scale_gap is relative."""
    cfg = {**manifest.config(MAN, "vit-b16-224"), **TINY[FAST][0],
           "num_hidden_layers": 1}
    w = weights.vit_weights(cfg, SEED, "cpu")
    frames = np.random.default_rng(3).integers(0, 256, (4, 32, 32, 3),
                                               dtype=np.uint8)
    one = fast.calibrate(w, cfg, frames[:2], 0, "cpu")
    both = fast.calibrate(w, cfg, frames, 0, "cpu", block=2)
    other = fast.calibrate(w, cfg, frames[2:], 0, "cpu")
    assert len(one) == 6 and one[0] == one[1] == one[2]
    assert both == tuple(max(a, b) for a, b in zip(one, other))
    seen = []
    fast.fast_embed(w, cfg, torch.from_numpy(frames[:2]), None, 0,
                    record=seen)
    assert one == tuple(float(m) / 127.0 for m in seen)
    assert fast.scale_gap(one, one) == 0.0
    assert fast.scale_gap([1.1 * s for s in one], one) == pytest.approx(0.1)
    assert fast.scale_gap(one[:5], one) == float("inf")


def test_merge_keeps_the_class_token_and_reports_margins():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 9, 4, generator=g)
    metric = torch.randn(2, 9, 3, generator=g)
    sizes = torch.ones(2, 9)
    x2, s2, margin = fast._merge(x, metric, sizes, 2)
    assert x2.shape == (2, 7, 4) and torch.equal(x2[:, 0], x[:, 0])
    assert torch.allclose(s2.sum(1), torch.full((2,), 9.0))
    assert (margin > 0).all() and torch.isfinite(margin).all()
    # an exact tie of two sources' best scores at the merge boundary
    metric[:, 2] = metric[:, 4]
    _, _, m = fast._merge(x, metric, sizes, 1)
    assert m.shape == (2,)


def test_library_linear_reader():
    us = 1000
    lib = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_cublas"
    ev = [_Ev("bench.embed_batch", 0, 1000 * us, False),
          _Ev("gemm_f32_wg(CUtensorMap_st, LinearArgs)", 0, 300 * us, True),
          _Ev(lib, 300 * us, 200 * us, True),
          _Ev(GEMM, 600 * us, 100 * us, True)]
    rec = trace.Records(ev, trace.load_groups())
    layers = 27
    facts = {"config": {"num_hidden_layers": layers},
             "info": {"batches": 2, "launches": {
                 "linear": {"gemm_f32_wg": 220},
                 "linear_declined_shape": 2 * layers * 2}}}
    read = runner._reader("library_linear_ms.embed")
    assert read(rec, facts) == pytest.approx(0.15)  # 300 us over 2 batches
    facts["info"]["launches"]["linear_declined_shape"] = 0
    assert read(rec, facts) is None  # a program that counts none


def test_cells_in_the_manifest():
    for name in TINY:
        w = manifest.cell(MAN, name)
        assert w["chips"] == 1 and manifest.workload(name)["limits"]
        names = {m["name"] for m in manifest.reported(MAN["per_layer"], name)}
        assert {"mfu.embed", "attn_roofline", "device_idle.embed"} <= names
    assert "linear_roofline" in {m["name"] for m in manifest.reported(
        MAN["per_layer"], SIGLIP)}
    assert "linear_roofline" not in {m["name"] for m in manifest.reported(
        MAN["per_layer"], FAST)}
    t = manifest.workload(FAST)
    base = manifest.workload("embed-b16-f32")
    assert {k: t[k] for k in ("pool_frames", "noise", "brightness", "tint",
                              "sample_rows_per_call")} == {
        k: base[k] for k in ("pool_frames", "noise", "brightness", "tint",
                             "sample_rows_per_call")}


def test_weights_of_the_fast_cell_are_the_b16_cells():
    cfg = {**manifest.config(MAN, "vit-b16-224"), **TINY[FAST][0]}
    a = weights.vit_weights(cfg, SEED, "cpu")
    assert all(np.isfinite(v.numpy()).all() for v in a.values())
