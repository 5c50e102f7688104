"""Operation and byte counts against hand-worked values, and the share
arithmetic."""

import pytest

from harness import cost, manifest

MAN = manifest.load()


def cfg(name):
    return manifest.config(MAN, name)


@pytest.mark.parametrize("name,t,gflop", [
    ("vit-b16-224", 197, 35.13),      # 2 x 17.57 G MACs
    ("vit-b32-432x768", 313, 58.26),  # 13 x 24 patches of 32 x 32 x 3
])
def test_flops_per_frame(name, t, gflop):
    c = cfg(name)
    assert cost.tokens(c) == t
    # patch + 12 x (q/k/v/out + scores and mix + MLP), 2 flops a MAC
    k = c["patch_size"] ** 2 * 3
    hand = 2 * ((t - 1) * 768 * k + 12 * (4 * t * 768 ** 2
                                          + 2 * t * t * 768
                                          + 2 * t * 768 * 3072))
    assert cost.config_flops_per_frame(c) == hand
    assert cost.config_flops_per_frame(c) / 1e9 == pytest.approx(gflop,
                                                                 abs=0.01)


def test_flops_match_bench_py_default():
    # bench.py's ViT-B/16 arithmetic at its defaults
    assert cost.vit_flops_per_frame() == pytest.approx(35.13e9, rel=1e-3)


def test_attention_bound_is_pr_table_value():
    # PERF.md's kernel table: B = 256, H = 12, T = 197, dh = 64, f32:
    # 0.1850 ms, bound by bytes (q, k, v and the output once)
    s = cost.attention_bound_s(256, 12, 197, 64, "float32")
    assert s * 1e3 == pytest.approx(0.1850, abs=1e-4)
    nbytes = 4 * 256 * 12 * 197 * 64 * 4
    assert s == pytest.approx(nbytes / 3.35e12)
    assert cost.config_attention_bound_s(cfg("vit-b16-224"), 256) == \
        pytest.approx(12 * s)


def test_linear_bound_is_compute_bound_at_b256():
    c = cfg("vit-b16-224")
    m = 256 * 197
    flops = 12 * 2 * m * 768 * (4 * 768 + 2 * 3072)
    assert cost.linear_bound_s(c, 256) == pytest.approx(flops / 495e12)


def test_query_bound_reads_the_corpus_once():
    q, n, d = 256, 200_000, 768
    assert cost.query_flops(q, n, d) == pytest.approx(78.6432e9)
    # 614.4 MB at 3.35 TB/s beats 78.6 GFLOP at 495 TFLOP/s
    assert cost.query_bound_s(q, n, d) * 1e3 == pytest.approx(0.18340,
                                                              abs=1e-5)
    assert cost.query_bound_s(1 << 14, n, d) == pytest.approx(
        2 * (1 << 14) * n * d / 495e12)


def test_shares():
    assert cost.share_pct(1.0, 4.0) == 25.0
    assert cost.share_pct(1.0, 0.0) is None
    assert cost.mfu_pct(495e12, 2.0, "float32") == pytest.approx(50.0)
    assert cost.mfu_pct(989e12, 1.0, "bfloat16") == pytest.approx(100.0)
    assert cost.mfu_pct(1.0, 0.0, "float32") is None


@pytest.mark.parametrize("name,value,flagged", [
    ("attn_roofline", 104.9, True), ("mfu.embed", 100.5, True),
    ("linear_roofline", 100.0, False), ("query_roofline", None, False),
    ("h2d_ms.embed", 250.0, False),
])
def test_over_peak_is_flagged_not_clipped(name, value, flagged):
    assert cost.over_peak(name, value) is flagged
    # the share itself is never clipped at 100
    assert cost.share_pct(2.0, 1.0) == 200.0


def test_image_size_forms():
    assert cost.image_hw({"image_size": 224}) == (224, 224)
    assert cost.image_hw({"image_size": [432, 768]}) == (432, 768)
