"""The port's fast profile against the JAX package, on the CPU at tiny
sizes: int8 GEMMs (ops/quant.py), ToMe (ops/tome.py, the ToMe blocks and
kernel B's key bias in its plain version), strided embedding
(parallel/embed.py), ``calibrate-int8``, the ``segment`` stride flags and
the daemon's coalescer under the fast env.

The same numpy inputs go through both packages (weights converted with
models/convert.py). Tolerances:

- int8 products: both sides quantize to the same int8 values and sum
  exact int32 products; the float rescale may round differently by one
  ulp (``assert_array_max_ulp``, 1 ulp).
- straight-through gradients: the unquantized product's vjp, f32 sums in
  other orders (1e-6).
- calibration scales: per-site abs-max of activations that went through
  a 2-layer forward on both sides (rtol 1e-5).
- bipartite_merge: equal merge sets; x' and sizes' to 1e-6 (f32 sums of
  a few terms in another order).
- ToMe ViT in f32: endpoints 1e-5, like the plain backbone's parity
  tests; int8 ViTs: L2-normalised embeddings 1e-3 (an ulp in an
  activation may move one int8 value by one step).
- strided embedding and its interpolation: 1e-6.
- the daemon's merged batch against each request alone: 1e-5 (f32 GEMMs
  over other batch shapes).
"""

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_research_tpu import cli as jax_cli
from vit_research_tpu.cli import common as jax_common
from vit_research_tpu.data import labels as jax_labels
from vit_research_tpu.data import synthetic
from vit_research_tpu.models import vit as jax_vit
from vit_research_tpu.ops import quant as jq
from vit_research_tpu.ops import tome as jtome
from vit_research_tpu.parallel import embed as jax_embed
from vit_research_tpu.utils.configs import ViTConfig
from vit_research_tpu_torch import cli, serve
from vit_research_tpu_torch.cli import common
from vit_research_tpu_torch.models import convert
from vit_research_tpu_torch.models import vit as tvit
from vit_research_tpu_torch.ops import attention as attn
from vit_research_tpu_torch.ops import quant as tq
from vit_research_tpu_torch.ops import tome as ttome
from vit_research_tpu_torch.parallel import embed as tembed

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = ViTConfig(image_size=(32, 32), patch_size=8, hidden_size=64,
                 num_layers=2, num_heads=4, mlp_dim=128)
ENV_KEYS = ("VRT_TOME_R", "VRT_GEMM_QUANT", "VRT_GEMM_SCALES",
            "VRT_GRAYSCALE", "VRT_TINY")


@pytest.fixture(scope="module")
def params():
    """JAX params of TINY (init_vit's seed-0 init, jitted): ToMe and int8
    models share the plain tree."""
    dummy = jnp.zeros((1, *TINY.image_size, 3), jnp.float32)
    return jax.jit(jax_vit.VisionTransformer(TINY).init)(
        jax.random.PRNGKey(0), dummy)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 32, 32, 3)).astype(np.float32)


def _jax_forward(cfg, params, x):
    """The JAX forward: jitted in f32; eager with int8 GEMMs, where XLA's
    rewrites of the rescale under jit move results by ulps, and an ulp in
    an activation can move an int8 value of the next layer by one step."""
    apply = jax_vit.VisionTransformer(cfg).apply
    if cfg.gemm_quant is None:
        apply = jax.jit(apply)
    return apply(params, jnp.asarray(x))


@pytest.fixture(scope="module")
def jax_scales(params):
    """JAX's static scales of TINY on ``_images(3, 4)``: calibration reads
    concrete values, so this is the file's one eager JAX forward."""
    cfg = dataclasses.replace(TINY, gemm_quant="int8-static")
    with jq.calibration_mode() as scales:
        jax_vit.VisionTransformer(cfg).apply(params,
                                             jnp.asarray(_images(3, 4)))
    return tuple(scales)


def _torch_model(cfg, params):
    m = tvit.VisionTransformer(cfg)
    m.load_state_dict(convert.params_to_state_dict(params, TINY))
    return m.eval()


# --------------------------------------------------------------- quant

# (x shape, JAX kernel shape, dimension numbers, port x and weight views)
_DN = {
    "qkv": ((2, 17, 64), (64, 4, 16), (((2,), (0,)), ((), ()))),
    "out": ((2, 17, 4, 16), (4, 16, 64), (((2, 3), (0, 1)), ((), ()))),
    "fc1": ((2, 17, 64), (64, 128), (((2,), (0,)), ((), ()))),
    "fc2": ((2, 17, 128), (128, 64), (((2,), (0,)), ((), ()))),
}


def _site(name, seed):
    """Numpy x and JAX-layout kernel of a dense site, and the port's
    (..., K) x and (N, K) weight of the same values."""
    xs, ks, dn = _DN[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    k = (rng.standard_normal(ks) * 0.1).astype(np.float32)
    n_contract = len(dn[0][1])
    kin = int(np.prod(ks[:n_contract]))
    tx = torch.from_numpy(x.reshape(2, 17, kin))
    tw = torch.from_numpy(k.reshape(kin, -1).T.copy())
    return x, k, dn, tx, tw


@pytest.mark.parametrize("site", sorted(_DN))
def test_int8_dot_general_matches_jax(site):
    x, k, dn, tx, tw = _site(site, 1)
    # eager, as the reference function is written: under jit XLA may
    # reassociate the rescale products (a few ulps)
    want = np.asarray(jq.int8_dot_general(jnp.asarray(x), jnp.asarray(k),
                                          dn)).reshape(2, 17, -1)
    got = tq.int8_dot_general(tx, tw).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # static: one activation scale for the call site
    s = float(np.abs(x).max()) / 127.0 * 0.8  # some values clip
    want = np.asarray(jq.StaticInt8DotGeneral((s,))(
        jnp.asarray(x), jnp.asarray(k), dn)).reshape(2, 17, -1)
    got = tq.StaticInt8DotGeneral([s])(tx, tw).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("site", ["qkv", "out"])
def test_int8_straight_through_gradients_match_jax_vjp(site, static):
    x, k, dn, tx, tw = _site(site, 2)
    g = np.random.default_rng(3).standard_normal(
        (2, 17, 64)).astype(np.float32)
    op = (jq.StaticInt8DotGeneral((0.02,)) if static
          else jq.int8_dot_general)
    def grads(a, b, ct):
        return jax.vjp(lambda a, b: op(a, b, dn), a, b)[1](ct)

    dx, dk = jax.jit(grads)(jnp.asarray(x), jnp.asarray(k), jnp.asarray(
        g.reshape((2, 17) + k.shape[len(dn[0][1]):])))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    top = tq.StaticInt8DotGeneral([0.02]) if static else tq.int8_dot_general
    top(tx, tw).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(dx).reshape(tx.shape),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tw.grad.numpy(), np.asarray(dk).reshape(tw.shape[1], -1).T,
        rtol=0, atol=1e-6)


def test_calibration_records_the_same_scales_as_jax(params, jax_scales):
    cfg = dataclasses.replace(TINY, gemm_quant="int8-static")
    x = _images(3, 4)
    want = jax_scales
    tm = _torch_model(cfg, params)
    with tq.calibration_mode() as got, torch.no_grad():
        tm(torch.from_numpy(x))
        tm(torch.from_numpy(x[:1]))  # a second forward max-reduces
    assert len(got) == len(want) == 6 * TINY.num_layers
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _message(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no error raised")


def test_quant_refusals_match_jax(params):
    x = torch.zeros(2, 17, 64)
    w = torch.zeros(8, 64)
    jx, jk = jnp.zeros((2, 17, 64)), jnp.zeros((64, 8))
    dn = _DN["fc1"][2]

    def reenter(mod):
        with mod.calibration_mode():
            with mod.calibration_mode():
                pass

    def exhausted_jax():
        op = jq.StaticInt8DotGeneral((0.1,))
        op(jx, jk, dn)
        op(jx, jk, dn)

    def exhausted_port():
        op = tq.StaticInt8DotGeneral((0.1,))
        op(x, w)
        op(x, w)

    bad = dataclasses.replace(TINY, gemm_quant="int8-static",
                              gemm_quant_scales=(0.1,) * 7)
    img = np.zeros((1, 32, 32, 3), np.float32)
    cases = [
        (lambda: reenter(jq), lambda: reenter(tq)),
        (lambda: jq.StaticInt8DotGeneral(())(jx, jk, dn),
         lambda: tq.StaticInt8DotGeneral(())(x, w)),
        (exhausted_jax, exhausted_port),
        (lambda: jax_vit.VisionTransformer(bad).apply(params, img),
         lambda: tvit.VisionTransformer(bad)),
    ]
    for jfn, tfn in cases:
        assert _message(tfn) == _message(jfn)
    # init traces the static model with empty scales (the reference routes
    # init through the dynamic product); the port builds no graph to trace


# ---------------------------------------------------------------- ToMe


def _merge_inputs(seed, b=3, t=17, d=8, dm=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    # a token id in the last feature: kept rows show which tokens survive
    x[..., -1] = np.arange(t)
    metric = rng.standard_normal((b, t, dm)).astype(np.float32)
    sizes = rng.integers(1, 4, (b, t)).astype(np.float32)
    return x, metric, sizes


@pytest.mark.parametrize("r", [1, 2, 4, 100])
def test_bipartite_merge_matches_jax(r):
    x, metric, sizes = _merge_inputs(r)
    wx, ws = jax.jit(jtome.bipartite_merge, static_argnums=3)(
        jnp.asarray(x), jnp.asarray(metric), jnp.asarray(sizes), r)
    gx, gs = ttome.bipartite_merge(torch.from_numpy(x),
                                   torch.from_numpy(metric),
                                   torch.from_numpy(sizes), r)
    wx, ws, gx, gs = map(np.asarray, (wx, ws, gx, gs))
    r_eff = min(r, 8)  # 9 sources, CLS never merged
    assert gx.shape == (3, 17 - r_eff, 8)
    keep = 9 - r_eff
    # the kept sources are the same tokens, unchanged; the merge sets and
    # weighted means agree
    np.testing.assert_array_equal(gx[:, :keep], wx[:, :keep])
    np.testing.assert_allclose(gx, wx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
    assert np.all(gx[:, 0, -1] == 0) and np.all(gs[:, 0] == sizes[:, 0])
    np.testing.assert_allclose(gs.sum(1), sizes.sum(1), rtol=1e-6)


def test_bipartite_merge_ties_and_edges():
    # duplicate tokens: every cosine ties at 1, so the first index wins
    # and a stable sort keeps source order; the merge of equals is exact
    x = np.ones((2, 9, 4), np.float32)
    metric = np.ones((2, 9, 3), np.float32)
    sizes = np.ones((2, 9), np.float32)
    args = [torch.from_numpy(a) for a in (x, metric, sizes)]
    gx, gs = ttome.bipartite_merge(*args, 3)
    wx, ws = jax.jit(jtome.bipartite_merge, static_argnums=3)(
        *map(jnp.asarray, (x, metric, sizes)), 3)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gx.numpy(), np.ones((2, 6, 4)))
    assert ttome.match(args[1], 3)[0].tolist() == [[1, 2, 3]] * 2
    # r clamps to len(src) - 1; CLS alone never merges
    gx, gs = ttome.bipartite_merge(*args, 50)
    assert gx.shape == (2, 5, 4) and gs[:, 0].tolist() == [1.0, 1.0]
    one = [a[:, :1] for a in args]
    assert ttome.bipartite_merge(*one, 4)[0] is one[0]
    # ViT-B/16 at r = 16: the last merge clamps to 10 of 11 sources
    assert ttome.merged_token_counts(197, 16, 12) == [
        197, 181, 165, 149, 133, 117, 101, 85, 69, 53, 37, 21, 11]


def test_biased_attention_matches_jax_einsum_path(params):
    """The port's MHA with a ToMe key bias (kernel B's plain version on
    the CPU) against the JAX module's einsum path on equal weights."""
    p = params["params"]["block_0"]["attn"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
    log_size = np.log(rng.integers(1, 6, (2, 17))).astype(np.float32)
    mha = jax_vit.MultiHeadSelfAttention(num_heads=4)
    want, _, want_metric = jax.jit(
        lambda p, x, ls: mha.apply({"params": p}, x, log_size=ls,
                                   output_metric=True))(
        p, jnp.asarray(x), jnp.asarray(log_size))
    tm = _torch_model(TINY, params)
    with torch.no_grad():
        got, _, metric = tm.blocks[0].attn(
            torch.from_numpy(x), log_size=torch.from_numpy(log_size),
            output_metric=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(metric.numpy(), np.asarray(want_metric),
                               rtol=0, atol=1e-6)
    # the kernel's public entry validates the bias before it routes
    q = torch.zeros(2, 4, 17, 16)
    for bad in (torch.zeros(2, 16), torch.zeros(2, 17, dtype=torch.float64),
                torch.zeros(17, 2).T):
        with pytest.raises(ValueError):
            attn.multi_head_attention(q, q, q, key_bias=bad)


@pytest.mark.parametrize("quant,r", [(None, 2), (None, 4), ("int8", 0),
                                     ("int8-static", 0)])
def test_fast_vit_matches_jax(params, jax_scales, quant, r):
    x = _images(3, 6)
    cfg = dataclasses.replace(TINY, tome_r=r, gemm_quant=quant)
    if quant == "int8-static":
        cfg = dataclasses.replace(cfg, gemm_quant_scales=jax_scales)
    want = _jax_forward(cfg, params, x)
    with torch.no_grad():
        got = _torch_model(cfg, params)(torch.from_numpy(x))
    assert set(got) == set(want)
    if r:
        np.testing.assert_array_equal(got["token_sizes"].numpy(),
                                      np.asarray(want["token_sizes"]))
    if quant is None:
        for key in want:
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=1e-5,
                                       atol=1e-5)
    else:
        # the LayerNorm outputs before the GEMMs differ by ulps (flax's
        # E[x^2] - E[x]^2 variance), and an ulp at a rounding boundary
        # moves an int8 value by one step: ~1/127 of one term of a sum
        def unit(a):
            a = np.asarray(a)
            return a / np.linalg.norm(a, axis=-1, keepdims=True)
        g, w = unit(got["pooled"]), unit(want["pooled"])
        assert np.sum(g * w, axis=-1).min() >= 0.9999
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2)


def test_tome_gap_pooler_weights_by_size_and_loads_plain_weights(params):
    x = _images(2, 7)
    cfg = dataclasses.replace(TINY, tome_r=3, pooler="gap")
    want = _jax_forward(cfg, params, x)
    tm = _torch_model(cfg, params)
    # the same state_dict keys as the plain model
    assert tm.state_dict().keys() == _torch_model(TINY, params) \
        .state_dict().keys()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got["pooled"].numpy(),
                               np.asarray(want["pooled"]), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="incompatible with remat"):
        tvit.VisionTransformer(dataclasses.replace(
            TINY, tome_r=2, output_attention_scores=True))
    with pytest.raises(ValueError, match="unknown gemm_quant"):
        tvit.VisionTransformer(dataclasses.replace(TINY, gemm_quant="fp8"))


# ----------------------------------------------------- strided embedding


class _KeyEngine:
    """Stands in for an engine: each path's embedding is a fixed row of
    a seeded table (both packages' strided embedding only call
    ``embed_paths`` and read ``out_dim`` / ``l2_normalize``)."""

    def __init__(self, n, d=16, seed=0, l2_normalize=True):
        rng = np.random.default_rng(seed)
        walk = np.cumsum(rng.standard_normal((n, d)) * 0.05, axis=0) + 1.0
        if n > 6:
            walk[n // 2:n // 2 + 3] = rng.standard_normal((3, d))  # event
        self.table = walk.astype(np.float32)
        self.out_dim = d
        self.l2_normalize = l2_normalize

    def embed_paths(self, paths, num_workers=8, use_native=False):
        return self.table[[int(p) for p in paths]]


@pytest.mark.parametrize("kw", [
    dict(stride=4), dict(stride=3, interpolate=False),
    dict(stride=4, refine_threshold=0.05),
    dict(stride=5, refine_threshold=0.01, refine_radius=1),
    dict(stride=4, refine_threshold=0.0), dict(stride=1)])
@pytest.mark.parametrize("n", [1, 37])
def test_embed_video_strided_matches_jax(kw, n):
    paths = [str(i) for i in range(n)]
    want_stats, got_stats = {}, {}
    want = jax_embed.embed_video_strided(_KeyEngine(n), paths,
                                         stats=want_stats, **kw)
    got = tembed.embed_video_strided(_KeyEngine(n), paths, stats=got_stats,
                                     **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    timings = ("keys_s", "refine_embed_s")
    assert {k: v for k, v in got_stats.items() if k not in timings} == \
        {k: v for k, v in want_stats.items() if k not in timings}
    assert set(got_stats) == set(want_stats)


@pytest.mark.parametrize("stride,n,l2", [(4, 36, True), (3, 36, False),
                                         (1, 8, True), (36, 36, True)])
def test_strided_interp_device_matches_jax(stride, n, l2):
    keys = np.random.default_rng(stride).standard_normal(
        (n // stride + (stride > 1), 12)).astype(np.float32)
    want = jax_embed.strided_interp_device(jnp.asarray(keys), stride, n,
                                           l2_normalize=l2)
    got = tembed.strided_interp_device(torch.from_numpy(keys), stride, n,
                                       l2_normalize=l2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="must divide"):
        tembed.strided_interp_device(torch.from_numpy(keys), 5, n + 1)


# ------------------------------------------------------------------ CLI


@pytest.fixture
def tiny_world(tmp_path, monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("VRT_TINY", "1")
    monkeypatch.chdir(tmp_path)
    synthetic.write_video_frames(
        "frames", 1, [("none", 4), ("left", 20), ("none", 4), ("right", 20),
                      ("none", 4)], size=(32, 32))
    return tmp_path


def test_calibrate_int8_cli_and_profile_digest(tiny_world, monkeypatch,
                                               capsys):
    cli.main(["calibrate-int8", "frames", "--out", "t.json", "--n-frames",
              "6", "--tome-r", "2", "--device", "cpu"])
    assert "wrote 6 site scales -> t.json" in capsys.readouterr().out
    got = json.load(open("t.json"))
    # the keys the JAX verb writes (vit_research_tpu/cli/ingest.py:84-88;
    # running that verb here costs ~20 s of eager JAX init and forward)
    assert set(got) == {"scales", "tome_r", "grayscale", "n_frames",
                        "frames_dir"}
    assert len(got["scales"]) == 6 and all(s > 0 for s in got["scales"])
    assert (got["tome_r"], got["grayscale"], got["n_frames"]) == \
        (2, False, 6)
    monkeypatch.setenv("VRT_GEMM_QUANT", "int8-static")
    monkeypatch.setenv("VRT_GEMM_SCALES", "t.json")
    monkeypatch.setenv("VRT_TOME_R", "2")
    digest = hashlib.sha256(",".join(
        f"{s:.9e}" for s in got["scales"]).encode()).hexdigest()[:8]
    assert common.engine_profile() == \
        "torch|" + jax_common.engine_profile() == \
        f"torch|tiny|tome2|quant-int8-static:{digest}|gray0"
    # the scales drive the engine; a file for another depth is refused
    eng = common._engine(16, "cpu")
    assert eng.model.dot_general.scales == tuple(got["scales"])
    json.dump({"scales": got["scales"] * 2}, open("t.json", "w"))
    with pytest.raises(ValueError, match="12 entries"):
        common._engine(16, "cpu")
    for value, msg in (("", "needs VRT_GEMM_SCALES"),
                       ("nope.json", "No such file")):
        monkeypatch.setenv("VRT_GEMM_SCALES", value)
        with pytest.raises(SystemExit, match=msg):
            common._engine(16, "cpu")


def _exit_message(main, argv):
    """The SystemExit message and the stride warnings on stderr."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value), [line for line in err.getvalue().splitlines()
                          if "--frame-stride" in line]


@pytest.mark.parametrize("extra", [
    ["--frame-stride", "0"],
    ["--frame-stride", "2", "--follow"],
    ["--frame-stride", "2", "--write-back"],
    ["--frame-stride", "2", "--stride-refine-radius", "-1"],
    ["--frame-stride", "2", "--stride-refine-radius", "1"],
    ["--stride-refine", "auto"],
    ["--frame-stride", "2", "--stride-refine", "x"],
    ["--frame-stride", "2", "--stride-refine", "3"],
    ["--frame-stride", "4", "--event-template", "missing.json"],
    ["--frame-stride", "4", "--event-template", "ev.json"],
    ["--frame-stride", "4", "--event-template", "ev.json",
     "--force-stride"],
    ["--frame-stride", "2", "--event-template", "ev.json"],
])
def test_segment_stride_checks_match_jax(tiny_world, extra):
    # a 2-frame event (a 3-frame make minus 1 frame of none)
    jax_labels.save_event_template(
        {"clips/vid1_clip_1_left": {"event_make": [[10, 12], [30, 40]],
                                    "event_none": [[12, 12]]}}, "ev.json")
    argv = ["segment", "frames", "--method", "knn-hmm", "--out", "o",
            "--vid", "1", *extra]
    got = _exit_message(cli.main, argv + ["--device", "cpu"])
    want = _exit_message(jax_cli.main, argv)
    assert got == want
    assert not os.path.exists("o")  # nothing ran


@pytest.mark.parametrize("env", [{"VRT_TOME_R": "2"},
                                 {"VRT_TOME_R": "4",
                                  "VRT_GEMM_QUANT": "int8"}])
def test_daemon_merged_batch_equals_requests_alone(tiny_world, monkeypatch,
                                                   env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    eng = common._engine(16, "cpu")
    frames = np.random.default_rng(9).integers(0, 256, (7, 32, 32, 3),
                                               dtype=np.uint8)
    parts = [frames[:1], frames[1:4], frames[4:]]
    alone = [eng.embed_batch(p) for p in parts]
    srv = serve.EmbedServer(eng, coalesce_ms=1000.0)
    results = {}
    try:
        threads = [threading.Thread(
            target=lambda i=i: results.update({i: srv._coalescer.embed(
                parts[i])})) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
        assert srv._coalescer.batches_run == 1
    finally:
        srv.stop()
    for i in range(3):
        np.testing.assert_allclose(results[i], alone[i], rtol=0, atol=1e-5)
