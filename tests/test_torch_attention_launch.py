"""Kernel B's launch path on the CPU, with no card: the bf16 variant rule
(one pass, wgmma, held, two passes) against the shared memory a block may
take, the f32 rule (the TF32 wgmma variant at dh = 64; the short-sequence
variant at dh = 96, 128 and 192 up to 32 keys, with its shared memory and
heads an SM; the CUDA-core kernel forced beside either),
and what ``ops/attention.py::_launch`` hands the C entry point, pinned
against a stub library.

The rules mirror ``launch_bf16_with`` and ``launch_f32`` in
csrc/attention.cu, whose ``static_assert``s state the same limits
(HeldLayout<DH, BIAS>::MAX_TILES), and the short variant's layout mirrors
csrc/attention_short.cu's (its ``static_assert``s pin the same bytes).
"""

import ctypes

import numpy as np
import pytest
import torch

from vit_research_tpu_torch.ops import _build
from vit_research_tpu_torch.ops import attention as attn

#: the held variant's key-tile limits, as csrc/attention.cu asserts them
HELD_LIMITS = {16: 13, 32: 12, 64: 11, 96: 10, 128: 24, 192: 22}


@pytest.mark.parametrize("width", attn.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("bias", [False, True])
def test_held_variant_fits_the_blocks_shared_memory(width, bias):
    """At its largest T the held variant stays within the 232,448 bytes a
    block may opt into, and within two blocks an SM below dh = 128; one
    more key tile would pass that budget."""
    n = attn.held_max_tiles(width, bias)
    assert attn.MAX_SMEM == 232_448 and attn.TWO_BLOCKS_SMEM == 115_712
    budget = attn.MAX_SMEM if width >= 128 else attn.TWO_BLOCKS_SMEM
    assert attn.held_max_bytes(width) == budget
    assert n == HELD_LIMITS[width]
    assert attn.held_smem_bytes(width, bias, n) <= budget <= attn.MAX_SMEM
    assert attn.held_smem_bytes(width, bias, n + 1) > budget
    # the ring of two key tiles (the Q tile passes through it), padded
    # rows, in bf16; two bf16 bias tiles; 64 x 64 bf16 scores a key tile
    ld = width + 8
    assert attn.held_smem_bytes(width, bias, 0) == \
        128 * ld * 2 + (256 if bias else 0)
    assert attn.held_smem_bytes(width, bias, 1) - \
        attn.held_smem_bytes(width, bias, 0) == 64 * 64 * 2


def test_two_blocks_share_an_sm_at_the_backbones_shape():
    """ViT-B/16 @224 (T = 197, dh = 64): 4 key tiles, 51,200 bytes (4
    blocks an SM); at the limit, T = 704, two."""
    assert attn.held_smem_bytes(64, False, 4) == 51_200
    assert 4 * (51_200 + 1024) <= 233_472
    assert 2 * (attn.held_smem_bytes(64, True, 11) + 1024) <= 233_472


@pytest.mark.parametrize("width", attn.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("bias", [False, True])
def test_bf16_variant_boundaries(width, bias):
    """One key tile takes the one-pass kernel; at dh = 64 the wgmma
    variant takes T = 65 to 256; the held variant takes every other T up
    to 64 * its tile limit, and one key past it the two-pass kernel. Each
    variant that takes a T is offered to force (bf16_variants), the rule's
    first."""
    limit = 64 * HELD_LIMITS[width]
    assert [attn.bf16_variant(t, width, bias) for t in (1, 5, 64)] == \
        ["1pass"] * 3
    if width == 64:
        assert attn.WG_KEYS == (65, 256)
        assert [attn.bf16_variant(t, width, bias)
                for t in (65, 128, 129, 197, 256)] == ["wg"] * 5
        assert [attn.bf16_variant(t, width, bias)
                for t in (257, limit)] == ["held"] * 2
        assert attn.bf16_variants(197, width, bias) == ("wg", "held",
                                                        "2pass")
    else:
        assert [attn.bf16_variant(t, width, bias)
                for t in (65, 128, 129, 197, 256, 257, limit)] == \
            ["held"] * 7
        assert attn.bf16_variants(197, width, bias) == ("held", "2pass")
    assert [attn.bf16_variant(t, width, bias)
            for t in (limit + 1, limit + 64, 4096)] == ["2pass"] * 3
    assert attn.bf16_variants(64, width, bias) == ("1pass",)
    assert attn.bf16_variants(limit + 1, width, bias) == ("2pass",)


def test_the_paths_shapes_take_their_variants():
    # the backbone (ViT-B/16 @224, T = 197; ToMe's biased blocks down to
    # T = 21), smoke's frame (T = 313), the heads and the chunk encoder
    # (T <= 25), the longest check (T = 1297)
    assert attn.bf16_variant(197, 64, False) == "wg"
    assert [attn.bf16_variant(t, 64, True) for t in (197, 85, 69, 21)] == \
        ["wg", "wg", "wg", "1pass"]
    assert attn.bf16_variant(313, 64, False) == "held"
    assert attn.bf16_variant(197, 96, False) == "held"  # F4's dh = 80
    assert attn.bf16_variant(5, 192, False) == "1pass"
    assert attn.bf16_variant(25, 96, True) == "1pass"
    assert attn.bf16_variant(1297, 64, False) == "2pass"


@pytest.mark.parametrize("dtype,t,width,bias,name", [
    (torch.float32, 197, 64, False, "attn_f32<64>/wg"),
    (torch.float32, 1297, 192, True, "attn_f32<192>"),
    (torch.float32, 9, 96, False, "attn_f32<96>/short"),
    (torch.float32, 5, 192, True, "attn_f32<192>/short"),
    (torch.float32, 32, 128, False, "attn_f32<128>/short"),
    (torch.float32, 33, 96, True, "attn_f32<96>"),
    (torch.bfloat16, 9, 96, False, "attn_bf16<96>"),
    (torch.bfloat16, 197, 64, True, "attn_bf16<64>/wg"),
    (torch.bfloat16, 65, 64, False, "attn_bf16<64>/wg"),
    (torch.bfloat16, 256, 64, False, "attn_bf16<64>/wg"),
    (torch.bfloat16, 257, 64, False, "attn_bf16<64>/held"),
    (torch.bfloat16, 197, 96, True, "attn_bf16<96>/held"),
    (torch.bfloat16, 705, 64, True, "attn_bf16<64>/2pass"),
    (torch.bfloat16, 1537, 128, False, "attn_bf16<128>/2pass"),
    (torch.bfloat16, 1408, 192, True, "attn_bf16<192>/held"),
    (torch.bfloat16, 1297, 64, False, "attn_bf16<64>/2pass"),
])
def test_kernel_names_count_each_variant(dtype, t, width, bias, name):
    assert attn.kernel_name(dtype, t, width, bias) == name
    # a forced variant counts under its own name
    if dtype == torch.bfloat16:
        forced = attn.bf16_variants(t, width, bias)[-1]
        assert attn.kernel_name(dtype, t, width, bias, forced) == \
            f"attn_bf16<{width}>" + {"1pass": "", "2pass": "/2pass"}[forced]
    elif attn.f32_variants(t, width, bias):
        assert attn.kernel_name(dtype, t, width, bias, "simt") == \
            f"attn_f32<{width}>/simt"


#: launch_f32's rule in csrc/attention.cu: (width, T) -> the f32 variants
#: that take it, the rule's first
F32_RULE = {(64, 1): ("wg", "simt"), (64, 21): ("wg", "simt"),
            (64, 64): ("wg", "simt"), (64, 65): ("wg", "simt"),
            (64, 197): ("wg", "simt"), (64, 313): ("wg", "simt"),
            (64, 1297): ("wg", "simt"), (64, 4096): ("wg", "simt"),
            **{(w, t): () for w in (16, 32, 96, 128, 192)
               for t in (1, 9, 197, 1297)},
            # up to 32 keys the short variant (a query row a lane, or 2-4)
            **{(w, t): ("short", "simt") for w in (96, 128, 192)
               for t in (1, 9, 25, 32)},
            **{(w, 33): () for w in (96, 128, 192)},
            **{(w, t): () for w in (16, 32) for t in (25, 32)}}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("width,t", sorted(F32_RULE))
def test_f32_variants_follow_the_c_rule(width, t, bias):
    """At width 64 every T takes the TF32 wgmma variant by the rule and the
    CUDA-core kernel when forced, with or without a key bias; at widths 96,
    128 and 192 up to 32 keys the short variant by the rule and the
    CUDA-core kernel when forced; elsewhere there is no variant to choose
    (the one kernel, named without one)."""
    assert attn.f32_variants(t, width, bias) == F32_RULE[width, t]
    want = F32_RULE[width, t][0] if F32_RULE[width, t] else None
    assert attn.f32_variant(t, width, bias) == want
    assert attn.kernel_name(torch.float32, t, width, bias) == (
        f"attn_f32<{width}>" + (f"/{want}" if want else ""))


def test_f32_variant_names_and_codes():
    """The f32 variants have names of their own and reach the C entry point
    as its Variant codes (WG = 4, SIMT = 5, SHORT = 6); the tiled kernel
    past 32 keys and the other widths' f32 kernels keep their names."""
    assert attn.kernel_name(torch.float32, 197, 64, True, "wg") == \
        "attn_f32<64>/wg"
    assert attn.kernel_name(torch.float32, 197, 64, True, "simt") == \
        "attn_f32<64>/simt"
    assert attn.VARIANT_CODES["wg"] == 4 and attn.VARIANT_CODES["simt"] == 5
    assert attn.VARIANT_CODES["short"] == 6
    assert attn.SHORT_WIDTHS == (96, 128, 192) and attn.SHORT_MAX_SEQ == 32
    assert attn.kernel_name(torch.float32, 9, 96, False) == \
        "attn_f32<96>/short"
    assert attn.kernel_name(torch.float32, 9, 96, False, "simt") == \
        "attn_f32<96>/simt"
    assert attn.kernel_name(torch.float32, 33, 96, False) == "attn_f32<96>"
    assert attn.kernel_name(torch.float32, 9, 32, False) == "attn_f32<32>"
    assert "attn_f32<64>" not in attn._KERNEL_NAMES.values()


class _StubLibrary:
    """Records each vrt_attention_fwd call's arguments; returns ``code``."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    def vrt_attention_fwd(self, *args):
        self.calls.append(args)
        return self.code

    def vrt_error_string(self, code):
        return b"stub error"


@pytest.fixture
def stub(monkeypatch):
    """The wrapper's library and CUDA context replaced: q's device is the
    current one (a CPU tensor's get_device() is -1) and the stream handle is
    4242; entering another device's context is recorded."""
    lib = _StubLibrary()
    entered = []

    class _Device:
        def __init__(self, index):
            entered.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(attn, "_current_device", lambda: -1)
    monkeypatch.setattr(attn, "_current_stream", lambda index: 4242)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    lib.entered = entered
    return lib


def _projection_order(b, t, h, d, dtype, seed):
    """q, k, v as the (B, H, T, dh) views of contiguous (B, T, H, dh)
    tensors, as the backbone's projections give them."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to(dtype).transpose(1, 2) for _ in range(3)]


def _counts():
    f = attn.multi_head_attention
    return f.launches, f.padded_launches, dict(f.launches_by_kernel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,with_bias", [(3, 197, True), (2, 9, False),
                                           (1, 130, True)])
def test_launch_marshals_views_in_projection_order(stub, dtype, b, t,
                                                   with_bias):
    h, d = 4, 64
    q, k, v = _projection_order(b, t, h, d, dtype, t)
    wide = torch.zeros(b, t + 3)  # bias rows t + 3 apart
    bias = wide[:, :t] if with_bias else None
    before = _counts()
    o = attn._launch(q, k, v, 0.125, bias)
    (args,) = stub.calls
    assert len(args) == 15
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr())
    assert args[4:8] == (b, h, t, d)
    assert isinstance(args[8], ctypes.Array) and len(args[8]) == 12
    # q, k, v: the projections' (T*H*dh, dh, H*dh); o alike; a batch of 1
    # is never stepped over (0)
    proj = (t * h * d if b > 1 else 0, d, h * d)
    assert list(args[8]) == list(proj) * 4
    assert type(args[9]) is float and args[9] == 0.125
    assert args[10] == int(dtype == torch.bfloat16)
    if with_bias:
        assert args[11] == bias.data_ptr()
        assert args[12] == (t + 3 if b > 1 else 0)
    else:
        assert args[11:13] == (None, 0)
    assert args[13] == 0  # the rule's variant
    assert args[14] == 4242
    assert stub.entered == []  # q's device is the current one
    # the output: the (B, H, T, dh) view of a contiguous (B, T, H, dh)
    assert o.shape == (b, h, t, d) and o.dtype == dtype
    assert o.transpose(1, 2).is_contiguous()
    launches, padded, by_kernel = _counts()
    assert (launches, padded) == (before[0] + 1, before[1])
    name = attn.kernel_name(dtype, t, d, with_bias)
    assert by_kernel[name] == before[2].get(name, 0) + 1
    assert sum(by_kernel.values()) == sum(before[2].values()) + 1


@pytest.mark.parametrize("d,width", [(80, 96), (48, 64), (150, 192)])
def test_launch_marshals_padded_widths(stub, d, width):
    """A width between two compiled ones: q, k, v zero-padded copies in
    projection order, the padded width, the caller's scale, an output
    view of the first d columns, counted in padded_launches."""
    q, k, v = _projection_order(2, 21, 3, d, torch.bfloat16, d)
    before = _counts()
    o = attn._launch(q, k, v, d ** -0.5, None)
    (args,) = stub.calls
    assert args[4:8] == (2, 3, 21, width)
    assert list(args[8]) == [21 * 3 * width, width, 3 * width] * 4
    assert args[9] == pytest.approx(d ** -0.5, rel=1e-15)
    assert args[10] == 1
    assert all(p not in (q.data_ptr(), k.data_ptr(), v.data_ptr())
               for p in args[:3])
    assert o.shape == (2, 3, 21, d)
    launches, padded, by_kernel = _counts()
    assert (launches, padded) == (before[0] + 1, before[1] + 1)
    assert by_kernel[f"attn_bf16<{width}>"] == \
        before[2].get(f"attn_bf16<{width}>", 0) + 1


def test_launch_enters_another_devices_context_only(stub, monkeypatch):
    q, k, v = _projection_order(2, 9, 2, 32, torch.float32, 0)
    attn._launch(q, k, v, 1.0, None)
    assert stub.entered == []
    monkeypatch.setattr(attn, "_current_device", lambda: 0)
    attn._launch(q, k, v, 1.0, None)
    assert stub.entered == [q.get_device()]
    assert len(stub.calls) == 2


def test_launch_raises_on_a_failed_launch(stub):
    """A code from the C entry point raises, naming it; nothing is
    counted."""
    stub.code = 1
    q, k, v = _projection_order(2, 197, 2, 64, torch.bfloat16, 1)
    before = _counts()
    with pytest.raises(RuntimeError, match=r"CUDA error 1 \(stub error\)"):
        attn._launch(q, k, v, 0.125, None)
    assert _counts() == before


@pytest.mark.parametrize("case,error,match", [
    ("wide", ValueError, "up to 192"),
    ("k_dtype", ValueError, "k is torch.float32"),
    ("last_dim", ValueError, "stride 1 on its last dim"),
    ("token_stride", ValueError, "multiples of 16 bytes"),
    ("misaligned", ValueError, "16-byte aligned"),
])
def test_launch_refusals_call_nothing(stub, case, error, match):
    """Each layout the kernel does not take raises before the C entry
    point is called or a launch is counted."""
    q, k, v = _projection_order(2, 9, 2, 64, torch.bfloat16, 2)
    if case == "wide":
        q = k = v = torch.zeros(1, 2, 5, 256)
    elif case == "k_dtype":
        k = k.float()
    elif case == "last_dim":
        q = torch.zeros(2, 2, 64, 9, dtype=torch.bfloat16).transpose(2, 3)
    elif case == "token_stride":
        q = torch.zeros(2, 2, 9, 66, dtype=torch.bfloat16)[..., :64]
    else:
        flat = torch.zeros(2 * 2 * 9 * 64 + 8, dtype=torch.bfloat16)
        start = (-flat.data_ptr() // 2) % 8 + 1  # one element past 16 bytes
        q = flat[start:start + 2 * 2 * 9 * 64].view(2, 2, 9, 64)
    before = _counts()
    with pytest.raises(error, match=match):
        attn._launch(q, k, v, 0.125, None)
    assert stub.calls == [] and _counts() == before


def test_launch_reuses_a_layouts_marshalling_and_still_checks_pointers(
        stub):
    """A second call with the same layout hands the C entry point the same
    strides array (computed once); a view of that layout whose base is not
    16-byte aligned still raises, and another layout gets its own."""
    q, k, v = _projection_order(2, 9, 2, 64, torch.bfloat16, 4)
    attn._LAYOUTS.clear()
    attn._launch(q, k, v, 0.125, None)
    attn._launch(*[x.clone() for x in (q, k, v)], 0.125, None)
    first, second = stub.calls
    assert second[8] is first[8] and len(attn._LAYOUTS) == 1
    flat = torch.zeros(2 * 9 * 2 * 64 + 16, dtype=torch.bfloat16)
    start = (-flat.data_ptr() // 2) % 8 + 1
    shifted = flat[start:start + 2 * 9 * 2 * 64].view(2, 9, 2, 64) \
        .transpose(1, 2)
    assert shifted.stride() == q.stride()
    with pytest.raises(ValueError, match="k's base address"):
        attn._launch(q, shifted, v, 0.125, None)
    assert len(stub.calls) == 2
    attn._launch(*(x.contiguous() for x in (q, k, v)), 0.125, None)
    assert len(attn._LAYOUTS) == 2
    assert list(stub.calls[2][8]) == [2 * 9 * 64, 9 * 64, 64] * 3 + \
        [9 * 2 * 64, 64, 2 * 64]


@pytest.mark.parametrize("variant,t,code", [("held", 197, 2), ("wg", 197, 4),
                                            ("2pass", 197, 3),
                                            ("held", 257, 2),
                                            ("1pass", 64, 1)])
def test_launch_marshals_a_forced_variant(stub, variant, t, code):
    """A forced bf16 variant reaches the C entry point as its code and
    counts under its own name (the held variant at the backbone's T = 197
    beside the rule's wgmma variant, to time the two in one process)."""
    q, k, v = _projection_order(2, t, 4, 64, torch.bfloat16, t)
    before = _counts()
    attn._launch(q, k, v, 0.125, None, variant)
    (args,) = stub.calls
    assert args[13] == code == attn.VARIANT_CODES[variant]
    name = attn.kernel_name(torch.bfloat16, t, 64, False, variant)
    assert name.endswith({"1pass": ">", "held": "/held", "wg": "/wg",
                          "2pass": "/2pass"}[variant])
    assert _counts()[2][name] == before[2].get(name, 0) + 1


@pytest.mark.parametrize("variant,t,d,dtype,match", [
    ("wg", 257, 64, torch.bfloat16, "does not take T = 257"),
    ("wg", 64, 64, torch.bfloat16, "does not take T = 64"),
    ("wg", 197, 96, torch.bfloat16, "head width 96"),
    ("held", 64, 64, torch.bfloat16, "does not take T = 64"),
    ("held", 197, 64, torch.float32, "bf16 variant"),
    ("fast", 197, 64, torch.bfloat16, "does not take"),
    ("wg", 197, 96, torch.float32, "head width 96 in torch.float32"),
    ("simt", 33, 96, torch.float32, "takes none"),
    ("short", 33, 192, torch.float32, "takes none"),
    ("short", 9, 64, torch.float32, "takes wg, simt"),
    ("short", 9, 32, torch.float32, "takes none"),
    ("short", 9, 96, torch.bfloat16, "an f32 variant"),
    ("wg", 9, 96, torch.float32, "takes short, simt"),
    ("wg", 9, 32, torch.float32, "head width 32"),
    ("1pass", 21, 64, torch.float32, "bf16 variant"),
    ("2pass", 1297, 64, torch.float32, "bf16 variant"),
    ("simt", 197, 64, torch.bfloat16, "an f32 variant"),
    ("fast", 197, 64, torch.float32, "does not take"),
])
def test_a_forced_variant_that_does_not_apply_calls_nothing(
        stub, variant, t, d, dtype, match):
    q, k, v = _projection_order(1, t, 2, d, dtype, 5)
    before = _counts()
    with pytest.raises(ValueError, match=match):
        attn._launch(q, k, v, 0.125, None, variant)
    assert stub.calls == [] and _counts() == before


@pytest.mark.parametrize("variant,code", [("wg", 4), ("simt", 5)])
@pytest.mark.parametrize("t,with_bias", [(197, False), (21, True),
                                         (1297, False)])
def test_launch_marshals_a_forced_f32_variant(stub, variant, code, t,
                                              with_bias):
    """A forced f32 variant at dh = 64 reaches the C entry point as its code
    and counts under its own name; the rule's call (no variant) hands code
    0 and counts under the wgmma variant."""
    q, k, v = _projection_order(2, t, 3, 64, torch.float32, t)
    bias = torch.zeros(2, t) if with_bias else None
    before = _counts()
    attn._launch(q, k, v, 0.125, bias, variant)
    attn._launch(q, k, v, 0.125, bias)
    forced, rule = stub.calls
    assert forced[10] == rule[10] == 0  # f32
    assert forced[13] == code and rule[13] == 0
    by_kernel = _counts()[2]
    name = f"attn_f32<64>/{variant}"
    assert by_kernel[name] == before[2].get(name, 0) + 1 + (variant == "wg")


@pytest.mark.parametrize("variant", [None, "wg", "simt"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_an_f32_variant_runs_the_plain_version_on_the_cpu(variant,
                                                          with_bias):
    """On CPU tensors an f32 variant is checked as on the card and
    multi_head_attention returns attention_plain's result, counting no
    launch; a variant that does not take the shape still raises."""
    q, k, v = (x.contiguous() for x in _projection_order(
        2, 197, 2, 64, torch.float32, 11))
    bias = torch.from_numpy(np.log(np.random.default_rng(11).integers(
        1, 5, size=(2, 197))).astype(np.float32)) if with_bias else None
    before = _counts()
    got = attn.multi_head_attention(q, k, v, key_bias=bias, variant=variant)
    assert torch.equal(got, attn.attention_plain(q, k, v, key_bias=bias))
    assert _counts() == before
    with pytest.raises(ValueError, match="bf16 variant"):
        attn.multi_head_attention(q, k, v, variant="held")
    q96 = torch.zeros(1, 2, 9, 96)
    with pytest.raises(ValueError, match="takes short, simt"):
        attn.multi_head_attention(q96, q96, q96, variant="wg")


def test_a_forced_variant_runs_the_plain_version_on_the_cpu():
    """On the CPU a forced variant is checked as on the card and the plain
    version runs."""
    q, k, v = (x.contiguous() for x in _projection_order(
        1, 197, 2, 64, torch.bfloat16, 6))
    got = attn.multi_head_attention(q, k, v, variant="held")
    assert torch.equal(got, attn.attention_plain(q, k, v))
    with pytest.raises(ValueError, match="does not take"):
        attn.multi_head_attention(q, k, v, variant="1pass")


@pytest.mark.parametrize("case", ["token_stride", "head_stride",
                                  "batch_stride", "misaligned"])
def test_wg_shape_refuses_a_stride_tma_refuses(stub, case):
    """At the wgmma variant's shape (bf16, dh = 64, T = 197) a base or a
    batch, head or token stride that is not a multiple of 16 bytes (what
    TMA's tensor maps refuse) raises ValueError before the C entry point
    is called; nothing is copied and nothing counts."""
    b, h, t = 2, 4, 197
    q, k, v = _projection_order(b, t, h, 64, torch.bfloat16, 7)
    flat = torch.zeros(b * h * t * 72 + 64, dtype=torch.bfloat16)
    start = (-flat.data_ptr() // 2) % 8  # 16-byte aligned
    if case == "token_stride":  # 66 elements: 132 bytes
        q = flat[start:start + b * h * t * 66].view(b, h, t, 66)[..., :64]
        match = "multiples of 16 bytes"
    elif case == "head_stride":  # t * 64 + 4 elements
        q = flat[start:].as_strided((b, h, t, 64),
                                    (h * (t * 64 + 4), t * 64 + 4, 64, 1))
        match = "multiples of 16 bytes"
    elif case == "batch_stride":  # h * t * 64 + 4 elements
        q = flat[start:].as_strided((b, h, t, 64),
                                    (h * t * 64 + 4, t * 64, 64, 1))
        match = "multiples of 16 bytes"
    else:
        q = flat[start + 1:start + 1 + b * h * t * 64].view(b, h, t, 64)
        match = "16-byte aligned"
    assert attn.bf16_variant(t, 64, False) == "wg"
    before = _counts()
    with pytest.raises(ValueError, match=match):
        attn._launch(q, k, v, 0.125, None)
    assert stub.calls == [] and _counts() == before


@pytest.mark.parametrize("variant,code", [("short", 6), ("simt", 5)])
@pytest.mark.parametrize("width,heads", [(96, 8), (128, 6), (192, 4)])
@pytest.mark.parametrize("t,with_bias", [(9, False), (5, True), (32, False),
                                         (1, True)])
def test_launch_marshals_a_forced_short_or_simt_variant(stub, variant, code,
                                                        width, heads, t,
                                                        with_bias):
    """Up to 32 keys at widths 96, 128 and 192 the short variant and the
    64-row tile (forced "simt") reach the C entry point as their codes, in
    f32, and count under their own names; the rule's call (no variant)
    hands code 0 and counts under the short variant."""
    q, k, v = _projection_order(2, t, heads, width, torch.float32, t)
    bias = torch.zeros(2, t) if with_bias else None
    before = _counts()
    attn._launch(q, k, v, width ** -0.5, bias, variant)
    attn._launch(q, k, v, width ** -0.5, bias)
    forced, rule = stub.calls
    assert forced[4:8] == rule[4:8] == (2, heads, t, width)
    assert forced[10] == rule[10] == 0  # f32
    assert forced[13] == code and rule[13] == 0
    assert (forced[11] is None) is (not with_bias)
    by_kernel = _counts()[2]
    short = f"attn_f32<{width}>/short"
    assert by_kernel[short] == before[2].get(short, 0) + 1 + (
        variant == "short")
    if variant == "simt":
        name = f"attn_f32<{width}>/simt"
        assert by_kernel[name] == before[2].get(name, 0) + 1


@pytest.mark.parametrize("d,width", [(80, 96), (100, 128), (150, 192)])
def test_padded_widths_up_to_32_keys_take_the_short_variant(stub, d, width):
    """A width between two compiled ones at T <= 32 runs the short variant
    at the next width through the wrapper's zero padding (the rule, code
    0), counted in padded_launches too."""
    q, k, v = _projection_order(3, 9, 4, d, torch.float32, d)
    before = _counts()
    o = attn._launch(q, k, v, d ** -0.5, None)
    (args,) = stub.calls
    assert args[4:8] == (3, 4, 9, width) and args[13] == 0
    assert o.shape == (3, 4, 9, d)
    launches, padded, by_kernel = _counts()
    assert (launches, padded) == (before[0] + 1, before[1] + 1)
    name = f"attn_f32<{width}>/short"
    assert by_kernel[name] == before[2].get(name, 0) + 1


# csrc/attention_short.cu's layout: a head a warp, its shared memory the
# barrier (16 bytes), T rows of Q padded by 4 P floats, NK rows of K, T
# rows of V and NK floats of key bias; a block holds the 1-4 heads that fit
# the most heads on an SM (the SM's 233,472 bytes less 1,024 a block).
SHORT_MAX_WARPS = 4
SM_SMEM, BLOCK_RESERVED = 233_472, 1024


def short_keys(t):
    """The keys the score loop computes for T keys (keys_for)."""
    return 8 if t <= 8 else 12 if t <= 12 else 16 if t <= 16 else 32


def short_lanes_a_row(t):
    """The lanes that share a query row's dh (lanes_a_row)."""
    nk = short_keys(t)
    return 4 if nk <= 8 else 2 if nk <= 16 else 1


def short_head_bytes(width, t, bias):
    nk = short_keys(t)
    return 16 + 4 * (t * (width + 4 * short_lanes_a_row(t)) + nk * width
                     + t * width + (nk if bias else 0))


def short_heads_per_sm(nbytes, warps):
    if warps * nbytes > attn.MAX_SMEM:
        return 0
    return SM_SMEM // (warps * nbytes + BLOCK_RESERVED) * warps


def short_heads_per_block(nbytes):
    best = 1
    for w in range(2, SHORT_MAX_WARPS + 1):
        if short_heads_per_sm(nbytes, w) >= short_heads_per_sm(nbytes, best):
            best = w
    return best


#: (width, T, bias) -> (a head's bytes, heads a block, heads an SM), as
#: csrc/attention_short.cu's static_asserts state them
SHORT_LAYOUTS = {(96, 9, False): (11_824, 3, 18),
                 (96, 25, False): (31_904, 1, 7),
                 (192, 5, False): (14_160, 4, 16),
                 (192, 32, True): (74_384, 3, 3)}


@pytest.mark.parametrize("width", attn.SHORT_WIDTHS)
@pytest.mark.parametrize("bias", [False, True])
def test_short_variant_fits_the_blocks_shared_memory(width, bias):
    """At every T up to 32 a block of the short variant's heads stays
    within the 232,448 bytes a block may opt into and at least three heads
    share an SM; every lane of a row has a query row (T * P <= 32 lanes,
    the row's float4 groups shared out evenly); Q's pitch keeps 16-byte
    copies aligned; the paths' shapes take the asserted layouts, and B =
    256 chunks of 8 heads at T = 9 fit in one wave on 132 SMs."""
    for t in range(1, attn.SHORT_MAX_SEQ + 1):
        nbytes = short_head_bytes(width, t, bias)
        warps = short_heads_per_block(nbytes)
        p = short_lanes_a_row(t)
        assert nbytes % 16 == 0 and ((width + 4 * p) * 4) % 16 == 0
        assert 1 <= warps <= SHORT_MAX_WARPS
        assert warps * nbytes <= attn.MAX_SMEM
        assert short_heads_per_sm(nbytes, warps) >= 3, t
        assert t * p <= 32 and short_keys(t) >= t
        assert (width // 4) % (2 * p) == 0  # the score loop's two groups
    for (w, t, b), want in SHORT_LAYOUTS.items():
        nbytes = short_head_bytes(w, t, b)
        warps = short_heads_per_block(nbytes)
        assert (nbytes, warps, short_heads_per_sm(nbytes, warps)) == want
    assert 132 * SHORT_LAYOUTS[96, 9, False][2] >= 256 * 8
