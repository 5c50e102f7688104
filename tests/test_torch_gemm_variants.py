"""Kernels A's and C's launch paths on the CPU, with no card: each one's
variant rule (the wgmma variant of csrc/patch_embed_wg.cu or
csrc/fused_ln_wg.cu, else the mma.sync one), the refusal of a forced
variant that does not take the call before anything launches, the names
counted in ``launches_by_kernel``, the weight as the TMA path reads it,
and what the wrappers hand the C entry points, pinned against a stub
library.

The rules mirror csrc/fused_ln.cuh (LN_WG_MAX_K, LnVariant) and
csrc/patch_embed.cuh (PeVariant); the shared memory mirrors wg::Cfg in
csrc/wg_gemm.cuh and the static_asserts of the two wgmma sources.
"""

import numpy as np
import pytest
import torch

from vit_research_tpu_torch.ops import _build
from vit_research_tpu_torch.ops import fused_ln
from vit_research_tpu_torch.ops import patch_embed as pe

#: the shared memory a block may opt into on the H100
MAX_SMEM = 232_448
CHUNK = 64 * 128  # a 64-row x 64-k bf16 chunk, one TMA box of W


def _wg_bytes(wgs_m, wgs_n, pieces, stages, rows_bytes):
    """wg::Cfg<wgs_m, wgs_n, pieces, stages>::bytes(rows_bytes): the
    alignment slack, the row operand, W's ring (each stage pieces x
    (128 wgs_n / 64) boxes), the output staging where the warpgroups share
    W's columns (wgs_m > 1: 16 rows x 160 bytes a consumer warp; else it is
    in the ring) and two barriers a stage."""
    ring = stages * pieces * (128 * wgs_n // 64) * CHUNK
    staging = 0 if wgs_m == 1 else 4 * wgs_m * wgs_n * 16 * 160
    return 1024 + rows_bytes + ring + staging + 2 * stages * 8


def test_ln_slab_limit_is_what_fits_beside_the_ring():
    """LN_WG_MAX_K is the deepest multiple of 64 whose K-wide slab of 64
    normalised bf16 rows fits beside four stages of W (fused_ln_wg.cu's
    static_assert); one chunk more would not fit."""
    chunks = -(-fused_ln.WG_MAX_K // 64)
    assert fused_ln.WG_MAX_K == 64 * chunks == 768
    assert _wg_bytes(1, 2, 1, 4, chunks * CHUNK) <= MAX_SMEM
    assert _wg_bytes(1, 2, 1, 4, (chunks + 1) * CHUNK) > MAX_SMEM


def test_patch_embed_wg_fits_one_block_an_sm():
    """Two row slots of two warpgroups' 64 rows, three stages of W's three
    pieces and the output staging (patch_embed_wg.cu's static_assert); a
    fourth stage would not fit."""
    assert _wg_bytes(2, 1, 3, 3, 2 * 2 * CHUNK) <= MAX_SMEM
    assert _wg_bytes(2, 1, 3, 4, 2 * 2 * CHUNK) > MAX_SMEM


def test_epilogue_staging_fits_in_a_warpgroups_columns():
    """Where the warpgroups split W's columns (kernel C), a warpgroup's four
    warps stage 16 rows each (160-byte pitch) in its own two 64-column
    boxes of the tile's last stage (wg::Cfg's static_assert)."""
    assert 4 * 16 * 160 <= 2 * CHUNK


@pytest.mark.parametrize("w_dtype,k,want", [
    (torch.bfloat16, 1, ("wg", "mma")),
    (torch.bfloat16, 40, ("wg", "mma")),
    (torch.bfloat16, 768, ("wg", "mma")),   # the slab's limit
    (torch.bfloat16, 720, ("wg", "mma")),
    (torch.bfloat16, 769, ("mma",)),
    (torch.bfloat16, 832, ("mma",)),
    (torch.bfloat16, 3072, ("mma",)),
    (torch.bfloat16, 0, ("mma",)),
    (torch.float32, 768, ("mma",)),         # 3xTF32 stays on mma.sync
    (torch.float32, 64, ("mma",))])
def test_ln_variant_rule(w_dtype, k, want):
    assert fused_ln.ln_variants(w_dtype, k) == want
    assert fused_ln.ln_variant(w_dtype, k) == want[0]


@pytest.mark.parametrize("dtype,want", [(torch.uint8, ("wg", "mma")),
                                        (torch.float32, ())])
def test_patch_embed_variant_rule(dtype, want):
    """Every uint8 batch takes the wgmma variant; float32 images keep their
    one CUDA-core kernel, with no variant to force."""
    assert pe.patch_embed_variants(dtype) == want


@pytest.mark.parametrize("fn,args,name", [
    (fused_ln.kernel_name, ("wg",), "ln_gemm/wg"),
    (fused_ln.kernel_name, ("mma",), "ln_gemm/mma"),
    (pe.kernel_name, (torch.uint8,), "patch_embed_u8/wg"),
    (pe.kernel_name, (torch.uint8, "wg"), "patch_embed_u8/wg"),
    (pe.kernel_name, (torch.uint8, "mma"), "patch_embed_u8/mma"),
    (pe.kernel_name, (torch.float32,), "patch_embed_f32")])
def test_kernel_names(fn, args, name):
    assert fn(*args) == name


def _ln_inputs(k=64, n=48, w_dtype=torch.bfloat16, x_dtype=torch.float32,
               m=5, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)) \
        .to(x_dtype)
    gamma, beta = (torch.from_numpy(rng.normal(mu, 0.1, size=k).astype(
        np.float32)) for mu in (1.0, 0.0))
    w = torch.from_numpy((rng.normal(size=(k, n)) / 8).astype(np.float32)) \
        .to(w_dtype)
    bias = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    return x, gamma, beta, w, bias


class _StubLibrary:
    """Records each entry point's arguments; returns ``code``."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    def _record(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.code
        return call

    def __getattr__(self, name):
        if name.startswith("vrt_") and name != "vrt_error_string":
            return self._record(name)
        raise AttributeError(name)

    def vrt_error_string(self, code):
        return b"stub error"


class _Stream:
    cuda_stream = 4242


@pytest.fixture
def stub(monkeypatch):
    """The wrappers' library and CUDA context replaced, so that their
    launch paths run on CPU tensors."""
    lib = _StubLibrary()

    class _Device:
        def __init__(self, index):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    return lib


@pytest.mark.parametrize("w_dtype,k,variant,code,name", [
    (torch.bfloat16, 64, None, 2, "ln_gemm/wg"),
    (torch.bfloat16, 64, "wg", 2, "ln_gemm/wg"),
    (torch.bfloat16, 64, "mma", 1, "ln_gemm/mma"),
    (torch.bfloat16, 896, None, 1, "ln_gemm/mma"),
    (torch.float32, 64, None, 1, "ln_gemm/mma")])
def test_ln_launch_marshals_its_variant(stub, w_dtype, k, variant, code,
                                        name):
    """The variant reaches vrt_ln_matmul as its code (the rule's resolved
    in Python, so that the count names the kernel that ran); the
    statistics scratch is the mma.sync variant's alone."""
    x, gamma, beta, w, bias = _ln_inputs(k=k, w_dtype=w_dtype)
    f = fused_ln.ln_matmul
    before, by_name = f.launches, f.launches_by_kernel[name]
    out = fused_ln._launch(x, gamma, beta, w, bias, 1e-6, "gelu",
                           torch.bfloat16, variant)
    ((entry, args),) = stub.calls
    assert entry == "vrt_ln_matmul" and len(args) == 18
    assert args[5] == out.data_ptr() and out.shape == (5, 48)
    assert (args[6] is None) == (code == 2)
    assert args[7:11] == (5, k, 48, 48)
    assert args[12] == fused_ln.ACTIVATIONS["gelu"]
    assert args[13:16] == (0, int(w_dtype == torch.bfloat16), 1)
    assert args[16] == code and args[17] == 4242
    assert f.launches == before + 1
    assert f.launches_by_kernel[name] == by_name + 1


@pytest.mark.parametrize("dtype,variant,entry,code,name", [
    (torch.uint8, None, "vrt_patch_embed_u8", 0, "patch_embed_u8/wg"),
    (torch.uint8, "wg", "vrt_patch_embed_u8", 2, "patch_embed_u8/wg"),
    (torch.uint8, "mma", "vrt_patch_embed_u8", 1, "patch_embed_u8/mma"),
    (torch.float32, None, "vrt_patch_embed_f32", None, "patch_embed_f32")])
def test_patch_embed_launch_marshals_its_variant(stub, dtype, variant, entry,
                                                 code, name):
    """uint8 images reach vrt_patch_embed_u8 with the variant's code (0:
    the rule) and the folded weight's three pieces, rows a multiple of 8
    values; float32 images their own entry point."""
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, size=(2, 16, 24, 3))
                              .astype(np.uint8)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(192, 50)).astype(np.float32))
    bias = torch.zeros(50)
    a_vec, b_vec = (torch.from_numpy(v) for v in pe.fold_affine(8))
    f = pe.fused_patch_embed
    before, by_name = f.launches, f.launches_by_kernel[name]
    out = pe._launch(images, w, bias, a_vec, b_vec, 8, torch.float32,
                     variant)
    ((got_entry, args),) = stub.calls
    assert got_entry == entry and out.shape == (2 * 2 * 3, 50)
    if code is not None:
        assert args[2] == 56  # ldw: 50 rounded up to 8 values
        assert args[5:11] == (2, 16, 24, 3, 8, 50)
        assert args[12] == code and args[13] == 4242
    assert f.launches == before + 1
    assert f.launches_by_kernel[name] == by_name + 1


@pytest.mark.parametrize("call", ["ln_f32_w", "ln_deep_k", "ln_unknown",
                                  "pe_f32_images", "pe_unknown"])
@pytest.mark.parametrize("on_stub", [False, True])
def test_forced_variant_that_does_not_take_the_call_raises(stub, call,
                                                           on_stub):
    """A forced variant the call does not take raises ValueError before
    anything launches, on the CPU (the plain version) as on the launch
    path (the stub)."""
    counts = (fused_ln.ln_matmul.launches, pe.fused_patch_embed.launches)
    if call.startswith("ln"):
        w_dtype = torch.float32 if call == "ln_f32_w" else torch.bfloat16
        k = 896 if call == "ln_deep_k" else 64
        variant = "xyz" if call == "ln_unknown" else "wg"
        x, gamma, beta, w, bias = _ln_inputs(k=k, w_dtype=w_dtype)
        with pytest.raises(ValueError, match="does not take"):
            if on_stub:
                fused_ln._launch(x, gamma, beta, w, bias, 1e-6, None,
                                 torch.float32, variant)
            else:
                fused_ln.ln_matmul(x, gamma, beta, w, bias,
                                   variant=variant)
    else:
        dtype = torch.float32 if call == "pe_f32_images" else torch.uint8
        variant = "mma" if call == "pe_f32_images" else "xyz"
        images = torch.zeros(1, 16, 16, 3, dtype=dtype)
        w, bias = torch.zeros(192, 8), torch.zeros(8)
        a_vec, b_vec = (torch.from_numpy(v) for v in pe.fold_affine(8))
        with pytest.raises(ValueError, match="does not take"):
            if on_stub:
                pe._launch(images, w, bias, a_vec, b_vec, 8, torch.float32,
                           variant)
            else:
                pe.fused_patch_embed(images, w, bias, patch_size=8,
                                     variant=variant)
    assert stub.calls == []
    assert (fused_ln.ln_matmul.launches,
            pe.fused_patch_embed.launches) == counts


@pytest.mark.parametrize("n", [768, 2304, 3072, 200, 48, 3])
def test_kernel_weight_is_what_the_tma_map_takes(n):
    """The bf16 W the wgmma variant's tensor map reads: rows of a multiple
    of 8 values (TMA's global stride, a multiple of 16 bytes), a 16-byte
    aligned base, zero past N and W unchanged before it; a misaligned
    view is copied."""
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.normal(size=(64, n)).astype(np.float32)).to(
        torch.bfloat16)
    shifted = torch.zeros(64 * n + 1, dtype=torch.bfloat16)[1:].view(64, n)
    shifted.copy_(w)  # contiguous, 2 bytes past an aligned base
    for given in (w, shifted):
        wk, ldw = fused_ln._kernel_weight(given)
        assert ldw % 8 == 0 and n <= ldw < n + 8
        assert wk.shape == (64, ldw) and wk.data_ptr() % 16 == 0
        assert torch.equal(wk[:, :n], w)
        assert not wk[:, n:].any()
    # an aligned W of whole 16-byte rows is read in place
    assert (fused_ln._kernel_weight(w)[0].data_ptr() == w.data_ptr()) == \
        (n % 8 == 0)


@pytest.mark.parametrize("d", [768, 200, 50, 8])
def test_split_weight_rows_are_what_the_tma_map_takes(d):
    """fold_split_weight's (3, K, D') pieces: D' a multiple of 8 values
    (16-byte rows for TMA), zero past D."""
    rng = np.random.default_rng(d)
    w = torch.from_numpy(rng.normal(size=(192, d)).astype(np.float32))
    a_vec, b_vec = (torch.from_numpy(v) for v in pe.fold_affine(8))
    pieces, c = pe.fold_split_weight(w, torch.zeros(d), a_vec, b_vec)
    assert pieces.dtype == torch.bfloat16 and pieces.is_contiguous()
    assert pieces.shape[:2] == (3, 192) and pieces.shape[2] % 8 == 0
    assert 0 <= pieces.shape[2] - d < 8 and not pieces[..., d:].any()
    assert c.shape == (d,)


def test_launch_u8_refuses_what_the_kernel_cannot_take(stub):
    """Pieces whose rows the tensor map cannot read, and images that are
    not uint8, raise before any launch."""
    images = torch.zeros(1, 16, 16, 3, dtype=torch.uint8)
    pieces = torch.zeros(3, 192, 12, dtype=torch.bfloat16)  # 24-byte rows
    with pytest.raises(ValueError, match="multiple of 8"):
        pe.launch_u8(images, pieces, torch.zeros(12), 8, torch.float32)
    with pytest.raises(TypeError, match="uint8"):
        pe.launch_u8(images.float(), pieces[..., :8].contiguous(),
                     torch.zeros(8), 8, torch.float32)
    assert stub.calls == []


@pytest.mark.parametrize("variant", [None, "wg", "mma"])
def test_variants_take_the_plain_route_on_the_cpu(variant):
    """On CPU tensors every offered variant runs the plain version, with
    its gradients (the Function passes the variant through)."""
    x, gamma, beta, w, bias = _ln_inputs()
    w = w.float().to(torch.bfloat16)
    args = [t.clone().requires_grad_(t.dtype == torch.float32)
            for t in (x, gamma, beta)]
    got = fused_ln.ln_matmul(*args, w, bias, activation="gelu",
                             out_dtype=torch.float32, variant=variant)
    want = fused_ln.ln_matmul_plain(x, gamma, beta, w, bias, eps=1e-6,
                                    activation="gelu",
                                    out_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.sum().backward()
    assert all(a.grad is not None for a in args)
    images = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, size=(1, 16, 16, 3)).astype(np.uint8))
    wp = torch.randn(192, 8).requires_grad_(True)
    out = pe.fused_patch_embed(images, wp, torch.zeros(8), patch_size=8,
                               variant=variant)
    out.sum().backward()
    assert out.shape == (1, 4, 8) and wp.grad is not None
