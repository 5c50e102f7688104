"""The encoder linears' split-operand GEMM (``ops/linear.py``,
``csrc/gemm_f32_wg.cu``) on the CPU, with no card: the plain version
against ``F.linear``, the routing rule's table (one case per path), the
six backbone sites reaching the product through ``models/vit.py::_dense``,
what the wrapper hands the C entry point and what it refuses before any
launch (against a stub library), the constants the rule mirrors from the
source, and the kernel's name against the benchmark's kernel groups.

The arithmetic of the kernel (3xTF32 with a per-stage flush) is modelled
in tests/test_torch_tf32_split.py; the kernel itself is held on the card
in tests/test_torch_cuda.py.
"""

import os
import re
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_research_tpu_torch.models import vit
from vit_research_tpu_torch.ops import _build
from vit_research_tpu_torch.ops import linear as lin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "vit_research_tpu_torch", "csrc",
                      "gemm_f32_wg.cu")
#: the rows of the two embed cells' batches: 256 frames at T = 197, 313
CELL_ROWS = (256 * 197, 256 * 313)


def _inputs(m=5, k=64, n=128, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((*lead, m, k)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) * k ** -0.5).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return x, w, b


@pytest.mark.parametrize("m,k,n,lead,with_bias", [
    (5, 64, 128, (), True), (197, 768, 768, (2,), True),
    (7, 3072, 768, (), False), (1, 32, 256, (3, 2), True),
    (9, 40, 10, (), True)])
def test_plain_version_is_f_linear(m, k, n, lead, with_bias):
    """The plain version (the product whole, then the bias) agrees with
    F.linear to f32's rounding of the bias add, at any leading dims; the
    wrapper runs it on CPU tensors."""
    x, w, b = _inputs(m, k, n, seed=m + k, lead=lead)
    b = b if with_bias else None
    want = F.linear(x, w, b)
    got = lin.linear_plain(x, w, b)
    assert got.shape == want.shape == (*lead, m, n)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 4e-7 * scale
    assert torch.equal(lin.linear(x, w, b), got)


class _Fake:
    """What the rule reads of a tensor, on any device."""

    def __init__(self, shape, *, device="cuda", dtype=torch.float32,
                 requires_grad=False):
        self.shape = tuple(shape)
        self.device = types.SimpleNamespace(type=device)
        self.dtype = dtype
        self.requires_grad = requires_grad

    def numel(self):
        return int(np.prod(self.shape))

    def dim(self):
        return len(self.shape)


def _route(m=CELL_ROWS[0], k=768, n=768, *, device="cuda",
           tensors=torch.float32, grad=False, **kw):
    x = _Fake((m // 197, 197, k) if m % 197 == 0 else (m, k),
              device=device, dtype=tensors)
    w = _Fake((n, k), device=device, dtype=tensors, requires_grad=grad)
    b = _Fake((n,), device=device, dtype=tensors, requires_grad=grad)
    return lin.route(x, w, b, **kw)


@pytest.mark.parametrize("case,want", [
    # both embed cells, every site: (K, N) of q/k/v/out, fc1, fc2
    *((dict(m=m, k=k, n=n), "kernel") for m in CELL_ROWS
      for k, n in ((768, 768), (768, 3072), (3072, 768))),
    (dict(m=lin.MIN_ROWS), "kernel"),             # the threshold itself
    (dict(m=lin.MIN_ROWS - 1), "library"),        # a short product
    (dict(m=197), "library"),                     # one frame
    (dict(grad=True), "library"),                 # a training step
    (dict(tensors=torch.bfloat16), "library"),    # the bf16 backbone
    (dict(dtype=torch.bfloat16), "library"),      # heads' compute dtype
    (dict(qdg=object()), "library"),              # the int8 fast profile
    (dict(k=40), "library"),                      # K off the stages
    (dict(n=200), "library"),                     # N off the tiles
    (dict(device="cpu"), "plain"),                # the CPU
    (dict(device="cpu", grad=True), "plain"),
])
def test_route_table(case, want):
    """One case per path of the rule: f32 inference at the cells' rows
    takes the kernel at all six sites; a recorded graph, a compute dtype
    (heads under bf16), an int8 product, fewer than MIN_ROWS rows, K or N
    off the tiles take cuBLAS; a CPU tensor the plain product."""
    assert _route(**case) == want


@pytest.mark.parametrize("case,counted", [
    (dict(k=1152, n=4304), True),                 # SigLIP's fc1: N off
    (dict(k=4304, n=1152), True),                 # its fc2: K off
    (dict(k=1152, n=1152), False),                # on the tiles: kernel
    (dict(m=lin.MIN_ROWS - 1, n=200), False),     # short: not the shape
    (dict(n=200, grad=True), False),              # a training step
    (dict(n=200, tensors=torch.bfloat16), False),
    (dict(n=200, qdg=object()), False),
    (dict(n=200, device="cpu"), False),
])
def test_library_shape_counter(case, counted):
    """A product that the kernel would take but for K or N (f32
    inference, at least MIN_ROWS rows) counts in route.declined_shape;
    linear's launch counters do not move."""
    before = lin.route.declined_shape
    launches = lin.linear.launches
    by_kernel = dict(lin.linear.launches_by_kernel)
    got = _route(**case)
    assert lin.route.declined_shape - before == int(counted)
    assert got == ("plain" if case.get("device") == "cpu" else
                   "kernel" if case.get("n", 768) == 1152
                   and case.get("k", 768) == 1152 else "library")
    assert lin.linear.launches == launches
    assert dict(lin.linear.launches_by_kernel) == by_kernel


def test_route_reads_autograd_state():
    """Grad-requiring weights take cuBLAS while a graph is recorded, the
    kernel under no_grad and inference_mode (the engine's forward)."""
    x = _Fake((CELL_ROWS[0], 768))
    w = _Fake((768, 768), requires_grad=True)
    assert lin.route(x, w, None) == "library"
    with torch.no_grad():
        assert lin.route(x, w, None) == "kernel"
    with torch.inference_mode():
        assert lin.route(x, w, None) == "kernel"


def test_every_backbone_site_reaches_the_product_through_dense(monkeypatch):
    """q, k, v, out and fc1, fc2 of each block go through _dense, which
    hands the rule the layer's weight and bias and, where it says
    "kernel", calls ops/linear.py's wrapper with them."""
    seen, routed = [], []

    def fake_route(x, w, b, *, qdg=None, dtype=None):
        routed.append((tuple(w.shape), qdg, dtype))
        return "kernel"

    def fake_linear(x, w, b):
        seen.append(tuple(w.shape))
        return F.linear(x, w, b)

    monkeypatch.setattr(lin, "route", fake_route)
    monkeypatch.setattr(lin, "linear", fake_linear)
    block = vit.EncoderBlock(32, 2, 64).eval()
    x = torch.randn(2, 5, 32)
    with torch.no_grad():
        block(x)
    assert sorted(seen) == sorted([(32, 32)] * 4 + [(64, 32), (32, 64)])
    assert all(q is None and d is None for _, q, d in routed)


def test_dense_keeps_its_products_where_the_rule_says_so(monkeypatch):
    """Where the rule does not say "kernel", _dense runs what it ran
    before: lin(x), the compute-dtype product, the int8 product; the
    wrapper is never called."""
    monkeypatch.setattr(lin, "linear", lambda *a: pytest.fail("launched"))
    layer = torch.nn.Linear(32, 128)
    x = torch.randn(3, 32)
    assert torch.equal(vit._dense(layer, x), layer(x))
    got = vit._dense(layer, x, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    calls = []

    def qdg(a, w):
        calls.append(w.shape)
        return a @ w.t()

    vit._dense(layer, x, qdg)
    assert calls == [(128, 32)]


class _StubLibrary:
    """Records vrt_linear_f32's arguments; returns ``code``."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    def vrt_linear_f32(self, *args):
        self.calls.append(args)
        return self.code

    def vrt_error_string(self, code):
        return b"stub error"


class _Stream:
    cuda_stream = 4242


@pytest.fixture
def stub(monkeypatch):
    """The wrapper's library and CUDA context replaced, so that its
    launch path runs on CPU tensors."""
    lib_ = _StubLibrary()

    class _Device:
        def __init__(self, index):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(_build, "library", lambda: lib_)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    return lib_


@pytest.mark.parametrize("lead,m,k,n,with_bias", [
    ((), 197, 768, 768, True), ((2,), 197, 768, 3072, True),
    ((4,), 313, 3072, 768, False), ((), 1, 32, 128, True)])
def test_launch_marshals_its_arguments(stub, lead, m, k, n, with_bias):
    """The rows as a view of x (no copy), W and the bias in place, the
    output (M, N), M, K, N, the row stride and the stream; one launch
    counted under the kernel's name."""
    x, w, b = _inputs(m, k, n, lead=lead)
    b = b if with_bias else None
    before = lin.linear.launches
    by_name = lin.linear.launches_by_kernel[lin.KERNEL_NAME]
    out = lin._launch(x, w, b)
    ((args),) = stub.calls
    rows = int(np.prod(lead)) * m
    assert len(args) == 9
    assert args[0] == x.data_ptr() and args[1] == w.data_ptr()
    assert args[2] == (None if b is None else b.data_ptr())
    assert args[3] == out.data_ptr() and out.shape == (*lead, m, n)
    assert args[4:8] == (rows, k, n, k) and args[8] == 4242
    assert lin.linear.launches == before + 1
    assert lin.linear.launches_by_kernel[lin.KERNEL_NAME] == by_name + 1


def test_launch_reads_strided_rows_in_place(stub):
    """Rows further apart than K (a slice of wider rows) go as a view
    with their stride: no copy."""
    wide = torch.randn(300, 800)
    x = wide[:, :768]
    w = torch.randn(768, 768)
    lin._launch(x, w, None)
    ((args),) = stub.calls
    assert args[0] == x.data_ptr() and args[7] == 800 and args[4] == 300


def test_launch_raises_on_a_cuda_error(stub):
    stub.code = 1
    x, w, b = _inputs(5, 64, 128)
    with pytest.raises(RuntimeError, match="linear kernel: CUDA error 1"):
        lin._launch(x, w, b)


@pytest.mark.parametrize("fault,exc,match", [
    ("bf16", TypeError, "float32"),
    ("k", ValueError, "multiple of 32"),
    ("n", ValueError, "multiple of 32 and N of 128"),
    ("misaligned", ValueError, "16-byte aligned"),
    ("transposed", ValueError, "contiguous values"),
    ("row_stride", ValueError, "multiple of 4"),
    ("weight_view", ValueError, "weight must be contiguous"),
    ("grad", ValueError, "no backward"),
    ("bias_shape", ValueError, "bias must be"),
    ("weight_shape", ValueError, "weight must be")])
def test_launch_refuses_what_the_kernel_does_not_take(stub, fault, exc,
                                                      match):
    """What the kernel cannot take raises before any launch (the C entry
    point refuses the same with cudaErrorInvalidValue): the wrapper never
    copies or falls back."""
    x, w, b = _inputs(64, 64, 128)
    if fault == "bf16":
        x = x.to(torch.bfloat16)
    elif fault == "k":
        x, w = x[:, :40].contiguous(), w[:, :40].contiguous()
    elif fault == "n":
        w, b = w[:100].contiguous(), b[:100].contiguous()
    elif fault == "misaligned":
        x = torch.zeros(64 * 64 + 1)[1:].view(64, 64)
    elif fault == "transposed":
        x = torch.randn(64, 64).t()
    elif fault == "row_stride":
        x = torch.randn(64, 66)[:, :64]
    elif fault == "weight_view":
        w = torch.randn(64, 128).t()
    elif fault == "grad":
        w = w.requires_grad_(True)
    elif fault == "bias_shape":
        b = b[:64]
    elif fault == "weight_shape":
        w = w[:, :32]
    before = lin.linear.launches
    with pytest.raises(exc, match=match):
        if fault.endswith("_shape"):
            lin.linear(x, w, b)
        else:
            lin._launch(x, w, b)
    assert stub.calls == [] and lin.linear.launches == before


def _source_constants() -> dict:
    with open(SOURCE) as fh:
        text = fh.read()
    return {name: int(value) for name, value in re.findall(
        r"constexpr int (\w+) = (\d+);", text)}, text


def test_rule_mirrors_the_kernels_tiles():
    """ops/linear.py's BK and BN are the kernel's; its shared memory (the
    ring of x's tile and W's two pieces a stage, the barriers) is what
    its static_assert pins, one block an SM on the H100."""
    consts, text = _source_constants()
    assert (consts["BK"], consts["BN"]) == (lin.BK, lin.BN)
    assert consts["BK"] * 4 == 128  # a stage is one 128-byte swizzle row
    stage = consts["BM"] * 128 + 2 * consts["BN"] * 128
    smem = 1024 + consts["STAGES"] * stage + 2 * consts["STAGES"] * 8
    assert f"Smem::BYTES == {smem}" in text
    assert smem <= 232_448 < 2 * smem
    assert "K % BK != 0 || N % BN != 0" in text


def test_kernel_name_lands_in_the_linear_group_alone():
    """The kernel's symbol, as the profiler names it, matches the
    benchmark's ``linear`` group and no other group's pattern."""
    _, text = _source_constants()
    assert re.search(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                     r"gemm_f32_wg\(", text)
    assert lin.KERNEL_NAME == "gemm_f32_wg"
    symbol = ("(anonymous namespace)::gemm_f32_wg(CUtensorMap_st, "
              "(anonymous namespace)::LinearArgs)")
    root = os.path.join(REPO, "bench_port", "kernel_groups")
    hits = set()
    for group in os.listdir(root):
        for name in os.listdir(os.path.join(root, group)):
            with open(os.path.join(root, group, name)) as fh:
                for line in fh:
                    line = line.strip()
                    if line and not line.startswith("#") and \
                            re.search(line, symbol):
                        hits.add(group)
    assert hits == {"linear"}
