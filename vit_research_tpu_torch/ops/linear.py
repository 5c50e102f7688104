"""The encoder's f32 linears on the tensor cores: ``x @ W^T + bias``.

:func:`linear` computes what ``F.linear`` computes for an ``nn.Linear``'s
f32 weight (N, K): on a CUDA tensor by a hand-written Hopper GEMM
(``csrc/gemm_f32_wg.cu``, ``gemm_f32_wg``: TF32 ``wgmma`` on split
operands, 3xTF32, with each stage's products added to the accumulator in
f32, the bias in the f32 epilogue), on a CPU tensor by
:func:`linear_plain`. The kernel splits its operands itself, so its result
does not depend on ``torch.backends.cuda.matmul.allow_tf32``, and it
reads W as it lies on every call: nothing is cached.

It replaces no TPU kernel (the JAX package leaves these products to
XLA). ``models/vit.py::_dense`` calls it where :func:`route` says
``"kernel"``: an f32 inference product on a CUDA tensor of at least
:data:`MIN_ROWS` rows whose K and N the kernel's tiles take. Everything
else keeps its own product: ``F.linear`` (cuBLAS) for training (no
backward kernel is written: the training loops are host-bound), the
compute-dtype and int8 paths, and short products; on the CPU ``lin(x)``.
"""

from __future__ import annotations

import collections

import torch

#: k a stage and columns a tile of ``csrc/gemm_f32_wg.cu`` (BK, BN): the
#: kernel takes K and N that are multiples of them
BK = 32
BN = 128
#: the fewest rows the rule sends to the kernel; below them cuBLAS's f32
#: GEMM is faster (too few 128-row tiles to fill the card's 132 SMs).
#: cuBLAS ms over the kernel's on an H100 80GB HBM3 at 700 W, (K, N) =
#: (768, 768) / (768, 3072) / (3072, 768): 512 rows 0.77 / 1.49 / 0.75,
#: 1,024 rows 1.02 / 1.80 / 1.18, 2,048 rows 1.76 / 2.12 / 1.75
MIN_ROWS = 1024
#: the name a launch counts under in ``linear.launches_by_kernel``
KERNEL_NAME = "gemm_f32_wg"


def _records_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def route(x: torch.Tensor, weight: torch.Tensor, bias=None, *, qdg=None,
          dtype=None) -> str:
    """Where ``_dense`` sends ``x @ weight^T + bias``: ``"plain"`` for a
    tensor that is not on a CUDA card (the plain product there);
    ``"kernel"`` where every one of these holds: x, weight and bias f32,
    no int8 product (``qdg``) and no compute ``dtype``, no autograd graph
    recorded, K % :data:`BK` == 0 and N % :data:`BN` == 0, and at least
    :data:`MIN_ROWS` rows; else ``"library"`` (``F.linear``, cuBLAS). A
    library product that only its K or N kept off the kernel counts in
    ``route.declined_shape``: the program asks once a product
    (``models/vit.py::_dense``)."""
    if x.device.type != "cuda":
        return "plain"
    k = x.shape[-1]
    n = weight.shape[0]
    eligible = (qdg is None and dtype is None
                and x.dtype == weight.dtype == torch.float32
                and (bias is None or bias.dtype == torch.float32)
                and not _records_grad(x, weight, bias)
                and weight.dim() == 2 and k > 0
                and x.numel() // k >= MIN_ROWS)
    if eligible and k % BK == 0 and n % BN == 0:
        return "kernel"
    if eligible:
        route.declined_shape += 1
    return "library"


#: f32 inference products of at least :data:`MIN_ROWS` rows that
#: :func:`route` sent to the library for their K or N alone (off the
#: kernel's tiles: SigLIP's MLP at 4,304); no launch of :func:`linear`
route.declined_shape = 0


def linear_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the f32 product ``x @ weight^T``, then the bias
    added, in the kernel's order (the product whole, the bias after)."""
    out = torch.matmul(x, weight.t())
    return out if bias is None else out + bias


def _rows(x: torch.Tensor, k: int) -> tuple:
    """x as (M, K) rows and their stride, as the kernel's tensor map reads
    them: a view where the leading dims allow one (no copy), each row's K
    values contiguous, rows a multiple of 4 values apart, the base 16-byte
    aligned; ValueError otherwise."""
    rows = x.reshape(-1, k)
    lda = rows.stride(0) if rows.shape[0] > 1 else k
    if rows.stride(1) != 1 or lda < k or lda % 4:
        raise ValueError(f"x's rows must be K = {k} contiguous values a "
                         f"multiple of 4 values apart (strides "
                         f"{tuple(x.stride())})")
    if rows.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    return rows, lda


def _launch(x, weight, bias):
    from vit_research_tpu_torch.ops import _build

    dev = x.device
    k = x.shape[-1]
    n = weight.shape[0]
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if _records_grad(x, weight, bias):
        raise ValueError("the kernel has no backward: call it under "
                         "torch.no_grad() or inference_mode (training "
                         "keeps F.linear)")
    if k % BK or n % BN:
        raise ValueError(f"the kernel takes K a multiple of {BK} and N of "
                         f"{BN}, got K = {k}, N = {n}")
    if not weight.is_contiguous() or weight.data_ptr() % 16:
        raise ValueError("weight must be contiguous (N, K) and 16-byte "
                         "aligned")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("bias must be contiguous")
    rows, lda = _rows(x, k)
    m = rows.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m:
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = lib.vrt_linear_f32(
                rows.data_ptr(), weight.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                m, k, n, lda, stream)
        _build.check(code, "linear kernel")
        # plain increments: exact because device work is serialized (the
        # serve daemon runs every forward under its one device lock)
        linear.launches += 1
        linear.launches_by_kernel[KERNEL_NAME] += 1
    return out.reshape(*x.shape[:-1], n)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ weight^T + bias``.

    Args:
      x: (..., K); leading dims are flattened into rows (a view where they
        allow one).
      weight: (N, K), as ``nn.Linear`` stores it. bias: (N,) or None.
    Returns (..., N). A CPU input runs :func:`linear_plain`. A CUDA input
    launches ``gemm_f32_wg`` (counted in ``linear.launches`` and
    ``linear.launches_by_kernel``) or raises on what it does not take: a
    dtype other than f32, K or N off the tiles, rows that are not
    contiguous, a misaligned base, an autograd graph to record."""
    k = x.shape[-1]
    if weight.dim() != 2 or weight.shape[1] != k:
        raise ValueError(f"weight must be (N, K = {k}), got "
                         f"{tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got "
                         f"{tuple(bias.shape)}")
    if x.device.type == "cpu":
        return linear_plain(x, weight, bias)
    if x.device.type == "cuda":
        return _launch(x, weight, bias)
    raise ValueError(f"unsupported device {x.device}")


linear.launches = 0
#: the same launches by kernel name (:data:`KERNEL_NAME`)
linear.launches_by_kernel = collections.Counter()
