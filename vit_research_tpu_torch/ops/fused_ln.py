"""Fused LayerNorm + projection: CUDA kernels and plain version.

Port of vit_research_tpu/ops/fused_ln.py. :func:`ln_matmul` computes
``act(LayerNorm(x; gamma, beta) @ W + bias)``: row statistics in f32 (mean,
then the centred variance), ``(x - mean) * rsqrt(var + eps) * gamma +
beta`` cast to W's dtype, the product accumulated in f32, the bias added in
f32, then no activation, exact GELU or tanh-GELU, and the result cast to
``out_dtype`` (W's dtype by default).

On a CUDA tensor it launches one of two hand-written kernels by the rule
:func:`ln_variant` mirrors (``csrc/fused_ln.cuh``), so the normalised
(M, K) tensor never exists in device memory:

- ``"wg"`` (``csrc/fused_ln_wg.cu``, on the wgmma mainloop of
  ``csrc/wg_gemm.cuh``): a bf16 W at 1 <= K <= :data:`WG_MAX_K`. A block
  normalises its 64 rows once into a K-wide bf16 slab in shared memory
  and multiplies it against every column tile of W, which TMA streams in.
- ``"mma"`` (``csrc/fused_ln.cu``, on the mma.sync mainloop of
  ``csrc/tc_gemm.cuh``): an f32 W in three TF32 passes (3xTF32: the
  wrapper splits W with :func:`tf32_split`, the kernel splits the LN output
  the same way), which keeps f32 accuracy whatever
  ``torch.backends.cuda.matmul.allow_tf32`` says, and a bf16 W past
  :data:`WG_MAX_K`.

``ln_matmul(..., variant="mma")`` forces the mma.sync variant where the
rule takes wgmma (to time the two in one process); a variant that does not
take the call raises ValueError. On a CPU tensor it runs
:func:`ln_matmul_plain`, the explicit composition of the reference's
``_ln_matmul_xla``. Gradients come from a ``torch.autograd.Function``
whose backward is the plain composition's VJP, as the reference's
``custom_vjp`` (there is no backward kernel).

As in the reference, the backbone does not call it: it is a tested
building block beside ``EncoderBlock``'s LayerNorm + Linear.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

#: activation name -> the kernel's code
ACTIVATIONS = {None: 0, "gelu": 1, "gelu_tanh": 2}
_DTYPES = (torch.float32, torch.bfloat16)
#: the deepest K the wgmma variant takes: its block's K-wide slab of
#: normalised rows fits in shared memory beside W's ring (LN_WG_MAX_K in
#: csrc/fused_ln.cuh)
WG_MAX_K = 768
#: the code of each variant at the C entry point (csrc/fused_ln.cuh's
#: LnVariant); 0 is the rule
VARIANT_CODES = {"mma": 1, "wg": 2}


def ln_variants(w_dtype: torch.dtype, k: int) -> tuple:
    """Every variant that takes a W of ``w_dtype`` at depth ``k``, the
    rule's first: ``"wg"`` for a bf16 W at 1 <= k <= :data:`WG_MAX_K`,
    then ``"mma"``, which takes every call."""
    wg = ("wg",) if w_dtype == torch.bfloat16 and 1 <= k <= WG_MAX_K else ()
    return wg + ("mma",)


def ln_variant(w_dtype: torch.dtype, k: int) -> str:
    """The rule's variant: the first of :func:`ln_variants`."""
    return ln_variants(w_dtype, k)[0]


def kernel_name(variant: str) -> str:
    """The name a launch counts under in ``ln_matmul.launches_by_kernel``:
    ``ln_gemm/wg`` or ``ln_gemm/mma``."""
    return f"ln_gemm/{variant}"


def _check_variant(variant, w_dtype, k: int) -> None:
    """Raise ValueError unless ``variant`` is None or takes the call."""
    takes = ln_variants(w_dtype, k)
    if variant is not None and variant not in takes:
        raise ValueError(f"variant {variant!r} does not take a "
                         f"{str(w_dtype).split('.')[-1]} W at K = {k} (the "
                         f"call takes {', '.join(takes)})")


def layer_norm_rows(x, gamma, beta, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in f32: the mean, then the centred
    variance, then ``(x - mean) * rsqrt(var + eps) * gamma + beta``."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mean
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * gamma + beta


def ln_matmul_plain(x, gamma, beta, w, bias, *, eps: float,
                    activation: str | None, out_dtype) -> torch.Tensor:
    """Plain PyTorch version on (M, K) rows -> (M, N). The product of the
    W-dtype-rounded LN output with W is taken in f32, which is the f32
    accumulation of exact products the reference asks for."""
    y = layer_norm_rows(x, gamma, beta, eps).to(w.dtype)
    out = y.to(torch.float32) @ w.to(torch.float32) + bias.to(torch.float32)
    if activation == "gelu":
        out = F.gelu(out, approximate="none")
    elif activation == "gelu_tanh":
        out = F.gelu(out, approximate="tanh")
    return out.to(out_dtype)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 values (10 explicit significand bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds (finite values)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(w: torch.Tensor, ldw: int | None = None) -> torch.Tensor:
    """(K, N) f32 -> (2, K, ldw) f32: ``W_hi = tf32(W)`` and ``W_lo =
    tf32(W - W_hi)``, the f32 weight's pieces for 3xTF32; columns past N
    are zero."""
    k, n = w.shape
    ldw = ldw or n
    pieces = torch.zeros((2, k, ldw), dtype=torch.float32, device=w.device)
    hi = tf32_round(w)
    pieces[0, :, :n] = hi
    pieces[1, :, :n] = tf32_round(w - hi)
    return pieces


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _kernel_weight(w):
    """W as the kernel reads it: f32 as its two TF32 pieces, bf16 as it
    is; rows padded to 16 bytes and 16-byte aligned. Returns (w, ldw)."""
    k, n = w.shape
    if w.dtype == torch.float32:
        ldw = _round_up(n, 4)
        return tf32_split(w, ldw), ldw
    ldw = _round_up(n, 8)
    if ldw == n and w.data_ptr() % 16 == 0:
        return w, ldw
    padded = torch.zeros((k, ldw), dtype=w.dtype, device=w.device)
    padded[:, :n] = w
    return padded, ldw


def _launch(x, gamma, beta, w, bias, eps, activation, out_dtype,
            variant=None):
    from vit_research_tpu_torch.ops import _build

    dev = x.device
    for name, t in (("gamma", gamma), ("beta", beta), ("w", w),
                    ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (leading dims x K)")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous (K, N)")
    # Exact conversions of the small vectors (the reference promotes them
    # to f32 in the same expressions).
    gamma, beta, bias = (t.to(torch.float32).contiguous()
                         for t in (gamma, beta, bias))
    m, k = x.shape
    n = w.shape[1]
    variant = variant or ln_variant(w.dtype, k)
    _check_variant(variant, w.dtype, k)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    wk, ldw = _kernel_weight(w)
    # the mma.sync variant's row statistics (the wgmma variant takes its
    # own in the GEMM's blocks)
    stats = (torch.empty(2 * m, dtype=torch.float32, device=dev)
             if variant == "mma" else None)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.vrt_ln_matmul(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wk.data_ptr(),
            bias.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(), m, k, n, ldw,
            float(eps), ACTIVATIONS[activation],
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), VARIANT_CODES[variant], stream)
    _build.check(code, "ln_matmul kernel")
    # plain increments: exact because device work is serialized (the
    # serve daemon runs every forward under its one device lock)
    ln_matmul.launches += 1
    ln_matmul.launches_by_kernel[kernel_name(variant)] += 1
    return out


def _forced(variant) -> tuple:
    """The trailing argument of :func:`_forward` for a forced variant; none
    for the rule's, so that its eight-argument form stays the common
    call."""
    return () if variant is None else (variant,)


def _forward(x, gamma, beta, w, bias, eps, activation, out_dtype,
             variant=None):
    if x.device.type == "cpu":
        return ln_matmul_plain(x, gamma, beta, w, bias, eps=eps,
                               activation=activation, out_dtype=out_dtype)
    if x.device.type == "cuda":
        return _launch(x, gamma, beta, w, bias, eps, activation, out_dtype,
                       variant)
    raise ValueError(f"unsupported device {x.device}")


class _LnMatmul(torch.autograd.Function):
    """Forward: the kernel (or the plain version on the CPU). Backward:
    the VJP of :func:`ln_matmul_plain` at the saved inputs."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, eps, activation, out_dtype,
                variant):
        ctx.save_for_backward(x, gamma, beta, w, bias)
        ctx.cfg = dict(eps=eps, activation=activation, out_dtype=out_dtype)
        return _forward(x, gamma, beta, w, bias, eps, activation, out_dtype,
                        *_forced(variant))

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad[:5])]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = ln_matmul_plain(*inputs, **ctx.cfg)
                grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None, None)


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor | None = None, *,
              eps: float = 1e-6, activation: str | None = None,
              out_dtype=None, variant: str | None = None) -> torch.Tensor:
    """``activation(LayerNorm(x; gamma, beta) @ w + bias)`` in one pass.

    Args:
      x: (..., K) f32 or bf16; leading dims are flattened into rows.
      gamma, beta: (K,) LayerNorm scale and shift.
      w: (K, N) f32 or bf16 projection. bias: (N,) or None (zeros).
      activation: None | 'gelu' (exact, erf) | 'gelu_tanh'.
      out_dtype: f32 or bf16; defaults to ``w.dtype``.
      variant: None (the rule, :func:`ln_variant`), or ``"wg"`` or
        ``"mma"`` where :func:`ln_variants` offers it (else ValueError,
        before any launch); for measurement.
    Returns (..., N). A CUDA input launches the kernel (counted in
    ``ln_matmul.launches``, and by variant in
    ``ln_matmul.launches_by_kernel``) and raises on what it does not take;
    a CPU input runs :func:`ln_matmul_plain`."""
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"w must be (K = {k}, N), got {tuple(w.shape)}")
    n = w.shape[1]
    out_dtype = out_dtype or w.dtype
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of "
                         f"{sorted(ACTIVATIONS, key=str)}, got {activation!r}")
    if bias is None:
        bias = torch.zeros(n, dtype=torch.float32, device=x.device)
    for name, t, size in (("gamma", gamma, k), ("beta", beta, k),
                          ("bias", bias, n)):
        if tuple(t.shape) != (size,):
            raise ValueError(f"{name} must be ({size},), got "
                             f"{tuple(t.shape)}")
    _check_variant(variant, w.dtype, k)
    out = _LnMatmul.apply(x.reshape(-1, k), gamma, beta, w, bias, float(eps),
                          activation, out_dtype, variant)
    return out.reshape(*x.shape[:-1], n)


ln_matmul.launches = 0
#: the same launches by variant (:func:`kernel_name`): ``ln_gemm/wg``,
#: ``ln_gemm/mma``
ln_matmul.launches_by_kernel = collections.Counter()
