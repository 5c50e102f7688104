"""Fused LayerNorm + projection: CUDA kernel and plain version.

Port of vit_research_tpu/ops/fused_ln.py. :func:`ln_matmul` computes
``act(LayerNorm(x; gamma, beta) @ W + bias)``: row statistics in f32 (mean,
then the centred variance), ``(x - mean) * rsqrt(var + eps) * gamma +
beta`` cast to W's dtype, the product accumulated in f32, the bias added in
f32, then no activation, exact GELU or tanh-GELU, and the result cast to
``out_dtype`` (W's dtype by default).

On a CUDA tensor it launches the hand-written kernel in
``csrc/fused_ln.cu``, whose GEMM tile loader normalises in registers, so
the normalised (M, K) tensor never exists in device memory; on a CPU
tensor it runs :func:`ln_matmul_plain`, the explicit composition of the
reference's ``_ln_matmul_xla``. Gradients come from a
``torch.autograd.Function`` whose backward is the plain composition's VJP,
as the reference's ``custom_vjp`` (there is no backward kernel).

As in the reference, the backbone does not call it: it is a tested
building block beside ``EncoderBlock``'s LayerNorm + Linear.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: activation name -> the kernel's code
ACTIVATIONS = {None: 0, "gelu": 1, "gelu_tanh": 2}
_DTYPES = (torch.float32, torch.bfloat16)


def ln_matmul_plain(x, gamma, beta, w, bias, *, eps: float,
                    activation: str | None, out_dtype) -> torch.Tensor:
    """Plain PyTorch version on (M, K) rows -> (M, N). The product of the
    W-dtype-rounded LN output with W is taken in f32, which is the f32
    accumulation of exact products the reference asks for."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    xc = xf - mean
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + eps) * gamma + beta).to(w.dtype)
    out = y.to(torch.float32) @ w.to(torch.float32) + bias.to(torch.float32)
    if activation == "gelu":
        out = F.gelu(out, approximate="none")
    elif activation == "gelu_tanh":
        out = F.gelu(out, approximate="tanh")
    return out.to(out_dtype)


def _launch(x, gamma, beta, w, bias, eps, activation, out_dtype):
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
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.vrt_ln_matmul(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
            bias.data_ptr(), out.data_ptr(), m, k, n, float(eps),
            ACTIVATIONS[activation], int(x.dtype == torch.bfloat16),
            int(w.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), stream)
    _build.check(code, "ln_matmul kernel")
    ln_matmul.launches += 1
    return out


def _forward(x, gamma, beta, w, bias, eps, activation, out_dtype):
    if x.device.type == "cpu":
        return ln_matmul_plain(x, gamma, beta, w, bias, eps=eps,
                               activation=activation, out_dtype=out_dtype)
    if x.device.type == "cuda":
        return _launch(x, gamma, beta, w, bias, eps, activation, out_dtype)
    raise ValueError(f"unsupported device {x.device}")


class _LnMatmul(torch.autograd.Function):
    """Forward: the kernel (or the plain version on the CPU). Backward:
    the VJP of :func:`ln_matmul_plain` at the saved inputs."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, eps, activation, out_dtype):
        ctx.save_for_backward(x, gamma, beta, w, bias)
        ctx.cfg = dict(eps=eps, activation=activation, out_dtype=out_dtype)
        return _forward(x, gamma, beta, w, bias, eps, activation, out_dtype)

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
                None, None, None)


def ln_matmul(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor | None = None, *,
              eps: float = 1e-6, activation: str | None = None,
              out_dtype=None) -> torch.Tensor:
    """``activation(LayerNorm(x; gamma, beta) @ w + bias)`` in one pass.

    Args:
      x: (..., K) f32 or bf16; leading dims are flattened into rows.
      gamma, beta: (K,) LayerNorm scale and shift.
      w: (K, N) f32 or bf16 projection. bias: (N,) or None (zeros).
      activation: None | 'gelu' (exact, erf) | 'gelu_tanh'.
      out_dtype: f32 or bf16; defaults to ``w.dtype``.
    Returns (..., N). A CUDA input launches the kernel (counted in
    ``ln_matmul.launches``) and raises on what it does not take; a CPU
    input runs :func:`ln_matmul_plain`."""
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
    out = _LnMatmul.apply(x.reshape(-1, k), gamma, beta, w, bias, float(eps),
                          activation, out_dtype)
    return out.reshape(*x.shape[:-1], n)


ln_matmul.launches = 0
