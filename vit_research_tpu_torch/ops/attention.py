"""Multi-head attention: CUDA kernel and plain version.

Port of vit_research_tpu/ops/attention.py. :func:`multi_head_attention`
computes softmax(q k^T * scale) v over (B, H, T, dh) with an f32 softmax.
On a CUDA tensor it launches the hand-written kernel in
``csrc/attention.cu`` (online softmax over K/V tiles streamed through
shared memory, so unlike the TPU kernel it has no ``MAX_KV_LEN``; bf16 on
the tensor cores, f32 on the CUDA cores). The kernel reads q, k and v
through their strides, so the backbone hands it the projections'
(B, T, H, dh) order as ``transpose(1, 2)`` views without a copy, and it
writes the output in that order too. On a CPU tensor it runs
:func:`attention_plain`, the explicit einsum/softmax of the reference's
``xla_attention``.

``key_bias`` is an optional (B, T) f32 additive bias on the keys,
softmax(q k^T * scale + bias) v: ToMe's proportional attention, where
the reference adds ``log(sizes)`` to the scores on its einsum path
(models/vit.py ToMe blocks). The kernel adds it inside its score loop.

Gradients: when an input requires grad, the call goes through
:class:`_Attention`, a ``torch.autograd.Function`` whose forward is the
kernel (the plain version on the CPU) and whose backward is the VJP of
:func:`attention_plain`, as the reference's ``custom_vjp`` takes the VJP of
``xla_attention`` (there is no backward kernel).
"""

from __future__ import annotations

import collections
import ctypes

import torch

#: head widths the kernel is compiled for (ViT-B: 64; the stage-1 chunk
#: encoder, 768 wide with 8 heads: 96; 768 wide with 6 heads, or 1,024
#: with 8: 128; the RAG/RATT heads, 768 wide with 4 heads: 192; tiny test
#: configs). A width between two of them runs zero-padded to the next
#: (:func:`kernel_head_dim`); a width above the last is not taken.
KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128, 192)
_DTYPES = (torch.float32, torch.bfloat16)
_ALIGN = 16  # bytes: the kernel moves q, k, v and o in 16-byte copies


def weak_scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: the value a Python float takes in JAX
    when it meets an array of that dtype (a weakly typed scalar takes the
    array's dtype, so ``bf16_array * 0.1`` multiplies by bf16(0.1)). torch
    keeps a Python scalar in f32 for a bf16 tensor's arithmetic; multiplying
    by this value instead gives JAX's product."""
    return torch.tensor(x, dtype=dtype).item()


def attention_plain(q, k, v, *, scale=None, key_bias=None) -> torch.Tensor:
    """Reference implementation: (B, H, T, d) -> (B, H, T, d). Scores
    and the product with v stay in the input dtype; the softmax runs in
    f32 (as ``xla_attention``). The scale is rounded to the input dtype
    first, as JAX rounds the Python float (:func:`weak_scalar`).
    ``key_bias`` (B, T) is added to the scores in their dtype, as the
    reference's ToMe path adds ``log_size[:, None, None, :]``."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * weak_scalar(scale,
                                                                 q.dtype)
    if key_bias is not None:
        scores = scores + key_bias[:, None, None, :].to(scores.dtype)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def kernel_head_dim(d: int) -> int | None:
    """The compiled width the kernel runs head width ``d`` at: ``d``
    itself, or the next wider one, with q, k and v zero-padded to it;
    None above the widest (192)."""
    return next((w for w in KERNEL_HEAD_DIMS if w >= d), None)


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """(B, H, T, d) -> (B, H, T, width) with zeros in columns d..width-1,
    as the ``transpose(1, 2)`` view of a contiguous (B, T, H, width)
    tensor (the projections' order). Zero columns add nothing to q k^T,
    and the output's first d columns are those of the unpadded inputs,
    so attention at the true scale ``d ** -0.5`` is unchanged."""
    b, h, t, d = x.shape
    out = x.new_zeros(b, t, h, width).transpose(1, 2)
    out[..., :d] = x
    return out


def _kernel_strides(x: torch.Tensor, name: str = "x") -> tuple:
    """(batch, head, token) strides in elements of a (B, H, T, dh) view
    as the kernel reads it. A dim of size 1 is never stepped over, so its
    stride is given as 0. Raises ValueError for a layout the kernel's
    16-byte loads cannot take: a last dim with stride other than 1, a base
    address or a stride that is not a multiple of 16 bytes."""
    if x.dim() != 4:
        raise ValueError(f"{name} must be (B, H, T, dh), got {tuple(x.shape)}")
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        raise ValueError(f"{name} needs stride 1 on its last dim (head_dim), "
                         f"got strides {x.stride()}")
    item = x.element_size()
    if x.data_ptr() % _ALIGN:
        raise ValueError(f"{name}'s base address is not {_ALIGN}-byte "
                         "aligned")
    strides = tuple(x.stride(i) if x.shape[i] > 1 else 0 for i in range(3))
    if any(s * item % _ALIGN for s in strides):
        raise ValueError(f"{name}'s batch/head/token strides {x.stride()[:3]}"
                         f" are not multiples of {_ALIGN} bytes")
    return strides


def _check_key_bias(key_bias, q) -> None:
    """Raise ValueError unless ``key_bias`` is a (B, T) f32 tensor on q's
    device with stride 1 along T (the kernel reads its rows through the
    batch stride)."""
    b, _, t, _ = q.shape
    if not isinstance(key_bias, torch.Tensor):
        raise ValueError(f"key_bias must be a tensor, got "
                         f"{type(key_bias).__name__}")
    if tuple(key_bias.shape) != (b, t):
        raise ValueError(f"key_bias must be (B, T) = {(b, t)}, got "
                         f"{tuple(key_bias.shape)}")
    if key_bias.dtype != torch.float32:
        raise ValueError(f"key_bias must be float32, got {key_bias.dtype}")
    if key_bias.device != q.device:
        raise ValueError(f"key_bias is on {key_bias.device}, q on "
                         f"{q.device}")
    if t > 1 and key_bias.stride(1) != 1:
        raise ValueError(f"key_bias needs stride 1 along T, got strides "
                         f"{key_bias.stride()}")


def _launch(q, k, v, scale, key_bias):
    from vit_research_tpu_torch.ops import _build

    b, h, t, d = q.shape
    width = kernel_head_dim(d)
    if width is None:
        raise ValueError(f"attention kernel supports head_dim up to "
                         f"{KERNEL_HEAD_DIMS[-1]}, got {d}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
    if width != d:
        # the scale stays the caller's (d ** -0.5 by default)
        q, k, v = (pad_head_dim(x, width) for x in (q, k, v))
    strides = [s for name, x in (("q", q), ("k", k), ("v", v))
               for s in _kernel_strides(x, name)]
    # The output in projection order (B, T, H, dh), seen as (B, H, T, dh).
    o = torch.empty(b, t, h, width, dtype=q.dtype, device=q.device) \
        .transpose(1, 2)
    strides += _kernel_strides(o, "o")
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.vrt_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, t,
            width, (ctypes.c_longlong * 12)(*strides), float(scale),
            int(q.dtype == torch.bfloat16),
            None if key_bias is None else key_bias.data_ptr(),
            0 if key_bias is None or b == 1 else key_bias.stride(0), stream)
    _build.check(code, "attention kernel")
    # a plain increment: exact because device work is serialized (the
    # serve daemon runs every forward under its one device lock)
    multi_head_attention.launches += 1
    multi_head_attention.launches_by_kernel[
        f"attn_{'bf16' if q.dtype == torch.bfloat16 else 'f32'}<{width}>"] += 1
    if width != d:
        multi_head_attention.padded_launches += 1
        o = o[..., :d]
    return o


def _forward(q, k, v, scale, key_bias):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, key_bias=key_bias)
    if q.device.type == "cuda":
        return _launch(q, k, v, scale, key_bias)
    raise ValueError(f"unsupported device {q.device}")


class _Attention(torch.autograd.Function):
    """Forward: :func:`_forward` (the kernel on CUDA). Backward: the VJP
    of :func:`attention_plain` at the saved inputs, for q, k, v and the key
    bias, whichever require grad."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, scale):
        inputs = (q, k, v, key_bias)
        ctx.save_for_backward(*(t if t is not None and t.requires_grad
                                else None for t in inputs))
        # inputs that take no grad may be inference tensors (a cached key
        # bias), which save_for_backward refuses: kept on ctx instead
        ctx.constants = [None if t is None or t.requires_grad else t
                         for t in inputs]
        ctx.scale = scale
        return _forward(q, k, v, scale, key_bias)

    @staticmethod
    def backward(ctx, grad):
        saved = [c if t is None else t
                 for t, c in zip(ctx.saved_tensors, ctx.constants)]
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad[:4])]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                q, k, v, key_bias = inputs
                out = attention_plain(q, k, v, scale=ctx.scale,
                                      key_bias=key_bias)
                grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in inputs), None)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale=None, key_bias=None) -> torch.Tensor:
    """softmax(q k^T * scale + key_bias) v for (B, H, T, head_dim) f32 or
    bf16 inputs; ``scale`` defaults to head_dim ** -0.5, ``key_bias`` is
    None or a finite (B, T) f32 tensor on q's device with stride 1 along T
    (else ValueError). The output has the input dtype.

    A CUDA input launches the kernel (counted in
    ``multi_head_attention.launches``, and by instantiation in
    ``multi_head_attention.launches_by_kernel``); q, k and v may be any
    views whose last dim has stride 1 and whose base and other strides are
    multiples of 16 bytes (see :func:`_kernel_strides`), and the output is the
    ``transpose(1, 2)`` view of a contiguous (B, T, H, head_dim) tensor.
    A head width between two compiled ones runs zero-padded to the next
    (counted in ``multi_head_attention.padded_launches`` too; the output
    is then a view of the first head_dim columns). It raises on a head
    width above 192 or a layout the kernel does not take. A CPU
    input runs :func:`attention_plain`. When an input requires grad
    (and grad mode is on), the call goes through :class:`_Attention`, so
    the gradients are the plain version's."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, got {q.dtype}")
    if key_bias is not None:
        _check_key_bias(key_bias, q)
    d = q.shape[-1]
    scale = float(d ** -0.5) if scale is None else float(scale)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, key_bias)):
        return _Attention.apply(q, k, v, key_bias, scale)
    return _forward(q, k, v, scale, key_bias)


multi_head_attention.launches = 0
multi_head_attention.padded_launches = 0
#: the same launches by instantiation, e.g. ``attn_bf16<96>``
multi_head_attention.launches_by_kernel = collections.Counter()
