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
"""

from __future__ import annotations

import ctypes

import torch

#: head widths the kernel is compiled for (ViT-B: 64; tiny test configs)
KERNEL_HEAD_DIMS = (16, 32, 64)
_DTYPES = (torch.float32, torch.bfloat16)
_ALIGN = 16  # bytes: the kernel moves q, k, v and o in 16-byte copies


def attention_plain(q, k, v, *, scale=None) -> torch.Tensor:
    """Reference implementation: (B, H, T, d) -> (B, H, T, d). Scores
    and the product with v stay in the input dtype; the softmax runs in
    f32 (as ``xla_attention``)."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


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


def _launch(q, k, v, scale):
    from vit_research_tpu_torch.ops import _build

    b, h, t, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel supports head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {d}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
    strides = [s for name, x in (("q", q), ("k", k), ("v", v))
               for s in _kernel_strides(x, name)]
    # The output in projection order (B, T, H, dh), seen as (B, H, T, dh).
    o = torch.empty(b, t, h, d, dtype=q.dtype, device=q.device) \
        .transpose(1, 2)
    strides += _kernel_strides(o, "o")
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.vrt_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, t,
            d, (ctypes.c_longlong * 12)(*strides), float(scale),
            int(q.dtype == torch.bfloat16), stream)
    _build.check(code, "attention kernel")
    # a plain increment: exact because device work is serialized (the
    # serve daemon runs every forward under its one device lock)
    multi_head_attention.launches += 1
    return o


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale=None) -> torch.Tensor:
    """softmax(q k^T * scale) v for (B, H, T, head_dim) f32 or bf16 inputs;
    ``scale`` defaults to head_dim ** -0.5. The output has the input dtype.

    A CUDA input launches the kernel (counted in
    ``multi_head_attention.launches``); q, k and v may be any views whose
    last dim has stride 1 and whose base and other strides are multiples
    of 16 bytes (see :func:`_kernel_strides`), and the output is the
    ``transpose(1, 2)`` view of a contiguous (B, T, H, head_dim) tensor.
    It raises on a head width or layout the kernel does not take. A CPU
    input runs :func:`attention_plain`."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"attention takes float32 or bfloat16, got {q.dtype}")
    d = q.shape[-1]
    scale = float(d ** -0.5) if scale is None else float(scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale)
    if q.device.type == "cuda":
        return _launch(q, k, v, scale)
    raise ValueError(f"unsupported device {q.device}")


multi_head_attention.launches = 0
