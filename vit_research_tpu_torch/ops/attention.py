"""Multi-head attention: CUDA kernel and plain version.

Port of vit_research_tpu/ops/attention.py. :func:`multi_head_attention`
computes softmax(q k^T * scale) v over (B, H, T, dh) with an f32 softmax.
On a CUDA tensor it launches the hand-written kernel in
``csrc/attention.cu`` (online softmax over K/V tiles streamed through
shared memory, so unlike the TPU kernel it has no ``MAX_KV_LEN``; bf16 on
the tensor cores, f32 on the CUDA cores except at dh = 64). bf16 past one key
tile takes one of three variants by the rule :func:`bf16_variant` mirrors:
at dh = 64 up to 256 keys the Hopper kernel of ``csrc/attention_wg.cu``
(wgmma and TMA, the whole score row in registers); else the held variant
(K and V streamed once, the row's scores held in shared memory) while they
fit, the two-pass kernel beyond. f32 at dh = 64 takes the Hopper kernel of
``csrc/attention_f32_wg.cu`` by the rule :func:`f32_variant` mirrors (TF32
wgmma on operands split into two TF32 pieces, three products each, so f32
accuracy whatever ``torch.backends.cuda.matmul.allow_tf32`` says; TMA
loads; any T), and f32 at dh = 96, 128 and 192 up to 32 keys (the chunk
encoder, the RAGHead) the short-sequence kernel of
``csrc/attention_short.cu`` (a warp a head, a query row on one to four
lanes, Q, K and V by 1-D bulk copies); at both the CUDA-core kernel with
its 64-row tile (``"simt"``) is to be forced beside it. The kernel reads
q, k and v through their strides, so the backbone hands it the
projections' (B, T, H, dh) order as ``transpose(1, 2)`` views without a
copy, and it writes the output in that order too. On a CPU tensor it runs
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

from vit_research_tpu_torch.ops import _build

#: head widths the kernel is compiled for (ViT-B: 64; the stage-1 chunk
#: encoder, 768 wide with 8 heads: 96; 768 wide with 6 heads, or 1,024
#: with 8: 128; the RAG/RATT heads, 768 wide with 4 heads: 192; tiny test
#: configs). A width between two of them runs zero-padded to the next
#: (:func:`kernel_head_dim`); a width above the last is not taken.
KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128, 192)
_DTYPES = (torch.float32, torch.bfloat16)
_ALIGN = 16  # bytes: the kernel moves q, k, v and o in 16-byte copies
_BQ = _BK = 64  # query rows a block, keys a shared-memory tile
#: the keys the wgmma variant takes at dh = 64 (WG_MIN_SEQ, WG_MAX_SEQ in
#: csrc/attention_bf16.cuh)
WG_KEYS = (65, 256)
#: the f32 widths the short-sequence variant takes, up to SHORT_MAX_SEQ
#: keys (SHORT_MAX_SEQ in csrc/attention.cu: a lane or more a query row)
SHORT_WIDTHS = (96, 128, 192)
SHORT_MAX_SEQ = 32
#: the shared memory a block may opt into on the H100
MAX_SMEM = 232_448
#: the shared memory of two blocks an SM (the SM's 233,472 bytes less
#: 1,024 the runtime keeps for each block, halved)
TWO_BLOCKS_SMEM = (233_472 - 2 * 1024) // 2


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


def held_smem_bytes(width: int, bias: bool, n_tiles: int) -> int:
    """Shared memory of the bf16 kernel's held variant at compiled width
    ``width`` over ``n_tiles`` key tiles (``HeldLayout`` in
    csrc/attention.cu): a ring of two key tiles in bf16 (rows padded by 8
    elements; the Q tile passes through it), two bf16 key-bias tiles with a
    bias, then 64 x 64 bf16 scores a key tile."""
    return (2 * _BK * (width + 8) * 2 + (2 * _BK * 2 if bias else 0)
            + n_tiles * _BQ * _BK * 2)


def held_max_bytes(width: int) -> int:
    """The most shared memory the held variant takes at compiled width
    ``width``: two blocks an SM at dh <= 96 (with one, it lost to the
    two-pass kernel on the H100), all a block may have from 128 on (where
    the two-pass kernel's 254-255 registers keep it to one or two blocks an
    SM itself)."""
    return MAX_SMEM if width >= 128 else TWO_BLOCKS_SMEM


def held_max_tiles(width: int, bias: bool) -> int:
    """The most key tiles (64 keys each) the held variant takes
    (``HeldLayout::MAX_TILES``)."""
    return (held_max_bytes(width) - held_smem_bytes(width, bias, 0)) \
        // (_BQ * _BK * 2)


_HELD_MAX = {(w, bias): held_max_tiles(w, bias)
             for w in KERNEL_HEAD_DIMS for bias in (False, True)}


def bf16_variants(t: int, width: int, bias: bool) -> tuple:
    """Every bf16 variant that takes T keys at compiled width ``width``,
    with or without a key bias, the rule's first (csrc/attention.cu's
    ``launch_bf16_with``): ``"1pass"`` where one key tile holds the row (T
    <= 64); ``"wg"`` at width 64 for T in :data:`WG_KEYS` (wgmma and TMA,
    the whole score row in registers); ``"held"`` up to 64 *
    :func:`held_max_tiles` keys (the row's scores held in shared memory:
    one stream of K, then one of V); ``"2pass"`` past one key tile (K
    streamed twice)."""
    n_tiles = -(-t // _BK)
    if n_tiles == 1:
        return ("1pass",)
    wg = ("wg",) if width == 64 and WG_KEYS[0] <= t <= WG_KEYS[1] else ()
    held = ("held",) if n_tiles <= _HELD_MAX[width, bias] else ()
    return wg + held + ("2pass",)


def bf16_variant(t: int, width: int, bias: bool) -> str:
    """The rule's bf16 variant for T keys at compiled width ``width``,
    with or without a key bias: the first of :func:`bf16_variants`."""
    return bf16_variants(t, width, bias)[0]


def f32_variants(t: int, width: int, bias: bool) -> tuple:
    """Every f32 variant that takes T keys at compiled width ``width``,
    with or without a key bias, the rule's first (csrc/attention.cu's
    ``launch_f32``): at width 64 ``"wg"`` (csrc/attention_f32_wg.cu: TF32
    wgmma on split operands, TMA loads; every T >= 1), then ``"simt"``
    (``attn_f32<64>`` on the CUDA cores); at widths 96, 128 and 192 up to
    :data:`SHORT_MAX_SEQ` keys ``"short"`` (csrc/attention_short.cu: a
    warp a head), then ``"simt"`` (``attn_f32<width>``'s 64-row tile); none
    elsewhere, where the one f32 kernel of that width runs."""
    if width == 64:
        return ("wg", "simt")
    if width in SHORT_WIDTHS and t <= SHORT_MAX_SEQ:
        return ("short", "simt")
    return ()


def f32_variant(t: int, width: int, bias: bool) -> str | None:
    """The rule's f32 variant for T keys at compiled width ``width``: the
    first of :func:`f32_variants`, or None where there is none."""
    return next(iter(f32_variants(t, width, bias)), None)


#: the code of each variant at the C entry point (csrc/attention.cu's
#: Variant); 0 is the rule. "wg" is bf16's and f32's wgmma variant alike.
VARIANT_CODES = {"1pass": 1, "held": 2, "2pass": 3, "wg": 4, "simt": 5,
                 "short": 6}
_VARIANT_SUFFIX = {"1pass": "", "held": "/held", "2pass": "/2pass",
                   "wg": "/wg"}
# launches_by_kernel's names, e.g. attn_f32<96>/short, attn_f32<96>/simt
# (the 64-row tile forced at T <= 32), attn_f32<96> (the same kernel by
# the rule past 32 keys), attn_f32<64>/wg, attn_bf16<64>/held
_KERNEL_NAMES = {**{(False, w, None): f"attn_f32<{w}>"
                    for w in KERNEL_HEAD_DIMS if w != 64},
                 **{(False, w, v): f"attn_f32<{w}>/{v}"
                    for w in (64, *SHORT_WIDTHS)
                    for v in f32_variants(1, w, False)},
                 **{(True, w, v): f"attn_bf16<{w}>{sfx}"
                    for w in KERNEL_HEAD_DIMS
                    for v, sfx in _VARIANT_SUFFIX.items()}}
_WIDTHS = {d: kernel_head_dim(d) for d in range(1, KERNEL_HEAD_DIMS[-1] + 1)}


def kernel_name(dtype: torch.dtype, t: int, width: int, bias: bool,
                variant: str | None = None) -> str:
    """The name a launch counts under in
    ``multi_head_attention.launches_by_kernel``: ``attn_f32<width>``, at
    width 64 with ``/wg`` or ``/simt``, at widths 96, 128 and 192 up to 32
    keys with ``/short`` or ``/simt``, or ``attn_bf16<width>`` with
    ``/wg``, ``/held`` or ``/2pass`` past one key tile: the rule's variant
    (:func:`f32_variant`, :func:`bf16_variant`), or ``variant``."""
    bf16 = dtype == torch.bfloat16
    if variant is None:
        variant = (bf16_variant if bf16 else f32_variant)(t, width, bias)
    return _KERNEL_NAMES[bf16, width, variant]


_BF16_NAMES = frozenset(_VARIANT_SUFFIX)
_F32_NAMES = frozenset(f32_variants(1, 64, False)
                       + f32_variants(1, SHORT_WIDTHS[0], False))


def _check_variant(variant, q, width: int, bias: bool) -> None:
    """Raise ValueError unless ``variant`` is None or a variant of q's
    dtype that takes q's shape (:func:`bf16_variants`,
    :func:`f32_variants`)."""
    if variant is None:
        return
    bf16 = q.dtype == torch.bfloat16
    if variant not in (_BF16_NAMES if bf16 else _F32_NAMES) and \
            variant in (_F32_NAMES if bf16 else _BF16_NAMES):
        raise ValueError(f"variant {variant!r} is "
                         f"{'an f32' if bf16 else 'a bf16'} variant; q is "
                         f"{q.dtype}")
    takes = (bf16_variants if bf16 else f32_variants)(
        q.shape[2], width, bias) if width else ()
    if variant not in takes:
        raise ValueError(f"variant {variant!r} does not take T = "
                         f"{q.shape[2]} at head width {width} in {q.dtype} "
                         f"(the shape takes {', '.join(takes) or 'none'})")


def _kernel_strides(x: torch.Tensor, name: str = "x") -> tuple:
    """(batch, head, token) strides in elements of a (B, H, T, dh) view
    as the kernel reads it. A dim of size 1 is never stepped over, so its
    stride is given as 0. Raises ValueError for a layout the kernel's
    16-byte loads cannot take: a last dim with stride other than 1, a base
    address or a stride that is not a multiple of 16 bytes."""
    shape, st = x.shape, x.stride()
    if len(shape) != 4:
        raise ValueError(f"{name} must be (B, H, T, dh), got {tuple(shape)}")
    if shape[3] > 1 and st[3] != 1:
        raise ValueError(f"{name} needs stride 1 on its last dim (head_dim), "
                         f"got strides {st}")
    if x.data_ptr() % _ALIGN:
        raise ValueError(f"{name}'s base address is not {_ALIGN}-byte "
                         "aligned")
    strides = (st[0] if shape[0] > 1 else 0, st[1] if shape[1] > 1 else 0,
               st[2] if shape[2] > 1 else 0)
    item = x.element_size()
    if (strides[0] * item) % _ALIGN or (strides[1] * item) % _ALIGN or \
            (strides[2] * item) % _ALIGN:
        raise ValueError(f"{name}'s batch/head/token strides {st[:3]}"
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


_Strides12 = ctypes.c_longlong * 12
# What _launch hands the C entry point for one layout, by (shape, q/k/v
# strides, dtype, key bias or not): the 12 strides as a ctypes array (the
# C side only reads it) and the name the launch counts under. Cleared when
# full.
_LAYOUTS: dict = {}
_LAYOUTS_MAX = 256


def _layout(q, k, v, ptrs, bias: bool, variant=None) -> tuple:
    """(strides, kernel name) for q/k/v at their data pointers ``ptrs``;
    raises ValueError as :func:`_kernel_strides` for a layout the kernel
    does not take (every stride a multiple of 16 bytes: what TMA, too,
    takes). The output's strides are those of the ``transpose(1, 2)``
    view of a contiguous (B, T, H, dh) tensor."""
    key = (q.shape, q.stride(), k.stride(), v.stride(), q.dtype, bias,
           variant)
    hit = _LAYOUTS.get(key)
    if hit is None:
        b, h, t, width = q.shape
        o = (t * h * width if b > 1 else 0, width if h > 1 else 0,
             h * width if t > 1 else 0)
        hit = (_Strides12(*_kernel_strides(q, "q"), *_kernel_strides(k, "k"),
                          *_kernel_strides(v, "v"), *o),
               kernel_name(q.dtype, t, width, bias, variant))
        if len(_LAYOUTS) >= _LAYOUTS_MAX:
            _LAYOUTS.clear()
        _LAYOUTS[key] = hit
    elif (ptrs[0] | ptrs[1] | ptrs[2]) % _ALIGN:
        for name, x in (("q", q), ("k", k), ("v", v)):
            _kernel_strides(x, name)  # raises for the misaligned one
    return hit


def _current_device() -> int:
    return torch.cuda.current_device()


def _current_stream(index: int) -> int:
    """The raw handle of device ``index``'s current stream (what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without
    building a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(q, k, v, scale, key_bias, variant=None):
    b, h, t, d = q.shape
    width = _WIDTHS.get(d)
    if width is None:
        raise ValueError(f"attention kernel supports head_dim up to "
                         f"{KERNEL_HEAD_DIMS[-1]}, got {d}")
    bias = key_bias is not None
    _check_variant(variant, q, width, bias)
    dtype, index = q.dtype, q.get_device()
    for name, x in (("k", k), ("v", v)):
        if x.dtype != dtype or x.get_device() != index:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{dtype} on {q.device}")
    if width != d:
        # the scale stays the caller's (d ** -0.5 by default)
        q, k, v = (pad_head_dim(x, width) for x in (q, k, v))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    strides, name = _layout(q, k, v, ptrs, bias, variant)
    # The output in projection order (B, T, H, dh), seen as (B, H, T, dh).
    o = torch.empty_strided((b, h, t, width), (t * h * width, width,
                                               h * width, 1),
                            dtype=dtype, device=q.device)
    args = (*ptrs, o.data_ptr(), b, h, t, width, strides, float(scale),
            int(dtype == torch.bfloat16),
            key_bias.data_ptr() if bias else None,
            key_bias.stride(0) if bias and b > 1 else 0,
            VARIANT_CODES[variant] if variant else 0)
    fn = _build.library().vrt_attention_fwd
    if index == _current_device():
        code = fn(*args, _current_stream(index))
    else:
        with torch.cuda.device(index):
            code = fn(*args, _current_stream(index))
    if code:
        _build.check(code, "attention kernel")
    # a plain increment: exact because device work is serialized (the
    # serve daemon runs every forward under its one device lock)
    multi_head_attention.launches += 1
    multi_head_attention.launches_by_kernel[name] += 1
    if width != d:
        multi_head_attention.padded_launches += 1
        o = o[..., :d]
    return o


def _forced(variant) -> tuple:
    """The trailing argument of :func:`_forward` and :func:`_launch` for a
    forced variant; none for the rule's, so that their five-argument form
    (which tests and chip_smoke.py stand in for) stays the common call."""
    return () if variant is None else (variant,)


def _forward(q, k, v, scale, key_bias, variant=None):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if q.is_cuda:
        return _launch(q, k, v, scale, key_bias, *_forced(variant))
    if q.device.type == "cpu":
        _check_variant(variant, q, _WIDTHS.get(q.shape[-1]),
                       key_bias is not None)
        return attention_plain(q, k, v, scale=scale, key_bias=key_bias)
    raise ValueError(f"unsupported device {q.device}")


class _Attention(torch.autograd.Function):
    """Forward: :func:`_forward` (the kernel on CUDA). Backward: the VJP
    of :func:`attention_plain` at the saved inputs, for q, k, v and the key
    bias, whichever require grad."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, scale, variant):
        inputs = (q, k, v, key_bias)
        ctx.save_for_backward(*(t if t is not None and t.requires_grad
                                else None for t in inputs))
        # inputs that take no grad may be inference tensors (a cached key
        # bias), which save_for_backward refuses: kept on ctx instead
        ctx.constants = [None if t is None or t.requires_grad else t
                         for t in inputs]
        ctx.scale = scale
        return _forward(q, k, v, scale, key_bias, *_forced(variant))

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
                  for t in inputs), None, None)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, scale=None, key_bias=None,
                         variant: str | None = None) -> torch.Tensor:
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
    the gradients are the plain version's.

    ``variant`` (for measurement) launches that variant of
    :func:`bf16_variants` or :func:`f32_variants` (by q's dtype) instead of
    the rule's, e.g. ``"held"`` at T = 197 in bf16 beside the rule's
    ``"wg"``, or ``"simt"`` (the CUDA-core kernel) in f32 at dh = 64
    beside the rule's ``"wg"`` and at dh = 96, 128 and 192 up to 32 keys
    beside the rule's ``"short"``; one that does not take the shape or the
    dtype raises ValueError. On a CUDA tensor the variant launches or
    raises: nothing falls back to another variant or to the plain
    version."""
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
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad
            or key_bias is not None and key_bias.requires_grad):
        return _Attention.apply(q, k, v, key_bias, scale, variant)
    return _forward(q, k, v, scale, key_bias, *_forced(variant))


multi_head_attention.launches = 0
multi_head_attention.padded_launches = 0
#: the same launches by instantiation and variant (:func:`kernel_name`),
#: e.g. ``attn_f32<64>/wg``, ``attn_f32<96>/short``, ``attn_bf16<96>``,
#: ``attn_bf16<64>/wg``, ``attn_bf16<64>/held``, ``attn_bf16<64>/2pass``
multi_head_attention.launches_by_kernel = collections.Counter()
