"""int8 encoder GEMMs, dynamic and static (opt-in, off the parity path).

Port of vit_research_tpu/ops/quant.py. Both operands of a dense layer's
product are quantized to symmetric int8, the contraction runs as
s8 x s8 -> s32 (``torch._int_mm`` on the card through
ops/topk.py::_int8_dot, which zero-pads to its shape rules: more than 16
rows, K and N multiples of 8; an int32 matmul on the CPU), and the s32
result is rescaled to float. The reference runs that contraction as an
XLA ``dot_general``, not a Pallas kernel, so the port runs it as a torch
op. The operations and their order are the reference's, so equal inputs
give equal bits up to the float division and product roundings of the
two libraries:

1. scale = ``max(max|x|, 1e-12) / 127`` over the contracted dim (per
   token for the activations, per output channel for the rows of an
   ``nn.Linear`` weight);
2. ``clip(round(x / scale), -127, 127)`` with round half to even;
3. dequantize: dynamic ``s32 * (ls[:, None] * rs[None, :])``, static
   ``s32 * (ls * rs)`` with one constant ``ls`` per call site;
4. cast to the promoted dtype of x and W; the caller adds the bias.

The functions take the ``nn.Linear`` contraction (the last dim of x with
the last dim of the (out, in) weight) where the reference's take a
``dot_general`` dimension-numbers argument: the port's dense layers keep
their ``nn.Linear`` parameters, so a quantized model has the plain one's
``state_dict``. Backward is a straight-through estimator: the gradients
of the unquantized product at the same operands.

Static scales: :class:`StaticInt8DotGeneral` holds one activation scale
per call site, consumed in call order by a cursor that the backbone
resets at the start of every forward (the reference gets this from
flax ``setup`` running per apply). Under :func:`calibration_mode` an
instance with no scales records ``max|x| / 127`` per site instead,
max-reduced over forwards, and computes the dynamic result.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from vit_research_tpu_torch.ops.topk import _int8_dot


def _axmax_scale(x: torch.Tensor) -> torch.Tensor:
    """Symmetric abs-max scale over the last dim, (..., 1). The divisor
    is a tensor on x's device: CUDA divides by a host scalar as a product
    with its reciprocal, an ulp off the reference's division."""
    s = torch.amax(torch.abs(x.to(torch.float32)), dim=-1, keepdim=True)
    return torch.clamp_min(s, 1e-12) / s.new_full((), 127.0)


def _quantize(x: torch.Tensor, scale) -> torch.Tensor:
    q = torch.round(x.to(torch.float32) / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def _int8_linear_forward(x: torch.Tensor, w: torch.Tensor,
                         ls: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (N, K).T through int8 with activation scale ``ls``:
    per token (..., 1) or one f32 scalar tensor on x's device."""
    rs = _axmax_scale(w)[:, 0]  # (N,) per output channel
    out = _int8_dot(_quantize(x, ls).reshape(-1, x.shape[-1]),
                    _quantize(w, rs[:, None]))
    out = out.to(torch.float32) * (ls.reshape(-1, 1) * rs)
    return out.to(torch.promote_types(x.dtype, w.dtype)).reshape(
        *x.shape[:-1], w.shape[0])


class _Int8LinearSTE(torch.autograd.Function):
    """int8 forward, with per-token scales (``act_scale`` None) or a
    static one (an f32 scalar tensor on x's device, for the reason in
    :func:`_axmax_scale`); backward as the unquantized ``x @ w.T`` at the
    same operands (the reference's ``_ste_bwd``: round and clip would
    otherwise zero every gradient)."""

    @staticmethod
    def forward(ctx, x, w, act_scale):
        ctx.save_for_backward(x, w)
        ls = _axmax_scale(x) if act_scale is None else act_scale
        return _int8_linear_forward(x, w, ls)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.promote_types(x.dtype, w.dtype))
        dx = (g @ w.to(g.dtype)).to(x.dtype) if ctx.needs_input_grad[0] \
            else None
        dw = None
        if ctx.needs_input_grad[1]:
            g2 = g.reshape(-1, g.shape[-1])
            dw = (g2.T @ x.reshape(-1, x.shape[-1]).to(g.dtype)).to(w.dtype)
        return dx, dw, None


def int8_dot_general(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` with both operands dynamically quantized to int8:
    x (..., K), weight (N, K) (an ``nn.Linear``'s) -> (..., N) in the
    promoted dtype, without bias. Per-token activation scales and
    per-output-channel weight scales; differentiable through the
    straight-through estimator."""
    return _Int8LinearSTE.apply(x, weight, None)


# --------------------------------------------------------------- static

_calibration = threading.local()


@contextlib.contextmanager
def calibration_mode():
    """Collect per-site static activation scales from forwards.

    Yields a list that fills with one scale per dense call site in
    execution order (several forwards under one context max-reduce per
    site)."""
    if getattr(_calibration, "scales", None) is not None:
        raise RuntimeError("calibration_mode is not reentrant")
    _calibration.scales = []
    try:
        yield _calibration.scales
    finally:
        _calibration.scales = None


class StaticInt8DotGeneral:
    """``x @ weight.T`` with STATIC per-site activation scales, consumed in
    call order from a cursor that :meth:`reset` puts back to 0 (the
    backbone calls it at the start of every forward).

    With empty scales inside :func:`calibration_mode`, each call records
    ``max|x| / 127`` into the active list and computes the dynamic-int8
    result (so calibration sees int8-conditioned downstream activations);
    with scales, each call consumes the next one. Empty scales outside
    calibration is an error: silently falling back to dynamic would
    re-add the cost this path exists to remove."""

    def __init__(self, scales=()):
        self.scales = tuple(float(s) for s in scales)
        self._i = 0
        self._on_device: dict = {}  # device -> the scales as f32 tensor

    def reset(self) -> None:
        self._i = 0

    def __call__(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        recording = getattr(_calibration, "scales", None)
        if not self.scales:
            if recording is None:
                raise ValueError(
                    "gemm_quant='int8-static' needs calibrated scales: "
                    "run one eager forward under quant.calibration_mode() "
                    "and set ViTConfig.gemm_quant_scales to the result")
            m = float(torch.max(torch.abs(x.to(torch.float32)))) / 127.0
            m = max(m, 1e-12)
            if self._i < len(recording):
                recording[self._i] = max(recording[self._i], m)
            else:
                recording.append(m)
            self._i += 1
            return _Int8LinearSTE.apply(x, weight, None)
        if self._i >= len(self.scales):
            raise ValueError(
                f"static int8 scales exhausted at call {self._i}: the "
                f"model makes more dot_general calls than the "
                f"{len(self.scales)} calibration recorded — re-calibrate "
                "with the same architecture flags")
        table = self._on_device.get(x.device)
        if table is None:
            table = torch.tensor(self.scales, dtype=torch.float32,
                                 device=x.device)
            self._on_device[x.device] = table
        s = table[self._i]
        self._i += 1
        return _Int8LinearSTE.apply(x, weight, s)
