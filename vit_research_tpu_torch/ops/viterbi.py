"""Viterbi decoding as max-plus recurrences: sequential on the host,
log-depth on torch tensors.

Port of vit_research_tpu/ops/viterbi.py. The sequential decoder is a numpy
loop on the host over time, carrying the (S,) max-plus scores and emitting
backpointer columns (:func:`viterbi_step` is its one step, shared with the
live decoder, segment/hmm.py::StreamingViterbi); :func:`viterbi_parallel`
is the log-depth variant on torch tensors: a max-plus
associative scan over the per-step (S, S) matrices, backpointers straight
from the forward scores, and a second associative scan composing the
backpointer maps. :func:`associative_scan` is the same odd/even recursion
as ``jax.lax.associative_scan``, so both packages combine elements in the
same order and the forward scores agree bit for bit. Ties take the first
maximum (``torch.argmax``, like ``jnp.argmax``).

The path is the true argmax path; the reference's backtrace off-by-one
(nba_proj/hmm.py:124) is not reproduced.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def viterbi_step(dp: np.ndarray, log_emit_t: np.ndarray,
                 log_trans: np.ndarray):
    """One max-plus forward step of the sequential decoder, in the JAX
    package's f32 order (``dp[..., :, None] + log_trans``, first argmax,
    max, then ``+ log_emit_t``): (..., S) scores -> (backpointers (..., S)
    int32, next scores (..., S) f32)."""
    m = dp[..., :, None] + log_trans
    return m.argmax(axis=-2).astype(np.int32), m.max(axis=-2) + log_emit_t


def viterbi_batch(log_emit, log_trans, log_prior):
    """Sequential Viterbi on the host over (B, T, S) emissions with shared
    (S, S) transitions (rows = from-state) and (S,) prior, in numpy f32.

    The forward loop steps every row at once through :func:`viterbi_step`;
    each row's states are those of the JAX package's ``viterbi`` bit for
    bit (elementwise f32 adds and maxes, first-argmax ties).
    Returns (paths (B, T) int32, scores (B,) float32) as numpy."""
    log_emit = np.asarray(log_emit, np.float32)
    log_trans = np.asarray(log_trans, np.float32)
    log_prior = np.asarray(log_prior, np.float32)
    b, t, s = log_emit.shape
    dp = log_prior + log_emit[:, 0]
    backptrs = np.empty((max(t - 1, 0), b, s), np.int32)
    for i in range(1, t):
        backptrs[i - 1], dp = viterbi_step(dp, log_emit[:, i], log_trans)
    rows = np.arange(b)
    last = dp.argmax(axis=1)
    score = dp[rows, last]
    path = np.empty((b, t), np.int32)
    path[:, t - 1] = last
    state = last
    for i in range(t - 2, -1, -1):
        state = backptrs[i, rows, state]
        path[:, i] = state
    return path, score.astype(np.float32)


def viterbi(log_emit, log_trans, log_prior):
    """Most-likely state path, sequential, on the host.

    Args:
      log_emit: (T, S) log emission scores.
      log_trans: (S, S) log transitions, rows = from-state; forbidden
        transitions are ``NEG_INF`` (not -inf).
      log_prior: (S,) log initial distribution.
    Returns (path (T,) int32, score () float32) as numpy."""
    paths, scores = viterbi_batch(np.asarray(log_emit, np.float32)[None],
                                  log_trans, log_prior)
    return paths[0], scores[0]


def _interleave(even, odd):
    out = torch.empty((even.shape[0] + odd.shape[0], *even.shape[1:]),
                      dtype=even.dtype, device=even.device)
    out[0::2] = even
    out[1::2] = odd
    return out


def _scan(fn, x):
    n = x.shape[0]
    if n < 2:
        return x
    odd = _scan(fn, fn(x[0:n - 1:2], x[1::2]))
    even = fn(odd[:-1] if n % 2 == 0 else odd, x[2::2])
    return _interleave(torch.cat([x[:1], even]), odd)


def associative_scan(fn, x: torch.Tensor, reverse: bool = False):
    """Inclusive scan of ``fn`` along dim 0 in log depth, combining in the
    order ``jax.lax.associative_scan`` does (``reverse`` flips the input
    and the result, as there)."""
    if reverse:
        return _scan(fn, x.flip(0)).flip(0)
    return _scan(fn, x)


def _maxplus(a, b):
    # (..., S, S) max-plus products: C[i, j] = max_k A[i, k] + B[k, j].
    return torch.amax(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def viterbi_parallel(log_emit, log_trans, log_prior):
    """Log-depth Viterbi; same contract as :func:`viterbi`."""
    log_emit = _f32(log_emit)
    dev = log_emit.device
    log_trans = _f32(log_trans, dev)
    log_prior = _f32(log_prior, dev)
    t = log_emit.shape[0]
    alpha0 = (log_prior + log_emit[0])[None]  # (1, S)
    if t == 1:
        last = torch.argmax(alpha0[0])
        return last[None].to(torch.int32), alpha0[0, last]

    # Step matrices M_t[i, j] = trans[i, j] + emit_t[j] for t >= 1.
    step = log_trans[None, :, :] + log_emit[1:, None, :]
    prefix = associative_scan(_maxplus, step)  # (T-1, S, S)
    alpha_rest = torch.amax(alpha0[0][None, :, None] + prefix, dim=1)
    alpha = torch.cat([alpha0, alpha_rest], dim=0)  # (T, S)

    # bp[t, j] = best state at t given state j at t+1 (first argmax).
    bp = torch.argmax(alpha[:-1][:, :, None] + log_trans[None, :, :], dim=1)
    # g[t] = bp_t o bp_{t+1} o ... o bp_{T-2}: final state -> state at t.
    g = associative_scan(lambda a, b: torch.gather(b, -1, a), bp,
                         reverse=True)
    last = torch.argmax(alpha[-1])
    path = torch.cat([g[:, last], last[None]]).to(torch.int32)
    return path, alpha[-1, last]


def masked_log(p, floor: float = 1e-6) -> torch.Tensor:
    """log with the reference's zero-replacement (probabilities below
    ``floor`` count as ``floor``)."""
    return torch.log(torch.clamp_min(_f32(p), floor))


def log_transition_matrix(trans) -> torch.Tensor:
    """Elementwise log of a transition matrix, 0 -> NEG_INF (forbidden)."""
    t = _f32(trans)
    return torch.where(t > 0, torch.log(torch.clamp_min(t, 1e-38)),
                       torch.full_like(t, NEG_INF))
