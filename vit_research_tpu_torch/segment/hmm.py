"""Possession-side HMM smoother (left / right / none).

Port of vit_research_tpu/segment/hmm.py: the states, the reference's
hand-tuned transitions, the transition validator, the one-shot device
decode :func:`smooth_probabilities`, and the host decoders of the live
path: :class:`HMM` (the reference's streaming-API lattice, decoded in one
call) and :class:`StreamingViterbi` (fixed-lag online Viterbi). The host
decoders are numpy, on the port's ``ops/viterbi.py`` constants, and do
the JAX package's f32 operations in its order, so they emit the same
states bit for bit. :func:`smooth_probabilities` routes as the reference
does: below 8192 frames the host sequential decoder, from there the
log-depth scan on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.ops import viterbi as viterbi_ops

STATES = ("left", "right", "none")

# Hand-tuned transitions forbidding direct left<->right switches
# (reference: nba_proj/hmm.py:10).
DEFAULT_TRANSITIONS = np.array(
    [
        [0.985, 0.0, 0.015],
        [0.0, 0.985, 0.015],
        [0.15, 0.15, 0.70],
    ],
    dtype=np.float32,
)

UNIFORM_PRIOR = np.full((3,), 1.0 / 3.0, dtype=np.float32)

_PROB_FLOOR = 1e-6  # reference zero-replacement (nba_proj/hmm.py:50-55)


def validate_transition_matrix(m) -> np.ndarray:
    """Check a user-supplied transition matrix and return it as (3, 3)
    float32. Raises ValueError on a wrong shape, non-finite or negative
    entries, or rows that are not probability distributions."""
    m = np.asarray(m, dtype=np.float32)
    if m.shape != (3, 3):
        raise ValueError(f"transition matrix must be 3x3, got shape "
                         f"{m.shape}")
    if not np.isfinite(m).all():
        raise ValueError("transition matrix has non-finite entries")
    if (m < 0).any():
        raise ValueError("transition matrix has negative entries")
    rows = m.sum(axis=1)
    if not np.allclose(rows, 1.0, atol=1e-3):
        raise ValueError(
            "transition matrix rows must each sum to 1 (probabilities, "
            f"not counts); row sums are {rows.tolist()}")
    return m


def _col_to_probs(col) -> np.ndarray:
    if isinstance(col, dict):
        p = np.array([col["left"], col["right"], col["none"]],
                     dtype=np.float32)
    else:
        p = np.asarray(col, dtype=np.float32)
    return np.maximum(p, _PROB_FLOOR)


def _log_trans_np(trans) -> np.ndarray:
    return viterbi_ops.log_transition_matrix(
        np.asarray(trans, np.float32)).numpy()


class HMM:
    """Streaming-API Viterbi smoother (reference: nba_proj/hmm.py:16-135):
    columns are buffered on the host and decoded in one call.

    The reference's 501-column window cap is gone (memory is O(T*3)), and
    the decoded path is the true argmax path (the reference's backtrace
    has an off-by-one, nba_proj/hmm.py:124). The decode is the
    sequential max-plus loop of ops/viterbi.py, in numpy on the host."""

    def __init__(self, cap_count: int | None = None, transition_matrix=None,
                 prior=None):
        # cap_count kept for API compatibility; used only as an initial
        # buffer-size hint (the buffer grows as needed).
        self.transition_matrix = (
            DEFAULT_TRANSITIONS if transition_matrix is None
            else np.asarray(transition_matrix, dtype=np.float32))
        self.prior = (UNIFORM_PRIOR if prior is None
                      else np.asarray(prior, np.float32))
        self._log_trans = _log_trans_np(self.transition_matrix)
        cap = int(cap_count) if cap_count else 1024
        self._probs = np.empty((max(cap, 16), 3), dtype=np.float32)
        self.count = 0
        self.decoded_sequence: list = []

    # -- streaming API (reference: nba_proj/hmm.py:16-19,49-107) -------------

    def add_first(self, first) -> None:
        self.count = 0
        self._append(first)

    def add_col_to_lattice(self, col) -> None:
        self._append(col)

    def _append(self, col) -> None:
        if self.count == self._probs.shape[0]:
            grown = np.empty((self._probs.shape[0] * 2, 3), dtype=np.float32)
            grown[: self.count] = self._probs[: self.count]
            self._probs = grown
        self._probs[self.count] = _col_to_probs(col)
        self.count += 1

    def add_cols(self, probs) -> None:
        """Vectorized bulk append of a (T, 3) probability array."""
        probs = np.asarray(probs, dtype=np.float32)
        need = self.count + probs.shape[0]
        if need > self._probs.shape[0]:
            grown = np.empty((max(need, self._probs.shape[0] * 2), 3),
                             np.float32)
            grown[: self.count] = self._probs[: self.count]
            self._probs = grown
        self._probs[self.count: need] = np.maximum(probs, _PROB_FLOOR)
        self.count = need

    # -- decoding (reference: nba_proj/hmm.py:109-135) ------------------------

    def decode_indices(self) -> np.ndarray:
        if self.count == 0:
            return np.zeros((0,), dtype=np.int32)
        log_emit = np.log(self._probs[: self.count])
        path, _ = viterbi_ops.viterbi(log_emit, self._log_trans,
                                      np.log(self.prior))
        return path

    def decode_sequence(self) -> list:
        path = self.decode_indices()
        self.decoded_sequence = [STATES[i] for i in path]
        return self.decoded_sequence


class StreamingViterbi:
    """Online Viterbi decoder with bounded memory and bounded latency.

    - States are emitted as soon as every survivor path agrees on them
      (path coalescence); those emissions are exactly the offline
      decode's prefix.
    - A state that falls ``max_lag`` frames behind is force-committed
      along the current best path (fixed-lag Viterbi), and the lattice is
      re-anchored on the committed state, so the rest of the decode is
      exact conditioned on the commitments and the emitted sequence is
      always a valid path (no forbidden transitions).
    - Memory is O(max_lag * S) regardless of stream length.

    Coalescence is checked every ``drain_every`` pushes (one O(window)
    sweep), so emissions arrive in bursts, but the pending window never
    exceeds ``max_lag`` after a push returns. The math follows
    ops/viterbi.py (f32, emission added after the max, first-argmax
    tie-breaking), so with an infinite ``max_lag`` the concatenated
    emissions equal the sequential decode
    (``smooth_probabilities(..., parallel=False)``) bit for bit.

    Usage::

        sv = StreamingViterbi(max_lag=512)
        for probs in frame_probability_stream:   # each (3,) or dict
            for state in sv.push(probs):
                handle(STATES[state])
        for state in sv.finish():
            handle(STATES[state])
    """

    def __init__(self, max_lag: int = 512, *, transition_matrix=None,
                 prior=None, drain_every: int = 32):
        if max_lag < 1:
            raise ValueError(f"max_lag must be >= 1, got {max_lag}")
        trans = (DEFAULT_TRANSITIONS if transition_matrix is None
                 else np.asarray(transition_matrix, np.float32))
        self._log_trans = _log_trans_np(trans)
        p = UNIFORM_PRIOR if prior is None else np.asarray(prior, np.float32)
        self._log_prior = np.log(p)
        self.max_lag = int(max_lag)
        self.drain_every = max(1, int(drain_every))
        self._n_states = self._log_trans.shape[0]
        self._scores: np.ndarray | None = None  # dp at newest pending time
        self._le: list[np.ndarray] = []   # pending log-emissions
        self._bp: list[np.ndarray] = []   # _bp[k] maps state at pending k
        #                                   -> state at pending k-1
        #                                   (_bp[0] is never read)
        self._since_drain = 0
        self.emitted = 0        # states emitted so far
        self.forced = 0         # of which force-committed (not coalesced)
        self._finished = False

    @property
    def pending(self) -> int:
        """Frames pushed but not yet emitted."""
        return len(self._le)

    def push(self, col) -> list[int]:
        """Feed one frame's (S,) state probabilities (array or
        left/right/none dict); returns the states newly fixed by this
        push (possibly empty — emissions arrive in bursts)."""
        if self._finished:
            raise RuntimeError("push after finish()")
        le = np.log(_col_to_probs(col))
        if self._scores is None:
            self._scores = self._log_prior + le
            self._bp.append(np.zeros(self._n_states, np.int32))  # unread
        else:
            bp, self._scores = self._step(self._scores, le)
            self._bp.append(bp)
        self._le.append(le)
        self._since_drain += 1
        if (self._since_drain >= self.drain_every
                or len(self._le) > self.max_lag):
            return self._drain()
        return []

    def finish(self) -> list[int]:
        """Flush: commit all pending states along the best path."""
        if self._finished:
            return []
        self._finished = True
        out = self._drain()
        w = len(self._le)
        if w:
            out.extend(self._best_path()[:w])
            self.emitted += w
            self._le.clear()
            self._bp.clear()
        return out

    # -- internals -----------------------------------------------------------

    def _step(self, dp: np.ndarray, le: np.ndarray):
        """One max-plus forward step (ops/viterbi.py::viterbi_step, the
        offline sequential decoder's): returns (backpointers, next dp)."""
        return viterbi_ops.viterbi_step(dp, le, self._log_trans)

    def _backtrace(self, state: int, upto: int) -> list[int]:
        """States at pending times 0..upto along the survivor path that
        is in ``state`` at pending time ``upto``."""
        seq = [0] * (upto + 1)
        cur = int(state)
        for k in range(upto, -1, -1):
            seq[k] = cur
            if k > 0:
                cur = int(self._bp[k][cur])
        return seq

    def _best_path(self) -> list[int]:
        """Best current path over the whole pending window."""
        return self._backtrace(int(np.argmax(self._scores)),
                               len(self._le) - 1)

    def _drain(self) -> list[int]:
        self._since_drain = 0
        w = len(self._le)
        if w == 0:
            return []
        out: list[int] = []
        # Backward survivor sweep: ps[s] = state at pending k on the
        # survivor path that ends in terminal state s.
        ps = np.arange(self._n_states)
        k = w - 1
        merge = -1
        while True:
            if (ps == ps[0]).all():
                merge = k
                break
            if k == 0:
                break
            ps = self._bp[k][ps]
            k -= 1
        if merge >= 0:
            # All survivors share the prefix 0..merge — emit it (exact).
            out.extend(self._backtrace(int(ps[0]), merge))
            self.emitted += merge + 1
            del self._le[: merge + 1]
            del self._bp[: merge + 1]
            w = len(self._le)
        excess = w - self.max_lag
        if excess > 0:
            # Fixed-lag forced commit: take the current best path's first
            # `excess` states, then re-anchor the lattice on the last
            # committed state so future decoding conditions on it.
            path = self._best_path()
            out.extend(path[:excess])
            self.emitted += excess
            self.forced += excess
            anchor = path[excess - 1]
            del self._le[:excess]
            del self._bp[:excess]
            dp = np.full(self._n_states, viterbi_ops.NEG_INF, np.float32)
            dp[anchor] = 0.0
            for j, le in enumerate(self._le):
                self._bp[j], dp = self._step(dp, le)
            self._scores = dp
        return out


#: From this many frames on, :func:`smooth_probabilities` decodes with the
#: log-depth scan; below it, sequentially on the host (the reference's
#: threshold and routing, vit_research_tpu/segment/hmm.py:310).
_PARALLEL_THRESHOLD = 8192


def smooth_probabilities(probs, transition_matrix=None, prior=None,
                         parallel: bool | None = None, *,
                         device) -> np.ndarray:
    """One-shot decode: (T, 3) or (B, T, 3) probabilities -> int32 state
    path(s) as numpy.

    The routing is the reference's: below ``_PARALLEL_THRESHOLD`` frames
    the sequential decoder (ops/viterbi.py::viterbi_batch, numpy on the
    host; ``device`` is only checked), from there the log-depth scan on
    ``device``; ``parallel`` forces one of them. The two sum scores in
    other orders and break exact ties differently, and vote-fraction
    emissions tie often, so the routing decides clips. Host-clock times
    on vote-fraction emissions (``chip_smoke.py --profile``, NVIDIA H100
    80GB HBM3, 700 W): the host loop 5.48 / 26.86 / 62.89 ms at T = 512 /
    2048 / 8191; the log-depth scan on the card 2.03 / 2.93 / 3.29 ms,
    and 5.68 ms at 32,768; a per-frame torch loop on the card (not used)
    32.86 / 125.65 / 588.10 ms."""
    dev = resolve_device(device)
    probs = np.maximum(np.asarray(probs, dtype=np.float32), _PROB_FLOOR)
    trans = (DEFAULT_TRANSITIONS if transition_matrix is None
             else np.asarray(transition_matrix, np.float32))
    prior = UNIFORM_PRIOR if prior is None else np.asarray(prior, np.float32)
    log_trans = viterbi_ops.log_transition_matrix(trans)
    log_prior = np.log(prior)
    log_emit = np.log(probs)
    use_parallel = (probs.shape[-2] >= _PARALLEL_THRESHOLD
                    if parallel is None else parallel)
    if not use_parallel:
        if probs.ndim == 2:
            return viterbi_ops.viterbi(log_emit, log_trans.numpy(),
                                       log_prior)[0]
        return viterbi_ops.viterbi_batch(log_emit, log_trans.numpy(),
                                         log_prior)[0]
    log_trans = log_trans.to(dev)
    log_prior = torch.from_numpy(log_prior).to(dev)
    log_emit = torch.from_numpy(log_emit).to(dev)
    if probs.ndim == 2:
        return viterbi_ops.viterbi_parallel(
            log_emit, log_trans, log_prior)[0].cpu().numpy()
    return torch.stack([
        viterbi_ops.viterbi_parallel(e, log_trans, log_prior)[0]
        for e in log_emit]).cpu().numpy()
