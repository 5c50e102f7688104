"""Possession-side HMM smoother (left / right / none): the one-shot decode.

Port of the parts of vit_research_tpu/segment/hmm.py on the kNN+HMM main
path: the states, the reference's hand-tuned transitions, the transition
validator and :func:`smooth_probabilities`. The streaming decoders
(``HMM``, ``StreamingViterbi``) belong to the ``--follow`` path and are
not ported yet.
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


def smooth_probabilities(probs, transition_matrix=None, prior=None,
                         parallel: bool = True, *,
                         device) -> np.ndarray:
    """One-shot decode on ``device``: (T, 3) or (B, T, 3) probabilities ->
    int32 state path(s) as numpy.

    The log-depth decoder is the default at every length, where the
    reference switches to it only from 8192 frames (a TPU tuning). On an
    H100 the sequential loop is launch-bound, one small kernel after
    another per frame: 39.8 ms against 3.6 ms at T=512 and 631.1 ms
    against 2.9 ms at T=8192 (NVIDIA H100 80GB HBM3, 700 W). The two
    decoders sum scores in other orders, so past ~30k frames they may
    break a near-tie differently, as the reference's two do.
    ``parallel=False`` runs the sequential loop."""
    dev = resolve_device(device)
    probs = np.maximum(np.asarray(probs, dtype=np.float32), _PROB_FLOOR)
    trans = (DEFAULT_TRANSITIONS if transition_matrix is None
             else np.asarray(transition_matrix, np.float32))
    prior = UNIFORM_PRIOR if prior is None else np.asarray(prior, np.float32)
    log_trans = viterbi_ops.log_transition_matrix(trans).to(dev)
    log_prior = torch.from_numpy(np.log(prior)).to(dev)
    log_emit = torch.from_numpy(np.log(probs)).to(dev)
    if probs.ndim == 2:
        fn = (viterbi_ops.viterbi_parallel if parallel
              else viterbi_ops.viterbi)
        path, _ = fn(log_emit, log_trans, log_prior)
        return path.cpu().numpy()
    if parallel:
        paths = torch.stack([
            viterbi_ops.viterbi_parallel(e, log_trans, log_prior)[0]
            for e in log_emit])
    else:
        paths, _ = viterbi_ops.viterbi_batch(log_emit, log_trans, log_prior)
    return paths.cpu().numpy()
