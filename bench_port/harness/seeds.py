"""Seeds for every draw of a run, from ``--seed`` and a tag.

``--seed`` may be any whole number, past 32 bits too. Each
draw (weights, frames, rows, queries, samples) takes its own stream,
so adding a draw never moves another one.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

_MASK = (1 << 128) - 1


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run ``seed``."""
    ss = np.random.SeedSequence([int(seed) & _MASK, zlib.crc32(tag.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))
