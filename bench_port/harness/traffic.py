"""The one generator of every cell's inputs, driven by the parameters of
its workload file and by ``--seed``. Inputs are made on the device in a
few large draws and handed to the program as host arrays, as its users
hand theirs.

Frames are the repo's synthetic world (data/synthetic.py's
``synth_frame``, drawn on the card): uniform noise in [lo, hi) per
pixel, the half of the frame on the possession's side brighter, and a
channel tint (red left, blue right), at the size the host resize gives.

Store rows stand for a game's frame embeddings: runs of consecutive
frames whose rows are near-duplicates of the run's own direction (a
shot held for a while), a slow drift along each run, per-frame noise, a
direction the whole game shares, and a share of frozen frames that
repeat the previous row exactly, so near and exact ties occur as they do
in real stores. Queries are rows of the store with noise added.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import seeds

SIDES = ("none", "left", "right")


def frames(size, t: dict, seed: int, device) -> np.ndarray:
    """``t["pool_frames"]`` uint8 frames (N, H, W, 3) of ``size`` (H, W)."""
    n = t["pool_frames"]
    h, w = size
    lo, hi = t["noise"]
    g = seeds.generator(seed, "frames", device)
    side = torch.randint(0, len(SIDES), (n,), generator=g, device=device)
    half = (torch.arange(w, device=device) < w // 2)[None, None, :, None]
    out = np.empty((n, h, w, 3), np.uint8)
    for s in range(0, n, 256):
        m = min(256, n - s)
        x = torch.randint(lo, hi, (m, h, w, 3), generator=g, device=device,
                          dtype=torch.int16)
        left = (side[s:s + m] == 1)[:, None, None, None]
        right = (side[s:s + m] == 2)[:, None, None, None]
        x += t["brightness"] * ((left & half) | (right & ~half))
        x[..., 0] += t["tint"] * left[..., 0]
        x[..., 2] += t["tint"] * right[..., 0]
        out[s:s + m] = x.clamp_(max=255).to(torch.uint8).cpu().numpy()
    return out


def game_rows(t: dict, d: int, seed: int, device):
    """(rows (N, d) f32, ids, metadatas) of a game-sized store."""
    n = t["rows"]
    r = seeds.rng(seed, "runs")
    lengths = []
    while sum(lengths) < n:
        lengths.append(int(r.integers(t["run_frames"][0],
                                      t["run_frames"][1] + 1)))
    lengths[-1] -= sum(lengths) - n
    runs = len(lengths)
    run_side = r.integers(0, len(SIDES), runs)
    g = seeds.generator(seed, "rows", device)
    shared = torch.randn(d, generator=g, device=device)
    base = torch.randn(runs, d, generator=g, device=device)
    drift = torch.randn(runs, d, generator=g, device=device)
    run_of = torch.repeat_interleave(
        torch.arange(runs, device=device),
        torch.tensor(lengths, device=device))
    starts = torch.cumsum(torch.tensor([0] + lengths[:-1], device=device), 0)
    frac = ((torch.arange(n, device=device) - starts[run_of]).float()
            / torch.tensor(lengths, device=device)[run_of].float())
    rows = (t["shared"] * shared + base[run_of]
            + t["drift"] * frac[:, None] * drift[run_of])
    rows += t["frame_noise"] * torch.randn(n, d, generator=g, device=device)
    frozen = torch.nonzero(torch.rand(n, generator=g, device=device)
                           < t["frozen_share"])[:, 0]
    frozen = frozen[frozen > 0]
    rows[frozen] = rows[frozen - 1]
    vid = t["vid"]
    ids = [f"vid{vid}_frame_{i + 1}" for i in range(n)]
    sides = np.repeat(run_side, lengths)
    metas = [{"vid_num": vid, "frame_num": i + 1, "side": SIDES[sides[i]],
              "t_norm": i / n} for i in range(n)]
    return rows.cpu().numpy(), ids, metas


def query_batches(rows: np.ndarray, t: dict, seed: int, device) -> np.ndarray:
    """``t["query_batches"]`` batches of ``t["queries"]`` queries (B, Q, D)
    f32: store rows drawn from the seed, with noise added."""
    b, q = t["query_batches"], t["queries"]
    idx = seeds.rng(seed, "queries").integers(0, len(rows), b * q)
    x = torch.from_numpy(rows[idx]).to(device)
    g = seeds.generator(seed, "query_noise", device)
    x += t["query_noise"] * torch.randn(x.shape, generator=g, device=device)
    return x.reshape(b, q, -1).cpu().numpy()
