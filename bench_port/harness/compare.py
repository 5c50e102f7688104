"""The numbers that decide ``correct``, each held to a limit of its own
(the cell's workload file gives the limits and PERF.md the readings they
were set from).

- ``embed_gap``: the largest absolute difference, over every compared
  row and element, between the program's L2-normalised embeddings and
  the reference's of the same frames.
- ``rank_gap``: the widest gap by which the score (exact, float64) of the
  answer a query got at rank r lies below the reference's r-th best
  score. Near or exact ties that trade places give gaps of the order of
  their scores' rounding; a missed neighbour gives its score's distance
  to the one it displaced.
- ``distance_gap``: the largest difference between a returned distance
  and 1 minus the exact score of the id it was returned for.
- ``bad_answers``: queries whose answer is no valid answer at all (not
  k results, an unknown or repeated id, metadata not the row's own);
  its limit is 0.
"""

from __future__ import annotations

import numpy as np
import torch


def embed_gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    gap = float(np.max(np.abs(got.astype(np.float64) - want)))
    return gap if np.isfinite(gap) else float("inf")


def search_gaps(scores, batches, id_index: dict, metas: list, k: int) -> dict:
    """``scores(queries)``: the exact (Q, N) scores on the device;
    ``batches``: (queries (Q, D), the store's answer dict) pairs."""
    rank_gap, dist_gap, bad = 0.0, 0.0, 0
    for queries, ans in batches:
        s = scores(queries)
        best = torch.topk(s, k, dim=1).values
        idx = np.zeros((len(queries), k), np.int64)
        dist = np.zeros((len(queries), k), np.float64)
        good = np.ones(len(queries), bool)
        for qi in range(len(queries)):
            ids = ans["ids"][qi]
            rows = [id_index.get(i, -1) for i in ids]
            if (len(rows) != k or min(rows, default=-1) < 0
                    or len(set(rows)) != k
                    or len(ans["distances"][qi]) != k
                    or any(m != metas[r]
                           for m, r in zip(ans["metadatas"][qi], rows))):
                good[qi] = False
                continue
            idx[qi] = rows
            dist[qi] = ans["distances"][qi]
        bad += int((~good).sum())
        if not good.any():
            continue
        sel = torch.from_numpy(np.nonzero(good)[0]).to(s.device)
        got = torch.gather(s[sel], 1, torch.from_numpy(idx[good]).to(
            s.device))
        rank_gap = max(rank_gap, float((best[sel] - got).max()))
        dist_gap = max(dist_gap, float(np.max(np.abs(
            (1.0 - dist[good]) - got.cpu().numpy()))))
    return {"rank_gap": rank_gap, "distance_gap": dist_gap,
            "bad_answers": bad}


def verdict(values: dict, limits: dict) -> dict:
    """{name: {"value": v, "limit": l}} for every limited number; a
    number that is not finite is over its limit."""
    return {name: {"value": values[name], "limit": limits[name]}
            for name in limits}


def passes(checks: dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
