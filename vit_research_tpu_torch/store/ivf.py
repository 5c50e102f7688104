"""IVF (inverted-file) approximate index for large collections.

Port of the in-memory part of vit_research_tpu/store/ivf.py (host numpy,
as there): the fit, the persisted fit (``save_meta`` / ``load_meta``, the
same ``ivf_meta.npz`` format) and the search. The reference's
out-of-core spill (``spill``, ``build_spilled``, ``load``) has no caller
in either package and is not ported. One repair: :meth:`load_meta`
validates the persisted cell layout (monotone bounds from 0 that end at
``len(order)``, row indices in ``[0, n)``, 2-D centroids with one row per
cell) and raises ValueError, so a malformed file engages the caller's
refit fallback instead of failing at query time.

The exact masked-matmul top-k (ops/topk via store/vector_store) stays the
default; past ~10^6 vectors the (Q, N) score matrix stops being free, and
IVF k-means partitions the corpus into ``n_lists`` cells and searches
only the ``nprobe`` cells whose centroids score highest for each query.
Cells store *row indices* into the collection's embedding array, so the
index never copies the vectors; rows added or updated since the fit are
searched exactly beside the probed cells (``extra``).
"""

from __future__ import annotations

import os

import numpy as np


class IVFIndex:
    def __init__(self, n_lists: int | None = None, nprobe: int = 8,
                 iters: int = 8, seed: int = 0):
        self.n_lists = n_lists
        self.nprobe = nprobe
        self.iters = iters
        self.seed = seed
        self.centroids: np.ndarray | None = None  # (L, D) L2-normalized
        self.cells: list[np.ndarray] = []  # row indices per cell
        self._n = 0

    # ------------------------------------------------------------------ fit

    def fit(self, x: np.ndarray) -> "IVFIndex":
        """K-means over (unit-normalized) rows. ``x`` is the collection's
        embedding array; rows are referenced by index, never copied."""
        n, d = x.shape
        ln = self.n_lists or max(int(np.sqrt(n)), 1)
        ln = min(ln, n)
        rng = np.random.default_rng(self.seed)

        # k-means++ -lite init: sample, then Lloyd iterations on cosine.
        # Only the <=100k-row sample is materialized; the full corpus is
        # touched once, in chunks, by the final assignment pass.
        sample = _normalize(
            x[np.sort(rng.choice(n, size=min(n, 100_000), replace=False))])
        cent = sample[rng.choice(len(sample), size=ln, replace=False)].copy()
        for _ in range(self.iters):
            assign = _chunked_argmax(sample, cent)
            for c in range(ln):
                rows = sample[assign == c]
                if len(rows):
                    cent[c] = rows.mean(axis=0)
            cent = _normalize(cent)

        assign = _chunked_argmax(x, cent)
        self.centroids = cent
        self.cells = [np.nonzero(assign == c)[0] for c in range(ln)]
        self._n = n
        return self

    # -------------------------------------------------------- fit persist

    def save_meta(self, path: str, fingerprint: bytes = b"") -> None:
        """Persist the fit only — centroids + per-cell row indices, ~n*8
        bytes — not the corpus, so a restarting server can adopt a
        previous k-means fit instead of refitting. ``fingerprint``
        identifies the exact fit-time corpus bytes; ``load_meta`` hands it
        back so the caller can verify the live corpus still matches before
        searching. Atomic via tmp + os.replace."""
        if self.centroids is None:
            raise ValueError("save_meta() requires a fitted index")
        order = (np.concatenate(self.cells) if self.cells
                 else np.empty(0, np.int64))
        sizes = np.array([len(c) for c in self.cells], np.int64)
        bounds = np.concatenate([[0], np.cumsum(sizes)])
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # file object: savez can't append .npz
            np.savez(f, centroids=self.centroids, order=order,
                     bounds=bounds, n=self._n, nprobe=self.nprobe,
                     fingerprint=np.frombuffer(fingerprint, np.uint8))
        os.replace(tmp, path)

    @classmethod
    def load_meta(cls, path: str) -> tuple["IVFIndex", bytes]:
        """Reopen a ``save_meta()`` fit. Returns (index, fingerprint); the
        caller must verify the fingerprint against the live corpus before
        searching. Raises ValueError on a layout whose cells cannot
        describe the fitted corpus."""
        with np.load(path) as meta:
            order = np.asarray(meta["order"])
            bounds = np.asarray(meta["bounds"])
            centroids = np.asarray(meta["centroids"])
            n = int(meta["n"])
            nprobe = int(meta["nprobe"])
            fp = meta["fingerprint"].tobytes()
        if bounds.ndim != 1 or len(bounds) < 1 or order.ndim != 1:
            raise ValueError("IVF meta: bounds and order must be 1-D")
        if bounds[0] != 0 or np.any(np.diff(bounds) < 0):
            raise ValueError("IVF meta: cell bounds are not monotone from 0")
        if bounds[-1] != len(order):
            raise ValueError(f"IVF meta: bounds end at {bounds[-1]}, order "
                             f"holds {len(order)} rows")
        if len(order) and (order.min() < 0 or order.max() >= n):
            raise ValueError(f"IVF meta: row indices outside [0, {n})")
        if centroids.ndim != 2 or len(centroids) != len(bounds) - 1:
            raise ValueError(f"IVF meta: centroids {centroids.shape} do not "
                             f"match {len(bounds) - 1} cells")
        idx = cls(n_lists=len(bounds) - 1, nprobe=nprobe)
        idx.centroids = centroids
        idx._n = n
        idx.cells = [order[bounds[c]:bounds[c + 1]]
                     for c in range(len(bounds) - 1)]
        return idx, fp

    # --------------------------------------------------------------- search

    def search(self, q: np.ndarray, x: np.ndarray, k: int, *,
               mask: np.ndarray | None = None, nprobe: int | None = None,
               extra: np.ndarray | None = None):
        """Approximate cosine top-k.

        Args:
          q: (Q, D) queries. x: the embedding array (its first fit-time
            rows must be the ones passed to fit).
          mask: optional (N,) bool — rows allowed in results.
          extra: row indices searched exactly in addition to the probed
            cells (the collection's post-fit mutation tail).
        Returns (scores, idx): (Q, k) each; invalid slots score -1e30.
        """
        nprobe = min(nprobe or self.nprobe, len(self.cells))
        qn = _normalize(np.asarray(q, np.float32))
        cq = qn @ self.centroids.T  # (Q, L)
        probe = np.argpartition(-cq, kth=nprobe - 1, axis=1)[:, :nprobe]
        tail = (np.asarray(extra, np.int64)
                if extra is not None and len(extra) else None)
        qk = min(k, len(x))
        out_s = np.full((len(qn), qk), -1e30, np.float32)
        out_i = np.zeros((len(qn), qk), np.int64)
        for qi in range(len(qn)):
            cand = np.concatenate([self.cells[c] for c in probe[qi]]) \
                if nprobe else np.empty(0, np.int64)
            if tail is not None:
                cand = np.unique(np.concatenate([cand, tail]))
            if mask is not None and len(cand):
                cand = cand[mask[cand]]
            if not len(cand):
                continue
            rows = x[cand]
            norms = np.linalg.norm(rows, axis=1)
            s = (rows @ qn[qi]) / np.maximum(norms, 1e-12)
            kk = min(qk, len(cand))
            top = np.argpartition(-s, kth=kk - 1)[:kk]
            order = np.argsort(-s[top], kind="stable")
            top = top[order]
            out_s[qi, :kk] = s[top]
            out_i[qi, :kk] = cand[top]
        return out_s, out_i


def _normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def _chunked_argmax(x: np.ndarray, cent: np.ndarray,
                    chunk: int = 65536) -> np.ndarray:
    out = np.empty(len(x), np.int64)
    for i in range(0, len(x), chunk):
        out[i:i + chunk] = np.argmax(x[i:i + chunk] @ cent.T, axis=1)
    return out
