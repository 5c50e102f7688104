"""IVF (inverted-file) approximate index for large collections.

Port of vit_research_tpu/store/ivf.py (host numpy, as there): the fit,
the persisted fit (``save_meta`` / ``load_meta``, the same
``ivf_meta.npz`` format), the search, and the out-of-core spill
(``spill``, ``build_spilled``, ``load``) in the reference's file layout,
so a spill written by either package loads in the other. One repair:
:meth:`load_meta` and :meth:`load` validate the persisted cell layout
(monotone bounds from 0 that end at ``len(order)``, row indices in
``[0, n)``, 2-D centroids with one row per cell) and raise ValueError, so
a malformed file engages the caller's refit fallback instead of failing
at query time.

The exact masked-matmul top-k (ops/topk via store/vector_store) stays the
default; past ~10^6 vectors the (Q, N) score matrix stops being free, and
IVF k-means partitions the corpus into ``n_lists`` cells and searches
only the ``nprobe`` cells whose centroids score highest for each query.
Cells store *row indices* into the collection's embedding array, so the
index never copies the vectors; rows added or updated since the fit are
searched exactly beside the probed cells (``extra``).

Corpora larger than host RAM spill to disk: ``spill()`` writes the rows
cell-ordered into a raw float32 memmap (each cell one contiguous slice,
so a probe is ``nprobe`` sequential reads), after which ``search(q,
x=None, ...)`` runs out of core. ``build_spilled`` fits and spills
straight from an ``np.memmap`` corpus without materializing it (the fit
samples at most 100k rows and streams the assignment pass); ``load()``
reopens a spilled index.
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
        # Out-of-core state: ({prefix}.dat path, (L+1,) cell bounds into
        # the cell-ordered memmap). Set by spill() / load().
        self._spill_dat: str | None = None
        self._spill_bounds: np.ndarray | None = None
        self._spill_mm: np.ndarray | None = None

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
        # touched once, in chunks, by the final assignment pass, so ``x``
        # can be an np.memmap far larger than RAM.
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
        # a previous spill describes the previous fit's cell order:
        # searching it against the new cells would misalign rows
        self._spill_dat = None
        self._spill_bounds = None
        self._spill_mm = None
        return self

    def matches(self, n: int) -> bool:
        """Does the fitted index still describe a corpus of n rows?"""
        return self.centroids is not None and self._n == n

    # ---------------------------------------------------------------- spill

    def spill(self, x: np.ndarray, prefix: str,
              chunk: int = 65536) -> "IVFIndex":
        """Write the corpus cell-ordered to ``{prefix}.dat`` (raw float32
        memmap) + ``{prefix}.npz`` (centroids, order, bounds), enabling
        ``search(q, x=None, ...)`` and ``IVFIndex.load(prefix)``. Rows
        are copied in bounded chunks, so ``x`` may itself be a memmap."""
        if self.centroids is None:
            raise ValueError("spill() requires a fitted index")
        n, d = x.shape
        if n != self._n:
            raise ValueError(f"corpus has {n} rows, index fit on {self._n}")
        order, bounds = self._cell_layout()
        dat = prefix + ".dat"
        mm = np.memmap(dat + ".tmp", mode="w+", dtype=np.float32,
                       shape=(n, d))
        for i in range(0, n, chunk):
            mm[i:i + chunk] = x[order[i:i + chunk]]
        mm.flush()
        del mm
        os.replace(dat + ".tmp", dat)
        np.savez(prefix + ".npz", centroids=self.centroids, order=order,
                 bounds=bounds, n=self._n, dim=d, nprobe=self.nprobe)
        self._spill_dat = dat
        self._spill_bounds = bounds
        self._spill_mm = None
        return self

    @classmethod
    def build_spilled(cls, x: np.ndarray, prefix: str,
                      **kwargs) -> "IVFIndex":
        """Fit + spill in one call; ``x`` may be an np.memmap larger than
        RAM (the fit samples, the spill streams)."""
        return cls(**kwargs).fit(x).spill(x, prefix)

    def _cell_layout(self) -> tuple[np.ndarray, np.ndarray]:
        """The serialized cell layout of spill() and save_meta(): (row
        order concatenated cell by cell, (L+1,) cell bounds)."""
        order = (np.concatenate(self.cells) if self.cells
                 else np.empty(0, np.int64))
        sizes = np.array([len(c) for c in self.cells], np.int64)
        return order, np.concatenate([[0], np.cumsum(sizes)])

    @classmethod
    def load(cls, prefix: str) -> "IVFIndex":
        """Reopen a spilled index (of either package); searches read only
        the probed cells from ``{prefix}.dat``. Raises ValueError on a
        layout whose cells cannot describe the spilled corpus."""
        with np.load(prefix + ".npz") as meta:
            idx = cls._from_layout(meta)
            idx._spill_bounds = np.asarray(meta["bounds"])
        idx._spill_dat = prefix + ".dat"
        return idx

    def _spilled_rows(self) -> np.ndarray:
        if self._spill_mm is None:
            d = self.centroids.shape[1]
            self._spill_mm = np.memmap(self._spill_dat, mode="r",
                                       dtype=np.float32,
                                       shape=(self._n, d))
        return self._spill_mm

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
        order, bounds = self._cell_layout()
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
            fp = meta["fingerprint"].tobytes()
            return cls._from_layout(meta), fp

    @classmethod
    def _from_layout(cls, meta) -> "IVFIndex":
        """The index a persisted layout (``save_meta`` or ``spill``)
        describes, validated."""
        order = np.asarray(meta["order"])
        bounds = np.asarray(meta["bounds"])
        centroids = np.asarray(meta["centroids"])
        n = int(meta["n"])
        nprobe = int(meta["nprobe"])
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
        return idx

    # --------------------------------------------------------------- search

    def search(self, q: np.ndarray, x: np.ndarray | None, k: int, *,
               mask: np.ndarray | None = None, nprobe: int | None = None,
               extra: np.ndarray | None = None,
               extra_rows: np.ndarray | None = None):
        """Approximate cosine top-k.

        Args:
          q: (Q, D) queries. x: the embedding array (its first fit-time
            rows must be the ones passed to fit; rows appended or updated
            since go in ``extra``). May be ``None`` for a spilled index:
            probed cells are then read from the on-disk memmap and the
            corpus is never resident.
          mask: optional (N,) bool — rows allowed in results.
          extra: row indices searched exactly in addition to the probed
            cells (the collection's post-fit mutation tail). With
            ``x=None`` their current values come in ``extra_rows``
            (len(extra), D), and stale spilled copies of those rows are
            excluded.
        Returns (scores, idx): (Q, k) each; invalid slots score -1e30.
        """
        nprobe = min(nprobe or self.nprobe, len(self.cells))
        qn = _normalize(np.asarray(q, np.float32))
        cq = qn @ self.centroids.T  # (Q, L)
        probe = np.argpartition(-cq, kth=nprobe - 1, axis=1)[:, :nprobe]
        tail = (np.asarray(extra, np.int64)
                if extra is not None and len(extra) else None)
        if x is None:
            if self._spill_dat is None:
                raise ValueError("search(x=None) needs a spilled index")
            if tail is not None and extra_rows is None:
                raise ValueError("x=None with extra requires extra_rows")
            if tail is not None:
                # keep the LAST occurrence of a row updated more than once
                # (its freshest value), so it holds one top-k slot; the
                # in-RAM path gets this from np.unique over cand
                rev_uniq, rev_first = np.unique(tail[::-1],
                                                return_index=True)
                keep_pos = len(tail) - 1 - rev_first
                tail = rev_uniq
                extra_rows = np.asarray(extra_rows, np.float32)[keep_pos]
            spill = self._spilled_rows()
            bounds = self._spill_bounds
            n_total = self._n if tail is None else max(
                self._n, int(tail.max()) + 1)
        else:
            n_total = len(x)
        qk = min(k, n_total)
        out_s = np.full((len(qn), qk), -1e30, np.float32)
        out_i = np.zeros((len(qn), qk), np.int64)
        for qi in range(len(qn)):
            cells = probe[qi] if nprobe else ()
            cand = (np.concatenate([self.cells[c] for c in cells])
                    if nprobe else np.empty(0, np.int64))
            if x is not None:
                if tail is not None:
                    cand = np.unique(np.concatenate([cand, tail]))
                if mask is not None and len(cand):
                    cand = cand[mask[cand]]
                rows = x[cand] if len(cand) else None
            else:
                # nprobe contiguous reads from the cell-ordered memmap
                rows = (np.concatenate(
                    [spill[bounds[c]:bounds[c + 1]] for c in cells])
                    if nprobe else np.empty((0, qn.shape[1]), np.float32))
                if tail is not None:
                    keep = ~np.isin(cand, tail)  # drop stale copies
                    cand = np.concatenate([cand[keep], tail])
                    rows = np.concatenate([rows[keep], extra_rows])
                if mask is not None and len(cand):
                    sel = mask[cand]
                    cand, rows = cand[sel], rows[sel]
            if not len(cand):
                continue
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
