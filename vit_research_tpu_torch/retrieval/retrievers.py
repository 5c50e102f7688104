"""Batched metadata-filtered retrievers over the vector store.

Port of vit_research_tpu/retrieval/retrievers.py, with its call contract:
``retriever(chunk_embs (B, D), metadata {vid, side, t_center, t_width})
-> (B, top_k, D)``, zero-padded past the candidates found, rows
L2-normalised. One device call per batch: the collection's rows and
metadata columns are snapshotted on the device (again whenever the
collection's mutation counter moves), the (B, N) mask ``vid != query vid
and side == query side and t in [t_center - t_width / 2, t_center +
t_width / 2]`` is built there from the (B,) query columns, and the scores
go through ops/topk.py::masked_topk: the dot over L2-normalised rows for
cosine and ip collections, the negated squared L2 over the raw rows for
l2 ones, then a stable descending sort, so ties break on the lower index
as ``lax.top_k`` does.

- ``FrameRetriever`` filters on ``t_norm``; queries are taken as given.
- ``RattChunkRetriever`` filters on ``t_center`` and L2-normalises the
  queries.

The result is a float32 tensor on the collection's device, ready for
the head's forward. This is torch
code, not a kernel: the JAX package's version is an XLA graph.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_research_tpu_torch.ops.topk import NEG_INF, masked_topk


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _meta_arrays(metadata, b):
    vids = np.asarray([int(v) for v in _as_numpy(metadata["vid"])[:b]])
    sides = [s.decode() if isinstance(s, bytes) else str(s)
             for s in _as_numpy(metadata["side"])[:b]]
    t_center = np.asarray(_as_numpy(metadata["t_center"])[:b], np.float64)
    t_width = np.asarray(_as_numpy(metadata["t_width"])[:b], np.float64)
    return vids, sides, t_center, t_width


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-8)


class _StoreView:
    """Device snapshot of a collection: the rows, their L2-normalised
    copy and the vid / side / time columns, taken again whenever the
    collection's version moves (Collection.device_snapshot)."""

    def __init__(self, collection, time_field: str):
        self.collection = collection
        self.time_field = time_field
        self._version = None

    def refresh(self) -> None:
        snap = self.collection.device_snapshot(
            ("vid_num", "side", self.time_field), since=self._version)
        if snap is None:
            return
        self._version, emb, cols = snap
        dev = emb.device
        self.n = emb.shape[0]
        self.normalized = _unit_rows(emb)
        self.metric = "l2" if self.collection.space == "l2" else "ip"
        self.rank = emb if self.metric == "l2" else self.normalized
        sides = [str(s) for s in cols["side"]]
        self.side_ids = {s: i for i, s in enumerate(sorted(set(sides)))}
        self.vids = torch.tensor([int(v) for v in cols["vid_num"]],
                                 dtype=torch.int64, device=dev)
        self.sides = torch.tensor([self.side_ids[s] for s in sides],
                                  dtype=torch.int64, device=dev)
        self.times = torch.tensor(
            np.asarray([float(t) for t in cols[self.time_field]],
                       np.float32), device=dev)


class _BatchedRetriever:
    """The shared engine: device mask, masked top-k, pad and normalise,
    on the collection's device."""

    time_field = "t_norm"
    normalize_query = False

    def __init__(self, collection, top_k: int = 10):
        self.collection = collection
        self.top_k = top_k
        self.device = collection.device
        self._view = _StoreView(collection, self.time_field)

    @torch.no_grad()
    def __call__(self, chunk_embs, metadata) -> torch.Tensor:
        dev = self.device
        if isinstance(chunk_embs, torch.Tensor):
            q = chunk_embs.detach().to(dev, torch.float32)
        else:
            q = torch.as_tensor(np.asarray(chunk_embs, np.float32),
                                device=dev)
        b, d = q.shape
        if self.normalize_query:
            q = _unit_rows(q)
        view = self._view
        view.refresh()
        out = torch.zeros(b, self.top_k, d, device=dev)
        if view.n == 0:
            return out
        vids, sides, t_center, t_width = _meta_arrays(metadata, b)
        t_min = (t_center - t_width / 2).astype(np.float32)
        t_max = (t_center + t_width / 2).astype(np.float32)
        # a side the collection does not hold matches nothing: -1
        side_ids = [view.side_ids.get(s, -1) for s in sides]

        def col(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=dev)[:, None]

        mask = ((view.vids[None, :] != col(vids, torch.int64))
                & (view.sides[None, :] == col(side_ids, torch.int64))
                & (view.times[None, :] >= col(t_min, torch.float32))
                & (view.times[None, :] <= col(t_max, torch.float32)))
        scores, idx = masked_topk(q, view.rank, mask,
                                  k=min(self.top_k, view.n),
                                  metric=view.metric)
        k = idx.shape[1]
        vecs = view.normalized[idx.reshape(-1)].reshape(b, k, d)
        valid = (scores > NEG_INF / 10)[:, :, None]
        out[:, :k] = torch.where(valid, vecs, 0.0)
        return out


class FrameRetriever(_BatchedRetriever):
    """Frame-level RAG retrieval: filters on ``t_norm``
    (reference: nba_proj/retrieval/frame_retriever.py:41-53)."""

    time_field = "t_norm"
    normalize_query = False


class RattChunkRetriever(_BatchedRetriever):
    """Chunk-level RATT retrieval: filters on ``t_center`` and normalises
    the queries (reference: nba_proj/retrieval/ratt_chunk_retriever.py:
    70-71, 123-151)."""

    time_field = "t_center"
    normalize_query = True
