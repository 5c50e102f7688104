"""Mesh-sharded exact top-k: a corpus split by rows over several devices.

Port of vit_research_tpu/ops/sharded_topk.py. The reference shards the
corpus rows over a mesh axis, scores each shard on its own chip and
merges the per-shard winners with one ``all_gather``. Here each shard is
a tensor on its mesh device (:class:`ShardedRows`); every shard runs the
flat path's ops/topk.py::masked_topk (or ``masked_topk_int8``) on its
device, and the winners, ``n_dev * k`` (score, index) pairs a query, are
gathered to the mesh's first device and merged there: the counterpart of
the reference's ``all_gather`` and second ``top_k``. The (Q, N) score
matrix never leaves its shard's device.

Results are those of the flat single-device path, ties included: each
shard's top-k keeps the lower index first (a stable sort), shards are
gathered in axis order, global row ids grow with the shard, and the merge
is a stable descending sort, so equal scores come out in global index
order. Padding rows (the corpus padded to a multiple of the axis size)
are rejected inside their shard by comparing the row index with
``n_valid``, so an unfiltered query builds no (Q, N) mask.
"""

from __future__ import annotations

import dataclasses

import torch

from vit_research_tpu_torch.ops.topk import masked_topk, masked_topk_int8
from vit_research_tpu_torch.parallel.mesh import Mesh

__all__ = ["ShardedRows", "pad_corpus", "place_sharded",
           "sharded_masked_topk", "sharded_masked_topk_int8"]


@dataclasses.dataclass
class ShardedRows:
    """A (N, ...) array split by rows over ``mesh[axis]``: ``shards[i]``,
    of N / n_dev rows, lies on ``mesh.axis_devices(axis)[i]``."""

    shards: list
    mesh: Mesh
    axis: str

    @property
    def shape(self) -> tuple:
        return (sum(s.shape[0] for s in self.shards),
                *self.shards[0].shape[1:])


def pad_corpus(corpus, n_dev: int):
    """Zero-pad the rows of ``corpus`` (a tensor or numpy array) to a
    multiple of ``n_dev``: ``(padded tensor, n_valid)``. Callers mask the
    padding rows out (the entry points below do, through ``n_valid``)."""
    corpus = torch.as_tensor(corpus)
    n = corpus.shape[0]
    pad = (-n) % n_dev
    if pad:
        corpus = torch.cat([corpus, corpus.new_zeros(
            (pad, *corpus.shape[1:]))])
    return corpus, n


def place_sharded(x, mesh: Mesh, axis: str = "data",
                  dim: int = 0) -> ShardedRows:
    """``x`` (rows already padded to a multiple of the axis size) split
    along ``dim`` over ``mesh[axis]``, each shard copied to its device:
    the capacity step, each device holds only its shard."""
    if dim != 0:
        raise ValueError("the corpus shards by rows (dim 0)")
    x = torch.as_tensor(x)
    devices = mesh.axis_devices(axis)
    if x.shape[0] % len(devices):
        raise ValueError(f"{x.shape[0]} rows do not split over "
                         f"{len(devices)} devices; pad_corpus first")
    return ShardedRows([s.to(d) for s, d in
                        zip(torch.chunk(x, len(devices)), devices)],
                       mesh, axis)


def _pad_mask(mask, n: int, n_padded: int):
    """A caller mask (broadcastable to (Q, N), the flat contract) as a
    2-D (1 | Q, n_padded) bool tensor with the padding columns False;
    None stays None. A (Q, 1) mask is broadcast to full width before the
    padding (padding it directly would mask out every row but 0)."""
    if mask is None:
        return None
    m = torch.as_tensor(mask).to(torch.bool)
    if m.dim() == 1:
        m = m[None]
    if m.shape[1] == 1 and n != 1:
        m = m.expand(m.shape[0], n)
    if m.shape[1] != n:
        raise ValueError(f"mask has {m.shape[1]} columns; expected 1 or {n}")
    if n_padded != n:
        m = torch.cat([m, m.new_zeros((m.shape[0], n_padded - n))], dim=1)
    return m


def _place(corpus, mesh: Mesh, axis: str) -> tuple:
    """(ShardedRows, rows) of a corpus given placed or not."""
    if isinstance(corpus, ShardedRows):
        if corpus.mesh is not mesh or corpus.axis != axis:
            raise ValueError("the corpus was placed on another mesh or axis")
        return corpus, corpus.shape[0]
    n_dev = len(mesh.axis_devices(axis))
    padded, n = pad_corpus(corpus, n_dev)
    return place_sharded(padded, mesh, axis), n


def _merge(local_topk, corpus: ShardedRows, mask, n_valid: int, k: int):
    """Run ``local_topk(shard index, device, shard mask, k_local)`` on
    every shard, with padding rows (index >= n_valid) masked out, then
    merge the winners on the mesh's first device: a stable descending
    sort of the gathered scores, global indices carried along."""
    devices = corpus.mesh.axis_devices(corpus.axis)
    first = devices[0]
    scores, indices = [], []
    start = 0
    for i, (dev, shard) in enumerate(zip(devices, corpus.shards)):
        local_n = shard.shape[0]
        m = None if mask is None else mask[:, start:start + local_n].to(dev)
        valid = min(max(n_valid - start, 0), local_n)
        if valid < local_n:
            keep = (torch.arange(local_n, device=dev) < valid)[None, :]
            m = keep if m is None else m & keep
        s, idx = local_topk(i, dev, m, min(k, local_n))
        scores.append(s.to(first))
        indices.append((idx + start).to(first))
        start += local_n
    s_all, i_all = torch.cat(scores, dim=1), torch.cat(indices, dim=1)
    top_s, pos = torch.sort(s_all, dim=1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(i_all, 1, pos[:, :k])


def _on_devices(x: torch.Tensor, devices) -> dict:
    """One copy of ``x`` per distinct device."""
    return {d: x.to(d) for d in dict.fromkeys(devices)}


def sharded_masked_topk(queries, corpus, mask=None, *, k: int, mesh: Mesh,
                        axis: str = "data", metric: str = "cosine",
                        n_valid: int | None = None):
    """Exact masked top-k with the corpus split by rows over
    ``mesh[axis]``: ops/topk.py::masked_topk's contract ((Q, D) queries,
    (N, D) corpus, a mask broadcastable to (Q, N), similarities out,
    ``NEG_INF`` fill), with the corpus as a tensor or array (padded and
    placed here) or as :class:`ShardedRows` from :func:`pad_corpus` +
    :func:`place_sharded`, whose true row count is ``n_valid``. Returns
    ``(scores, indices)``, (Q, min(k, N)) each, on the mesh's first
    device. Indices of ``NEG_INF`` entries may point at padding rows;
    callers keep ``scores > -1e29``, as with the flat path. Raises
    ValueError on an empty corpus."""
    placed, n = _place(corpus, mesh, axis)
    if n_valid is not None:
        n = n_valid  # a pre-padded corpus: only the first n rows are real
    if n == 0:
        raise ValueError("empty corpus")
    m = _pad_mask(mask, n, placed.shape[0])
    q = _on_devices(torch.as_tensor(queries, dtype=torch.float32),
                    mesh.axis_devices(axis))
    return _merge(lambda i, dev, mi, kk: masked_topk(
        q[dev], placed.shards[i], mi, k=kk, metric=metric),
        placed, m, n, min(k, n))


def sharded_masked_topk_int8(queries_q, queries_scale, corpus_q,
                             corpus_scale, mask=None, *, k: int, mesh: Mesh,
                             axis: str = "data",
                             n_valid: int | None = None):
    """int8 variant of :func:`sharded_masked_topk` (dot-product scores;
    callers pre-normalise for cosine): each shard's s8 x s8 -> s32
    products rescaled to f32 (ops/topk.py::masked_topk_int8), then the
    same merge. ``corpus_q`` and ``corpus_scale`` are both placed, or
    both not."""
    placed_q, n = _place(corpus_q, mesh, axis)
    placed_s, _ = _place(corpus_scale, mesh, axis)
    if n_valid is not None:
        n = n_valid
    if n == 0:
        raise ValueError("empty corpus")
    m = _pad_mask(mask, n, placed_q.shape[0])
    devices = mesh.axis_devices(axis)
    qq = _on_devices(torch.as_tensor(queries_q), devices)
    qs = _on_devices(torch.as_tensor(queries_scale), devices)
    return _merge(lambda i, dev, mi, kk: masked_topk_int8(
        qq[dev], qs[dev], placed_q.shards[i], placed_s.shards[i], mi, k=kk),
        placed_q, m, n, min(k, n))

