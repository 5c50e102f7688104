"""Persistent vector store with a Chroma-compatible API and a device
query path on torch.

Port of vit_research_tpu/store/vector_store.py. The API (PersistentClient
/ get_or_create_collection / upsert / query / get / delete with the same
``where`` mini-language) and the on-disk format are the reference's, so
either package reads a collection the other wrote. Queries are exact
top-k (ops/topk.py) rather than approximate HNSW, and metadata filters
become boolean masks over the score matrix.

Routing, as in the reference: a query whose rows x queries is under
2^14 is scored in host numpy; an unfiltered cosine query on a collection
of at least ``ivf_threshold`` rows goes through the IVF index
(store/ivf.py); every other query runs on the collection's ``device``
(a torch device, ``'cuda'`` by default) in f32, or in int8 after
``set_device_quantization('int8')``. Unlike the reference, a failure on
the device raises: there is no fallback to a host answer that would
hide it. The reference's mesh-sharded corpus (``shard_device``) is not
ported yet.

Durability: snapshot + append-log under ``{path}/{collection}/``.
A base snapshot (``snapshot.npz``, or the legacy embeddings.npy +
ids.json + metadatas.json) plus ordered log segments
(``seg_NNNNNN.npz`` listed in ``segments.json``); each flush appends ONE
segment holding only the rows touched since the last flush, and
compacts back into a fresh snapshot when the log grows past
``compact_ratio`` of the corpus or ``max_segments``. All file writes go
through write-tmp + ``os.replace`` so readers never observe a torn file,
and segment files not yet listed in the manifest are ignored. The disk
write runs outside the collection lock against a captured point-in-time
state, so readers never wait on a flush. The IVF fit persists as
``ivf_meta.npz`` beside the snapshot, adopted on reopen after a sha1
check of the fitted rows.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import shutil
import threading
import zipfile
from typing import Any, Sequence

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.ops.topk import (l2_normalize, masked_topk,
                                             masked_topk_int8, quantize_int8)
from vit_research_tpu_torch.store.ivf import IVFIndex
from vit_research_tpu_torch.utils import profiling

_OPS = ("$eq", "$ne", "$gt", "$gte", "$lt", "$lte", "$in", "$nin")


class StaleCollectionError(RuntimeError):
    """The collection directory was rewritten by another writer since this
    object last read it: flushing would either be generation-fenced on
    the next load (rows silently dropped) or overwrite the newer
    on-disk corpus wholesale. Reopen the collection instead of writing
    through a stale view."""


def _atomic_write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _atomic_write_npz(path: str, **arrays) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _match_clause(values: np.ndarray, clause: Any) -> np.ndarray:
    """Evaluate one field clause against an object column."""
    if not isinstance(clause, dict):
        clause = {"$eq": clause}
    mask = np.ones(len(values), dtype=bool)
    for op, ref in clause.items():
        if op == "$eq":
            m = values == ref
        elif op == "$ne":
            m = values != ref
        elif op == "$gt":
            m = _numeric(values) > ref
        elif op == "$gte":
            m = _numeric(values) >= ref
        elif op == "$lt":
            m = _numeric(values) < ref
        elif op == "$lte":
            m = _numeric(values) <= ref
        elif op == "$in":
            m = np.isin(values, np.asarray(list(ref), dtype=object))
        elif op == "$nin":
            m = ~np.isin(values, np.asarray(list(ref), dtype=object))
        else:
            raise ValueError(f"unsupported where op {op!r} (supported: {_OPS})")
        mask &= np.asarray(m, dtype=bool)
    return mask


def _numeric(values: np.ndarray) -> np.ndarray:
    out = np.full(len(values), np.nan, dtype=np.float64)
    for i, v in enumerate(values):
        if isinstance(v, (int, float, np.integer, np.floating)):
            out[i] = float(v)
    return out


class Collection:
    #: compact when the pending+logged delta exceeds this fraction of the
    #: corpus, or when the log reaches this many segments.
    compact_ratio = 0.5
    max_segments = 16
    #: cosine collections at or above this row count answer unfiltered
    #: queries through an IVF index (store/ivf.py) instead of the exact
    #: (Q, N) matmul; filtered queries stay exact. None disables.
    ivf_threshold: int | None = 1_000_000

    def __init__(self, name: str, space: str = "l2", dim: int | None = None,
                 path: str | None = None, device_quant: str | None = None,
                 embedding_profile: str | None = None, device="cuda"):
        if space not in ("l2", "cosine", "ip"):
            raise ValueError(f"unknown space {space!r}")
        self.name = name
        self.space = space
        #: where the device query path scores (a torch.device)
        self.device = resolve_device(device)
        # Which embedding settings produced the stored rows (e.g.
        # "tome0|quant-none|gray0" — cli/common.engine_profile): mixed
        # profiles inside one collection are corruption (half the rows
        # in a different embedding space), so writers stamp it and
        # stamp_embedding_profile refuses a mismatch. None = unknown
        # (pre-profile collections, or non-engine rows).
        self.embedding_profile = embedding_profile
        self.device_quant = None
        if device_quant:
            self._check_device_quant(device_quant, space)
            self.device_quant = device_quant
        self._path = path
        self._dim = dim
        self._ids: list[str] = []
        self._id_to_idx: dict[str, int] = {}
        self._embeddings = np.zeros((0, dim or 0), dtype=np.float32)
        self._metadatas: list[dict] = []
        self._columns: dict[str, np.ndarray] = {}  # lazily-built filter cache
        # Device-resident corpus: f32 tensor, or (int8 rows, f32
        # per-row scales) when device_quant == "int8".
        self._device_cache = None
        self._dirty = False
        self._lock = threading.RLock()
        # Serializes flush/compact against each other WITHOUT blocking
        # readers: the disk write runs outside self._lock (see flush).
        self._flush_serial = threading.Lock()
        # Set while a snapshot write is in flight outside the lock: the
        # first in-place row update copies the embedding matrix so the
        # writer keeps a consistent view (appends/deletes already
        # replace the array wholesale and never mutate shared memory).
        self._cow_pending = False
        # Set across a flush/compact disk write; delete() records ids it
        # drops in that window so the commit phase can queue delete
        # records for just-persisted rows without scanning the corpus.
        self._writer_active = False
        self._deleted_during_write: set[str] = set()
        # Append-log state: ids touched / removed since the last flush,
        # the on-disk segment list, and how many logged rows the segments
        # hold (drives compaction).
        self._pending_dirty: set[str] = set()
        self._pending_deleted: set[str] = set()
        self._persisted_ids: set[str] = set()
        self._segments: list[str] = []
        self._logged_rows = 0
        self._gen = 0  # compaction generation; tags snapshot + manifest
        self._ivf = None  # lazily-fit IVFIndex
        self._ivf_persisted = False  # current fit saved as ivf_meta.npz?
        # Rows added/updated since the IVF fit — searched exactly alongside
        # the probed cells, so upserts don't force a synchronous k-means
        # refit on the next query. Deletes reindex rows and DO drop the
        # index; a tail past 20% of the corpus triggers a refit.
        self._ivf_extra: set[int] = set()

    # ------------------------------------------------------------------ io

    @classmethod
    def _load(cls, name: str, path: str, device="cuda") -> "Collection":
        # A concurrent writer can compact between our manifest read and a
        # segment read (segments unlink after the manifest swap). Each file
        # write is individually atomic, so simply retrying re-reads a
        # consistent post-compaction state.
        last_err = None
        for _ in range(5):
            try:
                return cls._load_once(name, path, device)
            except (FileNotFoundError, IndexError, KeyError,
                    ValueError) as e:
                last_err = e
        raise last_err

    @classmethod
    def _load_once(cls, name: str, path: str, device) -> "Collection":
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        col = cls(name, space=cfg["space"], dim=cfg.get("dim"), path=path,
                  device_quant=cfg.get("device_quant"),
                  embedding_profile=cfg.get("embedding_profile"),
                  device=device)
        snap_path = os.path.join(path, "snapshot.npz")
        emb_path = os.path.join(path, "embeddings.npy")
        if os.path.exists(snap_path):
            with np.load(snap_path, allow_pickle=False) as snap:
                col._embeddings = snap["embeddings"].astype(np.float32)
                col._ids = [str(i) for i in snap["ids"]]
                col._metadatas = json.loads(str(snap["metadatas"]))
                col._gen = int(snap["gen"]) if "gen" in snap.files else 0
        elif os.path.exists(emb_path):  # legacy three-file snapshot
            col._embeddings = np.load(emb_path).astype(np.float32)
            with open(os.path.join(path, "ids.json")) as f:
                col._ids = json.load(f)
            with open(os.path.join(path, "metadatas.json")) as f:
                col._metadatas = json.load(f)
        if col._ids:
            col._id_to_idx = {i: n for n, i in enumerate(col._ids)}
            col._dim = col._embeddings.shape[1]
        manifest = os.path.join(path, "segments.json")
        segments, manifest_gen = [], 0
        if os.path.exists(manifest):
            with open(manifest) as f:
                m = json.load(f)
            if isinstance(m, dict):
                segments, manifest_gen = m["segments"], int(m["gen"])
            else:  # legacy list-form manifest (gen 0)
                segments = m
        # Generation fencing: a manifest OLDER than the snapshot lists
        # segments a completed compaction already baked in — replaying
        # them would resurrect overwritten/deleted rows. A NEWER manifest
        # means we read the snapshot mid-compaction — raise so _load
        # retries against the finished state.
        if manifest_gen > col._gen:
            raise ValueError("manifest generation ahead of snapshot "
                             "(concurrent compaction); retrying")
        if manifest_gen == col._gen:
            col._segments = segments
            for seg in col._segments:
                col._replay_segment(os.path.join(path, seg))
        col._persisted_ids = set(col._ids)
        col._pending_dirty.clear()
        col._pending_deleted.clear()
        col._dirty = False
        return col

    def _replay_segment(self, seg_path: str) -> None:
        with np.load(seg_path, allow_pickle=False) as seg:
            deleted = [str(i) for i in seg["deleted"]]
            ids = [str(i) for i in seg["ids"]]
            embs = seg["embeddings"]
            metas = json.loads(str(seg["metadatas"]))
        if deleted:
            drop = {i for i in deleted if i in self._id_to_idx}
            if drop:
                keep = np.array([i not in drop for i in self._ids], bool)
                self._ids = [i for i, k in zip(self._ids, keep) if k]
                self._metadatas = [m for m, k in zip(self._metadatas, keep)
                                   if k]
                self._embeddings = self._embeddings[keep]
                self._id_to_idx = {i: n for n, i in enumerate(self._ids)}
        if ids:
            self.upsert(ids, embs, metas)
        self._logged_rows += len(deleted) + len(ids)

    def _disk_state(self):
        """(snapshot_gen, manifest_gen, manifest_segments) currently on
        disk; ``None`` per slot when the artifact doesn't exist or is
        unreadable (torn mid-replace — can't prove staleness from it)."""
        p = self._path
        snap_gen = None
        snap = os.path.join(p, "snapshot.npz")
        if os.path.exists(snap):
            try:
                with np.load(snap, allow_pickle=False) as z:
                    snap_gen = int(z["gen"]) if "gen" in z.files else 0
            except Exception:
                snap_gen = None
        elif os.path.exists(os.path.join(p, "embeddings.npy")):
            snap_gen = 0  # legacy three-file snapshot (always gen 0)
        man_gen = man_segs = None
        mpath = os.path.join(p, "segments.json")
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    m = json.load(f)
                if isinstance(m, dict):
                    man_gen, man_segs = int(m["gen"]), list(m["segments"])
                else:  # legacy list-form manifest
                    man_gen, man_segs = 0, list(m)
            except Exception:
                pass
        return snap_gen, man_gen, man_segs

    def _check_not_stale(self) -> None:
        """Refuse to write through a stale view of the directory (another
        process compacted past our generation, or appended segments we
        never replayed). Loud beats silent: a stale flush would be
        generation-fenced away on the next load, or — when it compacts —
        atomically REPLACE the newer corpus with this object's old one.

        Best-effort SEQUENTIAL-staleness detection only, not multi-writer
        safety: the check-then-write is not atomic across processes (no
        file lock), so two writers at the same generation can both pass
        and the later manifest replace drops the other's segment; and a
        torn snapshot/manifest read (None slots) deliberately passes,
        since staleness can't be proven from it. The intended deployment
        is single-writer-at-a-time (CLI builders hand off to the daemon;
        rebuild-db runs while the daemon only reads, then reloads). True
        concurrent multi-writer use would need an flock on the collection
        dir or O_EXCL segment creation + manifest re-read after write."""
        snap_gen, man_gen, man_segs = self._disk_state()
        if snap_gen is None and man_gen is None:
            return  # nothing durable yet — first flush of a new dir
        if (snap_gen or 0) > self._gen or (man_gen or 0) > self._gen:
            raise StaleCollectionError(
                f"collection {self.name!r} at {self._path!r} is at "
                f"generation {max(snap_gen or 0, man_gen or 0)} on disk "
                f"but this object last read generation {self._gen}: "
                "another writer rebuilt it; reopen before writing")
        if (man_gen == self._gen and man_segs is not None
                and man_segs != self._segments):
            raise StaleCollectionError(
                f"collection {self.name!r} at {self._path!r} has log "
                "segments this object never replayed (another writer "
                "appended concurrently); reopen before writing")

    def flush(self) -> None:
        """Persist pending mutations: appends one log segment, or
        ESCALATES to a full snapshot rewrite when the log share crosses
        ``compact_ratio`` of the corpus or ``max_segments`` (or nothing
        was ever snapshotted). The delta append writes only the touched
        rows; the escalated rewrite writes the whole corpus — but
        either way the disk write runs OUTSIDE the collection lock, so
        queries/gets/upserts proceed concurrently (a point-in-time state
        is captured under the lock first; in-place upserts that race the
        write trigger one copy-on-write of the embedding matrix). Raises
        :class:`StaleCollectionError` instead of writing through a view
        another process has rebuilt past."""
        self._flush_or_compact(force_snapshot=False)

    def compact(self) -> None:
        """Force-merge the log into a fresh snapshot. Like :meth:`flush`,
        the snapshot write happens outside the collection lock: queries
        keep answering (from the in-memory arrays) while the multi-second
        rewrite is on disk."""
        self._flush_or_compact(force_snapshot=True)

    def _flush_or_compact(self, force_snapshot: bool) -> None:
        # One writer at a time (flush_serial), but readers NEVER wait on
        # the disk write: capture a consistent point-in-time state under
        # self._lock, release it, write files, re-acquire to commit the
        # bookkeeping. Mutations that land during the write stay pending
        # (re-flushing an already-persisted row is idempotent; rows the
        # snapshot captured but that were deleted mid-write get a delete
        # record queued so the next segment removes them).
        with self._flush_serial:
            with self._lock:
                if self._path is None:
                    return
                if not force_snapshot and not self._dirty:
                    return
                self._check_not_stale()
                path = self._path
                cfg_obj = {"space": self.space, "dim": self._dim,
                           "device_quant": self.device_quant,
                           "embedding_profile": self.embedding_profile}
                delta = (len(self._pending_dirty)
                         + len(self._pending_deleted) + self._logged_rows)
                has_snapshot = (
                    os.path.exists(os.path.join(path, "snapshot.npz"))
                    or os.path.exists(
                        os.path.join(path, "embeddings.npy")))
                if (not force_snapshot and has_snapshot
                        and not self._pending_dirty
                        and not self._pending_deleted):
                    # config-only change (e.g. a profile stamp): persist
                    # config.json only — an empty log segment per stamp
                    # would grow the manifest toward a pointless
                    # compaction
                    kind = "config"
                elif (force_snapshot or not has_snapshot
                        or len(self._segments) >= self.max_segments
                        or delta >= self.compact_ratio
                        * max(len(self._ids), 1)):
                    kind = "snapshot"
                    new_gen = self._gen + 1
                    snap_ids = list(self._ids)
                    snap_metas = list(self._metadatas)  # dicts are only
                    # ever REPLACED by upsert/delete, never mutated in
                    # place, so shallow refs stay consistent
                    snap_embs = self._embeddings  # guarded by COW below
                    self._cow_pending = True
                    old_segments = list(self._segments)
                else:
                    kind = "segment"
                    seq = ((int(self._segments[-1][4:10]) + 1)
                           if self._segments else 0)
                    seg_name = f"seg_{seq:06d}.npz"
                    cap_dirty = sorted(self._pending_dirty)
                    cap_deleted = sorted(self._pending_deleted)
                    seg_rows = (np.stack(
                        [self._embeddings[self._id_to_idx[i]]
                         for i in cap_dirty])
                        if cap_dirty
                        else np.zeros((0, self._dim or 0), np.float32))
                    seg_metas = [self._metadatas[self._id_to_idx[i]]
                                 for i in cap_dirty]
                    new_segments = self._segments + [seg_name]
                if kind != "config":
                    # Take the pending sets: mutations that land during
                    # the disk write accumulate in FRESH sets and simply
                    # stay pending for the next flush (no re-flush
                    # amplification of rows this write already covers).
                    cap_dirty_set = self._pending_dirty
                    cap_deleted_set = self._pending_deleted
                    self._pending_dirty = set()
                    self._pending_deleted = set()
                # delete() records ids dropped while the write is on
                # disk into this small set, so the commit phase doesn't
                # have to scan every persisted id under the lock.
                self._writer_active = True
                self._deleted_during_write = set()

            # ---- disk IO: no collection lock held ----
            snap_landed = False
            try:
                os.makedirs(path, exist_ok=True)
                _atomic_write_json(os.path.join(path, "config.json"),
                                   cfg_obj)
                if kind == "snapshot":
                    _atomic_write_npz(
                        os.path.join(path, "snapshot.npz"),
                        embeddings=snap_embs,
                        ids=np.asarray(snap_ids, dtype=str),
                        metadatas=np.asarray(json.dumps(snap_metas)),
                        gen=np.asarray(new_gen))
                    # The atomic snapshot replace IS the commit point:
                    # everything after (manifest truncate, unlinks) is
                    # cleanup that generation fencing makes optional.
                    snap_landed = True
                    _atomic_write_json(
                        os.path.join(path, "segments.json"),
                        {"gen": new_gen, "segments": []})
                    for seg in old_segments:  # racing readers retry
                        try:                  # in _load
                            os.unlink(os.path.join(path, seg))
                        except OSError:
                            pass
                    for legacy in ("embeddings.npy", "ids.json",
                                   "metadatas.json"):
                        try:
                            os.unlink(os.path.join(path, legacy))
                        except OSError:
                            pass
                elif kind == "segment":
                    _atomic_write_npz(
                        os.path.join(path, seg_name),
                        ids=np.asarray(cap_dirty, dtype=str),
                        embeddings=seg_rows.astype(np.float32),
                        metadatas=np.asarray(json.dumps(seg_metas)),
                        deleted=np.asarray(cap_deleted, dtype=str))
                    # Manifest last: a crash before this line leaves an
                    # orphan segment file that load ignores.
                    _atomic_write_json(
                        os.path.join(path, "segments.json"),
                        {"gen": self._gen, "segments": new_segments})
            except BaseException:
                if snap_landed:
                    # snapshot.npz is on disk at new_gen with the full
                    # capture; only cleanup failed. Without adopting the
                    # new generation, every retry would raise
                    # StaleCollectionError against our OWN write (disk
                    # gen > self._gen) — commit the bookkeeping, then
                    # surface the IO error.
                    self._commit_after_write(
                        "snapshot", cfg_obj, new_gen=new_gen,
                        snap_id_set=set(snap_ids))
                else:
                    # Nothing durable landed: put the captured
                    # pending-ness back (merged with whatever arrived
                    # meanwhile) so a retry re-persists it; filter ids
                    # deleted/re-added during the window to keep the
                    # pending invariants (pending_dirty ids must be
                    # resolvable, pending_deleted ids absent).
                    with self._lock:
                        if kind != "config":
                            self._pending_dirty |= {
                                i for i in cap_dirty_set
                                if i in self._id_to_idx}
                            self._pending_deleted |= {
                                i for i in cap_deleted_set
                                if i not in self._id_to_idx}
                        self._cow_pending = False
                        self._writer_active = False
                        self._dirty = True
                raise

            if kind == "snapshot":
                # O(N) set build happens OUTSIDE the lock (commit-time
                # reader stall stays O(mutations-during-write)).
                self._commit_after_write("snapshot", cfg_obj,
                                         new_gen=new_gen,
                                         snap_id_set=set(snap_ids))
            elif kind == "segment":
                self._commit_after_write(
                    "segment", cfg_obj, new_segments=new_segments,
                    cap_dirty_set=cap_dirty_set,
                    cap_deleted_set=cap_deleted_set,
                    logged=len(cap_dirty) + len(cap_deleted))
            else:
                self._commit_after_write("config", cfg_obj)

    def _commit_after_write(self, kind, cfg_obj, *, new_gen=None,
                            snap_id_set=None, new_segments=None,
                            cap_dirty_set=None, cap_deleted_set=None,
                            logged=0) -> None:
        with self._lock:
            if kind == "snapshot":
                self._gen = new_gen
                self._segments = []
                self._logged_rows = 0
                self._persisted_ids = snap_id_set
                persisted = snap_id_set
            elif kind == "segment":
                self._segments = new_segments
                self._logged_rows += logged
                self._persisted_ids |= cap_dirty_set
                self._persisted_ids -= cap_deleted_set
                persisted = cap_dirty_set
            else:
                persisted = set()
            # Any id this write persisted that was deleted while it was
            # on disk needs a delete record queued, or the next load
            # would resurrect it (delete() only records ids in the OLD
            # persisted set). delete() tracked the candidates, so this
            # scan is O(deletes-during-write), not O(corpus).
            self._pending_deleted.update(
                i for i in self._deleted_during_write
                if i in persisted and i not in self._id_to_idx)
            self._cow_pending = False
            self._writer_active = False
            self._deleted_during_write = set()
            current_cfg = {"space": self.space, "dim": self._dim,
                           "device_quant": self.device_quant,
                           "embedding_profile": self.embedding_profile}
            self._dirty = bool(self._pending_dirty
                               or self._pending_deleted
                               or current_cfg != cfg_obj)

    def stamp_embedding_profile(self, profile: str) -> None:
        """Record which embedding settings produced this collection's
        rows (writers call this before upserting engine embeddings).
        First stamp wins and persists; an equal re-stamp is a no-op; a
        DIFFERENT profile is a hard error — mixing embedding spaces in
        one collection corrupts every ranking against it. Rebuild into
        a fresh collection (or delete this one) to change profiles."""
        with self._lock:
            if profile is None:
                return
            if self.embedding_profile is None:
                self.embedding_profile = str(profile)
                self._dirty = True  # persist via config.json on flush
                return
            if self.embedding_profile != str(profile):
                raise ValueError(
                    f"collection {self.name!r} holds embeddings produced "
                    f"with profile {self.embedding_profile!r}, but this "
                    f"writer is running {profile!r} — mixing embedding "
                    "spaces in one collection corrupts every ranking "
                    "against it; rebuild into a fresh collection (or "
                    "delete this one) to switch profiles")

    # ------------------------------------------------------------ mutation

    def upsert(self, ids: Sequence[str], embeddings, metadatas=None) -> None:
        with self._lock:
            embeddings = np.asarray(embeddings, dtype=np.float32)
            if embeddings.ndim == 1:
                embeddings = embeddings[None]
            if self._dim is None or self._embeddings.shape[1] == 0:
                self._dim = embeddings.shape[1]
                self._embeddings = np.zeros((0, self._dim), np.float32)
            if metadatas is None:
                metadatas = [{} for _ in ids]
            new_rows, new_ids, new_metas = [], [], []
            batch_pos = {}  # id -> slot in new_*: an id repeated within
            #                 ONE call must still land as a single
            #                 last-wins row (Chroma semantics), not as
            #                 duplicate rows that then leak into
            #                 count/get/query
            for i, _id in enumerate(ids):
                _id = str(_id)
                idx = self._id_to_idx.get(_id)
                if idx is None:
                    pos = batch_pos.get(_id)
                    if pos is None:
                        batch_pos[_id] = len(new_ids)
                        new_ids.append(_id)
                        new_rows.append(embeddings[i])
                        new_metas.append(dict(metadatas[i] or {}))
                    else:
                        new_rows[pos] = embeddings[i]
                        new_metas[pos] = dict(metadatas[i] or {})
                else:
                    if self._cow_pending:
                        # A snapshot write is reading this array outside
                        # the lock: replace it before mutating in place
                        # so the on-disk snapshot stays a consistent
                        # point-in-time state.
                        self._embeddings = self._embeddings.copy()
                        self._cow_pending = False
                    self._embeddings[idx] = embeddings[i]
                    self._metadatas[idx] = dict(metadatas[i] or {})
                    if self._ivf is not None:
                        self._ivf_extra.add(idx)
                self._pending_dirty.add(_id)
                self._pending_deleted.discard(_id)
            if new_ids:
                base = len(self._ids)
                self._ids.extend(new_ids)
                for n, _id in enumerate(new_ids):
                    self._id_to_idx[_id] = base + n
                self._embeddings = np.concatenate(
                    [self._embeddings, np.stack(new_rows)], axis=0)
                # concatenate rebound the matrix: it no longer aliases an
                # in-flight snapshot writer's captured array, so a later
                # in-place update needn't pay the defensive copy.
                self._cow_pending = False
                self._metadatas.extend(new_metas)
                if self._ivf is not None:
                    self._ivf_extra.update(range(base, base + len(new_ids)))
            if (self._ivf is not None
                    and len(self._ivf_extra)
                    > self._IVF_REFIT_TAIL * len(self._ids)):
                self._ivf, self._ivf_extra = None, set()  # refit next query
            self._invalidate()

    add = upsert  # the reference only uses idempotent upserts

    def delete(self, ids: Sequence[str] | None = None,
               where: dict | None = None):
        """Delete by ids or filter. ``where={}`` deletes everything;
        calling with neither argument is an error (Chroma semantics)."""
        with self._lock:
            if ids is None and where is None:
                raise ValueError("delete() needs ids or where "
                                 "(use where={} to wipe)")
            if ids is not None:
                drop = {str(i) for i in ids}
                keep = np.array([i not in drop for i in self._ids], dtype=bool)
            else:
                keep = ~self._where_mask(where)
            for _id, k in zip(self._ids, keep):
                if not k:
                    self._pending_dirty.discard(_id)
                    if _id in self._persisted_ids:
                        self._pending_deleted.add(_id)
                    if self._writer_active:
                        # an in-flight flush may be persisting this very
                        # id; its commit phase checks this set and queues
                        # a delete record so the row can't resurrect
                        self._deleted_during_write.add(_id)
            self._ids = [i for i, k in zip(self._ids, keep) if k]
            self._metadatas = [m for m, k in zip(self._metadatas, keep) if k]
            self._embeddings = self._embeddings[keep]
            self._cow_pending = False  # boolean indexing rebound the matrix
            self._id_to_idx = {i: n for n, i in enumerate(self._ids)}
            self._ivf, self._ivf_extra = None, set()  # rows reindexed
            self._invalidate()

    def _invalidate(self):
        self._columns = {}
        self._device_cache = None
        self._dirty = True

    # --------------------------------------------------------------- reads

    def count(self) -> int:
        return len(self._ids)

    def _column(self, field: str) -> np.ndarray:
        col = self._columns.get(field)
        if col is None:
            col = np.array([m.get(field) for m in self._metadatas],
                           dtype=object)
            self._columns[field] = col
        return col

    def _where_mask(self, where: dict | None) -> np.ndarray:
        n = len(self._ids)
        if not where:
            return np.ones(n, dtype=bool)
        mask = np.ones(n, dtype=bool)
        for key, clause in where.items():
            if key == "$and":
                for sub in clause:
                    mask &= self._where_mask(sub)
            elif key == "$or":
                sub_mask = np.zeros(n, dtype=bool)
                for sub in clause:
                    sub_mask |= self._where_mask(sub)
                mask &= sub_mask
            else:
                mask &= _match_clause(self._column(key), clause)
        return mask

    def get(self, ids=None, where=None, include=("metadatas",), limit=None,
            offset: int = 0) -> dict:
        with self._lock:
            if ids is not None:
                sel = [self._id_to_idx[str(i)] for i in ids
                       if str(i) in self._id_to_idx]
                sel = np.asarray(sel, dtype=np.int64)
                if where:
                    m = self._where_mask(where)
                    sel = sel[[m[i] for i in sel]]
            else:
                sel = np.nonzero(self._where_mask(where))[0]
            if offset:
                sel = sel[offset:]
            if limit is not None:
                sel = sel[:limit]
            out = {"ids": [self._ids[i] for i in sel]}
            if "embeddings" in include:
                out["embeddings"] = self._embeddings[sel]
            if "metadatas" in include:
                out["metadatas"] = [self._metadatas[i] for i in sel]
            return out

    @staticmethod
    def _check_device_quant(mode: str, space: str) -> None:
        if mode != "int8":
            raise ValueError(f"unknown device_quant {mode!r}")
        if space == "l2":
            raise ValueError(
                "device_quant='int8' needs a 'cosine' or 'ip' space "
                "(l2 stays exact f32)")

    def set_device_quantization(self, mode: str | None) -> None:
        """Opt the device query path into int8 corpus compression: a
        quarter of the f32 device memory and s8 x s8 -> s32 products, at
        per-row symmetric-quantization accuracy
        (ops/topk.py::quantize_int8). Persisted with the collection."""
        with self._lock:
            if mode:
                self._check_device_quant(mode, self.space)
            self.device_quant = mode or None
            self._device_cache = None
            self._dirty = True  # persist in config.json on next flush

    def _device_corpus(self):
        if self._device_cache is None:
            emb = torch.from_numpy(self._embeddings).to(self.device)
            if self.space == "cosine":
                emb = l2_normalize(emb)
            self._device_cache = (quantize_int8(emb)
                                  if self.device_quant == "int8" else emb)
        return self._device_cache

    def query(self, query_embeddings, n_results: int = 10, where=None,
              include=("metadatas", "distances")) -> dict:
        """Exact top-k. Returns Chroma-shaped dict of per-query lists."""
        with self._lock, profiling.span("store.query"):
            q = np.asarray(query_embeddings, dtype=np.float32)
            if q.ndim == 1:
                q = q[None]
            n = len(self._ids)
            if n == 0:
                empty = [[] for _ in range(q.shape[0])]
                out = {"ids": empty}
                for k in ("distances", "metadatas", "embeddings"):
                    if k in include:
                        out[k] = [[] for _ in range(q.shape[0])]
                return out
            k = min(n_results, n)
            mask = self._where_mask(where)

            if (self.ivf_threshold is not None and not where
                    and self.space == "cosine"
                    # device_quant exists precisely to keep huge corpora
                    # on the exact device path — IVF must not override it.
                    and self.device_quant is None
                    and n >= self.ivf_threshold):
                scores, idx = self._query_ivf(q, k)
            elif n * q.shape[0] >= 1 << 14:
                scores, idx = self._query_device(q, mask, k)
            else:
                scores, idx = self._query_numpy(q, mask, k)

            # Similarity -> Chroma distance convention.
            if self.space == "l2":
                dist = -scores  # squared L2
            else:
                dist = 1.0 - scores
            valid = scores > -1e29
            out = {"ids": [[self._ids[j] for j, ok in zip(row, vrow) if ok]
                           for row, vrow in zip(idx, valid)]}
            if "distances" in include:
                out["distances"] = [[float(d) for d, ok in zip(drow, vrow) if ok]
                                    for drow, vrow in zip(dist, valid)]
            if "metadatas" in include:
                out["metadatas"] = [[self._metadatas[j]
                                     for j, ok in zip(row, vrow) if ok]
                                    for row, vrow in zip(idx, valid)]
            if "embeddings" in include:
                out["embeddings"] = [self._embeddings[row[vrow]]
                                     for row, vrow in zip(idx, valid)]
            return out

    def _query_device(self, q, mask, k):
        corpus = self._device_corpus()
        qd = torch.from_numpy(q).to(self.device)
        if self.space == "cosine":
            qd = l2_normalize(qd)
        # An unfiltered query ships no mask (N bools per call).
        m = (None if mask.all()
             else torch.from_numpy(mask).to(self.device)[None, :])
        if self.device_quant == "int8":
            corpus_q, corpus_scale = corpus
            qq, qscale = quantize_int8(qd)
            scores, idx = masked_topk_int8(qq, qscale, corpus_q,
                                           corpus_scale, m, k=k)
        else:
            metric = "ip" if self.space == "cosine" else self.space
            scores, idx = masked_topk(qd, corpus, m, k=k, metric=metric)
        return scores.cpu().numpy(), idx.cpu().numpy()

    #: persisted-fit filename beside the snapshot (see prewarm_index)
    _IVF_META = "ivf_meta.npz"
    #: drop the IVF fit (refit on next query) once the exactly-searched
    #: post-fit tail exceeds this fraction of the corpus; prewarm_index
    #: applies the same bound when deciding whether to adopt a persisted
    #: fit, so startup and steady-state agree on index quality
    _IVF_REFIT_TAIL = 0.2

    def _ivf_fingerprint(self, n_rows: int) -> bytes:
        """sha1 over the first ``n_rows`` embedding rows' raw bytes +
        shape — the validity key for a persisted IVF fit. Hashing reads
        the rows once, far cheaper than a k-means refit, and catches ANY
        content or order change including in-place upserts that keep the
        row count constant."""
        emb = np.ascontiguousarray(self._embeddings[:n_rows])
        h = hashlib.sha1()
        h.update(np.int64(n_rows).tobytes())
        h.update(np.int64(emb.shape[1] if emb.ndim == 2 else 0).tobytes())
        h.update(emb)
        return h.digest()

    def prewarm_index(self) -> bool:
        """Ready the serving index up front when the IVF path would
        engage (unfiltered cosine queries at >= ``ivf_threshold`` rows
        route through store/ivf.py, whose first-query k-means fit is a
        one-time cost that grows with the corpus). Long-lived servers call this
        during startup so no user request pays it.

        The fit is persisted as ``ivf_meta.npz`` beside the snapshot
        (centroids + cell assignments only, ~n*8 bytes — NOT a corpus
        copy), so a restarting daemon adopts the previous fit after a
        corpus-fingerprint check instead of refitting. Rows appended since
        the persisted fit are searched exactly alongside the probed cells
        (same mechanism as
        post-fit upserts); any content/order change to the fitted prefix
        fails the fingerprint and triggers a fresh fit + re-persist.

        Returns True when the IVF path is ready (fit adopted or
        computed), False when this collection answers queries another
        way. Startup-only by design: runs under the collection lock,
        including the meta write."""
        with self._lock:
            if (self.ivf_threshold is None or self.space != "cosine"
                    or self.device_quant is not None
                    or len(self._ids) < self.ivf_threshold):
                return False
            n = len(self._ids)
            meta_path = (os.path.join(self._path, self._IVF_META)
                         if self._path else None)
            fp_live = None  # digest reusable by the persist step below
            if self._ivf is None:
                if meta_path and os.path.exists(meta_path):
                    # Adopt when the fitted rows are an unchanged prefix
                    # of the live corpus and the appended tail is within
                    # the same bound that gates a runtime refit
                    # (_IVF_REFIT_TAIL, shared with upsert()). A torn,
                    # corrupt or mis-shaped meta refits below.
                    try:
                        idx, fp = IVFIndex.load_meta(meta_path)
                        if not (0 < idx._n <= n
                                and n - idx._n <= self._IVF_REFIT_TAIL * n
                                and idx.centroids.shape[1]
                                == self._embeddings.shape[1]):
                            idx = None
                    except (OSError, ValueError, KeyError,
                            zipfile.BadZipFile):
                        idx = None
                    if idx is not None:
                        fp_live = self._ivf_fingerprint(idx._n)
                        if fp == fp_live:
                            self._ivf = idx
                            self._ivf_extra = set(range(idx._n, n))
                            self._ivf_persisted = True
                            return True
                        if idx._n != n:
                            fp_live = None  # hashed a prefix only
                self._ivf = IVFIndex().fit(self._embeddings)
                self._ivf_extra = set()
                self._ivf_persisted = False
            elif (self._ivf_persisted
                  or any(e < self._ivf._n for e in self._ivf_extra)):
                # Already persisted — or prefix rows were updated
                # in-place since the fit (only the live _ivf_extra makes
                # them exact; a restart adopting this fit would serve
                # them through stale cells), so it must not be saved.
                return True
            if meta_path and not self._ivf_persisted:
                # A lazily-refit index (query-path, never persisted)
                # lands here too, so a bounce after heavy writes still
                # adopts instead of refitting. Skip — never clobber —
                # when another process rebuilt the directory past this
                # object's generation (same rule as flush()).
                try:
                    self._check_not_stale()
                    os.makedirs(self._path, exist_ok=True)
                    self._ivf.save_meta(
                        meta_path,
                        fp_live if fp_live is not None
                        else self._ivf_fingerprint(self._ivf._n))
                    self._ivf_persisted = True
                except (OSError, StaleCollectionError):
                    pass  # persistence is an optimization, never fatal
            return True

    def _query_ivf(self, q, k):
        if self._ivf is None:
            # Query-path fit: never writes (prewarm_index persists an
            # unpersisted fit later, e.g. at the next daemon start).
            self._ivf = IVFIndex().fit(self._embeddings)
            self._ivf_extra = set()
            self._ivf_persisted = False
        extra = (np.fromiter(self._ivf_extra, np.int64,
                             len(self._ivf_extra))
                 if self._ivf_extra else None)
        return self._ivf.search(q, self._embeddings, k, extra=extra)

    def _query_numpy(self, q, mask, k):
        emb = self._embeddings
        if self.space == "cosine":
            qe = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
            ce = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True),
                                  1e-12)
            s = qe @ ce.T
        elif self.space == "ip":
            s = q @ emb.T
        else:
            q2 = (q * q).sum(-1, keepdims=True)
            c2 = (emb * emb).sum(-1)
            s = -(q2 - 2.0 * (q @ emb.T) + c2[None, :])
        s = np.where(mask[None, :], s, -1e30)
        k = min(k, s.shape[1])
        idx = np.argpartition(-s, kth=k - 1, axis=1)[:, :k]
        part = np.take_along_axis(s, idx, axis=1)
        order = np.argsort(-part, axis=1, kind="stable")
        idx = np.take_along_axis(idx, order, axis=1)
        return np.take_along_axis(s, idx, axis=1), idx


class PersistentClient:
    """Chroma-compatible client over a directory of collection snapshots.
    ``device`` is where its collections' device query path runs
    (``'cuda'`` by default; asking for CUDA without a card raises)."""

    def __init__(self, path: str = "./vector_store", autoflush: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._collections: dict[str, Collection] = {}
        if autoflush:
            atexit.register(self.flush)

    def _col_path(self, name: str) -> str:
        return os.path.join(self.path, name)

    def get_or_create_collection(self, name: str,
                                 metadata: dict | None = None) -> Collection:
        if name in self._collections:
            return self._collections[name]
        path = self._col_path(name)
        if os.path.exists(os.path.join(path, "config.json")):
            col = Collection._load(name, path, self.device)
        else:
            space = (metadata or {}).get("hnsw:space", "l2")
            col = Collection(name, space=space, path=path,
                             device_quant=(metadata or {}).get(
                                 "vrt:device_quant"),
                             embedding_profile=(metadata or {}).get(
                                 "vrt:embedding_profile"),
                             device=self.device)
            col._dirty = True
        self._collections[name] = col
        return col

    def get_collection(self, name: str) -> Collection:
        """Strict lookup (Chroma semantics): raises on a missing name
        instead of silently creating an empty l2 collection — a typoed
        name should fail loudly, not serve empty results."""
        if name not in self._collections and not os.path.exists(
                os.path.join(self._col_path(name), "config.json")):
            raise ValueError(
                f"collection {name!r} does not exist in {self.path} "
                f"(have: {sorted(self.list_collections())})")
        return self.get_or_create_collection(name)

    def delete_collection(self, name: str) -> None:
        self._collections.pop(name, None)
        shutil.rmtree(self._col_path(name), ignore_errors=True)

    def list_collections(self) -> list[str]:
        names = set(self._collections)
        if os.path.isdir(self.path):
            for entry in os.listdir(self.path):
                if os.path.exists(os.path.join(self.path, entry, "config.json")):
                    names.add(entry)
        return sorted(names)

    def flush(self) -> None:
        for col in self._collections.values():
            try:
                col.flush()
            except StaleCollectionError as e:
                # atexit autoflush path: one stale collection (another
                # process rebuilt its directory) must not clobber disk
                # NOR abort the flush of the remaining collections.
                import sys

                print(f"vector_store: skipping flush: {e}",
                      file=sys.stderr)
