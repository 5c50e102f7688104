"""Asynchronous vector-DB rebuild overlapped with training.

Port of vit_research_tpu/train/async_rebuild.py. The reference rebuilds
its retrieval DB synchronously every ``REBUILD_EVERY`` epochs, and
training stalls for the whole rebuild (reference:
nba_proj/train/training.py:479-480). Here collections are
double-buffered: the retriever reads the *active* collection, a host
thread writes a *shadow* one, and at the next epoch boundary the trainer
calls :meth:`RebuildScheduler.maybe_swap`, which moves retrieval to the
fresh snapshot in one step. Training never waits for the rebuild, and
retrieval never sees a half-built DB.
"""

from __future__ import annotations

import threading
import traceback


class SwappableCollection:
    """A collection handle whose backing collection swaps atomically.
    Carries the query/get/count surface and the device snapshot the
    retrievers read; ``swap`` is O(1) and thread-safe."""

    def __init__(self, collection):
        self._active = collection
        self._lock = threading.Lock()
        self._swap_gen = 0  # part of the snapshot version

    @property
    def active(self):
        with self._lock:
            return self._active

    def swap(self, new_collection) -> None:
        with self._lock:
            self._active = new_collection
            self._swap_gen += 1

    def query(self, *a, **k):
        return self.active.query(*a, **k)

    def get(self, *a, **k):
        return self.active.get(*a, **k)

    def count(self):
        return self.active.count()

    def upsert(self, *a, **k):
        return self.active.upsert(*a, **k)

    def delete(self, *a, **k):
        return self.active.delete(*a, **k)

    @property
    def space(self):
        return self.active.space

    @property
    def device(self):
        return self.active.device

    def device_snapshot(self, fields, since=None):
        """Collection.device_snapshot of the active collection, its
        version paired with the swap count: it moves on every swap, even
        when both collections hold the same counter value (an id() of the
        active collection could be reused after garbage collection)."""
        with self._lock:
            gen, active = self._swap_gen, self._active
        inner = since[1] if since is not None and since[0] == gen else None
        snap = active.device_snapshot(fields, since=inner)
        if snap is None:
            return None
        version, rows, columns = snap
        return (gen, version), rows, columns


class RebuildScheduler:
    """Runs ``rebuild_fn(shadow_collection, *kick_args)`` on a background
    thread and swaps the shadow in at the next epoch boundary."""

    def __init__(self, swappable: SwappableCollection, make_collection,
                 rebuild_fn):
        """Args:
          make_collection: callable() -> an empty collection (the shadow).
          rebuild_fn: callable(collection, *kick_args) -> None; fills the
            shadow. ``kick_args`` are what the training loop passes to
            :meth:`kick`: the trainers pass their live projection.
        """
        self.swappable = swappable
        self.make_collection = make_collection
        self.rebuild_fn = rebuild_fn
        self._thread: threading.Thread | None = None
        self._ready = None
        self._error: str | None = None
        self._lock = threading.Lock()
        self.swaps = 0

    def kick(self, *args) -> bool:
        """Start a rebuild unless one is in flight; True if started.
        ``args`` go to ``rebuild_fn(shadow, *args)``."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            shadow = self.make_collection()

            def work():
                try:
                    self.rebuild_fn(shadow, *args)
                    with self._lock:
                        self._ready = shadow
                except Exception:  # raised at the next maybe_swap
                    with self._lock:
                        self._error = traceback.format_exc()

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
            return True

    def maybe_swap(self, raise_on_error: bool = True) -> bool:
        """Swap in a finished rebuild (at an epoch boundary); True when it
        swapped. A failed rebuild raises RuntimeError here, or, with
        ``raise_on_error=False`` (after training, where a failed
        auxiliary DB write must not discard the trained state), is
        printed."""
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                if not raise_on_error:
                    print(f"[async_rebuild] final rebuild failed "
                          f"(ignored):\n{err}")
                    return False
                raise RuntimeError(f"async rebuild failed:\n{err}")
            if self._ready is None:
                return False
            shadow, self._ready = self._ready, None
        self.swappable.swap(shadow)
        self.swaps += 1
        return True

    def wait(self, timeout: float | None = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)
