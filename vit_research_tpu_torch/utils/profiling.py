"""Structured timing spans and a device trace.

Port of vit_research_tpu/utils/profiling.py. :func:`span` is the
program's one span: ``with span("engine.stage", bytes=n): ...`` (names
``<layer>.<step>``; counts are numbers, or a short string such as a
route). It does nothing beyond a flag check unless

- ``VRT_PROFILE`` is set (read when this module is imported, and by
  :func:`active`): the span's wall time and counts are aggregated by
  name into a report, which the CLI prints at exit; or
- a ``torch.profiler`` session is recording: the span is appended to a
  bounded in-memory buffer as a :class:`SpanRecord` (name, start and end,
  thread, its id, the enclosing span of the same thread, counts),
  stamped on the clock of the profiler's own CPU events
  (``time.time_ns``), so it lies on one axis with the profiler's host
  and device events. :func:`recorded_spans` reads the buffer and
  :func:`take_spans` empties it.

A span never synchronises the device, records no CUDA event and opens
no ``record_function``: the profiler's event list is the same with spans
as without them. :func:`timed` is a one-off span that prints, and
:func:`device_trace` records a ``torch.profiler`` trace of a region (the
reference's ``jax.profiler.trace``) and writes it, with the region's
spans on rows of their own, to a directory.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler


class Profiler:
    """Aggregating span timer: ``with prof.span('embed'): ...``. Safe to
    use from several threads."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        #: {span name: {count name: sum}}, numeric counts only
        self.sums = defaultdict(lambda: defaultdict(float))
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **counts):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, counts)

    def add(self, name: str, seconds: float, counts: dict) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            for key, value in counts.items():
                if isinstance(value, (int, float)):
                    self.sums[name][key] += value

    def report(self) -> dict:
        with self._lock:
            out = {}
            for name in sorted(self.totals):
                row = {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_ms": round(1000 * self.totals[name]
                                        / max(self.counts[name], 1), 3)}
                if self.sums.get(name):
                    row["sums"] = dict(self.sums[name])
                out[name] = row
            return out

    def print_report(self) -> None:
        for name, row in self.report().items():
            sums = "".join(f" {k}={v:g}"
                           for k, v in row.get("sums", {}).items())
            print(f"[prof] {name}: total={row['total_s']}s "
                  f"n={row['count']} mean={row['mean_ms']}ms{sums}")

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.sums.clear()


_GLOBAL: Profiler | None = Profiler() if os.environ.get("VRT_PROFILE") \
    else None


def active() -> Profiler | None:
    """The process-wide profiler, created on first use when the
    ``VRT_PROFILE`` env var is set (else None)."""
    global _GLOBAL
    if _GLOBAL is None and os.environ.get("VRT_PROFILE"):
        _GLOBAL = Profiler()
    return _GLOBAL


# --------------------------------------------------------------- recorder


class SpanRecord(NamedTuple):
    """One span recorded while a ``torch.profiler`` session ran. Times
    are ns on the profiler's CPU clock (``time.time_ns``); ``thread`` is
    the native thread id (a Chrome trace's ``tid``); ``parent`` is the
    id of the enclosing span of the same thread (None at the top)."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: int | None
    counts: dict


#: the recorder keeps at most this many spans until they are taken
MAX_SPANS = 1 << 20


class _Buffer:
    """Spans as plain tuples (a :class:`SpanRecord` is made when they are
    read, off the recording path), at most ``cap`` of them."""

    def __init__(self, cap: int):
        self.cap = cap
        self.spans: list = []
        self.dropped = 0
        self._lock = threading.Lock()

    def append(self, rec: tuple) -> None:
        with self._lock:
            if len(self.spans) < self.cap:
                self.spans.append(rec)
            else:
                self.dropped += 1

    def read(self, empty: bool) -> list:
        with self._lock:
            out = self.spans
            if empty:
                self.spans, self.dropped = [], 0
            else:
                out = list(out)
        return [SpanRecord._make(t) for t in out]


class _ThreadSpans(threading.local):
    """A thread's open spans (their ids) and its native id, read once
    (a system call)."""

    def __init__(self):
        self.stack: list = []
        self.thread = threading.get_native_id()


_BUFFER = _Buffer(MAX_SPANS)
_IDS = itertools.count(1)
_OPEN = _ThreadSpans()


def recorded_spans() -> list:
    """The recorded spans, in the order they ended."""
    return _BUFFER.read(empty=False)


def dropped_spans() -> int:
    """Spans not recorded since the last :func:`take_spans`, the buffer
    being full."""
    return _BUFFER.dropped


def take_spans() -> list:
    """The recorded spans, emptying the buffer (and the drop count)."""
    return _BUFFER.read(empty=True)


class _NullSpan:
    """What :func:`span` returns with nothing to record."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "counts", "prof", "start_ns", "id", "parent")

    def __init__(self, name: str, counts: dict, prof: Profiler | None):
        self.name, self.counts, self.prof = name, counts, prof

    def set(self, **counts) -> None:
        """Counts known only inside the span (a route, a size)."""
        self.counts.update(counts)

    def __enter__(self):
        stack = _OPEN.stack
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _OPEN.stack.pop()
        if self.prof is not None:
            self.prof.add(self.name, (end_ns - self.start_ns) / 1e9,
                          self.counts)
        if _autograd_profiler._is_profiler_enabled:
            _BUFFER.append((self.name, self.start_ns, end_ns,
                            _OPEN.thread, self.id, self.parent,
                            self.counts))
        return False


def span(name: str, **counts):
    """A span of the program (see the module docstring): a flag check
    and nothing else unless ``VRT_PROFILE`` is set or a
    ``torch.profiler`` session records. ``with span(...) as s:
    s.set(route=...)`` adds counts from inside."""
    if _GLOBAL is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, counts, _GLOBAL)


def print_global_report() -> None:
    if _GLOBAL is not None and _GLOBAL.totals:
        _GLOBAL.print_report()


# ------------------------------------------------------------ exporters


#: the first Chrome-trace ``tid`` of the rows the spans are written on
SPAN_ROW_TID = 1 << 30


def _chrome_events(spans, base_ns: int) -> list:
    """``spans`` as Chrome trace events: one row (``tid``) a thread of
    spans, named ``vrt spans (thread <id>)``, times in us from
    ``base_ns`` (a torch.profiler trace's ``baseTimeNanoseconds``)."""
    rows: dict = {}
    pid = os.getpid()
    out = []
    for s in spans:
        if s.thread not in rows:
            rows[s.thread] = SPAN_ROW_TID + len(rows)
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": rows[s.thread],
                        "args": {"name": f"vrt spans (thread {s.thread})"}})
        out.append({"ph": "X", "cat": "vrt_span", "name": s.name,
                    "pid": pid, "tid": rows[s.thread],
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {"id": s.id, "parent": s.parent,
                             "thread": s.thread, **s.counts}})
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the region, CPU and (where there is
    a card) CUDA activity, written to ``log_dir`` as a Chrome trace
    (``trace.json``; open it in chrome://tracing or Perfetto), with the
    program's spans of the region on rows of their own, on the
    profiler's clock. The recorder's buffer is taken (emptied) here."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    spans = [s for s in take_spans() if s.start_ns >= t0]
    if not spans:
        return
    with open(path) as fh:
        trace = json.load(fh)
    trace["traceEvents"].extend(_chrome_events(
        spans, trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as fh:
        json.dump(trace, fh)


@contextlib.contextmanager
def timed(name: str, verbose: bool = True):
    """One-off span that prints its wall time, as the reference's inline
    prints."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if verbose:
            print(f"[prof] {name}: {time.perf_counter() - t0:.3f}s")
