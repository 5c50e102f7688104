"""Structured timing spans and a device trace.

Port of vit_research_tpu/utils/profiling.py: a context manager that
aggregates wall time per span name into a report (no-ops unless
``VRT_PROFILE`` is set; the CLI prints the report at exit), a one-off
:func:`timed` span that prints, and :func:`device_trace`, which records
a ``torch.profiler`` trace of a region (the reference's
``jax.profiler.trace``) and writes it to a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class Profiler:
    """Aggregating span timer: ``with prof.span('embed'): ...``."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name]
                                 / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def print_report(self) -> None:
        for name, row in self.report().items():
            print(f"[prof] {name}: total={row['total_s']}s "
                  f"n={row['count']} mean={row['mean_ms']}ms")

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


_GLOBAL: Profiler | None = None


def active() -> Profiler | None:
    """The process-wide profiler, created on first use when the
    ``VRT_PROFILE`` env var is set (else None)."""
    global _GLOBAL
    if _GLOBAL is None and os.environ.get("VRT_PROFILE"):
        _GLOBAL = Profiler()
    return _GLOBAL


@contextlib.contextmanager
def span(name: str):
    """No-op unless VRT_PROFILE is set."""
    p = active()
    if p is None:
        yield
    else:
        with p.span(name):
            yield


def print_global_report() -> None:
    if _GLOBAL is not None and _GLOBAL.totals:
        _GLOBAL.print_report()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the region, CPU and (where there is
    a card) CUDA activity, written to ``log_dir`` as a Chrome trace
    (``trace.json``; open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
