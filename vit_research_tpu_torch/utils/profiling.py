"""Structured timing spans.

Port of the span part of vit_research_tpu/utils/profiling.py: a context
manager that aggregates wall time per span name into a report. Spans are
no-ops unless ``VRT_PROFILE`` is set; the CLI prints the report at exit.
Device time is read with ``torch.profiler`` (``chip_smoke.py
--profile``), not here.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


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
