"""The traced run: the benchmark's own spans around its calls into the
program, torch.profiler's record of the device (kernels, copies), and the
reductions the per-layer readers take from them.

A kernel's time is credited to a layer by name patterns: every file
under ``kernel_groups/<group>/`` holds regular expressions, one a line
(``#`` starts a comment), and a group is the union of its files. A
kernel that patterns of several groups match goes to the group whose
match is longest (the most specific), and one that none matches to
``other``; none is dropped.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from pathlib import Path

import torch

from harness.manifest import BENCH_DIR

SPAN_PREFIX = "bench."
#: gaps shorter than this are summed under one label, not looked up
_LABEL_MIN_NS = 10_000


def load_groups(bench_dir: Path = BENCH_DIR) -> dict:
    """{group: [compiled pattern, ...]} from ``kernel_groups/``."""
    groups = {}
    root = bench_dir / "kernel_groups"
    for gdir in sorted(p for p in root.iterdir() if p.is_dir()):
        pats = []
        for f in sorted(p for p in gdir.rglob("*") if p.is_file()):
            for line in f.read_text().splitlines():
                line = line.split("#", 1)[0].strip()
                if line:
                    pats.append(re.compile(line))
        groups[gdir.name] = pats
    return groups


def group_of(name: str, groups: dict) -> str:
    best, best_len = "other", 0
    for group in sorted(groups):
        for pat in groups[group]:
            m = pat.search(name)
            if m and len(m.group(0)) > best_len:
                best, best_len = group, len(m.group(0))
    return best


class Recorder:
    """Spans around the benchmark's calls, and the profiler when ``on``.
    Off, a span costs nothing and nothing is recorded."""

    def __init__(self, on: bool, device):
        self.on = on
        self.prof = None
        self.cuda = torch.device(device).type == "cuda"

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN_PREFIX + name)

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> "Records | None":
        if self.prof is None:
            return None
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        return Records(self.prof.profiler.kineto_results.events(),
                       load_groups())


def _times(e) -> tuple:
    s = e.start_ns()
    return s, s + e.duration_ns()


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip_len(merged, lo, hi) -> int:
    return sum(max(0, min(e, hi) - max(s, lo)) for s, e in merged)


class Records:
    """What a traced window recorded. Times are ns on the profiler's
    clock; the window runs from the first span's start to the last
    span's end."""

    def __init__(self, events, groups: dict):
        self.groups = groups
        self.kernels, self.copies, self.spans, cpu = [], [], [], []
        for e in events:
            name = e.name()
            s, t = _times(e)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name.startswith(SPAN_PREFIX):
                    continue  # the span's range on the device's timeline
                if name.startswith(("Memcpy", "Memset")):
                    self.copies.append((name, s, t))
                else:
                    self.kernels.append((name, s, t))
            elif name.startswith(SPAN_PREFIX):
                self.spans.append((name[len(SPAN_PREFIX):], s, t,
                                   e.start_thread_id()))
            else:
                cpu.append((name, s, t, e.start_thread_id()))
        self.spans.sort(key=lambda x: x[1])
        if self.spans:
            self.lo = self.spans[0][1]
            self.hi = max(x[2] for x in self.spans)
            thread = self.spans[0][3]
        else:
            self.lo = self.hi = 0
            thread = None
        self.cpu = sorted((c for c in cpu if c[3] == thread),
                          key=lambda x: x[1])
        self.busy = _union([(s, t) for _, s, t in self.kernels + self.copies])

    # ---- the window

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        return _clip_len(self.busy, self.lo, self.hi) / 1e9

    def busy_within_spans(self, name: str) -> list:
        """(span seconds, device-busy seconds inside it) for every span
        ``name``."""
        starts = [b[0] for b in self.busy]
        out = []
        for sname, s, t, _ in self.spans:
            if sname == name:
                i = max(bisect.bisect_right(starts, s) - 1, 0)
                j = bisect.bisect_left(starts, t)
                out.append(((t - s) / 1e9,
                            _clip_len(self.busy[i:j], s, t) / 1e9))
        return out

    # ---- device time by kind

    def group_seconds(self) -> dict:
        """{group: kernel seconds in the window}, ``other`` included."""
        out = defaultdict(float)
        memo = {}
        for name, s, t in self.kernels:
            g = memo.get(name)
            if g is None:
                g = memo[name] = group_of(name, self.groups)
            out[g] += (min(t, self.hi) - max(s, self.lo)) / 1e9 \
                if t > self.lo and s < self.hi else 0.0
        return dict(out)

    def copy_seconds(self, kind: str) -> float:
        """Seconds of the window's copies whose name holds ``kind``
        (``HtoD``, ``DtoH``)."""
        return sum((t - s) for n, s, t in self.copies
                   if kind in n and s >= self.lo and t <= self.hi) / 1e9

    # ---- breakdown

    def device_ops(self, top: int = 10) -> list:
        tot = defaultdict(int)
        for name, s, t in self.kernels + self.copies:
            if t > self.lo and s < self.hi:
                tot[name] += min(t, self.hi) - max(s, self.lo)
        ranked = sorted(tot.items(), key=lambda x: -x[1])[:top]
        return [[name[:160], ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """The window's idle time on the device, summed by what the host
        was doing halfway through each gap: the benchmark's span and the
        innermost recorded operation under it (``Python`` where none was
        running: the program's own Python code)."""
        gaps, prev = [], self.lo
        for s, e in self.busy:
            if e <= self.lo or s >= self.hi:
                continue
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if prev < self.hi:
            gaps.append((prev, self.hi))
        tot = defaultdict(int)
        short = f"gaps under {_LABEL_MIN_NS // 1000} us"
        for s, e in gaps:
            if e - s < _LABEL_MIN_NS:
                tot[short] += e - s
        long_gaps = [(s, e) for s, e in gaps if e - s >= _LABEL_MIN_NS]
        mids = [(s + e) // 2 for s, e in long_gaps]
        for (s, e), label in zip(long_gaps, self._labels(mids)):
            tot[label] += e - s
        ranked = sorted(tot.items(), key=lambda x: -x[1])[:top]
        return [[label, ns / 1e9] for label, ns in ranked]

    def _labels(self, points: list) -> list:
        """``span > op`` at each of the sorted ``points``: one sweep over
        the host's operations, which nest, with a stack of the open
        ones."""
        starts = [sp[1] for sp in self.spans]
        out, stack, i = [], [], 0
        for x in points:
            while i < len(self.cpu) and self.cpu[i][1] <= x:
                name, s, t, _ = self.cpu[i]
                while stack and stack[-1][1] <= s:
                    stack.pop()
                stack.append((name, t))
                i += 1
            while stack and stack[-1][1] <= x:
                stack.pop()
            j = bisect.bisect_right(starts, x) - 1
            span = (self.spans[j][0] if j >= 0 and self.spans[j][2] > x
                    else "between calls")
            out.append(f"{span} > {stack[-1][0] if stack else 'Python'}")
        return out
