"""The program's own spans in a traced window, for the readers whose
``source`` is ``program_span``.

The port records a span (``vit_research_tpu_torch/utils/profiling.py``:
name, start and end ns, thread, id, parent, counts) while a
``torch.profiler`` session runs, on the clock of the profiler's CPU
events, so the spans lie on one axis with the window's kernels and
copies. :func:`spans` takes them from the program once a traced run and
keeps those inside the window ``[rec.lo, rec.hi]`` that lie below a
top-level ``engine.embed`` or ``store.query`` span (the calls the cells
time). A program that records no spans gives none, and the readers then
return None.
"""

from __future__ import annotations

import bisect
import weakref

#: the top-level spans of the calls the cells time
ROOTS = ("engine.embed", "store.query")

_TAKEN: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _take() -> list:
    """Every span the program has recorded, emptying its buffer; none
    where the program has no recorder."""
    from vit_research_tpu_torch.utils import profiling

    take = getattr(profiling, "take_spans", None)
    return list(take()) if take is not None else []


def below_roots(spans: list) -> list:
    """The spans of ``spans`` that have a span named in :data:`ROOTS`
    among their ancestors."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        up = by_id.get(s.parent)
        while up is not None and up.name not in ROOTS:
            up = by_id.get(up.parent)
        if up is not None:
            out.append(s)
    return out


def spans(rec) -> list:
    """The window's program spans below the timed calls (taken from the
    program on the first call for ``rec``)."""
    if rec not in _TAKEN:
        window = [s for s in _take()
                  if s.start_ns >= rec.lo and s.end_ns <= rec.hi]
        _TAKEN[rec] = below_roots(window)
    return _TAKEN[rec]


def named(rec, name: str) -> list:
    return [s for s in spans(rec) if s.name == name]


def host_ms(rec, name: str) -> float | None:
    """The mean host ms of the window's spans ``name``; None where there
    is none."""
    got = named(rec, name)
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / len(got) / 1e6


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_s(rec, intervals) -> float:
    """Seconds of the union of ``intervals`` (ns pairs) in which no
    kernel and no copy ran on the device (``rec.busy``)."""
    starts = [b[0] for b in rec.busy]
    idle = 0
    for s, e in _merge(intervals):
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        j = bisect.bisect_left(starts, e)
        busy = sum(max(0, min(be, e) - max(bs, s))
                   for bs, be in rec.busy[i:j])
        idle += (e - s) - busy
    return idle / 1e9


def idle_by_name(rec) -> dict:
    """{span name: device-idle seconds inside the window's spans of that
    name}, and under ``"all"`` the idle seconds inside their union."""
    out = {}
    for s in spans(rec):
        out.setdefault(s.name, []).append((s.start_ns, s.end_ns))
    table = {name: idle_s(rec, iv) for name, iv in out.items()}
    table["all"] = idle_s(rec, [iv for ivs in out.values() for iv in ivs])
    return table
