"""``BENCHMARK.json`` and the files it names, each found by its name.

A configuration is ``configs/<config>.json`` (the ``file`` of its entry),
a cell's traffic is ``workloads/<cell>.json``, a per-layer metric is
``metrics/<metric>.py`` and a kernel group is every file under
``kernel_groups/<group>/``. Adding one of them adds a file and edits none.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

#: a name: a letter, digit or ``_`` first, then at most 63 more of those,
#: ``.`` and ``-``
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
#: a unit: 1 to 16 letters, digits, ``_``, ``/``, ``%``, ``.`` and ``-``
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def cell(man: dict, name: str) -> dict:
    """The ``workloads`` entry called ``name``."""
    for entry in man["workloads"]:
        if entry["name"] == name:
            return entry
    known = ", ".join(e["name"] for e in man["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")


def config(man: dict, name: str) -> dict:
    """The configuration file of the ``configs`` entry called ``name``."""
    for entry in man["configs"]:
        if entry["name"] == name:
            with open(ROOT / entry["file"]) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    """The traffic file of the cell ``name``: its entry point, its
    parameters and the limits of its comparison."""
    with open(BENCH_DIR / "workloads" / f"{name}.json") as fh:
        return json.load(fh)


def reported(metrics: list, cell_name: str) -> list:
    """The entries of ``metrics`` that the cell reports: those without a
    ``workloads`` key, and those whose ``workloads`` names it."""
    return [m for m in metrics
            if "workloads" not in m or cell_name in m["workloads"]]


def problems(man: dict) -> list:
    """What in ``man`` breaks the naming rules: names, units, ``better``,
    ``source``, ``moves``, and the cells a metric names."""
    out = []
    metrics = man["end_to_end"] + man["per_layer"]
    cells = {w["name"] for w in man["workloads"]}
    configs = {c["name"] for c in man["configs"]}
    e2e = {m["name"] for m in man["end_to_end"]}
    for kind, names in (("metric", [m["name"] for m in metrics]),
                        ("cell", [w["name"] for w in man["workloads"]]),
                        ("config", [c["name"] for c in man["configs"]])):
        if len(set(names)) != len(names):
            out.append(f"two {kind}s share a name")
        out += [f"{kind} name {n!r}" for n in names
                if not NAME_RE.fullmatch(n)]
    for m in metrics:
        if not UNIT_RE.fullmatch(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"better of {m['name']}")
        if m["source"] not in SOURCES:
            out.append(f"source of {m['name']}")
        out += [f"{m['name']} names cell {c!r}"
                for c in m.get("workloads", ()) if c not in cells]
    for m in man["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"end-to-end {m['name']} takes its number from "
                       f"{m['source']}")
    for m in man["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves {m['moves']!r}")
    for w in man["workloads"]:
        if w["config"] not in configs:
            out.append(f"cell {w['name']} names config {w['config']!r}")
        for key in ("config", "traffic"):
            if not NAME_RE.fullmatch(w[key]):
                out.append(f"{key} {w[key]!r} of {w['name']}")
    for c in man["configs"]:
        out += [f"reduced key {k!r} of {c['name']}" for k in c["reduced"]
                if not NAME_RE.fullmatch(k)]
    return out
