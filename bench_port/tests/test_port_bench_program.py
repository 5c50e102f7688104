"""The readers of the program's own spans (harness/program.py and the
``program_span`` metrics) on hand-made spans and records, and a traced
CPU run of each cell, which records the spans and reads no metric."""

from collections import namedtuple

import pytest
import torch

from conftest import TINY
from harness import manifest, program, runner, trace

Span = namedtuple("Span", "name start_ns end_ns thread id parent counts")
US = 1000

PROGRAM_METRICS = [m["name"] for m in manifest.load()["per_layer"]
                   if m["source"] == "program_span"]


class _Ev:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d = name, start, dur
        self._dev = (torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def start_thread_id(self):
        return 1


def _records(bench_span):
    """A 1 ms window; the device busy 0-100 and 400-800 us."""
    ev = [_Ev("bench." + bench_span, 0, 1000 * US, False),
          _Ev("gemm", 0, 100 * US, True),
          _Ev("Memcpy HtoD (Pinned -> Device)", 400 * US, 50 * US, True),
          _Ev("gemm", 450 * US, 350 * US, True)]
    return trace.Records(ev, {})


def _spans(root, stage, back):
    """Spans under ``root`` (id 1), and spans the readers must leave out:
    one with no timed call above it, one past the window."""
    return [Span(root, 0, 1000 * US, 7, 1, None, {}),
            Span(stage, 100 * US, 400 * US, 7, 2, 1, {"batch": 0}),
            Span(stage, 450 * US, 500 * US, 7, 3, 1, {"batch": 1}),
            Span(back, 800 * US, 1000 * US, 7, 4, 1, {"batch": 0}),
            Span(stage, 100 * US, 200 * US, 8, 5, None, {}),
            Span(stage, 900 * US, 1200 * US, 7, 6, 1, {})]


@pytest.fixture
def given(monkeypatch):
    """Hand ``spans`` to the readers in place of the program's."""
    taken = []

    def give(spans):
        def take():
            taken.append(1)
            return list(spans)
        monkeypatch.setattr(program, "_take", take)
        return taken
    return give


def _read(metric, rec):
    return runner._reader(metric)(rec, {"info": {"batches": 2}, "units": 8,
                                        "window_s": 1e-3})


def test_embed_readers_on_hand_made_spans(given):
    taken = given(_spans("engine.embed", "engine.stage", "engine.readback"))
    rec = _records("embed_batch")
    # stage spans of 300 and 50 us; 300 us of idle device inside them
    assert _read("stage_ms.embed", rec) == pytest.approx(0.175)
    assert _read("stage_idle.embed", rec) == pytest.approx(30.0)
    assert _read("readback_ms.embed", rec) == pytest.approx(0.2)
    assert _read("readback_ms.search", rec) is None
    assert len(taken) == 1  # taken from the program once a run


def test_search_readers_on_hand_made_spans(given):
    given(_spans("store.query", "store.assemble", "store.readback"))
    rec = _records("query")
    assert _read("assemble_ms.search", rec) == pytest.approx(0.175)
    assert _read("readback_ms.search", rec) == pytest.approx(0.2)
    assert _read("stage_ms.embed", rec) is None


def test_idle_inside_spans():
    rec = _records("embed_batch")
    # 50-150: 50 idle; 300-500 and 450-600 merge into 300-600: 100 idle;
    # 850-950: all idle
    got = program.idle_s(rec, [(50 * US, 150 * US), (300 * US, 500 * US),
                               (450 * US, 600 * US), (850 * US, 950 * US)])
    assert got == pytest.approx(250e-6)
    assert program.idle_s(rec, [(0, 100 * US)]) == 0.0


def test_idle_by_name(given):
    given(_spans("store.query", "store.assemble", "store.readback"))
    got = program.idle_by_name(_records("query"))
    assert got == pytest.approx({"store.assemble": 300e-6,
                                 "store.readback": 200e-6, "all": 500e-6})


@pytest.mark.parametrize("metric", PROGRAM_METRICS)
def test_a_program_without_a_recorder_reads_nothing(monkeypatch, metric):
    """A program without the recorder (no ``take_spans``, as before the
    spans existed): every reader of its spans returns None, and none
    raises."""
    from vit_research_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "take_spans")
    assert program._take() == []
    assert _read(metric, _records("query")) is None


@pytest.mark.parametrize("name", sorted(TINY))
def test_traced_cpu_run_records_spans_and_reads_none(name):
    from vit_research_tpu_torch.utils import profiling

    profiling.take_spans()
    cfg, t = TINY[name]
    out = runner.run(name, 5, 0.3, True, device="cpu", cfg_over=cfg,
                     traffic_over=t)
    assert out["correct"] and out["metrics"] == {}
    names = {s.name for s in program.below_roots(profiling.take_spans())}
    if name.startswith("embed"):
        assert {"engine.dispatch", "engine.readback"} <= names
    else:
        assert {"store.topk", "store.readback", "store.assemble"} <= names
