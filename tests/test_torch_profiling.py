"""utils/profiling.py's spans: off, aggregated under ``VRT_PROFILE``, and
recorded on the profiler's clock while a ``torch.profiler`` session
runs; the engine's spans (parallel/embed.py) and the written trace.

This file imports no JAX, so it also runs on the card (the ``cuda`` test
at the end):

    python -m pytest --noconftest -q tests/test_torch_profiling.py
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from vit_research_tpu_torch.data.preprocess import PreprocessSpec
from vit_research_tpu_torch.models.vit import init_vit
from vit_research_tpu_torch.parallel import embed
from vit_research_tpu_torch.utils import profiling
from vit_research_tpu_torch.utils.configs import ViTConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ViTConfig(image_size=(32, 32), patch_size=8, hidden_size=32,
                 num_layers=2, num_heads=2, mlp_dim=64)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """No report and an empty buffer, whatever the environment."""
    monkeypatch.setattr(profiling, "_GLOBAL", None)
    profiling.take_spans()
    yield
    profiling.take_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _events(prof) -> list:
    return list(prof.profiler.kineto_results.events())


def _engine(device="cpu", batch_size=4):
    return embed.EmbeddingEngine(init_vit(TINY, seed=0, device="cpu"),
                                 PreprocessSpec(size=(32, 32)),
                                 device=device, batch_size=batch_size)


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 32, 32, 3),
                                                dtype=np.uint8)


def test_off_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    s = profiling.span("engine.stage", bytes=1)
    with s as inner:
        inner.set(route="numpy")
    assert s is profiling._NULL
    _engine().embed_batch(_frames(5))
    assert profiling.take_spans() == [] and profiling.dropped_spans() == 0


def test_spans_carry_ids_parents_threads_and_counts():
    with _cpu_profile():
        with profiling.span("a.outer", frames=3) as outer:
            with profiling.span("a.inner", bytes=5):
                pass
            outer.set(route="device")
        t = threading.Thread(target=lambda: profiling.span("a.other")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    got = {s.name: s for s in profiling.take_spans()}
    assert set(got) == {"a.outer", "a.inner", "a.other"}
    outer, inner, other = got["a.outer"], got["a.inner"], got["a.other"]
    assert outer.parent is None and inner.parent == outer.id
    assert other.parent is None and len({outer.id, inner.id, other.id}) == 3
    assert outer.counts == {"frames": 3, "route": "device"}
    assert inner.counts == {"bytes": 5}
    assert outer.thread == inner.thread == threading.get_native_id()
    assert other.thread != outer.thread
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_spans_share_the_profilers_clock():
    """A span inside a ``record_function`` lies within its kineto
    interval, and a span around a matmul encloses its ``aten::mm``."""
    a, b = torch.ones(256, 256), torch.ones(256, 256)
    with _cpu_profile() as prof:
        with record_function("user.outer"):
            with profiling.span("t.inner"):
                a @ b
        with profiling.span("t.outer"):
            a @ b
    spans = {s.name: s for s in profiling.take_spans()}
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in _events(prof)]
    (_, rs, re_), = [e for e in evs if e[0] == "user.outer"]
    inner, outer = spans["t.inner"], spans["t.outer"]
    assert rs <= inner.start_ns <= inner.end_ns <= re_
    mms = [e for e in evs if e[0] == "aten::mm"]
    assert len(mms) == 2
    _, ms, me = max(mms, key=lambda e: e[1])
    assert outer.start_ns <= ms <= me <= outer.end_ns


def test_engine_records_each_batch():
    eng = _engine()
    with _cpu_profile():
        eng.embed_batch(_frames(10))
    spans = profiling.take_spans()
    (top,) = [s for s in spans if s.name == "engine.embed"]
    assert top.counts == {"frames": 10} and top.parent is None
    disp = [s for s in spans if s.name == "engine.dispatch"]
    back = [s for s in spans if s.name == "engine.readback"]
    assert [s.counts["frames"] for s in disp] == [4, 4, 2]
    batches = [s.counts["batch"] for s in disp]
    assert batches == [s.counts["batch"] for s in back]
    assert batches == list(range(batches[0], batches[0] + 3))
    assert all(s.parent == top.id for s in disp + back)
    # f32 (frames, 32) outputs; the ragged tail runs at its true size
    assert [s.counts["bytes"] for s in back] == [4 * 32 * 4] * 2 + [
        2 * 32 * 4]
    # batch i is read back only after batch i+1 was dispatched
    for i in range(2):
        assert back[i].start_ns >= disp[i + 1].end_ns
    # no pinned staging on the CPU
    assert not [s for s in spans if s.name in ("engine.stage", "engine.h2d")]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_embed_paths_decodes_on_the_producers_thread(tmp_path, prefetch):
    from vit_research_tpu_torch.data import synthetic

    paths = synthetic.write_video_frames(str(tmp_path), 1, [("left", 6)],
                                         size=(32, 32))
    eng = _engine()
    with _cpu_profile():
        out = eng.embed_paths(paths, num_workers=1, prefetch=prefetch)
    assert out.shape == (6, 32)
    spans = profiling.take_spans()
    (top,) = [s for s in spans if s.name == "engine.embed"]
    decode = [s for s in spans if s.name == "engine.decode"]
    waits = [s for s in spans if s.name == "engine.queue_wait"]
    assert [s.counts["frames"] for s in decode] == [4, 2]
    if prefetch:
        assert {s.thread for s in decode} != {top.thread}
        assert all(s.parent is None for s in decode)
        assert [s.counts.get("frames") for s in waits] == [4, 2, None]
        assert all(s.parent == top.id for s in waits)
    else:
        assert {s.thread for s in decode} == {top.thread} and not waits


def test_buffer_keeps_its_bound_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_BUFFER", profiling._Buffer(3))
    with _cpu_profile():
        for i in range(5):
            with profiling.span("b.x", i=i):
                pass
    assert len(profiling.recorded_spans()) == 3
    assert profiling.dropped_spans() == 2
    assert [s.counts["i"] for s in profiling.take_spans()] == [0, 1, 2]
    assert profiling.dropped_spans() == 0 and profiling.recorded_spans() == []


def test_aggregation_is_exact_across_threads(monkeypatch):
    prof = profiling.Profiler()
    monkeypatch.setattr(profiling, "_GLOBAL", prof)
    n = 2000

    def work():
        for _ in range(n):
            with profiling.span("agg.x", bytes=3, route="numpy"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    row = prof.report()["agg.x"]
    assert row["count"] == 4 * n and row["sums"] == {"bytes": 12 * n}
    assert profiling.take_spans() == []  # aggregated, not recorded


def test_vrt_profile_prints_the_report():
    code = ("from vit_research_tpu_torch.utils import profiling as p\n"
            "for _ in range(3):\n"
            "    with p.span('cli.step', frames=2):\n"
            "        pass\n"
            "p.print_global_report()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "VRT_PROFILE": "1"})
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[prof] cli.step: ") and " n=3 " in line
    assert line.endswith(" frames=6")


def test_device_trace_writes_the_spans(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        with profiling.span("t.matmul", rows=64):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    (sp,) = [e for e in events if e.get("name") == "t.matmul"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert sp["tid"] >= profiling.SPAN_ROW_TID and sp["args"]["rows"] == 64
    assert sp["ts"] <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"]
    names = [e for e in events if e.get("ph") == "M"
             and e.get("tid") == sp["tid"]]
    assert names and names[0]["args"]["name"].startswith("vrt spans")
    assert profiling.recorded_spans() == []  # taken by the trace


@pytest.mark.cuda
def test_engine_spans_on_the_card():
    """On the card: the pinned staging and the copy have their spans, and
    the device trace's kernels lie within the spans of the batches that
    launched and waited for them (the spans and the device trace share a
    clock): none starts before the first dispatch span or ends after the
    last readback span, and batch i has a kernel that starts after its
    dispatch span starts and before its readback span ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's pinned path runs only "
                    "there")
    eng = _engine(device="cuda")
    eng.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.embed_batch(_frames(12))
        torch.cuda.synchronize()
    spans = profiling.take_spans()
    by = {name: [s for s in spans if s.name == name] for name in (
        "engine.stage", "engine.h2d", "engine.dispatch", "engine.readback")}
    assert [len(v) for v in by.values()] == [3, 3, 3, 3]
    assert [s.counts["bytes"] for s in by["engine.stage"]] == [
        4 * 32 * 32 * 3] * 3
    assert [s.counts["batch"] for s in by["engine.h2d"]] == [
        s.counts["batch"] for s in by["engine.dispatch"]]
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in _events(prof) if e.device_type() == cuda
                     and not e.name().startswith(("Memcpy", "Memset")))
    disp, back = by["engine.dispatch"], by["engine.readback"]
    assert kernels and disp[0].start_ns <= kernels[0][0]
    assert kernels[-1][1] <= back[-1].end_ns
    for d, b in zip(disp, back):
        first = next(s for s, _ in kernels if s >= d.start_ns)
        assert first <= b.end_ns
