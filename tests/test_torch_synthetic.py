"""data/synthetic.py and utils/profiling.py's ``timed``, ``device_trace``
and ``Profiler.reset`` against the JAX package: the same pixels, files,
clip directories, labels and templates for the same arguments, and the
same printed spans."""

import json
import os

import numpy as np

from vit_research_tpu.data import synthetic as jax_synthetic
from vit_research_tpu.utils import profiling as jax_profiling
from vit_research_tpu_torch.data import synthetic
from vit_research_tpu_torch.utils import profiling


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_synth_frame_same_pixels():
    for side in ("left", "right", "none"):
        for size in ((48, 64), (32, 32), (7, 9)):
            got = synthetic.synth_frame(3, 17, side, size)
            want = jax_synthetic.synth_frame(3, 17, side, size)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            rng_a, rng_b = (np.random.default_rng(5) for _ in range(2))
            np.testing.assert_array_equal(
                synthetic.synth_frame(1, 2, side, size, rng_a),
                jax_synthetic.synth_frame(1, 2, side, size, rng_b))


def test_video_frames_and_clips_same_files(tmp_path):
    segs = [("none", 3), ("left", 5), ("right", 4)]
    got = synthetic.write_video_frames(str(tmp_path / "p"), 2, segs,
                                       size=(24, 40))
    want = jax_synthetic.write_video_frames(str(tmp_path / "j"), 2, segs,
                                            size=(24, 40))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    clips = [(1, "left", 4, 3), (2, "right", 10, 2)]
    got = synthetic.write_clips(str(tmp_path / "pc"), 2, clips)
    want = jax_synthetic.write_clips(str(tmp_path / "jc"), 2, clips)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert _files(tmp_path / "pc") == _files(tmp_path / "jc")


def test_mini_dataset_and_manual_intervals_match(tmp_path):
    got = synthetic.make_mini_dataset(str(tmp_path / "p"), vids=(1, 2),
                                      clips_per_vid=3, frames_per_clip=4,
                                      size=(16, 16))
    want = jax_synthetic.make_mini_dataset(str(tmp_path / "j"), vids=(1, 2),
                                           clips_per_vid=3,
                                           frames_per_clip=4, size=(16, 16))

    def rel(x):
        return json.loads(json.dumps(x).replace(str(tmp_path / "p"), "R")
                          .replace(str(tmp_path / "j"), "R"))

    assert rel(list(got)) == rel(list(want))
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    segs = ((("left", 30), ("none", 10), ("right", 30)),
            (("none", 2), ("left", 5)))
    a = synthetic.make_manual_intervals(vids=(1, 4), segs=segs)
    b = jax_synthetic.make_manual_intervals(vids=(1, 4), segs=segs)
    assert dict(a.intervals) == dict(b.intervals)
    a.to_csv(str(tmp_path / "a.csv"))
    b.to_csv(str(tmp_path / "b.csv"))
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()


def test_timed_prints_as_the_reference(capsys):
    for mod in (profiling, jax_profiling):
        with mod.timed("load"):
            pass
        with mod.timed("quiet", verbose=False):
            pass
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for line in lines:
        assert line.startswith("[prof] load: ") and line.endswith("s")
        float(line[len("[prof] load: "):-1])


def test_profiler_reset():
    p = profiling.Profiler()
    with p.span("a"):
        pass
    assert p.report()["a"]["count"] == 1
    p.reset()
    assert p.report() == {}


def test_device_trace_writes_a_trace(tmp_path):
    """device_trace on the CPU: a torch.profiler Chrome trace of the
    region (CPU activity; CUDA's where there is a card) in log_dir."""
    import torch

    log_dir = str(tmp_path / "trace")
    with profiling.device_trace(log_dir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
