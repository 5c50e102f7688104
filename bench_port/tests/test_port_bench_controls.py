"""On the card: the program's readings stay within each cell's limits
and the control's (the reference computed in TF32, the precision below
the configuration's) do not, on three seeds, at sizes a test run holds:
the embed pools cut to one engine batch, the store at its full 200,000
rows with two compared batches. PERF.md gives the full-size readings."""

import pytest

from harness import manifest

CUT = {"embed-b16-f32": ({"pool_frames": 256}, 2),
       "embed-b32-432-f32": ({"pool_frames": 256}, 2),
       "search-200k-f32": ({"sample_within": 2, "sample_batches": 2}, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUT))
def test_control_fails_and_program_passes(cuda, name):
    import control
    from harness import runner

    runner.prepare()
    traffic_over, calls = CUT[name]
    seeds = [3_100_000_001, 3_100_000_002, 3_100_000_003]
    limits = manifest.workload(name)["limits"]
    for row in control.readings(name, seeds, set(seeds), calls,
                                traffic_over=traffic_over):
        prog, ctrl = row["program"], row["control"]
        assert all(prog[k] <= v for k, v in limits.items()), row
        assert any(ctrl[k] > v for k, v in limits.items()), row
