"""Readings for the limits of ``correct``: the program's numbers and the
control's, over many seeds, in one process.

    python bench_port/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--calls N]

For each seed it sets the cell up as a run does, makes ``--calls`` calls
of the window's kind (the calls a run compares), frees the program's
state and compares as a run does: the program's reading. On the seeds of
``--control-seeds`` it also puts the reference, computed in TF32, in the
program's place and holds it to the same comparison: the control's
reading. One JSON line a seed, then the largest program reading and the
smallest control reading of each number. The benchmark's own runs never
run this.
"""

import argparse
import gc
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import torch  # noqa: E402

from harness import manifest, runner  # noqa: E402


def readings(name: str, seeds, control_seeds, calls: int, *,
             device="cuda", cfg_over=None, traffic_over=None):
    """Yields {"seed", "program", "control"?} for every seed."""
    man = manifest.load()
    cell = manifest.cell(man, name)
    cfg = {**manifest.config(man, cell["config"]), **(cfg_over or {})}
    t = {**manifest.workload(name), **(traffic_over or {})}
    entry_mod = importlib.import_module(f"harness.entries.{t['entry']}")
    for seed in seeds:
        entry = entry_mod.Entry(cfg, t, seed, device)
        for _ in range(calls):
            entry.call()
        entry.release()
        row = {"seed": seed, "program": entry.checks()}
        if seed in control_seeds:
            row["control"] = entry.control()
        del entry
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        yield row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--calls", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 3
    runner.prepare()
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    worst, least = {}, {}
    t0 = time.perf_counter()
    for row in readings(args.workload, seeds, control, args.calls):
        print(json.dumps(row), flush=True)
        for k, v in row["program"].items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in row.get("control", {}).items():
            least[k] = min(least.get(k, v), v)
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "program_max": worst, "control_min": least,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
