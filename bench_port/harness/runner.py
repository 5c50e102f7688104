"""One run of one cell: set-up, the measured window, the trace, the
comparison with the reference, and the result line.

:func:`main` is the command (``bench_port/run.py``): it refuses to run
without the cards the cell asks for, keeps the kernel caches inside the
checkout, and checks that no module of JAX or of the JAX package was
loaded. :func:`run` is the rest of a run, on any device, which the
benchmark's own tests drive on the CPU at a tiny size.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

import torch

from harness import compare, cost, manifest, trace

#: top-level modules that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "vit_research_tpu")
CACHE_DIR = manifest.ROOT / ".bench_port_cache"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _reader(name: str):
    path = manifest.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(name: str, seed: int, seconds: float, traced: bool, *,
        device="cuda", t0: float | None = None, cfg_over: dict | None = None,
        traffic_over: dict | None = None, after_setup=None) -> dict:
    """One run of cell ``name``; returns the result's fields.
    ``cfg_over`` / ``traffic_over`` replace entries of the configuration
    and workload files and ``after_setup(entry)`` is called once set-up is
    done (the tests' tiny sizes and planted faults)."""
    t0 = time.perf_counter() if t0 is None else t0
    man = manifest.load()
    cell = manifest.cell(man, name)
    cfg = {**manifest.config(man, cell["config"]), **(cfg_over or {})}
    t = {**manifest.workload(name), **(traffic_over or {})}
    entry_mod = importlib.import_module(f"harness.entries.{t['entry']}")
    rec = trace.Recorder(traced, device)
    t_ctx = time.perf_counter()
    torch.zeros(1, device=device)  # the CUDA context, timed on its own
    phases = {"start": t_ctx - t0, "context": time.perf_counter() - t_ctx}

    entry = entry_mod.Entry(cfg, t, seed, device)
    phases.update(entry.setup_phases)
    if after_setup is not None:
        after_setup(entry)
    _sync(device)
    setup_s = time.perf_counter() - t0

    rec.start()
    calls, attempted, failed = [], 0, 0
    start = time.perf_counter()
    while True:
        ts = time.perf_counter()
        with rec.span(entry.span):
            units, bad = entry.call()
        te = time.perf_counter()
        calls.append((ts, te, units))
        attempted += units
        failed += bad
        if te - start >= seconds:
            break
    _sync(device)
    t_trace = time.perf_counter()
    records = rec.stop()
    trace_s = time.perf_counter() - t_trace
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    e2e = {**entry.end_to_end(calls, start), "setup_s": setup_s}
    info = entry.run_info(calls)
    entry.release()
    checks = compare.verdict(entry.checks(), t["limits"])

    if traced:
        wanted = manifest.reported(man["per_layer"], name)
        run_facts = {"cell": name, "config": cfg, "traffic": t,
                     "info": info, "units": attempted,
                     "window_s": calls[-1][1] - start}
        values = {m["name"]: _reader(m["name"])(records, run_facts)
                  for m in wanted}
    else:
        wanted = manifest.reported(man["end_to_end"], name)
        values = {m["name"]: e2e[m["name"]] for m in wanted}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values[m["name"]] is not None}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0 and compare.passes(checks),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if records is not None:
        out["trace_read_s"] = trace_s
        dev.update(busy_s=records.busy_s, window_s=records.window_s)
        out["breakdown"] = {"device_ops": records.device_ops(),
                            "idle_gaps": records.idle_gaps()}
        out["kernel_groups"] = records.group_seconds()
    out["setup_phases"] = phases
    out["launches"] = info.get("launches", {})
    out["checks"] = checks
    return out


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({e})"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def prepare() -> None:
    """Kernel caches inside the checkout, at fixed paths (the program's
    own nvcc build lives in vit_research_tpu_torch/_build/); no JAX or
    TensorFlow behind a library; f32 products in f32, as configured."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None, t0: float | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    chips = manifest.cell(manifest.load(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} card(s): no result",
              file=sys.stderr)
        return 3
    prepare()
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              device="cuda", t0=t0)
    card = power_limit()
    bad = loaded_forbidden()
    if bad:
        print(f"error: modules loaded in the run: {', '.join(bad)}: no "
              "result", file=sys.stderr)
        return 4
    for name, value in out["metrics"].items():
        if cost.over_peak(name, value["value"]):
            print(f"warning: {name} reads {value['value']} %, over 100%: "
                  "operations or bytes counted too high, or time left out",
                  file=sys.stderr)
    print(f"card: {card}; peaks {cost.PEAK_FLOPS} FLOP/s, "
          f"{cost.HBM_BYTES_PER_S} B/s at 700 W; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr)
    print(f"set-up phases (s): {json.dumps(out['setup_phases'])}",
          file=sys.stderr)
    if out["launches"]:
        print(f"launches in the window: {json.dumps(out['launches'])}",
              file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
