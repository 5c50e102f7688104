"""Evaluation and observability commands: smoke, metrics, eval-clips and
score-events.

Port of vit_research_tpu/cli/eval_cmds.py with the reference's arguments
and output lines plus ``--device`` (smoke, eval-clips).
"""

from __future__ import annotations

import json
import os

from vit_research_tpu_torch.cli import common


def cmd_smoke(args):
    """One seeded frame through the random-init P=32 432x768 backbone;
    prints every endpoint's shape."""
    from vit_research_tpu_torch.evaluate.smoke import smoke_test

    smoke_test(device=args.device)


def cmd_metrics(args):
    """A run dir's metrics.jsonl curve (or ``--csv`` of it), or one line a
    run for a checkpoint root."""
    from vit_research_tpu_torch.utils.metrics import read_metrics

    ledger = os.path.join(args.dir, "metrics.jsonl")
    if os.path.exists(ledger):  # one run: print the curve
        rows = read_metrics(ledger)
        if args.csv:
            _metrics_to_csv(rows, args.csv)
            print(f"wrote {len(rows)} rows to {args.csv}")
            return
        for row in rows:
            items = " ".join(f"{k}={row[k]:.4f}" for k in sorted(row)
                             if k not in ("step", "ts"))
            print(f"epoch {row['step']}: {items}")
        return
    if args.csv:
        raise SystemExit(
            f"--csv needs a single run dir (no metrics.jsonl in "
            f"{args.dir}); pick one run under it")
    found = False
    for name in sorted(os.listdir(args.dir)) if os.path.isdir(args.dir) \
            else []:
        rows = read_metrics(os.path.join(args.dir, name, "metrics.jsonl"))
        if not rows:
            continue
        found = True
        accs = [r["val_acc"] for r in rows if "val_acc" in r]
        best = f"best val_acc {max(accs):.4f}" if accs else "no val_acc"
        print(f"{name}: {len(rows)} epochs, {best}")
    if not found:
        raise SystemExit(f"no metrics.jsonl ledgers under {args.dir}")


def _metrics_to_csv(rows, path):
    import csv

    keys = ["step"] + sorted({k for r in rows for k in r}
                             - {"step", "ts"})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
        w.writeheader()
        for row in rows:
            w.writerow(row)


def cmd_eval_clips(args):
    """Per-clip logit sequences and event localization of a stage-2 run
    over a frame store's chunks of ``--vids``, with live retrieval from
    ``--collection``; writes logit_sequences.json and .csv to ``--out``."""
    from vit_research_tpu_torch.db.frame_store import (FrameStore,
                                                       load_chunk_index)
    from vit_research_tpu_torch.device import resolve_device
    from vit_research_tpu_torch.evaluate.clip_sequences import (
        infer_clip_sequences, save_results)

    resolve_device(args.device)
    store = FrameStore(args.store).open()
    idx = load_chunk_index(args.store)
    chunks = common._chunks_from_index(store, idx, vids=args.vids)
    if not chunks:
        print("no chunks for the requested vids")
        return
    _, encode_chunk = common._stage1_encode(store, idx, args.ckpt,
                                            args.stage1_run_id, args.device)
    head_apply = common._stage2_head(
        store.dim, args.ckpt, args.stage2_run_id, k_sim=args.k_sim,
        k_contrast=args.k_contrast, k_temporal=args.k_temporal,
        device=args.device)
    col = common._open_collection(args.db, args.collection, args.device)
    rows = infer_clip_sequences(
        chunks, head_apply, encode_chunk, col, k_sim=args.k_sim,
        k_contrast=args.k_contrast, k_temporal=args.k_temporal,
        future_step=args.future_step, zeros_query=args.zeros_query,
        batch_size=16)
    save_results(rows, os.path.join(args.out, "logit_sequences.json"),
                 os.path.join(args.out, "logit_sequences.csv"))
    print(f"wrote {len(rows)} clip rows to {args.out}")


def cmd_score_events(args):
    """Score eval rows' top-k event localization (hit@k, centre error)
    against an event template, or the rows' own chunk status ids."""
    from vit_research_tpu_torch.data.labels import load_event_template
    from vit_research_tpu_torch.evaluate.event_scoring import (
        score_event_localization, truth_events_by_clip)

    with open(args.results) as fh:
        if args.results.endswith(".jsonl"):
            # segment --follow --score-events appends one row a clip
            rows = [json.loads(line) for line in fh if line.strip()]
        else:
            rows = json.load(fh)
    truth = None
    if args.events:
        # load_event_template reads a missing file as {}: here a typo'd
        # path must not pass for an empty template
        if not os.path.exists(args.events):
            raise SystemExit(f"{args.events}: no such file")
        try:
            truth = truth_events_by_clip(load_event_template(args.events))
        except ValueError as e:
            raise SystemExit(f"{args.events}: {e}")
        if not truth:
            raise SystemExit(f"{args.events}: no event_make/event_miss "
                             "intervals found")
    try:
        report = score_event_localization(
            rows, truth, ks=[int(x) for x in args.ks.split(",") if x])
    except ValueError as e:
        raise SystemExit(str(e))

    print(f"scored {report['clips_scored']} clips "
          f"(ground truth: {report['ground_truth']}; "
          f"{report['clips_without_events']} without events, "
          f"{report['clips_without_frame_numbers']} without frame "
          "numbers)")
    for k, v in report["hit_at"].items():
        print(f"  hit@{k}: {v:.4f}" if v is not None else f"  hit@{k}: n/a")
    if "center_error_mean" in report:
        print(f"  top-1 center error: mean {report['center_error_mean']:.1f} "
              f"median {report['center_error_median']:.1f} frames")
    for side, vals in sorted(report["per_side_hit_at"].items()):
        pretty = ", ".join(f"hit@{k}={v:.3f}" for k, v in vals.items()
                           if v is not None)
        print(f"  {side}: {pretty}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"wrote {args.out}")


def register(sub):
    sm = sub.add_parser("smoke", help="one frame through the random-init "
                                      "P=32 432x768 backbone")
    common.device_arg(sm)
    sm.set_defaults(fn=cmd_smoke)

    ec = sub.add_parser("eval-clips",
                        help="per-clip logit sequences and top-k event "
                             "chunks of a stage-2 run")
    ec.add_argument("--store", required=True)
    ec.add_argument("--ckpt", required=True)
    ec.add_argument("--db", required=True)
    ec.add_argument("--collection", default="ratt_db")
    ec.add_argument("--vids", type=int, nargs="+", required=True)
    ec.add_argument("--out", required=True)
    ec.add_argument("--stage1-run-id", default=None)
    ec.add_argument("--stage2-run-id", default=None)
    ec.add_argument("--k-sim", type=int, default=6)
    ec.add_argument("--k-contrast", type=int, default=6)
    ec.add_argument("--k-temporal", type=int, default=4)
    ec.add_argument("--future-step", type=int, default=2)
    ec.add_argument("--zeros-query", action="store_true")
    common.device_arg(ec)
    ec.set_defaults(fn=cmd_eval_clips)

    sev = sub.add_parser(
        "score-events",
        help="score eval-clips' top-k event localization (hit@k, "
        "center error)")
    sev.add_argument("results", help="logit_sequences.json from eval-clips")
    sev.add_argument("--events", default=None,
                     help="clip_labelling_template.json; omitted -> the "
                     "rows' own chunk status_id ground truth")
    sev.add_argument("--ks", default="1,3,5")
    sev.add_argument("--out", default=None, help="JSON report path")
    sev.set_defaults(fn=cmd_score_events)

    mt = sub.add_parser("metrics", help="inspect run metrics.jsonl ledgers")
    mt.add_argument("dir", help="a run dir (prints the curve) or a "
                    "checkpoint root (summarizes every run)")
    mt.add_argument("--csv", default=None,
                    help="export a single run's curve to CSV")
    mt.set_defaults(fn=cmd_metrics)
