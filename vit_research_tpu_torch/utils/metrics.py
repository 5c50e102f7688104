"""Structured metrics: append-only JSONL run ledgers.

Port of vit_research_tpu/utils/metrics.py, same file format. Every run
directory gets an append-only ``metrics.jsonl``: one JSON object per
epoch carrying the full diagnostic dict, machine-readable, resume-safe
(appends continue across restarts) and crash-tolerant (each record is a
single-line append; a torn final line is skipped on read, and the next
logger terminates it before appending).
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    """One JSON line per ``log`` call: ``{"step": s, "ts": t, **metrics}``.

    The file handle is opened per append so concurrent readers (and a
    crash at any point) see only whole lines plus at most one torn tail.
    """

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._repair_torn_tail()

    def _repair_torn_tail(self) -> None:
        """If the previous process died mid-append the file ends without
        a newline; appending straight onto that torn line would merge the
        next (valid) record into it and lose both on read. Terminate it
        so the torn fragment stays an isolated unparseable line."""
        try:
            with open(self.path, "rb+") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() == 0:
                    return
                f.seek(-1, os.SEEK_END)
                if f.read(1) != b"\n":
                    f.write(b"\n")
        except FileNotFoundError:
            pass

    def log(self, step: int, metrics: dict | None = None, **kw) -> dict:
        """Append one record. Metric values come from ``metrics`` (an
        arbitrary dict — ``step``/``ts`` keys in it are dropped in favor
        of the positional step and wall time) and/or keyword args."""
        row = {"step": int(step), "ts": time.time()}
        combined = {**(metrics or {}), **kw}
        for k, v in combined.items():
            if k in ("step", "ts"):
                continue
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                # The contract is 'an arbitrary dict': JSON-serializable
                # structures (dict/list/str/None) ride along unchanged;
                # only truly foreign objects get stringified rather than
                # killing the run at checkpoint-save time.
                if isinstance(v, (dict, list, tuple, str)) or v is None:
                    try:
                        json.dumps(v)
                        row[k] = v
                    except (TypeError, ValueError):
                        row[k] = str(v)
                else:
                    row[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        return row


def read_metrics(path: str, *, latest_per_step: bool = True) -> list[dict]:
    """Read a metrics.jsonl ledger.

    With ``latest_per_step`` (default), a re-run epoch after ``--resume``
    supersedes its earlier record, so the result is one row per step in
    step order — the clean training curve. Torn lines (crash mid-append)
    are skipped.
    """
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail from a crash mid-append
            if isinstance(row, dict) and "step" in row:
                rows.append(row)
    if not latest_per_step:
        return rows
    by_step: dict = {}
    for row in rows:  # later appends win
        by_step[row["step"]] = row
    return [by_step[s] for s in sorted(by_step)]
