"""Per-clip chunk-logit sequences and event localization.

Port of vit_research_tpu/evaluate/clip_sequences.py:

- the stage-2 head over a set of chunks with live retrieval, a batch of
  16 at a time (the pool encoded once);
- the optional zeroed-query ablation (the local query embedding zeroed
  to isolate retrieval's contribution);
- per clip: the ordered logit / probability / prediction sequences, the
  z-normalised logits and the top-k event chunks ranked by logit;
- the rows to JSON and CSV, in the JAX package's schema.

``head_apply`` returns the logits on its device; the sigmoid is torch's
there, and the rows hold host floats.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np
import torch

from vit_research_tpu_torch.retrieval import cache_stage2 as CS
from vit_research_tpu_torch.train.common import batch_iterator


def _frame_bound(ch, pos: int):
    """Frame number of a chunk's first (``pos`` 0) or last (-1) frame: the
    chunk's ``start_frame`` / ``end_frame`` when given, else parsed from
    its frame paths (``vid{N}_frame_{M}``); None when neither is there."""
    explicit = ch.get("start_frame" if pos == 0 else "end_frame")
    if explicit is not None:
        return int(explicit)
    frames = ch.get("frames")
    if not frames:
        return None
    from vit_research_tpu_torch.data import naming

    try:
        return naming.parse_frame_name(os.path.basename(str(frames[pos])))[1]
    except (ValueError, IndexError):
        return None


def z_normalize(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    if len(x) < 2:
        return x
    return (x - x.mean()) / (x.std() + 1e-6)


def get_topk_chunks_for_sequence(seq, k: int = 5) -> list[dict]:
    """A clip's top-k chunks by logit, with their localization."""
    k = min(k, len(seq))
    top = sorted(seq, key=lambda x: x["logit"], reverse=True)[:k]
    rows = []
    for rank, x in enumerate(top, start=1):
        sf, ef = x.get("start_frame"), x.get("end_frame")
        row = {
            "rank": rank, "vid": x["vid"], "clip": x["clip"],
            "side": x["side"], "label": x["label"],
            "chunk_start_idx": x["start_idx"],
            "chunk_end_idx": x["end_idx"],
            "start_frame": sf, "end_frame": ef,
            "center_frame": (sf + ef) // 2
            if sf is not None and ef is not None else None,
            "logit": float(x["logit"]), "prob": float(x["prob"]),
            "pred": int(x["pred"]),
        }
        # only where the chunk carries an event label (score-events reads
        # it); the schema is the reference's otherwise
        if x.get("status_id") is not None:
            row["status_id"] = x["status_id"]
        rows.append(row)
    return rows


def infer_clip_sequences(chunks, head_apply, encode_fn, collection, *,
                         k_sim: int, k_contrast: int, k_temporal: int,
                         future_step: int = 2, search_k_content: int = 64,
                         search_k_temporal: int = 32, batch_size: int = 16,
                         zeros_query: bool = False,
                         top_k_event_chunks: int = 5,
                         exclude_self: bool = True,
                         self_sim_cap: float | None = None) -> list[dict]:
    """The stage-2 head over ``chunks`` with live retrieval; one row a
    clip, sorted by (vid, clip).

    Args:
      head_apply: callable(query (B, D), sim, contrast, temporal) ->
        (B, 1) logits (evaluate/scoring.py::stage2_head).
      encode_fn: chunk -> (D,) embedding (the frozen stage-1 encoder).
      zeros_query: zero the local query embedding (ablation).
      exclude_self / self_sim_cap: cache_stage2.build_live_entry's (keep
        ``exclude_self`` for chunks that are in the collection; live
        chunks pass False and the cap instead)."""
    clip_outputs: dict = {}
    pool_embs = {CS.make_chunk_key(ch):
                 np.asarray(encode_fn(ch), np.float32) for ch in chunks}
    for batch in batch_iterator(chunks, batch_size, shuffle=False,
                                drop_remainder=False):
        raw = CS.fetch_live_batch(
            batch, encode_fn, collection, k_sim=k_sim, k_contrast=k_contrast,
            k_temporal=k_temporal, future_step=future_step,
            search_k_content=search_k_content,
            search_k_temporal=search_k_temporal, all_chunks=chunks,
            pool_embs=pool_embs, exclude_self=exclude_self,
            self_sim_cap=self_sim_cap)
        query = raw["query_emb"]
        if zeros_query:
            query = np.zeros_like(query)
        logits = torch.as_tensor(head_apply(
            query, raw["sim_embs"], raw["contrast_embs"],
            raw["temporal_embs"])).reshape(-1)
        probs = torch.sigmoid(logits).cpu().numpy()
        logits = logits.cpu().numpy()
        for ch, logit, prob in zip(batch, logits, probs):
            entry = {
                "vid": int(ch["vid"]), "clip": int(ch["clip"]),
                "side": str(ch["side"]), "label": int(ch["label"]),
                "start_idx": int(ch["start_idx"]),
                "end_idx": int(ch["end_idx"]),
                "t_center": float(ch["t_center"]),
                "start_frame": _frame_bound(ch, 0),
                "end_frame": _frame_bound(ch, -1),
                "logit": float(logit), "prob": float(prob),
                "pred": int(prob > 0.5),
            }
            if "status_id" in ch:
                entry["status_id"] = int(ch["status_id"])
            clip_outputs.setdefault((int(ch["vid"]), int(ch["clip"])),
                                    []).append(entry)

    rows = []
    for seq in clip_outputs.values():
        seq = sorted(seq, key=lambda x: x["start_idx"])
        raw_seq = [x["logit"] for x in seq]
        rows.append({
            "clip_key": f"vid{seq[0]['vid']}_clip{seq[0]['clip']}",
            "vid": seq[0]["vid"], "clip": seq[0]["clip"],
            "side": seq[0]["side"], "label": seq[0]["label"],
            "num_chunks": len(seq),
            "start_idxs": [x["start_idx"] for x in seq],
            "end_idxs": [x["end_idx"] for x in seq],
            "start_frames": [x.get("start_frame") for x in seq],
            "end_frames": [x.get("end_frame") for x in seq],
            "t_centers": [x["t_center"] for x in seq],
            "raw_sequence": raw_seq,
            "z_sequence": z_normalize(raw_seq).tolist(),
            "prob_sequence": [x["prob"] for x in seq],
            "pred_sequence": [x["pred"] for x in seq],
            "status_ids": [x.get("status_id") for x in seq],
            "topk_chunks": get_topk_chunks_for_sequence(
                seq, top_k_event_chunks),
        })
    rows.sort(key=lambda x: (x["vid"], x["clip"]))
    return rows


def save_results(rows, out_json: str, out_csv: str | None = None) -> None:
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(rows, f, indent=2)
    if out_csv:
        if rows:
            with open(out_csv, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                w.writeheader()
                for r in rows:
                    w.writerow({k: json.dumps(v) if isinstance(v, (list, dict))
                                else v for k, v in r.items()})
        else:
            open(out_csv, "w").close()
