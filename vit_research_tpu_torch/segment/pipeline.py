"""Offline kNN+HMM possession segmentation.

Port of vit_research_tpu/segment/pipeline.py::segment_with_knn_hmm (the
generate_clips_hmm path, nba_proj/generate_clips_hmm.py:367-490): k-NN
fused-confidence emissions against a labelled corpus, Viterbi smoothing,
padded clip extraction, and confident write-back into the corpus
collection. The live session and the other orchestrations are not ported
yet.
"""

from __future__ import annotations

import numpy as np

from vit_research_tpu.data import naming
from vit_research_tpu_torch.segment import clips as clips_mod
from vit_research_tpu_torch.segment import knn as knn_mod
from vit_research_tpu_torch.segment.hmm import STATES, smooth_probabilities


def segment_with_knn_hmm(frame_names, embeddings, corpus, *, device,
                         out_root: str | None = None,
                         src_dir: str | None = None,
                         k: int = 50, confidence_threshold: float = 0.7,
                         min_len: int = 100, pad: int = 100,
                         collection=None, vid: int | None = None,
                         metric: str = "l2", transition_matrix=None):
    """Args:
      frame_names: ordered frame filenames.
      embeddings: (N, D) frame embeddings (parallel/embed.py).
      corpus: dict with 'embeddings' (M, D), 'labels' (M,) int ids,
        'probs' (M, 3) stored per-frame probabilities.
      device: where the top-k and the Viterbi decode run.
      collection: optional vector-store collection for confident
        write-back of new frame ids.
      transition_matrix: optional (3, 3) HMM transitions.
    Returns (decoded list[str], clip_dirs, fused dict)."""
    nl, idx, _ = knn_mod.knn_labels(
        embeddings, corpus["embeddings"], corpus["labels"], k,
        device=device, metric=metric)
    neighbor_probs = np.asarray(corpus["probs"])[idx]
    fused = knn_mod.fused_confidence(
        nl, neighbor_probs, top_n=k,
        confidence_threshold=confidence_threshold)

    path = smooth_probabilities(fused["emissions"],
                                transition_matrix=transition_matrix,
                                device=device)
    decoded = [STATES[i] for i in path]

    _confident_writeback(collection, fused, frame_names, embeddings, vid)

    clip_dirs = []
    if out_root is not None and src_dir is not None:
        clip_dirs = clips_mod.save_clips_from_sequence(
            decoded, list(frame_names), src_dir, out_root,
            min_len=min_len, pad=pad, vid=vid)
    return decoded, clip_dirs, fused


def _confident_writeback(collection, fused, frame_names, embeddings, vid):
    """Upsert confident frames back into the corpus collection. Only NEW
    frame ids are written: overwriting an existing row would replace
    manually-labelled seed metadata with a kNN-derived guess."""
    if collection is None or not fused["confident"].any():
        return
    existing = set(collection.get(ids=list(frame_names))["ids"])
    sel = [i for i in np.nonzero(fused["confident"])[0]
           if frame_names[i] not in existing]
    if not sel:
        return
    metas = []
    for i in sel:
        p = fused["upsert_probs"][i]
        metas.append({
            "label": STATES[fused["decision"][i]],
            "video": vid if vid is not None
            else naming.vid_num(frame_names[i]),
            "left_prob": float(p[0]),
            "right_prob": float(p[1]),
            "none_prob": float(p[2]),
        })
    collection.upsert([frame_names[i] for i in sel],
                      np.asarray(embeddings)[sel], metas)
