"""kNN-vote possession segmentation: offline, live and streaks.

Port of the kNN orchestrations of vit_research_tpu/segment/pipeline.py:

1. :func:`segment_with_knn_hmm`, the generate_clips_hmm path
   (nba_proj/generate_clips_hmm.py:367-490): k-NN fused-confidence
   emissions against a labelled corpus, Viterbi smoothing, padded clip
   extraction, and confident write-back into the corpus collection;
2. :class:`KnnHmmStreamSession` and :func:`segment_knn_hmm_stream`, its
   live form: per micro-batch top-k, StreamingViterbi, online clip
   extraction (the ``--follow`` loop and the daemon's segment sessions);
3. :func:`segment_with_knn_streaks`, the pre-HMM sliding-window
   classifier (nba_proj/generate_clips.py:99-368);

and the TemporalHead orchestration, :func:`segment_with_temporal_head`
(nba_proj/smarter_generate_clips.py:349-423).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vit_research_tpu_torch.data import naming
from vit_research_tpu_torch.segment import clips as clips_mod
from vit_research_tpu_torch.segment import knn as knn_mod
from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.ops.topk import l2_normalize, masked_topk
from vit_research_tpu_torch.segment.hmm import (STATES, StreamingViterbi,
                                                smooth_probabilities)


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


class KnnHmmStreamSession:
    """Stateful per-batch body for live kNN+HMM segmentation, shared by
    :func:`segment_knn_hmm_stream`, the ``--follow`` loop and the serving
    daemon's segment sessions (one implementation, three surfaces).

    - The corpus is staged on ``device`` once, at construction: a
      per-push upload of a large corpus would dominate every batch. A
      corpus whose embeddings are already a float32 tensor on ``device``
      (the daemon's shared snapshot, serve.py) is used as it is.
    - Pushes run at their true size. The reference pads them to
      power-of-two buckets only to bound jit retraces
      (pipeline.py:158-165); eager PyTorch traces nothing.
    - ``metric`` follows the vector store's semantics: ``'cosine'``
      L2-normalizes corpus and queries and ranks by dot product, exactly
      like ``Collection.query`` over the same rows; ``'l2'``/``'ip'``
      pass through. ``corpus_prenormalized`` says the caller normalized
      the corpus rows already (the daemon does it once for all sessions).
    - Confident write-back (pass ``collection``) mirrors the offline
      pipeline's per-frame math and new-ids-only guard.
    """

    def __init__(self, corpus, *, device, k: int = 50,
                 confidence_threshold: float = 0.7,
                 min_len: int = 100, pad: int = 100, max_lag: int = 512,
                 drain_every: int = 32, collection=None,
                 vid: int | None = None, metric: str = "l2",
                 corpus_prenormalized: bool = False,
                 transition_matrix=None):
        self._metric = metric
        if metric == "cosine":
            self._topk_metric = "ip"
        elif metric in ("l2", "ip"):
            self._topk_metric = metric
        else:
            raise ValueError(f"unknown metric {metric!r}")
        self.device = resolve_device(device)
        embs = torch.as_tensor(corpus["embeddings"], dtype=torch.float32,
                               device=self.device)
        if metric == "cosine" and not corpus_prenormalized:
            embs = l2_normalize(embs)
        self._corpus_dev = embs
        self._labels = np.asarray(corpus["labels"])
        self._probs = np.asarray(corpus["probs"])
        self.k = int(k)
        self.confidence_threshold = float(confidence_threshold)
        self.collection = collection
        self.vid = vid
        self.viterbi = StreamingViterbi(
            max_lag=max_lag, drain_every=drain_every,
            transition_matrix=transition_matrix)
        self.extractor = clips_mod.StreamingClipExtractor(
            min_len=min_len, pad=pad)
        self.frames_seen = 0

    @property
    def corpus_size(self) -> int:
        return len(self._labels)

    @property
    def forced(self) -> int:
        return self.viterbi.forced

    def push_batch(self, frame_names, embeddings) -> list:
        """One micro-batch: kNN vote -> streaming Viterbi -> online clip
        extraction. Returns the ClipIntervals (global frame indices)
        whose padded extent became final."""
        embeddings = np.asarray(embeddings, np.float32)
        n = len(embeddings)
        if n == 0:
            return []
        q = torch.from_numpy(embeddings).to(self.device)
        if self._metric == "cosine":
            q = l2_normalize(q)
        scores, idx = masked_topk(q, self._corpus_dev, None, k=self.k,
                                  metric=self._topk_metric)
        scores = scores.cpu().numpy()
        idx = idx.cpu().numpy()
        nl = np.where(scores > -1e29, self._labels[idx], -1)
        fused = knn_mod.fused_confidence(
            nl, self._probs[idx], top_n=self.k,
            confidence_threshold=self.confidence_threshold)
        _confident_writeback(self.collection, fused, list(frame_names),
                             embeddings, self.vid)
        clips = []
        for row in fused["emissions"]:
            for state in self.viterbi.push(row):
                clips.extend(self.extractor.push(STATES[state]))
        self.frames_seen += n
        return clips

    def finish(self) -> list:
        """Flush the decoder and the extractor; returns the tail clips."""
        clips = []
        for state in self.viterbi.finish():
            clips.extend(self.extractor.push(STATES[state]))
        clips.extend(self.extractor.finish())
        return clips


def segment_knn_hmm_stream(batches, corpus, *, device, k: int = 50,
                           confidence_threshold: float = 0.7,
                           min_len: int = 100, pad: int = 100,
                           max_lag: int = 512, drain_every: int = 32,
                           collection=None,
                           vid: int | None = None, metric: str = "l2",
                           transition_matrix=None):
    """Live variant of :func:`segment_with_knn_hmm` for streams: consume
    an iterator of ``(frame_names, embeddings)`` micro-batches as the
    embedder produces them, run one batched k-NN fused-confidence pass
    per micro-batch (:class:`KnnHmmStreamSession`), push the emissions
    through StreamingViterbi, and yield ClipIntervals with GLOBAL frame
    indices the moment their padded extent is final.

    Confident frames are written back to ``collection`` per micro-batch
    (the offline path's per-frame math and new-ids-only guard). On
    decisive streams the yielded clips equal the offline pipeline's;
    ambiguous stretches longer than ``max_lag`` fall back to fixed-lag
    commits (see StreamingViterbi)."""
    session = KnnHmmStreamSession(
        corpus, device=device, k=k,
        confidence_threshold=confidence_threshold,
        min_len=min_len, pad=pad, max_lag=max_lag,
        drain_every=drain_every, collection=collection, vid=vid,
        metric=metric, transition_matrix=transition_matrix)
    for frame_names, embeddings in batches:
        yield from session.push_batch(frame_names, embeddings)
    yield from session.finish()


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


def segment_with_knn_streaks(frame_names, embeddings, corpus, *, device,
                             out_root: str | None = None,
                             src_dir: str | None = None,
                             k: int = 25,
                             confidence_threshold: float = 0.85,
                             window: int = 50, dominance: float = 0.8,
                             min_len: int = 50, pad: int = 0,
                             collection=None, vid: int | None = None,
                             metric: str = "l2",
                             intervals_csv: str | None = None):
    """The pre-HMM streaming classifier as one batched pass
    (reference: nba_proj/generate_clips.py:99-368): k-NN fused decisions,
    sliding-window streak detection with flagged re-checks
    (segment/streaks.py), optional `clip_intervals.csv`, optional clip
    dirs, and confident (>= threshold) self-upserts.

    Returns (decoded list[str], clip_dirs, intervals) where ``intervals``
    is the raw list of (side_id, start, end)."""
    from vit_research_tpu_torch.segment.streaks import streak_intervals

    nl, idx, _ = knn_mod.knn_labels(
        embeddings, corpus["embeddings"], corpus["labels"], k,
        device=device, metric=metric)
    neighbor_probs = np.asarray(corpus["probs"])[idx]
    fused = knn_mod.fused_confidence(
        nl, neighbor_probs, top_n=k,
        confidence_threshold=confidence_threshold)

    conf = np.max(fused["fused"], axis=1)
    intervals = streak_intervals(
        fused["decision"], conf, window=window, dominance=dominance,
        conf_threshold=confidence_threshold, min_len=min_len)

    decoded = ["none"] * len(frame_names)
    for side, s, e in intervals:
        decoded[s:e + 1] = [STATES[side]] * (e - s + 1)

    _confident_writeback(collection, fused, frame_names, embeddings, vid)

    if intervals_csv is not None:
        with open(intervals_csv, "w") as f:
            f.write("side,start_frame,end_frame\n")
            for side, s, e in intervals:
                f.write(f"{STATES[side]},"
                        f"{naming.frame_num(frame_names[s])},"
                        f"{naming.frame_num(frame_names[e])}\n")

    clip_dirs = []
    if out_root is not None and src_dir is not None:
        clip_dirs = clips_mod.save_clips_from_sequence(
            decoded, list(frame_names), src_dir, out_root,
            min_len=min_len, pad=pad, vid=vid)
    return decoded, clip_dirs, intervals


def segment_with_temporal_head(frame_names, embeddings, manual_intervals, *,
                               device, out_root: str | None = None,
                               src_dir: str | None = None,
                               params_path: str | None = None,
                               epochs: int = 3000, lr: float = 1e-5,
                               min_len: int = 100, pad: int = 100,
                               vid: int | None = None, seed: int = 0):
    """The smarter_generate_clips path: a TemporalHead trained on ``device``
    against the manual labels of ``frame_names`` (or restored from
    ``params_path``), its per-frame probabilities smoothed by the Viterbi
    decoder (segment/hmm.py::smooth_probabilities, the reference's
    8192-frame routing) and cut into padded clips.

    The trained weights are cached at ``params_path`` (.npz) under the
    flax tree's keys (train/checkpoint.py::save_params_npz), as the
    reference reuses its ``.pt``: a ``temporal_head.npz`` written by
    either package loads in the other. Returns (decoded states, clip
    dirs, (T, 3) probabilities)."""
    from vit_research_tpu_torch.models import convert
    from vit_research_tpu_torch.models.temporal_head import TemporalHead
    from vit_research_tpu_torch.train.checkpoint import (load_params_npz,
                                                         save_params_npz)
    from vit_research_tpu_torch.train.train_temporal import (
        predict_probs, train_temporal_head)

    dev = resolve_device(device)
    labels = np.asarray(manual_intervals.label_array(frame_names), np.int32)
    dim = np.shape(embeddings)[-1]
    if params_path and os.path.exists(params_path):
        model = TemporalHead(dim)
        template = convert.temporal_head_to_params(model.state_dict())
        model.load_state_dict(convert.temporal_head_to_state_dict(
            load_params_npz(template, params_path)))
        model = model.to(dev)
    else:
        model, _ = train_temporal_head(embeddings, labels, epochs=epochs,
                                       lr=lr, seed=seed, device=dev)
        if params_path:
            save_params_npz(convert.temporal_head_to_params(
                model.state_dict()), params_path)

    probs = predict_probs(model, embeddings)
    path = smooth_probabilities(probs, device=dev)
    decoded = [STATES[i] for i in path]

    clip_dirs = []
    if out_root is not None and src_dir is not None:
        clip_dirs = clips_mod.save_clips_from_sequence(
            decoded, list(frame_names), src_dir, out_root,
            min_len=min_len, pad=pad, vid=vid)
    return decoded, clip_dirs, probs
