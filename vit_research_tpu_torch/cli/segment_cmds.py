"""Segmentation command: segment --method knn-hmm (offline).

Port of the offline kNN+HMM branch of vit_research_tpu/cli/segment_cmds.py
with the reference's arguments plus ``--device``.
"""

from __future__ import annotations

import json
import os

from vit_research_tpu_torch.cli import common


def _load_transitions(path):
    from vit_research_tpu_torch.segment.hmm import validate_transition_matrix

    with open(path) as fh:
        data = json.load(fh)
    if isinstance(data, dict):
        if "best_transition_matrix" not in data:
            raise SystemExit(f"{path}: JSON dict carries no "
                             "'best_transition_matrix' (expected a "
                             "tune-segment output or a bare 3x3 list)")
        data = data["best_transition_matrix"]
    try:
        return validate_transition_matrix(data)
    except ValueError as e:
        raise SystemExit(f"{path}: {e}")


def cmd_segment(args):
    """Frames -> possession clips by kNN votes against a labelled corpus
    collection, Viterbi smoothing and padded clip extraction, with
    optional confident write-back."""
    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.segment.pipeline import segment_with_knn_hmm

    # Validate before the engine spins up and the frames are embedded.
    transitions = (_load_transitions(args.transitions)
                   if args.transitions else None)
    client, col, corpus = common.load_corpus(args.db, args.corpus_collection,
                                             args.device)
    space = getattr(col, "space", "l2")

    os.makedirs(args.out, exist_ok=True)
    frames = naming.list_frames(args.frames)
    eng = common._engine(args.batch_size, args.device)
    embs = eng.embed_paths([os.path.join(args.frames, f) for f in frames])
    if args.write_back:
        # write-back upserts this engine's embeddings into the corpus
        common._stamp_profile(col)
    decoded, clip_dirs, _ = segment_with_knn_hmm(
        frames, embs, corpus, device=eng.device, out_root=args.out,
        src_dir=args.frames, vid=args.vid, k=args.k,
        confidence_threshold=args.confidence_threshold,
        min_len=args.min_len, pad=args.pad, metric=space,
        collection=col if args.write_back else None,
        transition_matrix=transitions)
    if args.write_back:
        client.flush()
    print(f"decoded {len(decoded)} frames -> {len(clip_dirs)} clips")


def register(sub):
    sg = sub.add_parser("segment", help="frames -> possession clips")
    sg.add_argument("frames")
    sg.add_argument("--method", choices=["knn-hmm"], required=True)
    sg.add_argument("--db", required=True, help="vector-store root")
    sg.add_argument("--corpus-collection", required=True,
                    help="labeled frame collection (write-frame-db)")
    sg.add_argument("--k", type=int, default=50, help="kNN neighbors")
    sg.add_argument("--confidence-threshold", type=float, default=0.7)
    sg.add_argument("--write-back", action="store_true",
                    help="upsert confident frames back into the corpus")
    sg.add_argument("--out", required=True)
    sg.add_argument("--vid", type=int, required=True)
    sg.add_argument("--batch-size", type=int, default=256)
    sg.add_argument("--min-len", type=int, default=100)
    sg.add_argument("--pad", type=int, default=100)
    sg.add_argument("--transitions", default=None,
                    help="JSON with a 3x3 HMM transition matrix (bare "
                    "list or tune-segment output)")
    common.device_arg(sg)
    sg.set_defaults(fn=cmd_segment)
