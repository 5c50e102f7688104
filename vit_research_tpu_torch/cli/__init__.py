"""Command line of the port: the kNN+HMM segmentation main path.

    python -m vit_research_tpu_torch.cli write-frame-db FRAMES \\
        --manual-csv M.csv --db DB --collection C [--device cuda]
    python -m vit_research_tpu_torch.cli segment FRAMES --method knn-hmm \\
        --db DB --corpus-collection C --out OUT --vid N [--write-back] \\
        [--transitions T.json] [--device cuda]

The verbs take the reference CLI's arguments and read/write the same
vector-store format. ``VRT_TINY=1`` swaps the ViT-B/16 for the
reference's tiny test ViT and ``VRT_GRAYSCALE=1`` embeds luminance frames,
as in the reference. Collections are stamped with the reference's profile
string prefixed by ``torch|``: the port's seeded weights span another
embedding space, so the reference's profile fence refuses to write one
package's embeddings into a collection built by the other, and reads
across the two warn.
"""

from __future__ import annotations

import argparse
import os
import sys

from vit_research_tpu.cli import common

PROFILE_PREFIX = "torch|"


def engine_profile() -> str:
    """The reference's profile string for the current env, prefixed."""
    return PROFILE_PREFIX + common.engine_profile()


def _engine(batch_size: int, device):
    from vit_research_tpu.data.preprocess import PreprocessSpec
    from vit_research_tpu_torch.models.vit import init_vit
    from vit_research_tpu_torch.parallel.embed import (EmbeddingEngine,
                                                       make_hf_frame_embedder)

    env = common._engine_env()
    if env["tome_r"] or env["gemm_quant"]:
        raise SystemExit("VRT_TOME_R / VRT_GEMM_QUANT are not ported to the "
                         "torch engine yet; unset them")
    if os.environ.get("VRT_TINY"):
        model = init_vit(common._tiny_vit_config(env), seed=0, device="cpu")
        return EmbeddingEngine(
            model, PreprocessSpec(size=(32, 32), grayscale=env["grayscale"]),
            device=device, batch_size=min(batch_size, 16))
    return make_hf_frame_embedder(device=device, batch_size=batch_size,
                                  grayscale=env["grayscale"])


def _stamp_profile(col) -> None:
    try:
        col.stamp_embedding_profile(engine_profile())
    except ValueError as e:
        raise SystemExit(str(e))


def _corpus_from_collection(col):
    from vit_research_tpu_torch.segment.knn import corpus_from_collection

    stored = getattr(col, "embedding_profile", None)
    current = engine_profile()
    if stored is not None and stored != current:
        print(f"WARNING: corpus collection {col.name!r} was built with "
              f"embedding profile {stored!r} but this command runs "
              f"{current!r} — distances across profiles are not "
              "comparable; rebuild the collection or match the settings",
              file=sys.stderr, flush=True)
    try:
        return corpus_from_collection(col)
    except ValueError as e:
        raise SystemExit(str(e))


def load_corpus(db: str, collection: str):
    """Open a labelled frame collection of the vector store at ``db``:
    (client, collection, kNN corpus dict of segment/knn.py)."""
    from vit_research_tpu.store.vector_store import PersistentClient

    client = PersistentClient(db)
    col = client.get_collection(collection)
    return client, col, _corpus_from_collection(col)


def cmd_write_frame_db(args):
    """Manually labelled frames -> labelled frame collection with one-hot
    probability metadata."""
    from vit_research_tpu.db.builders import write_labeled_frame_collection
    from vit_research_tpu.store.vector_store import PersistentClient
    from vit_research_tpu_torch.segment.knn import SIDES

    frames, sides = common._labeled_frames(args.frames, args.manual_csv)
    keep = [(f, s) for f, s in zip(frames, sides) if s != "ignore"]
    if not keep:
        raise SystemExit("no frames fall inside the manual intervals")
    paths = [os.path.join(args.frames, f) for f, _ in keep]
    labels = [s for _, s in keep]
    probs = [[1.0 if s == t else 0.0 for t in SIDES] for s in labels]
    eng = _engine(args.batch_size, args.device)
    client = PersistentClient(args.db)
    col = client.get_or_create_collection(
        args.collection, metadata={"hnsw:space": "l2"})
    _stamp_profile(col)
    n = write_labeled_frame_collection(paths, labels, probs, eng.embed_paths,
                                       col, batch_size=args.batch_size)
    client.flush()
    print(f"wrote {n} labeled frame embeddings into {args.collection}")


def _load_transitions(path):
    import json

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
    from vit_research_tpu.data import naming
    from vit_research_tpu_torch.segment.pipeline import segment_with_knn_hmm

    # Validate before the engine spins up and the frames are embedded.
    transitions = (_load_transitions(args.transitions)
                   if args.transitions else None)
    client, col, corpus = load_corpus(args.db, args.corpus_collection)
    space = getattr(col, "space", "l2")

    os.makedirs(args.out, exist_ok=True)
    frames = naming.list_frames(args.frames)
    eng = _engine(args.batch_size, args.device)
    embs = eng.embed_paths([os.path.join(args.frames, f) for f in frames])
    if args.write_back:
        # write-back upserts this engine's embeddings into the corpus
        _stamp_profile(col)
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vit_research_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    wf = sub.add_parser(
        "write-frame-db",
        help="manually-labeled frames -> labeled frame collection")
    wf.add_argument("frames")
    wf.add_argument("--manual-csv", required=True)
    wf.add_argument("--db", required=True)
    wf.add_argument("--collection", required=True)
    wf.add_argument("--batch-size", type=int, default=128)
    wf.add_argument("--device", default="cuda")
    wf.set_defaults(fn=cmd_write_frame_db)

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
    sg.add_argument("--device", default="cuda")
    sg.set_defaults(fn=cmd_segment)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
