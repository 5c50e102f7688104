"""Shared CLI plumbing: engine construction, the embedding-profile fence,
world loading and argument groups.

Port of the helpers of vit_research_tpu/cli/common.py that the port's
verbs use. Collections and frame stores are stamped with the reference's
profile string prefixed by ``torch|``: the port's seeded weights span
another embedding space than the JAX package's, so the fence
(``Collection.stamp_embedding_profile``) refuses to write one package's
embeddings into a collection built by the other, and reads across the
two warn.
"""

from __future__ import annotations

import os
import sys

PROFILE_PREFIX = "torch|"


def _engine_env() -> dict:
    """Parse the embedding env toggles once for every consumer: tome_r
    (int, ``VRT_TOME_R``), gemm_quant (``VRT_GEMM_QUANT``), grayscale
    (``VRT_GRAYSCALE``). ToMe and the int8 GEMMs are not ported yet:
    :func:`_engine` refuses them, so the calibration scales of
    ``int8-static`` are not read."""
    raw_tome = os.environ.get("VRT_TOME_R", "").strip()
    try:
        tome_r = int(raw_tome) if raw_tome else 0
    except ValueError:
        raise SystemExit(
            f"VRT_TOME_R must be an integer, got {raw_tome!r}")
    gemm_quant = os.environ.get("VRT_GEMM_QUANT", "").strip() or None
    if gemm_quant not in (None, "int8", "int8-static"):
        raise SystemExit(
            f"VRT_GEMM_QUANT must be 'int8', 'int8-static' or unset, "
            f"got {gemm_quant!r}")
    grayscale = os.environ.get("VRT_GRAYSCALE", "").strip() not in ("", "0")
    return {"tome_r": tome_r, "gemm_quant": gemm_quant,
            "grayscale": grayscale}


def _tiny_vit_config(env: dict):
    """The one tiny test-ViT configuration (``VRT_TINY``), the
    reference's."""
    from vit_research_tpu_torch.utils.configs import ViTConfig

    return ViTConfig(image_size=(32, 32), patch_size=8, hidden_size=32,
                     num_layers=1, num_heads=2, mlp_dim=64,
                     use_flash_attention=False, tome_r=env["tome_r"],
                     gemm_quant=env["gemm_quant"])


def _engine(batch_size: int, device):
    """The frame embedder for the current env on ``device``: the
    ViT-B/16 @224 engine, or the tiny test ViT under ``VRT_TINY=1``."""
    from vit_research_tpu_torch.data.preprocess import PreprocessSpec
    from vit_research_tpu_torch.models.vit import init_vit
    from vit_research_tpu_torch.parallel.embed import (EmbeddingEngine,
                                                       make_hf_frame_embedder)

    env = _engine_env()
    if env["tome_r"] or env["gemm_quant"]:
        raise SystemExit("VRT_TOME_R / VRT_GEMM_QUANT are not ported to the "
                         "torch engine yet; unset them")
    if os.environ.get("VRT_TINY"):
        model = init_vit(_tiny_vit_config(env), seed=0, device="cpu")
        return EmbeddingEngine(
            model, PreprocessSpec(size=(32, 32), grayscale=env["grayscale"]),
            device=device, batch_size=min(batch_size, 16))
    return make_hf_frame_embedder(device=device, batch_size=batch_size,
                                  grayscale=env["grayscale"])


def engine_profile() -> str:
    """Canonical string for the current embedding settings, ``torch|`` +
    the reference's (e.g. ``torch|tome0|quant-none|gray0``): collections
    and frame stores stamp it at write time and read-side commands warn
    when querying across profiles."""
    env = _engine_env()
    quant = env["gemm_quant"] or "none"
    gray = "1" if env["grayscale"] else "0"
    tiny = "tiny|" if os.environ.get("VRT_TINY") else ""
    return (f"{PROFILE_PREFIX}{tiny}tome{env['tome_r']}|quant-{quant}"
            f"|gray{gray}")


def check_embedding_profile(col, what: str = "collection") -> None:
    """Warn (stderr) when querying a collection whose stored profile
    differs from the current engine settings."""
    stored = getattr(col, "embedding_profile", None)
    current = engine_profile()
    if stored is not None and stored != current:
        print(
            f"WARNING: {what} {getattr(col, 'name', '?')!r} was built "
            f"with embedding profile {stored!r} but this command runs "
            f"{current!r} — distances across profiles are not "
            "comparable; rebuild the collection or match the settings",
            file=sys.stderr, flush=True)


def _stamp_profile(col, profile=None) -> None:
    """Writer-side stamp with the CLI error convention: a profile mismatch
    is a clean SystemExit, not a traceback."""
    try:
        col.stamp_embedding_profile(profile if profile is not None
                                    else engine_profile())
    except ValueError as e:
        raise SystemExit(str(e))


def _load_world(args):
    """(per-frame sample records, chunk dicts) of ``--vids`` under
    ``--clip-root``, with the clip labels and event template if given."""
    from vit_research_tpu_torch.data import chunks as chunks_mod
    from vit_research_tpu_torch.data import labels as labels_mod
    from vit_research_tpu_torch.data import samples as samples_mod

    clip_labels = labels_mod.load_clip_labels(args.clip_labels) \
        if args.clip_labels else {}
    events = labels_mod.load_event_template(args.event_template) \
        if args.event_template else {}
    recs = samples_mod.load_samples(args.vids, args.clip_root, clip_labels,
                                    events)
    chunks = chunks_mod.build_chunks(recs, chunk_size=args.chunk_size,
                                     chunk_stride=args.chunk_stride)
    return recs, chunks


def _labeled_frames(frames_dir: str, manual_csv: str):
    """Sorted frame names with manual-interval side labels ('ignore' for
    unlabeled)."""
    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.data.labels import ManualIntervals

    frames = naming.list_frames(frames_dir)
    mi = ManualIntervals.from_csv(manual_csv)
    return frames, [mi.class_from_frame(f) for f in frames]


def load_corpus(db: str, collection: str, device):
    """Open a labelled frame collection of the vector store at ``db``:
    (client, collection, kNN corpus dict of segment/knn.py). Warns when
    the collection was built under another embedding profile."""
    from vit_research_tpu_torch.segment.knn import corpus_from_collection
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    client = PersistentClient(db, device=device)
    col = client.get_collection(collection)
    check_embedding_profile(col, what="corpus collection")
    try:
        return client, col, corpus_from_collection(col)
    except ValueError as e:
        raise SystemExit(str(e))


def world_args(sp):
    sp.add_argument("--clip-root", dest="clip_root", required=True)
    sp.add_argument("--vids", type=int, nargs="+", required=True)
    sp.add_argument("--clip-labels", dest="clip_labels", default=None)
    sp.add_argument("--event-template", dest="event_template",
                    default=None)
    sp.add_argument("--chunk-size", type=int, default=8)
    sp.add_argument("--chunk-stride", type=int, default=2)


def device_arg(sp):
    sp.add_argument("--device", default="cuda",
                    help="torch device of the engine and the store's "
                         "device queries (cuda or cpu)")
