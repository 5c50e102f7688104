"""Runnable end-to-end walkthrough on synthetic data.

Port of examples/full_pipeline.py, the reference's whole workflow in one
script: raw frames -> ViT embeddings -> temporal-head HMM possession
segmentation -> clips -> chunks -> memmap frame store -> stage-1 chunk
encoder -> RATT vector DB -> stage-2 retrieval cache -> RATTHeadV2
training with live validation -> per-clip event inference.

    python -m vit_research_tpu_torch.examples.full_pipeline [workdir]
    python -m vit_research_tpu_torch.examples.full_pipeline --tiny \\
        --device cpu [workdir]

The default runs at full width on the card: the seeded ViT-B/16 @224
(kernels A and B at dh = 64) on 224 x 224 frames, the default
ChunkEncoder (768 x 3, 8 heads: B at dh = 96) and RATTHeadV2 (768 x 2, 4
heads). ``--tiny`` runs the JAX walkthrough's tiny configurations.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.examples import _engines

GAME = [("none", 6), ("left", 40), ("none", 6), ("right", 40), ("none", 6)]


def main(argv=None) -> dict:
    """Run the walkthrough; returns the engine, the games' frame paths,
    clip dirs and event template, the validation chunks and the clip
    rows."""
    ap = _engines.parser(__doc__)
    ap.add_argument("workdir", nargs="?", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="vrt_demo_")
    print(f"[demo] working in {workdir} on {dev}")

    from vit_research_tpu_torch.data import chunks as chunks_mod
    from vit_research_tpu_torch.data import labels as labels_mod
    from vit_research_tpu_torch.data import naming, samples, synthetic
    from vit_research_tpu_torch.utils.configs import (ChunkEncoderConfig,
                                                      HeadConfig)

    tiny = args.tiny
    if tiny:
        enc_cfg = ChunkEncoderConfig(embed_dim=32, num_layers=1, num_heads=2,
                                     mlp_dim=128, max_len=6)
        head_cfg = HeadConfig(embed_dim=32, num_layers=1, num_heads=2,
                              mlp_dim=16, k_sim=3, k_contrast=3,
                              k_temporal=2)
    else:
        enc_cfg = ChunkEncoderConfig()
        head_cfg = HeadConfig(k_sim=3, k_contrast=3, k_temporal=2)

    # 1. Two synthetic "games" of raw frames.
    size = _engines.TINY_FRAME_SIZE if tiny else _engines.FULL_FRAME_SIZE
    frame_dirs = {vid: synthetic.write_video_frames(
        os.path.join(workdir, f"frames_{vid}"), vid, GAME, size=size)
        for vid in (1, 2)}
    print(f"[demo] wrote {sum(len(v) for v in frame_dirs.values())} frames")

    # 2. Embedding engine (seeded random ViT, the reference's random
    #    backbone regime).
    eng = _engines.build_engine(
        dev, tiny=_engines.tiny_vit(32, 1) if tiny else None,
        batch_size=16 if tiny else 256)

    # 3. Segmentation: temporal head + Viterbi HMM -> possession clips.
    from vit_research_tpu_torch.segment.pipeline import (
        segment_with_temporal_head)

    clip_labels, events, clip_dirs_by_vid = {}, {}, {}
    for vid, paths in frame_dirs.items():
        names = [os.path.basename(p) for p in paths]
        embs = eng.embed_paths(paths, num_workers=2)
        mi = labels_mod.ManualIntervals()
        mi.intervals["none"] += [(vid, 1, 6), (vid, 47, 52), (vid, 93, 98)]
        mi.intervals["left"].append((vid, 7, 46))
        mi.intervals["right"].append((vid, 53, 92))
        _, clip_dirs, _ = segment_with_temporal_head(
            names, embs, mi,
            out_root=os.path.join(workdir, f"clips_hmm_smooth_{vid}_smart"),
            src_dir=os.path.join(workdir, f"frames_{vid}"), vid=vid,
            epochs=200, lr=1e-3, min_len=25, pad=3, device=dev)
        clip_dirs_by_vid[vid] = clip_dirs
        print(f"[demo] vid{vid}: {len(clip_dirs)} clips")
        for cdir in clip_dirs:
            _, _, side = naming.parse_clip_dir(os.path.basename(cdir))
            label = 1 if side == "left" else 0
            clip_labels[cdir] = label
            frames = sorted(os.listdir(cdir), key=naming.frame_sort_key)
            mid = naming.frame_num(frames[len(frames) // 2])
            key = "event_make" if label else "event_miss"
            events[cdir] = {"event_make": [], "event_miss": [],
                            "event_none": [], key: [[mid, mid + 3]]}

    # 4. Samples -> chunks -> memmap frame store.
    from vit_research_tpu_torch.db.frame_store import (FrameStore,
                                                       build_chunk_index)

    recs = samples.load_samples(
        (1, 2), os.path.join(workdir, "clips_hmm_smooth_{vid}_smart"),
        clip_labels, events)
    chunks = chunks_mod.build_chunks(recs, chunk_size=6, chunk_stride=3)
    store_dir = os.path.join(workdir, "store")
    store = FrameStore.build([p for c in chunks for p in c["frames"]],
                             eng.embed_paths, store_dir)
    idx = build_chunk_index(chunks, store, store_dir)
    print(f"[demo] {len(chunks)} chunks over {store.n} unique frames")

    # 5. Stage-1 chunk encoder.
    from vit_research_tpu_torch.train.train_chunk_encoder import (
        make_encode_fn, train_chunk_encoder)

    n = len(chunks)
    ce_model, ce_params, hist = train_chunk_encoder(
        store, idx, list(range(0, n, 2)), list(range(1, n, 2)),
        config=enc_cfg, num_epochs=3, batch_size=4, device=dev)
    print(f"[demo] stage-1 val acc {hist[-1].get('val_acc', 0):.3f}")
    encode = make_encode_fn(ce_model, ce_params)

    # 6. RATT vector DB.
    from vit_research_tpu_torch.db.builders import write_ratt_chunk_db
    from vit_research_tpu_torch.store.vector_store import PersistentClient

    client = PersistentClient(os.path.join(workdir, "db"), autoflush=False,
                              device=dev)
    col = client.get_or_create_collection(
        "ratt_db", metadata={"hnsw:space": "cosine"})
    write_ratt_chunk_db(idx, store, encode, col)
    client.flush()
    print(f"[demo] ratt_db holds {col.count()} chunk embeddings")

    # 7. Stage-2 cache + RATTHeadV2 training with live validation.
    from vit_research_tpu_torch.retrieval import cache_stage2 as CS
    from vit_research_tpu_torch.train.train_stage2 import train_stage2
    from vit_research_tpu_torch.utils.configs import (ExperimentConfig,
                                                      RetrievalConfig,
                                                      TrainConfig)

    def encode_chunk(ch):
        emb, _ = encode(store.gather_paths([ch["frames"]]))
        return emb[0] / (np.linalg.norm(emb[0]) + 1e-8)

    cache = CS.build_stage2_cache(chunks, encode_chunk, col, k_sim=3,
                                  k_contrast=3, k_temporal=2, future_step=1)
    cfg2 = ExperimentConfig(
        name="stage2", head=head_cfg,
        train=TrainConfig(batch_size=4, num_epochs=3, accum_steps=1),
        retrieval=RetrievalConfig(future_chunk_step=1, search_k_content=16,
                                  search_k_temporal=8))
    train_c = [c for c in chunks if c["vid"] == 1]
    val_c = [c for c in chunks if c["vid"] == 2]
    head, _ = train_stage2(train_c, val_c, cache, encode_fn=encode_chunk,
                           collection=col, cfg=cfg2, verbose=True,
                           device=dev)

    # 8. Per-clip event inference.
    from vit_research_tpu_torch.evaluate.clip_sequences import (
        infer_clip_sequences, save_results)

    head.eval()

    @torch.no_grad()
    def head_apply(q, s, c, t):
        return head(*(torch.as_tensor(np.asarray(x, np.float32)).to(dev)
                      for x in (q, s, c, t)))[0]

    rows = infer_clip_sequences(
        val_c, head_apply, encode_chunk, col, k_sim=3, k_contrast=3,
        k_temporal=2, future_step=1, batch_size=4)
    out = os.path.join(workdir, "results.json")
    save_results(rows, out, out.replace(".json", ".csv"))
    print(f"[demo] wrote {len(rows)} clip rows -> {out}")
    for r in rows:
        top = r["topk_chunks"][0]
        print(f"  clip {r['clip_key']} label={r['label']} "
              f"top-chunk logit={top['logit']:.3f} pred={top['pred']}")
    return {"workdir": workdir, "engine": eng, "frames": frame_dirs,
            "clip_dirs": clip_dirs_by_vid, "events": events,
            "val_chunks": val_c, "rows": rows, "results": out}


if __name__ == "__main__":
    main(sys.argv[1:])
