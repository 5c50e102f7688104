"""Game-day serving: one warm daemon, many consumers.

Port of examples/serving.py. A single daemon (what `cli serve` starts)
owns the engine, the labelled corpus and the trained scoring stack, and
everything else is a thin socket client:

1. stateless ops: embed / query / stats;
2. a scored segment session over :class:`SessionClient`: possession clips
   and make/miss event rows stream back mid-game;
3. two concurrent `segment --follow --socket` followers (two "games")
   sharing the one card: no engine start-up per game, the device work
   serialised and micro-batched by the daemon;
4. final daemon stats (the `stats` op).

    python -m vit_research_tpu_torch.examples.serving [workdir]
    python -m vit_research_tpu_torch.examples.serving --tiny --device cpu \\
        [workdir]

The default runs the seeded ViT-B/16 @224 on the card, on 224 x 224
frames, with a stage-1 ChunkEncoder (768 x 3, 8 heads: kernel B at
dh = 96) and a RATTHeadV2 saved as trained runs; ``--tiny`` the JAX
walkthrough's 1-layer 64-wide test ViT. Keep ``workdir`` short: a unix
socket path holds at most 107 bytes.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import threading

import numpy as np
import torch

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.examples import _engines, live_segmentation

GAME = [("none", 10), ("left", 60), ("none", 12), ("right", 55),
        ("none", 10)]
CHUNK = dict(chunk_size=6, chunk_stride=3, k_sim=3, k_contrast=3,
             k_temporal=2, future_step=1)


def stream_sides() -> list:
    return [s for side, n in GAME for s in [side] * n]


def make_world(workdir, device, tiny: bool):
    """Corpus collection, trained-run checkpoints and a ratt_db chunk
    collection (stand-ins for write-frame-db / train-stage1 /
    train-stage2 / write-ratt-db). Returns (engine, {side: image path},
    corpus collection, checkpoint root)."""
    from vit_research_tpu_torch.models.heads import ChunkEncoder
    from vit_research_tpu_torch.models.ratt_v2 import RATTHeadV2
    from vit_research_tpu_torch.store.vector_store import PersistentClient
    from vit_research_tpu_torch.train.checkpoint import CheckpointManager
    from vit_research_tpu_torch.utils.configs import (ChunkEncoderConfig,
                                                      HeadConfig)

    client = PersistentClient(os.path.join(workdir, "db"), device=device)
    engine, paths, coll = live_segmentation.make_world(workdir, device, tiny,
                                                       client=client)

    # "trained" stage-1/stage-2 runs (seeded init saved through the real
    # checkpoint path: the restore plumbing is what the demo exercises)
    dim = engine.out_dim
    enc = ChunkEncoder(ChunkEncoderConfig(embed_dim=dim, mlp_dim=4 * dim,
                                          max_len=CHUNK["chunk_size"]),
                       generator=torch.Generator().manual_seed(1))
    head = RATTHeadV2(HeadConfig(embed_dim=dim, k_sim=CHUNK["k_sim"],
                                 k_contrast=CHUNK["k_contrast"],
                                 k_temporal=CHUNK["k_temporal"]),
                      generator=torch.Generator().manual_seed(2))
    ckpt = os.path.join(workdir, "ckpts")
    for run, model in (("stage1_demo", enc), ("stage2_demo", head)):
        m = CheckpointManager(ckpt, run)
        m.save(1, {"params": model.state_dict()}, metrics={"val_acc": 1.0})
        m.maybe_update_best(1, 1.0)

    ratt = client.get_or_create_collection(
        "ratt_db", metadata={"hnsw:space": "cosine"})
    rng = np.random.default_rng(3)
    ids, rows, metas = [], [], []
    for vid in (7, 8):
        for clip in range(2):
            side = "left" if clip % 2 == 0 else "right"
            for s in range(4):
                ids.append(f"v{vid}c{clip}s{s}")
                e = rng.normal(size=dim).astype(np.float32)
                rows.append(e / np.linalg.norm(e))
                metas.append({"vid_num": vid, "clip_num": clip,
                              "side": side, "label": (vid + clip) % 2,
                              "t_center": (s + 0.5) / 4, "t_width": 0.1,
                              "start_idx": s * 3, "end_idx": s * 3 + 5})
    ratt.upsert(ids, np.stack(rows), metadatas=metas)
    client.flush()
    return engine, paths, coll, ckpt


def score_cfg(workdir, ckpt) -> dict:
    return {"ckpt": ckpt, "stage1_run_id": "stage1_demo",
            "stage2_run_id": "stage2_demo",
            "db": os.path.join(workdir, "db"), "collection": "ratt_db",
            **CHUNK}


def stateless_ops(sock, paths) -> dict:
    from vit_research_tpu_torch.serve import request

    print("== stateless ops: embed / query / stats ==")
    emb = request(sock, {"op": "embed", "paths": [
        paths[s] for s in live_segmentation.SIDES]})
    print(f"  embed: {len(emb['embeddings'])} row(s), "
          f"D={len(emb['embeddings'][0])}")
    q = request(sock, {"op": "query", "paths": [paths["left"]],
                       "n_results": 2})
    print(f"  query: top ids {q['ids'][0]}")
    st = request(sock, {"op": "stats"})
    print(f"  stats: uptime {st['uptime_s']}s, "
          f"requests {st['requests']}")
    return {"embed": emb, "query": q, "stats": st}


def scored_session(sock, paths, workdir, ckpt) -> list:
    from vit_research_tpu_torch.serve import SessionClient

    print("== scored segment session: clips + event rows mid-game ==")
    stream = stream_sides()
    with SessionClient(sock) as c:
        start = c.request({"op": "segment_start", "k": 5, "min_len": 40,
                           "pad": 8, "max_lag": 128, "vid": 1,
                           "score_events": score_cfg(workdir, ckpt)})
        if not start["ok"]:
            raise RuntimeError(f"segment_start refused: {start}")
        print(f"  session open (scoring={start['scoring']})")
        replies = []
        for i in range(0, len(stream), 32):
            replies.append(c.request({
                "op": "segment_push",
                "paths": [paths[s] for s in stream[i: i + 32]]}))
        replies.append(c.request({"op": "segment_finish"}))
    for r in replies:
        for clip, ev in zip(r["clips"], r.get("events", [])):
            top = (ev or {}).get("topk_chunks", [None])[0]
            where = (f"top event chunk idx {top['chunk_start_idx']}.."
                     f"{top['chunk_end_idx']} P(make)={top['prob']:.3f}"
                     if top else "too short to chunk")
            print(f"  clip {clip['side']:5s} {clip['start']}.."
                  f"{clip['end']}: {where}")
    return replies


def concurrent_followers(sock, paths, workdir, ckpt) -> dict:
    """Two 'games' dumping frames to disk, two `segment --follow
    --socket` loops sharing the daemon. Returns {vid: clip dir names}."""
    from vit_research_tpu_torch import cli

    print("== two concurrent --follow --socket games, one daemon ==")
    stream = stream_sides()
    outs = []
    for vid in (1, 2):
        fdir = os.path.join(workdir, f"game{vid}")
        os.makedirs(fdir, exist_ok=True)
        for i, s in enumerate(stream, start=1):
            shutil.copy(paths[s],
                        os.path.join(fdir, f"vid{vid}_frame_{i}.jpg"))
        open(os.path.join(fdir, "STOP"), "w").close()
        outs.append(os.path.join(workdir, f"clips_game{vid}"))

    sc = score_cfg(workdir, ckpt)
    errors = []

    def follow(vid):
        try:
            cli.main(["segment", os.path.join(workdir, f"game{vid}"),
                      "--method", "knn-hmm", "--follow", "--socket", sock,
                      "--k", "5", "--min-len", "40", "--pad", "8",
                      "--max-lag", "128", "--out", outs[vid - 1],
                      "--vid", str(vid), "--idle-timeout", "20",
                      "--poll-interval", "0.05", "--batch-size", "32",
                      "--score-events", "--score-ckpt", sc["ckpt"],
                      "--stage1-run-id", sc["stage1_run_id"],
                      "--stage2-run-id", sc["stage2_run_id"],
                      "--score-db", sc["db"],
                      "--score-collection", sc["collection"],
                      "--chunk-size", str(sc["chunk_size"]),
                      "--chunk-stride", str(sc["chunk_stride"]),
                      "--k-sim", str(sc["k_sim"]),
                      "--k-contrast", str(sc["k_contrast"]),
                      "--k-temporal", str(sc["k_temporal"]),
                      "--future-step", str(sc["future_step"])])
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append((vid, e))
            raise

    threads = [threading.Thread(target=follow, args=(v,)) for v in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"a follower failed or hung: {errors}")
    clips = {}
    for vid in (1, 2):
        clips[vid] = sorted(d for d in os.listdir(outs[vid - 1])
                            if d.startswith(f"vid{vid}_clip"))
        print(f"  game {vid}: {clips[vid]} + events.jsonl")
    return clips


def main(argv=None) -> dict:
    """Run the four parts against one daemon; returns the engine, the
    frame paths by side, the replies of each part and the followers'
    clip dirs."""
    from vit_research_tpu_torch.serve import EmbedServer, request

    ap = _engines.parser(__doc__)
    ap.add_argument("workdir", nargs="?", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="vrt_serving_")
    os.makedirs(workdir, exist_ok=True)
    engine, paths, coll, ckpt = make_world(workdir, dev, args.tiny)

    srv = EmbedServer(engine, collection=coll)
    sock = os.path.join(workdir, "vrt.sock")
    ready = threading.Event()
    t = threading.Thread(target=srv.serve, args=(sock,),
                         kwargs={"ready_event": ready}, daemon=True)
    t.start()
    try:
        # a False here means serve() raised (e.g. a live previous run
        # still owns the socket): fail with the real cause, not a
        # downstream connection error
        if not ready.wait(30):
            raise RuntimeError(f"daemon failed to start on {sock}")
        ops = stateless_ops(sock, paths)
        session = scored_session(sock, paths, workdir, ckpt)
        followed = concurrent_followers(sock, paths, workdir, ckpt)
        st = request(sock, {"op": "stats"})
        print(f"== final stats == sessions: {st['segment']}, "
              f"frames embedded: {st['frames_embedded']}")
    finally:
        srv.stop()
        t.join(timeout=10)
    return {"engine": engine, "paths": paths, "ops": ops,
            "session": session, "followed": followed, "stats": st}


if __name__ == "__main__":
    main(sys.argv[1:])
