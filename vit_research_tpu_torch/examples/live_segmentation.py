"""Live possession segmentation: clips surface mid-game.

Port of examples/live_segmentation.py. Two ways to consume a frame
stream:

1. **Library**: feed (frame_names, embeddings) micro-batches to
   ``segment_knn_hmm_stream`` as the engine produces them and receive
   ClipIntervals the moment their padded extent is final: bounded memory
   (StreamingViterbi's fixed-lag window), equal to the offline decode
   wherever survivor paths coalesce.
2. **Daemon**: start the serving daemon on a labelled corpus collection,
   open a segment session over its unix socket, push frames as they
   "arrive", and print clips as the server streams them back.

    python -m vit_research_tpu_torch.examples.live_segmentation [workdir]
    python -m vit_research_tpu_torch.examples.live_segmentation --tiny \\
        --device cpu [workdir]

The default runs the seeded ViT-B/16 @224 on the card, on 224 x 224
frames; ``--tiny`` the JAX walkthrough's 1-layer 64-wide test ViT.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading

import numpy as np

from vit_research_tpu_torch.device import resolve_device
from vit_research_tpu_torch.examples import _engines

GAME = [("none", 30), ("left", 150), ("none", 40), ("right", 140),
        ("none", 30)]  # the synthetic broadcast: two possessions
SIDES = ("left", "right", "none")


def stream_sides() -> list:
    return [s for side, n in GAME for s in [side] * n]


def make_world(workdir, device, tiny: bool, client=None):
    """Three distinct 'camera angles' and a labelled corpus collection
    ``corpus`` built from the engine's own embeddings (stands in for `cli
    write-frame-db` over manually labelled frames), in ``client`` (a new
    store under ``workdir/db`` by default). Returns (engine, {side: image
    path}, collection)."""
    from PIL import Image

    from vit_research_tpu_torch.store.vector_store import PersistentClient

    engine = _engines.build_engine(
        device, tiny=_engines.tiny_vit(64, 1) if tiny else None,
        batch_size=32)
    h, w = _engines.TINY_FRAME_SIZE if tiny else _engines.FULL_FRAME_SIZE
    block = h // 4
    paths = {}
    for i, side in enumerate(SIDES):
        img = np.full((h, w, 3), 40 + 80 * i, np.uint8)
        img[: block * (i + 1), :block] = 255
        p = os.path.join(workdir, f"{side}.png")
        Image.fromarray(img).save(p)
        paths[side] = p
    embs = engine.embed_batch(
        np.stack([np.asarray(Image.open(paths[s])) for s in SIDES]))
    if client is None:
        client = PersistentClient(os.path.join(workdir, "db"), device=device)
    coll = client.get_or_create_collection("corpus",
                                           metadata={"hnsw:space": "l2"})
    ids, rows, metas = [], [], []
    for i, side in enumerate(SIDES):
        probs = {f"{s}_prob": (0.9 if s == side else 0.05) for s in SIDES}
        for c in range(5):
            ids.append(f"{side}{c}")
            rows.append(embs[i])
            metas.append({"label": side, **probs})
    coll.upsert(ids, np.asarray(rows), metadatas=metas)
    return engine, paths, coll


def stream_batches(engine, paths):
    """The game as (frame names, embeddings) batches of 32 frames."""
    from PIL import Image

    stream = stream_sides()
    for i in range(0, len(stream), 32):  # frames "arrive" in batches
        part = stream[i: i + 32]
        frames = np.stack([np.asarray(Image.open(paths[s])) for s in part])
        names = [f"vid1_frame_{i + j}.jpg" for j in range(len(part))]
        yield names, engine.embed_batch(frames)


def library_stream(engine, paths, coll, device) -> list:
    from vit_research_tpu_torch.segment.knn import corpus_from_collection
    from vit_research_tpu_torch.segment.pipeline import (
        segment_knn_hmm_stream)

    print("== library: segment_knn_hmm_stream ==")
    corpus = corpus_from_collection(coll)
    total = len(stream_sides())
    clips = []
    for clip in segment_knn_hmm_stream(stream_batches(engine, paths), corpus,
                                       device=device, k=5, min_len=100,
                                       pad=20, drain_every=8, max_lag=128):
        print(f"  clip: {clip.side:5s} frames {clip.start}..{clip.end} "
              f"(game is {total} frames)")
        clips.append(clip)
    return clips


def daemon_stream(engine, paths, coll, workdir) -> list:
    from vit_research_tpu_torch.serve import EmbedServer, SessionClient

    print("== daemon: segment session over the unix socket ==")
    srv = EmbedServer(engine, collection=coll)
    sock = os.path.join(workdir, "vrt.sock")
    ready = threading.Event()
    t = threading.Thread(target=srv.serve, args=(sock,),
                         kwargs={"ready_event": ready}, daemon=True)
    t.start()
    if not ready.wait(30):
        raise RuntimeError(f"daemon failed to start on {sock}")
    stream = stream_sides()
    clips = []
    try:
        with SessionClient(sock) as client:
            start = client.request({"op": "segment_start", "k": 5,
                                    "min_len": 100, "pad": 20,
                                    "max_lag": 128})
            print(f"  session open: corpus_size={start['corpus_size']} "
                  f"metric={start['metric']}")
            for i in range(0, len(stream), 32):
                resp = client.request({
                    "op": "segment_push",
                    "paths": [paths[s] for s in stream[i: i + 32]]})
                for c in resp["clips"]:
                    print(f"  clip at frame {resp['frames_seen']}: "
                          f"{c['side']:5s} frames {c['start']}..{c['end']}")
                clips += resp["clips"]
            fin = client.request({"op": "segment_finish"})
            for c in fin["clips"]:
                print(f"  clip at finish: {c['side']:5s} "
                      f"frames {c['start']}..{c['end']}")
            clips += fin["clips"]
            print(f"  done: {fin['frames_seen']} frames, "
                  f"{fin['forced']} forced commits")
    finally:
        srv.stop()
        t.join(timeout=10)
    return clips


def main(argv=None) -> dict:
    """Run both parts; returns the engine, the frame paths by side, the
    corpus collection, the library stream's clips and the daemon's."""
    ap = _engines.parser(__doc__)
    ap.add_argument("workdir", nargs="?", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix="vrt_live_")
    os.makedirs(workdir, exist_ok=True)
    engine, paths, coll = make_world(workdir, dev, args.tiny)
    streamed = library_stream(engine, paths, coll, dev)
    served = daemon_stream(engine, paths, coll, workdir)
    return {"engine": engine, "paths": paths, "collection": coll,
            "streamed": streamed, "served": served}


if __name__ == "__main__":
    main(sys.argv[1:])
