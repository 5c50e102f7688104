"""Embedding/retrieval serving daemon on the torch engine.

Port of vit_research_tpu/serve.py. The daemon keeps ONE warm engine
(parallel/embed.py::EmbeddingEngine, kernels A and B on the card) plus an
optional open vector-store collection, and serves both over a Unix domain
socket with the reference's protocol, byte for byte: the same JSON ops and
replies, and the same binary framing, so either package's clients drive
either package's daemon.

Protocol: newline-delimited JSON, one request object per line, one
response object per line — plus a length-prefixed BINARY framing for
bulk payloads (below); both framings share one socket, distinguished
per request by the first byte.

    {"op": "ping"}
    {"op": "embed", "paths": [...]}            -> {"ok": true, "embeddings": [[...], ...]}
    {"op": "embed", "frames_b64": [...]}       (base64 JPEG/PNG bytes)
    {"op": "query", "paths"|"frames_b64"|"embeddings": ..., "n_results": 5,
     "where": {...}}                           -> per-query ids/distances/metadatas
    {"op": "stats"}                            -> uptime, per-op request counts,
                                                  error count, frames embedded,
                                                  device batches, segment session
                                                  gauges (active/finished/abandoned,
                                                  frames/clips/events)
    {"op": "reload", "db": null, "collection": null}
                                               -> {"ok": true, "rows": N, ...}
    {"op": "reload_weights", "ckpt": null, "stage1_run_id": null,
     "stage2_run_id": null}                    -> {"ok": true, "generation": N,
                                                   "reloaded": [...]}
    {"op": "shutdown"}

Binary framing (bulk transport: a 16-frame JPEG request is ~0.7 MB of
raw bytes vs ~1 MB of base64-in-JSON, and an embed reply is 4 bytes/f32
vs ~24 of number text):

    frame  = 0xBF 'V' | header_len u32 LE | payload_len u64 LE
             | header (JSON object, UTF-8) | payload (raw bytes)

0xBF is an invalid UTF-8 lead byte, so a JSON line can never start with
it — servers dispatch on the first byte, and a client may freely mix
JSON lines and binary frames on one connection. The header is the same
request object as the JSON protocol with the bulk field replaced by a
``"bin"`` descriptor for the payload:

    {"op": "embed", "bin": {"kind": "raw_u8", "shape": [N,H,W,3]}}
        payload = C-contiguous uint8 pixels; (H,W) == the engine spec
        size skips host preprocessing entirely, other sizes are resized
        host-side like every other input form
    {"op": "embed", "bin": {"kind": "jpeg", "sizes": [s0, s1, ...]}}
        payload = the concatenated encoded images (any PIL-decodable
        format), split at the given byte sizes
    ("query" and "segment_push" accept the same descriptors wherever
     they accept "paths"/"frames_b64")

The reply to a binary request is a binary frame: the usual JSON reply
object as the header, with bulk arrays (an embed's "embeddings") moved
to the payload and described by ``"bin": {"kind": "f32", "shape":
[...]}`` (little-endian float32, C order). Replies without bulk data
have payload_len = 0. Framing-level corruption (bad magic, oversized or
non-JSON header) gets one error reply with ``"closing": true`` and the
connection closes — request-level errors keep it alive, as in the JSON
protocol. Clients: :meth:`SessionClient.request_binary` /
:func:`request_binary`.

Hot collection reload (``reload``): re-opens the collection from disk
and swaps it atomically — no engine restart:

- ``db``/``collection`` default to the ones the daemon was started
  with; pass them explicitly to point the daemon at a different
  collection or to ADD retrieval to a daemon started without ``--db``.
- ``query`` and NEW segment sessions see the new corpus immediately;
  segment sessions already running keep ranking against their
  start-time snapshot (the same contract as the offline pipeline).
- Refused while any write-back segment session is active: those
  sessions upsert into the bound collection object, and two live
  generations of one collection writing the same directory would race
  the append-log manifest. Finish them first (the reply says how many).
- The old collection is flushed first, so rows written back by
  already-finished sessions survive into the reopened generation.
- ``cli serve-ctl reload`` is the operator form.

Hot weight reload (``reload_weights``): scoring sessions restore a
stage-1 ChunkEncoder + stage-2 RATTHeadV2 stack from run checkpoints;
the daemon caches each restored stack per config key ``(ckpt,
stage1_run_id, stage2_run_id, chunk_size, k_sim, k_contrast,
k_temporal)`` from first use, so concurrent sessions share one restore
and serving stays on one weight generation until the operator rolls it
forward:

- ``reload_weights`` restores the cached stacks from disk again (a
  training run wrote a new best checkpoint) and swaps them in; every
  restore completes before any swap, so a failed restore leaves every
  old stack serving, and the generation rises once.
- ``ckpt`` / ``stage1_run_id`` / ``stage2_run_id`` narrow which stacks
  reload; all three together PRELOAD a stack no session has asked for
  yet. ``chunk_size`` and the ``k_*`` only describe such a target and
  are refused without the full id triple.
- Active scoring sessions are pinned: they keep the stack they started
  with (``segment_start`` replies carry ``weights_generation``); new
  sessions get the reloaded one.
- ``cli serve-ctl reload-weights`` is the operator form.

Live segmentation sessions (one per connection — use
:class:`SessionClient`, not the one-shot :func:`request`): the server's
collection doubles as the labeled kNN corpus (cli write-frame-db),
frames stream in as they arrive, and finished possession clips stream
back mid-game (segment/pipeline.py::KnnHmmStreamSession):

    {"op": "segment_start", "k": 25, "confidence_threshold": 0.7,
     "min_len": 100, "pad": 100, "max_lag": 512, "drain_every": 8,
     "write_back": false, "vid": null, "transitions": null}
        ("transitions": optional 3x3 HMM matrix — e.g. the
         best_transition_matrix from cli tune-segment)
        (ranking uses the collection's own space, like "query";
         write_back=true upserts confident frames per push with the
         offline pipeline's new-ids-only guard)
    {"op": "segment_push", "paths"|"frames_b64": [...]}
        -> {"ok": true, "clips": [{"side","start","end"}...],
            "frames_seen": N}      (clip indices are global frame
                                    positions within the session)
    {"op": "segment_finish"}       -> remaining clips + "forced" count

Live event scoring (optional): a ``"score_events"`` config in
``segment_start`` returns a make/miss eval row with every finished clip,
``segment --score-events`` (evaluate/live.py) over the socket:

    {"op": "segment_start", ..., "score_events": {
        "ckpt": "ckpts", "stage1_run_id": "...", "stage2_run_id": "...",
        "db": "db", "collection": "ratt_db",
        "chunk_size": 8, "chunk_stride": 2, "k_sim": 8, "k_contrast": 8,
        "k_temporal": 4, "future_step": 2, "emb_cache_cap": 16384}}
        -> {"ok": true, ..., "scoring": true, "weights_generation": N}
           (required: ckpt/stage1_run_id/stage2_run_id/db/collection; a
            missing or mistyped run is an error reply, never a
            random-weight head)
    segment_push / segment_finish replies then carry
        "events": [row | null, ...]   (aligned with "clips"; null: a clip
                                       shorter than one chunk;
                                       {"error": ...}: the clip failed to
                                       score, and is delivered all the
                                       same)

The rows are eval-clips' schema, which cli score-events reads. The
stream's embeddings are reused for scoring (an ``emb_cache_cap`` LRU);
frames pushed as b64 that leave the cache cannot be embedded again (no
path) and error. Scoring runs on the engine's device under the device
lock, like every other device op.

``serve --shard-device`` splits the daemon's collection over a mesh of
every visible card (``shard_mesh``; parallel/mesh.py): its ``query``
answers come from the sharded device path, a ``reload`` re-shards the
reopened collection, and ``stats`` and the reload reply say
``"sharded"``. The segment sessions rank against their own staged
snapshot of the rows, as in the reference. The daemon's segment sessions
are the kNN+HMM path only, as the reference's: ``segment --method temporal``
runs offline in the client's process (``--socket`` refuses it).

Concurrency: requests are parsed and decoded on per-connection threads;
device work (the engine's forward, corpus staging, the sessions' and
queries' top-k) is serialized by one device lock, so the kernels'
launch counters (plain ``+= 1``) stay exact and the kernel library,
loaded on first use, is loaded by one thread. Malformed requests get
``{"ok": false, "error": ...}`` instead of killing the connection.

Cross-request micro-batching: a coalescer thread gathers embed requests
that arrive within ``coalesce_ms`` of each other (or until a full batch
of frames is pending) and runs them as ONE engine call, splitting the
outputs back per request. The port's engine runs ragged batches at their
true size, so a merged batch is just a larger ragged batch: a request's
rows differ from its rows alone only by the f32 GEMMs' summation order.
That holds for the fast profile's engines too (``VRT_TOME_R``,
``VRT_GEMM_QUANT``, read by cli/common.py::_engine like every verb's):
ToMe merges tokens within a frame, dynamic int8 scales are per token and
static ones are constants. ``coalesce_ms=0`` disables it.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import socket
import socketserver
import sys
import threading
import time

import numpy as np
import torch


def _decode_image_blobs(blobs, spec) -> np.ndarray:
    from PIL import Image

    from vit_research_tpu_torch.data.preprocess import load_frames

    imgs = []
    for raw in blobs:
        with Image.open(io.BytesIO(raw)) as im:
            imgs.append(np.asarray(im.convert("RGB")))
    # load_frames accepts in-memory arrays (preprocess_frame is
    # path-or-image), so the serve path shares the parity preprocessing.
    return load_frames(imgs, spec)


def _decode_b64_frames(frames_b64, spec) -> np.ndarray:
    return _decode_image_blobs([base64.b64decode(b) for b in frames_b64],
                               spec)


# ---- binary framing ---------------------------------------------------------
#
# 0xBF is an invalid UTF-8 lead byte, so a binary frame can never be
# mistaken for the first byte of a JSON line (and vice versa) — both
# protocols share one socket, distinguished per request.
BIN_MAGIC = b"\xbfV"
_BIN_MAX_HEADER = 1 << 24  # 16 MB of JSON header is already absurd
_BIN_MAX_PAYLOAD = 1 << 31  # 2 GB; bound a corrupt length prefix


class _ProtocolError(Exception):
    """Framing-level corruption: the stream is desynchronized and the
    connection must close (unlike request-level errors, which reply and
    keep the connection alive)."""


def pack_binary_frame(header: dict, payload: bytes = b"") -> bytes:
    """magic(2) | header_len u32 LE | payload_len u64 LE | header JSON |
    payload bytes."""
    h = json.dumps(header).encode()
    return (BIN_MAGIC + len(h).to_bytes(4, "little")
            + len(payload).to_bytes(8, "little") + h + payload)


def _read_exact(rfile, n: int) -> bytes:
    chunks, got = [], 0
    while got < n:
        chunk = rfile.read(n - got)
        if not chunk:
            raise _ProtocolError("connection closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _read_payload(rfile, n: int) -> bytearray:
    """Read ``n`` bytes into one writable buffer, so a raw_u8 payload
    becomes the frame batch without another copy (numpy arrays over
    ``bytes`` are read-only, and torch refuses to alias those)."""
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = rfile.readinto(view[got:])
        if not k:
            raise _ProtocolError("connection closed mid-frame")
        got += k
    return buf


def read_binary_frame_body(rfile) -> tuple[dict, bytes]:
    """Read one binary frame AFTER the 2 magic bytes were consumed.
    Raises :class:`_ProtocolError` on framing corruption (caller must
    close the connection — byte positions are no longer trustworthy)."""
    hlen = int.from_bytes(_read_exact(rfile, 4), "little")
    plen = int.from_bytes(_read_exact(rfile, 8), "little")
    if hlen > _BIN_MAX_HEADER:
        raise _ProtocolError(f"binary header length {hlen} exceeds limit")
    if plen > _BIN_MAX_PAYLOAD:
        raise _ProtocolError(f"binary payload length {plen} exceeds limit")
    try:
        header = json.loads(_read_exact(rfile, hlen))
    except ValueError as e:
        raise _ProtocolError(f"binary header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise _ProtocolError("binary header must be a JSON object")
    payload = _read_payload(rfile, plen)
    return header, payload


def frames_from_binary(bin_desc: dict, payload: bytes, spec) -> np.ndarray:
    """Decode a binary request payload into a (N, H, W, 3) uint8 batch at
    ``spec.size`` (the same contract the b64 path produces)."""
    kind = bin_desc.get("kind")
    if kind == "raw_u8":
        shape = tuple(int(s) for s in bin_desc.get("shape", ()))
        if len(shape) != 4 or shape[-1] != 3 or any(s <= 0 for s in shape):
            raise ValueError(f"raw_u8 shape must be (N,H,W,3), got {shape}")
        expected = int(np.prod(shape))
        if expected != len(payload):
            raise ValueError(f"raw_u8 payload is {len(payload)} bytes, "
                             f"shape {shape} needs {expected}")
        arr = np.frombuffer(payload, np.uint8).reshape(shape)
        if shape[1:3] == tuple(spec.size):
            return arr  # already at spec size: no host preprocessing
        from vit_research_tpu_torch.data.preprocess import load_frames

        return load_frames(list(arr), spec)  # per-frame resize
    if kind == "jpeg":  # any PIL-decodable format, JPEG/PNG in practice
        sizes = [int(s) for s in bin_desc.get("sizes", ())]
        if any(s <= 0 for s in sizes) or sum(sizes) != len(payload):
            raise ValueError(
                f"jpeg sizes {sizes} do not tile a {len(payload)}-byte "
                "payload")
        blobs, off = [], 0
        for s in sizes:
            blobs.append(payload[off:off + s])
            off += s
        return _decode_image_blobs(blobs, spec)
    raise ValueError(f"unknown binary payload kind {kind!r} "
                     "(expected 'raw_u8' or 'jpeg')")


def _encode_binary_reply(resp: dict) -> bytes:
    """Pack a handler reply as a binary frame; a bulk array under '_np'
    ships as a raw little-endian float32 payload instead of JSON text."""
    resp = dict(resp)  # never mutate the handler's reply dict
    arr = resp.pop("_np", None)
    if arr is not None:
        arr = np.ascontiguousarray(arr, np.float32)
        resp["bin"] = {"kind": "f32", "shape": list(arr.shape)}
        payload = arr.tobytes()
    else:
        payload = b""
    return pack_binary_frame(resp, payload)


class _Coalescer:
    """Cross-request micro-batcher (see module docstring).

    Each :meth:`embed` call parks its frames in ``_pending`` and blocks;
    the worker thread lingers up to ``linger_s`` from the first pending
    arrival (or until a full engine batch of frames is waiting), then
    concatenates everything into one ``embed_batch`` call under the
    device lock and fans the rows back out."""

    def __init__(self, engine, device_lock, linger_s: float):
        self.engine = engine
        self.device_lock = device_lock
        self.linger_s = linger_s
        self._pending = []  # [(frames, event, slot)]
        self._mutex = threading.Lock()
        self._arrived = threading.Condition(self._mutex)
        self._closed = False
        self.batches_run = 0  # observability + tests
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-coalescer")
        self._thread.start()

    def embed(self, frames: np.ndarray) -> np.ndarray:
        if len(frames) >= self.engine.batch_size:
            # A full batch gains nothing from merging, and concatenating
            # it with others would copy it ahead of embed_batch's own
            # sub-batching — dispatch it directly.
            with self.device_lock:
                with self._mutex:
                    closed = self._closed
                if closed:  # same refusal as the queued path: no NEW
                    # device work may start once shutdown has begun
                    raise RuntimeError("server is shutting down")
                out = self.engine.embed_batch(frames)
                self.batches_run += 1
            return out
        done = threading.Event()
        slot = {}
        with self._mutex:
            if self._closed:
                raise RuntimeError("server is shutting down")
            self._pending.append((frames, done, slot))
            self._arrived.notify()
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["out"]

    def close(self):
        """Stop the worker: already-queued requests are drained first,
        and the join waits for a forward in flight (returning mid-forward
        would let the process exit with work still queued on the card)."""
        with self._mutex:
            self._closed = True
            self._arrived.notify()
        self._thread.join(timeout=3600)
        if self._thread.is_alive():
            print("WARNING: coalescer worker still busy after 3600 s; "
                  "in-flight device work may be abandoned on exit",
                  file=sys.stderr)

    def _run(self):
        while True:
            with self._mutex:
                while not self._pending and not self._closed:
                    self._arrived.wait()
                if not self._pending:  # closed and drained
                    return
                # Linger (condition-wait, so arrivals wake us instantly)
                # until a full batch of frames is pending or the window
                # closes.
                deadline = time.monotonic() + self.linger_s
                while (not self._closed
                       and sum(len(f) for f, _, _ in self._pending)
                       < self.engine.batch_size):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._arrived.wait(timeout=remaining)
                work, self._pending = self._pending, []
            try:
                # Inside the try: a failed concatenate (shape mismatch,
                # MemoryError) must fail THESE requests, not kill the
                # worker and strand every later embed in done.wait().
                frames = (work[0][0] if len(work) == 1 else
                          np.concatenate([w[0] for w in work]))
                with self.device_lock:
                    out = self.engine.embed_batch(frames)
                    self.batches_run += 1
                i = 0
                for f, done, slot in work:
                    slot["out"] = out[i:i + len(f)]
                    i += len(f)
            except Exception as e:
                for _, done, slot in work:
                    slot["error"] = e
            finally:
                for _, done, slot in work:
                    done.set()


class EmbedServer:
    """Warm-engine embedding (+ optional retrieval) server."""

    def __init__(self, engine, *, collection=None, coalesce_ms: float = 2.0,
                 collection_source: tuple[str, str] | None = None,
                 shard_mesh=None, engine_profile: str | None = None):
        self.engine = engine
        #: which embedding settings the engine runs (operator
        #: observability — cli/common.engine_profile); shown by
        #: ping/stats so a cross-profile daemon is diagnosable remotely
        self.engine_profile = engine_profile
        self.collection = collection
        self._lock = threading.Lock()  # serialize device work
        self._stopping = False  # set by stop(); device ops then refuse
        self._coalescer = (_Coalescer(engine, self._lock, coalesce_ms / 1e3)
                           if coalesce_ms > 0 else None)
        self._server = None
        self._corpus_cache = None  # ((collection id, mutations), corpus)
        self._corpus_lock = threading.Lock()
        # Hot reload (the `reload` op): where the collection came from on
        # disk, and the guard that makes "swap the collection" atomic
        # against segment sessions BINDING it. Write-back sessions pin the
        # collection: they hold the object and upsert into it, so a swap
        # would leave two live generations appending to one directory.
        self._collection_source = collection_source  # (db_path, name)
        # the mesh a reopened collection is sharded over again (serve
        # --shard-device), or None
        self._shard_mesh = shard_mesh
        self._collection_lock = threading.Lock()
        self._reload_lock = threading.Lock()  # one reload at a time
        self._write_back_sessions = 0
        # Hot weight reload (the `reload_weights` op): restored scorer
        # stacks cached per config key from first use, as (generation,
        # (encode_batch, head_apply)). A reload REPLACES an entry, never
        # the modules inside a stack, so a session holding the old stack
        # keeps its generation (pinned).
        self._weights_lock = threading.Lock()
        self._scorer_stacks: dict[tuple, tuple] = {}
        self._weights_generation = 0
        # observability (the `stats` op): counters shared across
        # connection threads, guarded by their own lock — never the
        # device lock, a stats probe must not queue behind a forward
        self._stats_lock = threading.Lock()
        self._started = time.time()
        self._stats = {
            "requests": {}, "errors": 0, "frames_embedded": 0,
            "segment": {"sessions_started": 0, "sessions_finished": 0,
                        "sessions_abandoned": 0, "sessions_active": 0,
                        "scoring_active": 0,
                        "frames_pushed": 0, "clips_emitted": 0,
                        "events_scored": 0, "event_errors": 0},
        }

    @contextlib.contextmanager
    def _device(self):
        """The device lock, refusing NEW work once stop() has run.

        Handler threads are daemonic: if the serve loop returned while
        one of them was inside a device call, the process could exit with
        work still queued on the card. stop() sets ``_stopping`` and
        :meth:`serve`'s drain then acquires this lock once: every running
        device op finishes first, every queued acquirer wakes to a
        refusal, and nothing new can start before process exit."""
        with self._lock:
            if self._stopping:
                raise RuntimeError("server is shutting down")
            yield

    def _count(self, *path, n: int = 1):
        with self._stats_lock:
            d = self._stats
            for key in path[:-1]:
                d = d[key]
            d[path[-1]] = d.get(path[-1], 0) + n

    # ---- request handling -------------------------------------------------

    def _embed_request(self, req) -> np.ndarray:
        # Decode on the caller's connection thread, OUTSIDE the lock —
        # only device work serializes, so client B's JPEG decode overlaps
        # client A's forward pass.
        if "frames_np" in req:
            # Binary transport: the socket layer already decoded the
            # payload into a spec-size uint8 batch (frames_from_binary).
            batch = req["frames_np"]
        elif "paths" in req:
            missing = [p for p in req["paths"] if not os.path.exists(p)]
            if missing:
                raise ValueError(f"missing paths: {missing[:3]}")
            from vit_research_tpu_torch.data.preprocess import load_frames

            batch = load_frames(req["paths"], self.engine.spec)
        elif "frames_b64" in req:
            batch = _decode_b64_frames(req["frames_b64"], self.engine.spec)
        else:
            raise ValueError(
                "embed needs 'paths', 'frames_b64', or a binary payload")
        if self._coalescer is not None:
            out = self._coalescer.embed(batch)
        else:
            with self._device():
                out = self.engine.embed_batch(batch)
        # counted AFTER the engine returns: failed embeds must not
        # inflate the gauge (frames_pushed is success-only too)
        self._count("frames_embedded", n=len(batch))
        return out

    def _corpus_snapshot(self, collection):
        """Labeled corpus dict from ``collection`` (the session's BOUND
        object — never re-read from self.collection, which a concurrent
        reload may swap mid-call), cached across sessions and invalidated
        by the collection's identity + mutation counter — session starts
        must not re-read every row per connection. The embeddings are
        staged on the engine's DEVICE here (L2-normalized once for a
        cosine collection), so N concurrent sessions share ONE resident
        tensor instead of N uploads and copies."""
        from vit_research_tpu_torch.ops.topk import l2_normalize
        from vit_research_tpu_torch.segment.knn import corpus_from_collection

        muts = getattr(collection, "_mutations", None)
        space = getattr(collection, "space", "l2")
        key = (id(collection), muts)
        with self._corpus_lock:
            if (self._corpus_cache is None or muts is None
                    or self._corpus_cache[0] != key):
                corpus = corpus_from_collection(collection)
                with self._device():  # staging is device work
                    embs = torch.as_tensor(corpus["embeddings"],
                                           device=self.engine.device)
                    if space == "cosine":
                        embs = l2_normalize(embs)
                    corpus["embeddings"] = embs
                self._corpus_cache = (key, corpus)
            return self._corpus_cache[1]

    def _make_scorer(self, cfg):
        """The live event scorer of a segment session
        (evaluate/scoring.py::make_live_scorer) on the engine's device:
        (scorer, weights generation). A misconfiguration raises
        ValueError, an error reply; never a random-weight head."""
        from vit_research_tpu_torch.evaluate import scoring

        if not isinstance(cfg, dict):
            raise ValueError(
                "'score_events' must be an object: {ckpt, stage1_run_id, "
                "stage2_run_id, db, collection, ...}")
        required = ("ckpt", "stage1_run_id", "stage2_run_id", "db",
                    "collection")
        missing = [k for k in required if not cfg.get(k)]
        if missing:
            raise ValueError(
                f"score_events config missing {missing} — the TRAINED "
                "runs to score with (cli train-stage1 / train-stage2) and "
                "the chunk retrieval collection (cli write-ratt-db)")

        def embed_missing(paths):
            # score_clip's re-embed of frames evicted from the scorer's
            # LRU: it runs under the device lock (scoring is device
            # work), so the engine is called directly, not through
            # _embed_request or the coalescer, which take the lock
            paths = [str(p) for p in paths]
            gone = [p for p in paths if not os.path.exists(p)]
            if gone:
                raise ValueError(
                    "score_events: frames evicted from the embedding "
                    f"cache and not on disk (e.g. {gone[:2]}); push "
                    "frames as paths or raise emb_cache_cap")
            from vit_research_tpu_torch.data.preprocess import load_frames

            return self.engine.embed_batch(
                load_frames(paths, self.engine.spec))

        def num(key, default):
            v = cfg.get(key)  # an explicit null takes the default
            return default if v is None else int(v)

        # emb_cache_cap: null means unbounded, absent the bounded default
        cap = cfg.get("emb_cache_cap", 16384)
        cap = None if cap is None else int(cap)
        # the collection opens outside the device lock (a store read is
        # host disk work; holding the lock would stall every session's
        # pushes); the cheap checks come before the restore
        col = scoring.open_collection(cfg["db"], cfg["collection"],
                                      device=self.engine.device)
        if num("chunk_size", 8) < 1 or num("chunk_stride", 2) < 1:
            raise ValueError(
                "score_events needs positive chunk_size and chunk_stride")
        key = (str(cfg["ckpt"]), str(cfg["stage1_run_id"]),
               str(cfg["stage2_run_id"]), num("chunk_size", 8),
               num("k_sim", 8), num("k_contrast", 8), num("k_temporal", 4))
        gen, stack = self._scorer_stack(key)
        scorer = scoring.make_live_scorer(
            embed_missing, dim=self.engine.out_dim, collection=col,
            stack=stack, chunk_size=key[3],
            chunk_stride=num("chunk_stride", 2), k_sim=key[4],
            k_contrast=key[5], k_temporal=key[6],
            future_step=num("future_step", 2), emb_cache_cap=cap,
            device=self.engine.device)
        return scorer, gen

    def _load_stack(self, key: tuple) -> tuple:
        """Restore a scorer stack of config ``key`` from disk onto the
        engine's device, under the device lock like every model build on
        this server."""
        from vit_research_tpu_torch.evaluate import scoring

        with self._device():
            return scoring.load_scorer_stack(
                dim=self.engine.out_dim, ckpt=key[0], stage1_run_id=key[1],
                stage2_run_id=key[2], chunk_size=key[3], k_sim=key[4],
                k_contrast=key[5], k_temporal=key[6],
                device=self.engine.device)

    def _scorer_stack(self, key: tuple) -> tuple:
        """The cached ``(generation, (encode_batch, head_apply))`` of a
        scorer config key, restored on first use. Sessions bind the
        returned stack; a later ``reload_weights`` replaces the cache
        entry, so bound sessions stay on the generation they started
        with."""
        with self._weights_lock:
            ent = self._scorer_stacks.get(key)
        if ent is not None:
            return ent
        # restored outside _weights_lock: a restore must not stall other
        # sessions' cache hits
        stack = self._load_stack(key)
        with self._weights_lock:
            # a lost race keeps the other session's stack, so the
            # sessions of one key share one stack
            return self._scorer_stacks.setdefault(
                key, (self._weights_generation, stack))

    def _score_clips(self, session, clips):
        """Eval rows of just-finished clips, aligned with ``clips`` (None
        for a clip shorter than one chunk, ``{"error": ...}`` for a clip
        that failed to score); None when the session scores nothing.
        Clips are numbered in emission order, scored or not, as the CLI's
        --follow loop numbers them."""
        st = session.get("segment_score")
        if st is None:
            return None
        rows = []
        for c in clips:
            st["clips"] += 1
            frames = st["refs"][c.start: c.end + 1]
            try:
                # the stage-1 encode, the head and any re-embed are
                # device work
                with self._device():
                    rows.append(st["scorer"].score_clip(
                        frames, side=c.side, clip_num=st["clips"],
                        vid=st["vid"]))
            except Exception as e:  # noqa: BLE001 - never fail the push:
                # its clips would be lost to the client while the session
                # has already moved past them
                rows.append({"error": str(e)})
        self._count("segment", "events_scored",
                    n=sum(1 for r in rows
                          if r is not None and "clip_key" in r))
        self._count("segment", "event_errors",
                    n=sum(1 for r in rows
                          if r is not None and "clip_key" not in r))
        return rows

    def _segment_start(self, req, session) -> dict:
        if "segment" in session:
            raise ValueError("a segment session is already active on "
                             "this connection; segment_finish it first")
        write_back = bool(req.get("write_back"))
        if write_back and req.get("vid") is None:
            raise ValueError(
                "write_back requires 'vid': daemon-minted frame names "
                "(path basenames / frame_{N}) don't encode a video "
                "number for the write-back metadata")
        # Bind the collection and (for write-back) pin it in ONE atomic
        # step: a reload between "capture the object" and "count the
        # writer" could otherwise swap the collection out from under a
        # session that is about to upsert into it.
        with self._collection_lock:
            collection = self.collection
            if collection is None:
                raise ValueError(
                    "server started without a collection — segment "
                    "sessions need a labeled corpus (serve --db "
                    "--collection, or the reload op)")
            if write_back:
                if self.engine_profile is not None and hasattr(
                        collection, "stamp_embedding_profile"):
                    # a write-back session upserts THIS engine's
                    # embeddings: refuse a cross-profile corpus write
                    # before pinning (ValueError -> protocol error
                    # reply; mixing spaces would corrupt the corpus)
                    collection.stamp_embedding_profile(self.engine_profile)
                self._write_back_sessions += 1
        try:
            return self._segment_start_bound(req, session, collection,
                                             write_back)
        except BaseException:
            # Leave the connection state EXACTLY as it was. A partially
            # populated session dict would later double-unpin at
            # connection close (pin count goes negative -> every future
            # reload refused forever) and skew the session gauges.
            session.pop("segment", None)
            session.pop("segment_write_back", None)
            session.pop("segment_score", None)
            if write_back:  # pinned above — unpin exactly once
                with self._collection_lock:
                    self._write_back_sessions -= 1
            raise

    def _segment_start_bound(self, req, session, collection,
                             write_back) -> dict:
        from vit_research_tpu_torch.segment.pipeline import \
            KnnHmmStreamSession

        space = getattr(collection, "space", "l2")
        transitions = req.get("transitions")
        if transitions is not None:
            from vit_research_tpu_torch.segment.hmm import \
                validate_transition_matrix

            try:
                # full content check (finite, nonneg, row-stochastic):
                # a counts matrix or zero row would silently corrupt
                # every decode in the session
                transitions = validate_transition_matrix(transitions)
            except ValueError as e:
                raise ValueError(f"'transitions': {e} (calibrate with "
                                 "cli tune-segment)")
        scorer, weights_gen = None, None
        score_cfg = req.get("score_events")
        if score_cfg not in (None, False):
            # not a truthiness test: {} must reach _make_scorer's
            # required-keys error, never silently disable scoring. Built
            # before any session state, so a bad config leaves the
            # connection as it was
            scorer, weights_gen = self._make_scorer(score_cfg)
        score_vid = 0
        if scorer is not None and req.get("vid") is not None:
            try:
                score_vid = int(req["vid"])
            except (TypeError, ValueError):
                raise ValueError(
                    f"'vid' must be an integer when scoring, got "
                    f"{req['vid']!r}")
        # host read; only staging and session setup are device work
        corpus = self._corpus_snapshot(collection)
        with self._device():
            seg = KnnHmmStreamSession(
                corpus,
                device=self.engine.device,
                transition_matrix=transitions,
                k=int(req.get("k", 25)),
                confidence_threshold=float(
                    req.get("confidence_threshold", 0.7)),
                min_len=int(req.get("min_len", 100)),
                pad=int(req.get("pad", 100)),
                max_lag=int(req.get("max_lag", 512)),
                # serving favors responsiveness: sweep for emittable
                # states every few frames (the sweep is ~O(window) tiny
                # numpy ops), not the library default of 32
                drain_every=int(req.get("drain_every", 8)),
                # corpus growth from a shared daemon is opt-in; the
                # session keeps ranking against its start-time snapshot
                # either way (same as the offline pipeline)
                collection=collection if write_back else None,
                vid=req.get("vid"),
                # rank with the collection's own metric, like the query
                # op on this server (store/vector_store.py query path);
                # the snapshot already normalized cosine rows
                metric=space, corpus_prenormalized=True)
        session["segment"] = seg
        session["segment_write_back"] = write_back
        if scorer is not None:
            session["segment_score"] = {
                "scorer": scorer, "refs": [], "clips": 0,
                "vid": score_vid, "weights_generation": weights_gen}
            self._count("segment", "scoring_active")
        self._count("segment", "sessions_started")
        self._count("segment", "sessions_active")
        resp = {"ok": True, "corpus_size": seg.corpus_size,
                "metric": space, "scoring": scorer is not None}
        if weights_gen is not None:
            # the weight generation that scores this session, for its
            # lifetime (reload_weights pins active sessions)
            resp["weights_generation"] = weights_gen
        return resp

    @staticmethod
    def _clips_json(clips) -> list:
        return [{"side": c.side, "start": c.start, "end": c.end}
                for c in clips]

    def _segment_push(self, req, session) -> dict:
        seg = session.get("segment")
        if seg is None:
            raise ValueError("no active segment session — send "
                             "segment_start first")
        # write-back ids follow the CLI convention (frame basenames);
        # in-memory frames (b64 or binary payload) get session-positional ids
        if "paths" in req:
            names = [os.path.basename(p) for p in req["paths"]]
        else:
            n_in = (len(req["frames_np"]) if "frames_np" in req
                    else len(req.get("frames_b64", ())))
            names = [f"frame_{seg.frames_seen + i}" for i in range(n_in)]
        embs = self._embed_request(req)
        with self._device():  # the kNN top-k matmul is device work
            clips = seg.push_batch(names, embs)
        st = session.get("segment_score")
        if st is not None:
            # refs index frames by global session position (what clip
            # start/end mean), full paths where given so evicted frames
            # can be embedded again; the scorer's LRU is keyed by
            # basename, which either form resolves to. Extended only
            # after push_batch succeeded: a failed push consumed nothing
            st["refs"].extend(req["paths"] if "paths" in req else names)
            st["scorer"].remember(names, embs)
        self._count("segment", "frames_pushed", n=len(names))
        self._count("segment", "clips_emitted", n=len(clips))
        resp = {"ok": True, "frames_seen": seg.frames_seen,
                "clips": self._clips_json(clips)}
        events = self._score_clips(session, clips)
        if events is not None:
            resp["events"] = events
        return resp

    def _segment_finish(self, session) -> dict:
        seg = session.get("segment")
        if seg is None:
            raise ValueError("no active segment session")
        clips = seg.finish()  # before dropping state: a failed flush
        resp = {"ok": True, "frames_seen": seg.frames_seen,  # must not
                "forced": seg.forced,  # lose the pending clips silently
                "clips": self._clips_json(clips)}
        events = self._score_clips(session, clips)
        if events is not None:
            resp["events"] = events
        self._count("segment", "clips_emitted", n=len(clips))
        session.pop("segment")
        if session.pop("segment_score", None) is not None:
            self._count("segment", "scoring_active", n=-1)
        self._unpin_write_back(session)
        self._count("segment", "sessions_finished")
        self._count("segment", "sessions_active", n=-1)
        return resp

    def _unpin_write_back(self, session) -> None:
        if not session.pop("segment_write_back", False):
            return
        # Persist this session's write-backs now: collections opened
        # by a reload have no atexit autoflush (deliberately — see
        # _reload), and "acked upserts survive daemon death" must not
        # depend on which generation happens to be live.
        #
        # Ordering is load-bearing. The flush runs BEFORE the pin drops,
        # so a concurrent reload's pin re-check refuses until the rows
        # are durable; and it runs under _reload_lock, so it can never
        # land in reload's window between reopening the directory and
        # swapping the new generation in (rows durable on disk but
        # invisible to the already-loaded new object). A session that
        # finishes mid-reload therefore waits for the reload to fail its
        # re-check (this pin is still up) and then flushes into the old,
        # still-live generation. Lock order here and in _reload:
        # _reload_lock -> _collection_lock.
        try:
            with self._reload_lock:
                with self._collection_lock:
                    # The pin guaranteed no reload swapped the collection
                    # while this session ran, so the current collection
                    # IS the one it upserted into.
                    col = self.collection
                # flush is disk I/O with the store's own lock — keep
                # _collection_lock released for it.
                if col is not None:
                    col.flush()
        except Exception as e:
            # never turn a finished session (clips already computed)
            # into an error reply — but a failed persist is loud. The
            # rows stay pending in the collection; the next flush (any
            # session's unpin, or a reload's pending carry) retries them.
            self._count("errors")
            print(f"serve: write-back flush failed: {e}",
                  file=sys.stderr)
        finally:
            with self._collection_lock:
                self._write_back_sessions -= 1

    def _reload(self, req) -> dict:
        """Re-open the collection from disk and swap it in atomically
        (see the module docstring's "Hot collection reload")."""
        from vit_research_tpu_torch.store.vector_store import (
            PersistentClient, StaleCollectionError)

        src = self._collection_source or (None, None)
        db = req.get("db") or src[0]
        name = req.get("collection") or src[1]
        if not db or not name:
            raise ValueError(
                "server was started without --db/--collection; reload "
                "needs explicit 'db' and 'collection'")
        refusal = ("reload refused: {} active write-back segment "
                   "session(s) are upserting into the current collection "
                   "(two live generations of one collection would race "
                   "its append log); finish them first")
        with self._reload_lock:
            with self._collection_lock:
                if self._write_back_sessions:
                    raise ValueError(
                        refusal.format(self._write_back_sessions))
                old = self.collection
            # Disk work OUTSIDE _collection_lock: a multi-GB flush/reopen
            # must not stall every concurrent segment_start behind it
            # (the pin re-check below keeps the swap itself sound).
            if old is not None:
                try:
                    # Persist write-backs from already-finished sessions
                    # so the reopened generation includes them.
                    old.flush()
                except StaleCollectionError:
                    # An external rebuild rewrote the directory past the
                    # old object's generation: flushing it would be
                    # fenced out on the next load or REPLACE the fresh
                    # rebuild with the daemon's older corpus. Leave the
                    # rows pending; the capture under the final lock below
                    # carries them into the NEW generation instead.
                    pass
            # autoflush=False: an autoflush client registers an atexit
            # flush that would pin every swapped-out generation (host
            # arrays + device corpus cache) in memory for the daemon's
            # lifetime; durability comes from the flush above plus the
            # flush-on-unpin of write-back sessions.
            new = PersistentClient(db, autoflush=False,
                                   device=self.engine.device
                                   ).get_collection(name)
            new_profile = getattr(new, "embedding_profile", None)
            profile_mismatch = (self.engine_profile is not None
                                and new_profile is not None
                                and new_profile != self.engine_profile)
            if profile_mismatch:
                print(f"serve: WARNING: reloaded collection {name!r} was "
                      f"built with embedding profile {new_profile!r} but "
                      f"this daemon's engine runs "
                      f"{self.engine_profile!r} — distances across "
                      "profiles are not comparable", file=sys.stderr)
            if self._shard_mesh is not None:
                # placement only (the mesh recorded, the corpus cache
                # cleared): the shards are staged at the first query,
                # which runs under the device lock
                new.shard_device(self._shard_mesh)
            carried = 0
            with self._collection_lock:
                # Re-check under the lock: a write-back session may have
                # pinned the OLD collection while we were loading.
                if self._write_back_sessions:
                    raise ValueError(
                        refusal.format(self._write_back_sessions))
                if old is not None:
                    # Captured HERE — under the lock, after the pin
                    # re-check, before detach: besides stale-flush rows
                    # this also rescues rows whose write-back unpin flush
                    # FAILED (that path drops the pin with the rows still
                    # pending in old; detach would erase them).
                    pending = old.pending_mutations()
                    if pending is not None:
                        if pending["deleted"]:
                            new.delete(ids=pending["deleted"])
                        if pending["ids"]:
                            new.upsert(pending["ids"],
                                       pending["embeddings"],
                                       pending["metadatas"])
                        carried = (len(pending["ids"])
                                   + len(pending["deleted"]))
                    # Neuter the old object: the startup client's atexit
                    # autoflush (or any straggling holder) must never
                    # write its stale generation over the live one; also
                    # drops its device corpus cache so the card's memory
                    # frees as soon as in-flight queries finish.
                    old.detach()
                self.collection = new
                self._collection_source = (db, name)
            carried_flushed = True
            if carried:
                try:
                    new.flush()  # outside _collection_lock: disk I/O
                except Exception as e:
                    # The swap already happened and the carried rows are
                    # live in the new generation's memory — a failed
                    # persist must not turn a successful reload into an
                    # error reply. The rows stay pending (autoflush=False
                    # collection); the next write-back unpin flush or
                    # reload retries them. Loud + counted, flagged below.
                    carried_flushed = False
                    self._count("errors")
                    print(f"serve: carried-rows flush failed: {e}",
                          file=sys.stderr)
            with self._corpus_lock:
                # new object, new identity — but drop the old corpus
                # tensor eagerly rather than at the next session start
                self._corpus_cache = None
            return {"ok": True, "db": db, "collection": name,
                    "profile_mismatch": profile_mismatch,
                    "rows": new.count(),
                    "previous_rows": (old.count() if old is not None
                                      else None),
                    "carried_pending": carried,
                    "carried_flushed": carried_flushed,
                    "sharded": self._shard_mesh is not None}

    def _reload_weights(self, req) -> dict:
        """Restore scorer stacks from disk again and swap them in for NEW
        sessions (the module docstring's "Hot weight reload").

        Every selected stack is restored before any is swapped: a stack
        that fails to restore makes the op an error reply with every old
        stack still serving. Active scoring sessions hold their stack and
        keep their generation either way."""
        ckpt = req.get("ckpt")
        s1 = req.get("stage1_run_id")
        s2 = req.get("stage2_run_id")
        dim_keys = ("chunk_size", "k_sim", "k_contrast", "k_temporal")
        if (any(req.get(k) is not None for k in dim_keys)
                and not (ckpt and s1 and s2)):
            # the dims only describe a preload target; without the full
            # id triple they would be dropped silently
            raise ValueError(
                "chunk_size/k_sim/k_contrast/k_temporal only apply when "
                "ckpt, stage1_run_id and stage2_run_id are all given "
                "(they parameterize the preload target, not a filter)")
        with self._weights_lock:
            keys = list(self._scorer_stacks)
        if ckpt and s1 and s2:
            # a full target preloads a stack no session has asked for yet
            def num(k, default):
                v = req.get(k)
                return default if v is None else int(v)

            target = (str(ckpt), str(s1), str(s2), num("chunk_size", 8),
                      num("k_sim", 8), num("k_contrast", 8),
                      num("k_temporal", 4))
            if target not in keys:
                keys.append(target)
        selected = [k for k in keys
                    if (not ckpt or k[0] == str(ckpt))
                    and (not s1 or k[1] == str(s1))
                    and (not s2 or k[2] == str(s2))]
        if not selected:
            raise ValueError(
                "reload_weights matched no scorer stacks — none are "
                "cached yet (no scoring session has run); pass ckpt, "
                "stage1_run_id and stage2_run_id together to preload one")
        # ScoringUnavailable (a ValueError) becomes an error reply before
        # anything is swapped
        fresh = {k: self._load_stack(k) for k in selected}
        with self._weights_lock:
            self._weights_generation += 1
            gen = self._weights_generation
            for k, stack in fresh.items():
                self._scorer_stacks[k] = (gen, stack)
        with self._stats_lock:
            # only scoring sessions hold a weight stack
            pinned = self._stats["segment"]["scoring_active"]
        return {"ok": True, "generation": gen,
                "reloaded": [{"ckpt": k[0], "stage1_run_id": k[1],
                              "stage2_run_id": k[2], "chunk_size": k[3],
                              "k_sim": k[4], "k_contrast": k[5],
                              "k_temporal": k[6]} for k in selected],
                "active_sessions_pinned": pinned}

    def _connection_closed(self, session) -> None:
        """Called by the socket handler when a connection ends. A still-
        open segment session dies with it (state is per-connection) —
        account it so the active gauge can't leak upward forever."""
        if session.get("segment") is not None:
            session.pop("segment", None)
            if session.pop("segment_score", None) is not None:
                self._count("segment", "scoring_active", n=-1)
            self._unpin_write_back(session)
            self._count("segment", "sessions_abandoned")
            self._count("segment", "sessions_active", n=-1)

    def handle(self, req: dict, session: dict | None = None) -> dict:
        if session is None:
            session = {}
        op = req.get("op")
        self._count("requests", str(op))
        if op == "stats":
            with self._weights_lock:
                wgen = self._weights_generation
                n_stacks = len(self._scorer_stacks)
            with self._stats_lock:
                snap = {"requests": dict(self._stats["requests"]),
                        "errors": self._stats["errors"],
                        "frames_embedded": self._stats["frames_embedded"],
                        "segment": dict(self._stats["segment"])}
            return {"ok": True,
                    "uptime_s": round(time.time() - self._started, 3),
                    **snap,
                    "device_batches": (self._coalescer.batches_run
                                       if self._coalescer else None),
                    "collection": getattr(self.collection, "name", None),
                    "engine_profile": self.engine_profile,
                    "weights_generation": wgen,
                    "scorer_stacks": n_stacks,
                    "sharded": self._shard_mesh is not None,
                    "batch_size": self.engine.batch_size,
                    "out_dim": self.engine.out_dim}
        if op == "segment_start":
            return self._segment_start(req, session)
        if op == "segment_push":
            return self._segment_push(req, session)
        if op == "segment_finish":
            return self._segment_finish(session)
        if op == "ping":
            return {"ok": True, "batch_size": self.engine.batch_size,
                    "out_dim": self.engine.out_dim,
                    "engine_profile": self.engine_profile,
                    "collection": getattr(self.collection, "name", None)}
        if op == "reload":
            return self._reload(req)
        if op == "reload_weights":
            return self._reload_weights(req)
        if op == "embed":
            emb = self._embed_request(req)
            if req.get("_reply_binary"):
                # Raw f32 payload instead of ~6x-larger JSON number text
                # (the socket layer packs '_np' into the binary frame).
                return {"ok": True, "_np": emb}
            return {"ok": True, "embeddings": emb.tolist()}
        if op == "query":
            if self.collection is None:
                raise ValueError("server started without a collection")
            if "embeddings" in req:
                q = np.asarray(req["embeddings"], np.float32)
            else:
                q = self._embed_request(req)
            # Under the device lock: the query's top-k matmul is device
            # work too, and the documented contract is that device work
            # from concurrent clients is serialized.
            with self._device():
                res = self.collection.query(
                    q, n_results=int(req.get("n_results", 5)),
                    where=req.get("where"),
                    include=("metadatas", "distances"))
            return {"ok": True, "ids": res["ids"],
                    "distances": res["distances"],
                    "metadatas": res["metadatas"]}
        if op == "shutdown":
            # The connection handler stops the server AFTER flushing this
            # response, so the client always sees the acknowledgement.
            return {"ok": True, "stopping": True}
        raise ValueError(f"unknown op {op!r}")

    # ---- socket plumbing ---------------------------------------------------

    def serve(self, socket_path: str, *, ready_event=None) -> None:
        """Blocking serve loop (call :meth:`stop` or send ``shutdown``)."""
        handler_self = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                session: dict = {}  # per-connection state (segment ops)
                try:
                    while True:
                        first = self.rfile.read(1)
                        if not first:
                            return
                        binary = first == BIN_MAGIC[:1]
                        try:
                            if binary:
                                # Framing errors (_ProtocolError) mean the
                                # stream position is untrustworthy: reply
                                # once and CLOSE. Anything raised after the
                                # frame is fully consumed is a request
                                # error — reply and keep the connection.
                                second = _read_exact(self.rfile, 1)
                                if second != BIN_MAGIC[1:]:
                                    raise _ProtocolError(
                                        "bad binary magic byte 2")
                                req, payload = read_binary_frame_body(
                                    self.rfile)
                                bin_desc = req.pop("bin", None)
                                if bin_desc is not None or payload:
                                    req["frames_np"] = frames_from_binary(
                                        bin_desc or {}, payload,
                                        handler_self.engine.spec)
                                req["_reply_binary"] = True
                            else:
                                line = first + self.rfile.readline()
                                if not line.strip():
                                    continue
                                req = json.loads(line)
                                if isinstance(req, dict):
                                    # reserved transport-internal keys —
                                    # not settable from the JSON wire
                                    req.pop("frames_np", None)
                                    req.pop("_reply_binary", None)
                                    req.pop("_np", None)
                            resp = handler_self.handle(req, session)
                        except _ProtocolError as e:
                            handler_self._count("errors")
                            err = {"ok": False, "error": str(e),
                                   "closing": True}
                            self.wfile.write(_encode_binary_reply(err)
                                             if binary else
                                             (json.dumps(err) + "\n")
                                             .encode())
                            self.wfile.flush()
                            return
                        except Exception as e:  # keep the connection alive
                            handler_self._count("errors")
                            resp = {"ok": False, "error": str(e)}
                        # Reply in the framing the request arrived in.
                        self.wfile.write(_encode_binary_reply(resp)
                                         if binary else
                                         (json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                        if resp.get("stopping"):
                            # Response is on the wire; now stop.
                            # shutdown() is safe here: handlers run on
                            # their own threads, not the serve_forever
                            # thread.
                            handler_self.stop()
                            return
                finally:
                    # an open segment session dies with its connection
                    handler_self._connection_closed(session)

        _reclaim_socket_path(socket_path)
        self._server = _UnixServer(socket_path, Handler)
        if ready_event is not None:
            ready_event.set()
        try:
            self._server.serve_forever(poll_interval=0.1)
        finally:
            self._server.server_close()
            # Quiesce the device BEFORE returning: handler threads are
            # daemonic, so once this method returns the CLI process can
            # exit — with a handler mid-forward. stop() set _stopping, so
            # acquiring the device lock once is a full barrier: the op
            # currently on the device finishes, every queued acquirer
            # wakes into the _device() refusal, and nothing new starts.
            self._stopping = True  # also covers serve_forever raising
            if self._coalescer is not None:
                self._coalescer.close()  # joins the worker (drains queue)
            with self._lock:
                if self.engine.device.type == "cuda":
                    torch.cuda.synchronize(self.engine.device)
            if os.path.exists(socket_path):
                os.unlink(socket_path)

    def stop(self):
        self._stopping = True  # _device() now refuses new device work
        if self._server is not None:
            self._server.shutdown()
        if self._coalescer is not None:
            self._coalescer.close()


class _UnixServer(socketserver.ThreadingUnixStreamServer):
    """Shared server config for the daemon and its warming placeholder.

    Default backlog is 5: a burst of concurrent clients on a busy host
    overflows it and their connect() fails with EAGAIN (unix sockets
    don't queue past the backlog)."""
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128


def _reclaim_socket_path(socket_path: str) -> None:
    """Unlink ``socket_path`` only if no live server answers on it: if
    something still accepts, binding here would silently orphan that
    daemon (warm engine and all) with no error anywhere."""
    if not os.path.exists(socket_path):
        return
    probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        probe.settimeout(1.0)
        probe.connect(socket_path)
    except OSError:
        os.unlink(socket_path)  # stale socket from a dead server
    else:
        raise RuntimeError(f"a live server already owns {socket_path}")
    finally:
        probe.close()


class WarmingServer:
    """Placeholder listener bound on the daemon socket while the real
    engine initializes.

    Why: `cli serve` builds its engine (and, with ``--warmup``, the CUDA
    kernel library and one batch) BEFORE it can serve; without a socket
    during that time an operator could not tell "daemon initializing, be
    patient" from "daemon dead". This listener answers immediately:
    ``ping``/``stats`` get ``{"ok": true, "warming": true, "ready":
    false, "phase": ..., "elapsed_s": ...}``; every other JSON op gets a
    ``warming_up`` error telling the caller to retry; a binary-framed
    request gets its connection closed (EOF — the binary protocol has no
    out-of-band error channel this early).

    Usage (cmd_serve)::

        warm = WarmingServer(socket_path)     # binds + serves in a thread
        warm.phase = "engine build"           # update as startup advances
        ...build engine...
        warm.close()                          # unbinds; then EmbedServer
        server.serve(socket_path)             # binds the same path

    There is a sub-second window between ``close()`` and the real bind
    where connects fail with FileNotFoundError; pollers should treat
    that as "still starting" until the ping reply loses ``warming``."""

    def __init__(self, socket_path: str):
        self.phase = "starting"
        #: set when a client sent ``shutdown`` while warming: the engine
        #: build cannot be aborted mid-call, but cmd_serve checks this
        #: between startup phases and exits instead of serving — without
        #: it a warming daemon would be un-stoppable except by kill.
        self.shutdown_requested = False
        self._t0 = time.monotonic()
        self._closed = False
        # live handler connections: close() severs them, or a
        # persistent-connection poller would keep getting 'warming'
        # answers from this placeholder FOREVER after the real server
        # takes over (stopping a socketserver listener leaves its
        # handler threads serving established sockets).
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def setup(self):
                super().setup()
                with outer._conns_lock:
                    outer._conns.add(self.connection)

            def finish(self):
                with outer._conns_lock:
                    outer._conns.discard(self.connection)
                super().finish()

            def handle(self):
                try:
                    while True:
                        if outer._closed:
                            return
                        first = self.rfile.read(1)
                        if not first or outer._closed:
                            return
                        if first == BIN_MAGIC[:1]:
                            return  # binary client: close -> EOF error
                        line = first + self.rfile.readline()
                        try:
                            req = json.loads(line)
                            op = (req or {}).get("op")
                        except (ValueError, AttributeError):
                            op = None
                        elapsed = round(time.monotonic() - outer._t0, 1)
                        if op in ("ping", "stats"):
                            resp = {"ok": True, "warming": True,
                                    "ready": False, "phase": outer.phase,
                                    "elapsed_s": elapsed}
                        elif op == "shutdown":
                            outer.shutdown_requested = True
                            resp = {"ok": True, "warming": True,
                                    "note": ("shutdown queued: the "
                                             "daemon exits at the next "
                                             "startup-phase boundary "
                                             "(an in-flight engine "
                                             "build cannot be "
                                             "interrupted safely)")}
                        else:
                            resp = {"ok": False, "warming": True,
                                    "error": (
                                        "daemon warming up "
                                        f"({outer.phase}, {elapsed}s in);"
                                        " poll ping until it stops "
                                        "reporting warming, then retry")}
                        self.wfile.write(
                            (json.dumps(resp) + "\n").encode())
                        self.wfile.flush()
                except OSError:
                    pass

        _reclaim_socket_path(socket_path)
        self._socket_path = socket_path
        self._server = _UnixServer(socket_path, Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1}, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop answering, sever established connections, and release
        the socket path for the real server's bind. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(5.0)
        try:
            os.unlink(self._socket_path)
        except OSError:
            pass


def _connect_with_retry(s, socket_path: str, timeout: float) -> None:
    """connect() to a unix socket returns EAGAIN when the server's accept
    backlog is momentarily full (there is no client-side queueing past
    it); retry with backoff until the deadline instead of surfacing a
    transient as a hard failure."""
    deadline = time.monotonic() + timeout
    delay = 0.01
    while True:
        try:
            s.connect(socket_path)
            return
        except (BlockingIOError, InterruptedError):
            if time.monotonic() + delay > deadline:
                raise
            time.sleep(delay)
            delay = min(delay * 2, 0.25)


class SessionClient:
    """Persistent-connection client. Required for stateful segment
    sessions (their state lives and dies with the connection); also
    cheaper than :func:`request` for bursts of stateless calls."""

    def __init__(self, socket_path: str, timeout: float = 60.0):
        _require_socket(socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout)
        _connect_with_retry(self._sock, socket_path, timeout)
        self._buf = b""
        self._dead = False

    def request(self, req: dict) -> dict:
        if self._dead:
            raise ConnectionError(
                "SessionClient is closed/poisoned — a previous request "
                "failed mid-flight (e.g. timed out), so the next bytes "
                "on this socket may be a STALE response; open a new "
                "client instead of desynchronizing the stream")
        # Serialize OUTSIDE the poison path: a json TypeError here means
        # nothing hit the wire, so the stream is still in sync and the
        # session must survive the caller's bad argument.
        payload = (json.dumps(req) + "\n").encode()
        try:
            self._sock.sendall(payload)
            while b"\n" not in self._buf:
                chunk = self._sock.recv(1 << 20)
                if not chunk:
                    raise ConnectionError(
                        "server closed the connection mid-session")
                self._buf += chunk
        except BrokenPipeError as e:
            # never let a SOCKET pipe error surface as BrokenPipeError:
            # cli.main treats BrokenPipeError as "stdout closed by
            # `| head`" and exits quietly — a dead daemon must stay a
            # loud ConnectionError (base class, so except ConnectionError
            # / OSError callers behave the same)
            self.close()
            raise ConnectionError(f"daemon connection broken: {e}") from e
        except Exception:
            self.close()
            raise
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)

    def request_binary(self, req: dict, frames=None, jpegs=None) -> dict:
        """Binary-framed request (see the module docstring's protocol
        section). ``frames``: a (N, H, W, 3) uint8 array shipped raw;
        ``jpegs``: a list of encoded image byte strings. A bulk reply
        payload comes back as a float32 ``np.ndarray`` under
        ``"embeddings"`` instead of JSON number text."""
        if self._dead:
            raise ConnectionError(
                "SessionClient is closed/poisoned — open a new client")
        header = dict(req)
        if frames is not None:
            arr = np.asarray(frames)
            if arr.dtype != np.uint8 or arr.ndim != 4 or arr.shape[-1] != 3:
                raise ValueError(
                    f"frames must be (N,H,W,3) uint8, got "
                    f"{arr.dtype} {arr.shape}")
            header["bin"] = {"kind": "raw_u8", "shape": list(arr.shape)}
            payload = np.ascontiguousarray(arr).tobytes()
        elif jpegs is not None:
            jpegs = [bytes(b) for b in jpegs]
            header["bin"] = {"kind": "jpeg",
                             "sizes": [len(b) for b in jpegs]}
            payload = b"".join(jpegs)
        else:
            payload = b""
        data = pack_binary_frame(header, payload)
        try:
            self._sock.sendall(data)
            magic = self._read_exact(2)
            if magic != BIN_MAGIC:
                raise ConnectionError(
                    f"expected a binary reply frame, got {magic!r}")
            hlen = int.from_bytes(self._read_exact(4), "little")
            plen = int.from_bytes(self._read_exact(8), "little")
            resp = json.loads(self._read_exact(hlen))
            body = self._read_exact(plen)
        except BrokenPipeError as e:
            self.close()
            raise ConnectionError(f"daemon connection broken: {e}") from e
        except Exception:
            self.close()
            raise
        bin_desc = resp.pop("bin", None)
        if bin_desc is not None:
            if bin_desc.get("kind") != "f32":
                raise ValueError(f"unknown reply payload kind {bin_desc!r}")
            resp["embeddings"] = np.frombuffer(body, "<f4").reshape(
                [int(s) for s in bin_desc["shape"]])
        return resp

    def _read_exact(self, n: int) -> bytes:
        # bytearray accumulator: `bytes +=` on an attribute re-copies the
        # whole buffer per recv — O(n^2) on exactly the multi-MB payloads
        # the binary transport exists for.
        buf = bytearray(self._buf)
        while len(buf) < n:
            chunk = self._sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError(
                    "server closed the connection mid-session")
            buf += chunk
        out, self._buf = bytes(buf[:n]), bytes(buf[n:])
        return out

    def close(self) -> None:
        self._dead = True
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _require_socket(socket_path: str) -> None:
    """Friendly early error for a missing daemon socket (shared by both
    clients — the raw connect() ENOENT is indistinguishable from a dead
    daemon otherwise). FileNotFoundError is an OSError, so existing
    ``except OSError`` callers behave the same."""
    if not os.path.exists(socket_path):
        raise FileNotFoundError(
            f"no daemon socket at {socket_path!r} (start one with: "
            "python -m vit_research_tpu_torch.cli serve --socket ...)")


def request(socket_path: str, req: dict, timeout: float = 60.0) -> dict:
    """One-shot client: send a request object, return the response."""
    _require_socket(socket_path)
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(timeout)
            _connect_with_retry(s, socket_path, timeout)
            s.sendall((json.dumps(req) + "\n").encode())
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(1 << 20)
                if not chunk:
                    if not buf:
                        raise ConnectionError(
                            "server closed the connection without replying")
                    break
                buf += chunk
    except BrokenPipeError as e:
        # see SessionClient.request: socket pipe errors must not be
        # mistaken for a closed stdout by cli.main's quiet-exit handler
        raise ConnectionError(f"daemon connection broken: {e}") from e
    return json.loads(buf)


def request_binary(socket_path: str, req: dict, frames=None, jpegs=None,
                   timeout: float = 60.0) -> dict:
    """One-shot binary-framed request (see SessionClient.request_binary)."""
    with SessionClient(socket_path, timeout=timeout) as client:
        return client.request_binary(req, frames=frames, jpegs=jpegs)
