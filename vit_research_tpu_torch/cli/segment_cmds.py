"""Segmentation arc: segment (offline / --follow / --socket),
tune-segment, the follow backends (local engine vs serve daemon), and the
labelling and clip-curation verbs self-label, finalize-clips, merge-clips,
clustering and fresh-test.

Port of vit_research_tpu/cli/segment_cmds.py with the reference's
arguments plus ``--device``, the fast profile's strided embedding
(``--frame-stride``, ``--stride-refine[-radius]``, ``--event-template``,
``--force-stride``) and live event scoring (``--score-events`` with its
``--score-*``, ``--stage*-run-id``, ``--chunk-*``, ``--k-*`` and
``--future-step`` flags: offline from the written clip dirs, in-process
with ``--follow``, and through the daemon's session with ``--follow
--socket``) included. ``--method temporal``, the reference's default,
trains the TemporalHead on the game's manual intervals (``--manual-csv``,
``--epochs``) on ``--device`` and caches it as ``temporal_head.npz`` in
``--out``.
"""

from __future__ import annotations

import json
import os
import sys

from vit_research_tpu_torch.cli import common


def _load_transitions(path):
    """Read a (3, 3) HMM transition matrix from JSON: either a bare
    nested list, or a ``tune-segment`` output dict (uses its
    ``best_transition_matrix``)."""
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
    """Frames -> possession clips. ``--method temporal`` (the default) is
    the reference's modern path: a TemporalHead CNN trained on the game's
    manual intervals, then the HMM (nba_proj/smarter_generate_clips.py:
    349-423). The other two rank against a labelled frame collection
    (--db/--corpus-collection, built by write-frame-db): ``--method
    knn-hmm`` is the kNN-vote + Viterbi path
    (nba_proj/generate_clips_hmm.py:367-490), offline or live
    (``--follow``, in this process or through a serve daemon with
    ``--socket``); ``--method streaks`` the pre-HMM sliding-window
    classifier (nba_proj/generate_clips.py:99-368, also writes
    clip_intervals.csv). Both take optional confident write-back and
    ``--score-events``: a make/miss eval row for every clip."""
    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.segment.pipeline import (
        segment_with_knn_hmm, segment_with_knn_streaks,
        segment_with_temporal_head)

    # Validate method arguments BEFORE the engine spins up: embedding a
    # whole frames dir only to fail on a missing flag is hostile.
    refine_threshold = _check_stride_args(args)
    if args.socket:
        if not args.follow:
            raise SystemExit("--socket is the daemon-routed live mode: "
                             "it requires --follow (for offline scoring "
                             "against a daemon, use the daemon's query/"
                             "embed ops or run segment locally)")
        if args.method != "knn-hmm":
            raise SystemExit("--socket supports --method knn-hmm only "
                             "(the daemon's segment sessions)")
        if args.db or args.corpus_collection:
            raise SystemExit("--socket ranks against the DAEMON's "
                             "collection (cli serve --collection); drop "
                             "--db/--corpus-collection — scoring still "
                             "takes --score-db/--score-collection")
    if args.follow and args.method != "knn-hmm":
        raise SystemExit("--follow supports --method knn-hmm only")
    if args.transitions and args.method != "knn-hmm":
        raise SystemExit("--transitions applies to --method knn-hmm only "
                         "(the temporal/streaks paths don't take an HMM "
                         "transition override)")
    knn = args.method in ("knn-hmm", "streaks")
    if args.method == "temporal" and not args.manual_csv:
        raise SystemExit("--method temporal needs --manual-csv")
    if knn and not args.socket:
        if not (args.db and args.corpus_collection):
            raise SystemExit(f"--method {args.method} needs --db and "
                             "--corpus-collection (see write-frame-db)")
        client, col, corpus = common.load_corpus(
            args.db, args.corpus_collection, args.device)
        # rank with the collection's own metric on every surface (the
        # daemon's segment sessions already do)
        space = getattr(col, "space", "l2")
    transitions = (_load_transitions(args.transitions)
                   if args.transitions else None)
    if args.score_events and not (args.score_collection and args.score_ckpt
                                  and args.stage1_run_id
                                  and args.stage2_run_id
                                  and (args.score_db or args.db)):
        raise SystemExit(
            "--score-events needs --score-collection, --score-ckpt, "
            "--stage1-run-id and --stage2-run-id (the TRAINED runs to "
            "score with — without them the head would be random weights "
            "producing plausible-looking garbage), plus a retrieval "
            "store (--score-db, or --db when they share one); see "
            "eval-clips for the training pipeline")
    if args.score_events and (args.chunk_size < 1 or args.chunk_stride < 1):
        # build_chunks says the same, but only after the game's embed
        # (offline) or at the first clip (--follow)
        raise SystemExit("--score-events needs positive --chunk-size and "
                         "--chunk-stride")

    if args.follow:
        if args.socket:
            backend = _DaemonFollowBackend(args,
                                           transition_matrix=transitions)
        else:
            backend = _LocalFollowBackend(
                args, corpus, col if args.write_back else None,
                client if args.write_back else None,
                metric=space, transition_matrix=transitions)
        return _segment_follow(args, backend)

    os.makedirs(args.out, exist_ok=True)
    frames = naming.list_frames(args.frames)
    eng = common._engine(args.batch_size, args.device)
    # the scorer before the embed: a typo'd --score-collection or a
    # missing checkpoint fails here, not after the game's embed
    scorer = common._live_event_scorer(args, eng)
    frame_paths = [os.path.join(args.frames, f) for f in frames]
    if args.frame_stride > 1:
        embs = _embed_strided(args, eng, frame_paths, refine_threshold)
    else:
        embs = eng.embed_paths(frame_paths)
    if scorer is not None:
        # the clip dirs hold copies of these frames under the same names:
        # scoring reuses the embeddings instead of embedding them again
        scorer.remember(frame_paths, embs)
    if knn and args.write_back:
        # write-back upserts this engine's embeddings into the corpus: a
        # cross-profile write permanently mixes embedding spaces
        common._stamp_profile(col)
    if args.method == "temporal":
        from vit_research_tpu_torch.data.labels import ManualIntervals

        decoded, clip_dirs, _ = segment_with_temporal_head(
            frames, embs, ManualIntervals.from_csv(args.manual_csv),
            device=eng.device, out_root=args.out, src_dir=args.frames,
            vid=args.vid, epochs=args.epochs, min_len=args.min_len,
            pad=args.pad,
            params_path=os.path.join(args.out, "temporal_head.npz"))
    elif args.method == "streaks":
        decoded, clip_dirs, _ = segment_with_knn_streaks(
            frames, embs, corpus, device=eng.device, out_root=args.out,
            src_dir=args.frames, vid=args.vid, k=args.k,
            confidence_threshold=args.confidence_threshold,
            window=args.window, min_len=args.min_len, pad=args.pad,
            collection=col if args.write_back else None, metric=space,
            intervals_csv=os.path.join(args.out, "clip_intervals.csv"))
    else:
        decoded, clip_dirs, _ = segment_with_knn_hmm(
            frames, embs, corpus, device=eng.device, out_root=args.out,
            src_dir=args.frames, vid=args.vid, k=args.k,
            confidence_threshold=args.confidence_threshold,
            min_len=args.min_len, pad=args.pad, metric=space,
            collection=col if args.write_back else None,
            transition_matrix=transitions)
    if knn and args.write_back:
        client.flush()
    print(f"decoded {len(decoded)} frames -> {len(clip_dirs)} clips")

    if scorer is not None:
        from vit_research_tpu_torch.evaluate.clip_sequences import \
            save_results

        rows = []
        for cdir in clip_dirs:
            row = common._score_clip_dir(scorer, cdir)
            if row is None:
                print(f"{os.path.basename(cdir)}: too short to chunk "
                      f"(< {scorer.chunk_size} frames) — not scored")
                continue
            print(common._event_row_summary(row))
            rows.append(row)
        save_results(rows, os.path.join(args.out, "events.json"),
                     os.path.join(args.out, "events.csv"))
        print(f"scored {len(rows)}/{len(clip_dirs)} clips -> "
              f"{os.path.join(args.out, 'events.json')} "
              "(score with: score-events)")


def _check_stride_args(args):
    """The strided-embedding flags' checks, before any engine starts;
    returns the refine threshold (None: no refinement)."""
    if args.frame_stride < 1:
        raise SystemExit("--frame-stride must be >= 1")
    if args.frame_stride > 1 and args.follow:
        # the follow loop embeds incrementally as frames appear; a
        # silent ignore would report full-rate cost as strided
        raise SystemExit("--frame-stride applies to offline runs only "
                         "(--follow embeds incrementally)")
    if args.frame_stride > 1 and args.write_back:
        # interpolated rows are not embeddings: upserting them as
        # confident corpus rows would contaminate every later run
        raise SystemExit(
            "--frame-stride cannot combine with --write-back: N-1 of "
            "every N rows are interpolations, not embeddings, and "
            "write-back would persist them into the corpus")
    refine_threshold = None
    if args.stride_refine_radius < 0:
        raise SystemExit("--stride-refine-radius must be >= 0")
    if args.stride_refine_radius > 0 and args.stride_refine is None:
        # a silent ignore would report unrefined numbers as refined
        raise SystemExit("--stride-refine-radius only applies with "
                         "--stride-refine")
    if args.stride_refine is not None:
        if args.frame_stride <= 1:
            raise SystemExit("--stride-refine only applies with "
                             "--frame-stride > 1")
        if args.stride_refine == "auto":
            from vit_research_tpu_torch.parallel.embed import \
                REFINE_THRESHOLD_DEFAULT
            refine_threshold = REFINE_THRESHOLD_DEFAULT
        else:
            try:
                refine_threshold = float(args.stride_refine)
            except ValueError:
                raise SystemExit("--stride-refine takes 'auto' or a cosine-"
                                 f"distance float, got {args.stride_refine!r}")
            if not 0.0 <= refine_threshold <= 2.0:
                raise SystemExit("--stride-refine threshold must be in "
                                 "[0, 2] (cosine distance)")
    if args.event_template and args.frame_stride > 1:
        # stride <= the shortest event to localize: an event strictly
        # inside one stride gap touches no keyframe, so interpolation
        # smears it and the novelty gate cannot see it
        if not os.path.exists(args.event_template):
            raise SystemExit(
                f"--event-template {args.event_template!r}: file not found")
        from vit_research_tpu_torch.data.labels import load_event_template
        from vit_research_tpu_torch.evaluate.event_scoring import \
            min_event_span
        span = min_event_span(load_event_template(args.event_template))
        if span is not None and args.frame_stride > span:
            msg = (f"--frame-stride {args.frame_stride} exceeds the "
                   f"shortest labeled event in {args.event_template} "
                   f"({span} frame{'s' if span != 1 else ''}): an event "
                   "that fits strictly inside one stride gap touches no "
                   "keyframe, so it is invisible to interpolation AND to "
                   "--stride-refine; use a stride <= the shortest event")
            if args.force_stride:
                print(f"WARNING: {msg} (--force-stride given; "
                      "sub-stride events WILL be missed)",
                      file=sys.stderr, flush=True)
            else:
                raise SystemExit(
                    msg + " (or pass --force-stride to run anyway)")
    return refine_threshold


def _embed_strided(args, eng, frame_paths, refine_threshold):
    """The fast profile's embedding: every ``--frame-stride``-th frame
    exactly, the rest interpolated (parallel/embed.py::
    embed_video_strided), with the refinement's cost reported."""
    from vit_research_tpu_torch.parallel.embed import embed_video_strided

    stats: dict = {}
    embs = embed_video_strided(eng, frame_paths, stride=args.frame_stride,
                               refine_threshold=refine_threshold,
                               refine_radius=args.stride_refine_radius,
                               stats=stats)
    if refine_threshold is not None:
        print(f"stride-refine: {stats.get('refined_gaps', 0)}/"
              f"{stats.get('gaps', 0)} gaps hot "
              f"({stats.get('refined_frames', 0)} frames "
              f"re-embedded exactly; novelty p50 "
              f"{stats.get('novelty_p50', 0.0):.4f} max "
              f"{stats.get('novelty_max', 0.0):.4f})")
        n_exact = stats.get("keys", 0) + stats.get("refined_frames", 0)
        if n_exact > 0.6 * max(len(frame_paths), 1):
            # past ~60% exact frames the two passes cost about as much as
            # embedding every frame once
            print(f"NOTE: refinement embedded {n_exact}/"
                  f"{len(frame_paths)} frames exactly — at this "
                  "hot-gap density the two-pass refined stride costs "
                  "about as much as (or more than) full-rate "
                  "embedding; drop --frame-stride for this content",
                  file=sys.stderr, flush=True)
    return embs


class _LocalFollowBackend:
    """--follow in-process: own engine + KnnHmmStreamSession (+ scorer).
    Clips are scored from their just-written dirs, with the stream's
    embeddings from the scorer's LRU."""

    def __init__(self, args, corpus, collection, client, *,
                 metric: str = "l2", transition_matrix=None):
        from vit_research_tpu_torch.segment.pipeline import \
            KnnHmmStreamSession

        self.eng = common._engine(args.batch_size, args.device)
        if collection is not None:
            # --write-back: refuse cross-profile corpus writes outright
            # (reads already warned in common.load_corpus)
            common._stamp_profile(collection)
        self._client = client
        # a bounded LRU: a followed game grows without limit, but its
        # clips are recent (fixed-lag commits); 16,384 frames cover any
        # possession, and evicted frames are embedded again on a miss
        self.scorer = common._live_event_scorer(args, self.eng,
                                                emb_cache_cap=16384)
        self.scoring = self.scorer is not None
        self.session = KnnHmmStreamSession(
            corpus, device=self.eng.device, k=args.k,
            confidence_threshold=args.confidence_threshold,
            min_len=args.min_len, pad=args.pad, max_lag=args.max_lag,
            drain_every=8, collection=collection, vid=args.vid,
            metric=metric, transition_matrix=transition_matrix)

    def push(self, names, paths):
        """(clip intervals that became final with this chunk, None): local
        clips are scored later, from the written dir (score_dir)."""
        # prefetch=0: each call is a single <=batch_size chunk, so a
        # producer thread can't overlap anything — it would just add
        # a thread spawn + queue per poll on a 200k-frame session
        embs = self.eng.embed_paths(paths, prefetch=0)
        if self.scorer is not None:
            self.scorer.remember(names, embs)
        return self.session.push_batch(names, embs), None

    def finish(self):
        clips = self.session.finish()
        if self._client is not None:
            self._client.flush()
        return clips, None, self.session.forced

    def score_dir(self, clip_dir):
        return common._score_clip_dir(self.scorer, clip_dir)


class _DaemonFollowBackend:
    """--follow --socket: a running ``cli serve`` daemon owns the warm
    engine, the corpus collection and (with --score-events) the scoring
    stack; this process only tails the frames dir, pushes paths over the
    unix socket and writes clip dirs and event rows from the replies. N
    games can follow concurrently against ONE card — the daemon
    serializes device work and micro-batches concurrent embeds
    (serve.py), where N local --follow loops would each need their own
    engine.

    Resilience: daemon session state is CONNECTION-scoped, so a dropped
    connection (or a daemon restart) loses the lattice — but this
    backend records every successful push and, on ConnectionError,
    reconnects (waiting up to ``RECONNECT_DEADLINE_S`` for the socket
    to come back), opens a fresh session and REPLAYS the history. The
    replay is deterministic, so already-returned clips re-emerge
    identically and are skipped by count; the game continues mid-stream
    instead of dying with the connection. --write-back sessions cannot
    replay (their corpus grew mid-game, shifting the decode) and a
    failure DURING replay poisons the backend — both fail loudly rather
    than continue on misaligned state."""

    RECONNECT_DEADLINE_S = 120.0
    #: how long a FIRST connect waits out a warming daemon (serve.py
    #: WarmingServer: engine build, and with --warmup the kernel build
    #: and one batch); reconnects mid-game keep the 120 s budget.
    WARMING_DEADLINE_S = 2400.0

    def __init__(self, args, transition_matrix=None):
        self._args = args
        self._transitions = (None if transition_matrix is None else
                             [[float(x) for x in row]
                              for row in transition_matrix])
        self._history: list[list[str]] = []  # successful pushes (paths)
        self._clips_returned = 0
        self._poisoned: str | None = None
        self.client = None
        self._connect(first=True)

    def _connect(self, *, first: bool) -> None:
        from vit_research_tpu_torch.serve import SessionClient

        args = self._args
        try:
            # generous timeout: a push of a full batch waits behind other
            # clients' device work on a shared daemon
            self.client = SessionClient(args.socket, timeout=600.0)
        except FileNotFoundError as e:
            if first:  # operator error, not a flap: clean exit
                raise SystemExit(str(e))
            raise
        req = {"op": "segment_start", "k": args.k,
               "confidence_threshold": args.confidence_threshold,
               "min_len": args.min_len, "pad": args.pad,
               "max_lag": args.max_lag,
               "write_back": bool(args.write_back), "vid": args.vid}
        if self._transitions is not None:
            req["transitions"] = self._transitions
        if args.score_events:
            # the local scorer's configuration, checked daemon-side (a bad
            # run is an error reply); paths absolute, like the frames',
            # as the daemon's working directory is not the user's
            req["score_events"] = {
                "ckpt": os.path.abspath(args.score_ckpt),
                "stage1_run_id": args.stage1_run_id,
                "stage2_run_id": args.stage2_run_id,
                "db": os.path.abspath(args.score_db or args.db),
                "collection": args.score_collection,
                "chunk_size": args.chunk_size,
                "chunk_stride": args.chunk_stride,
                "k_sim": args.k_sim, "k_contrast": args.k_contrast,
                "k_temporal": args.k_temporal,
                "future_step": args.future_step,
                "emb_cache_cap": 16384}
        wait_s = (self.WARMING_DEADLINE_S if first
                  else self.RECONNECT_DEADLINE_S)
        try:
            try:
                resp = self.client.request(req)
            except (OSError, ConnectionError):
                # the warming->ready swap severs established connections
                # (WarmingServer.close) — possibly mid-first-request;
                # ride through it like any other warming signal
                resp = self._await_ready_and_retry(req, wait_s)
            if not resp.get("ok") and resp.get("warming"):
                # The daemon answered from its warming placeholder: that
                # is patience, not refusal — poll until the real server
                # takes over instead of failing the session.
                resp = self._await_ready_and_retry(req, wait_s)
        except TimeoutError as e:
            if first:
                raise SystemExit(str(e))
            raise  # TimeoutError is an OSError: reconnect loops retry it
        if not resp.get("ok"):
            # only the FIRST connect turns a refusal into a clean exit
            # (bad user config); a refusal after a reconnect is a
            # changed daemon — surface it loudly
            err = f"daemon refused the segment session: {resp.get('error')}"
            if first:
                raise SystemExit(err)
            raise RuntimeError(err)
        self.scoring = bool(resp.get("scoring"))

    def _await_ready_and_retry(self, req, deadline_s: float) -> dict:
        """Poll a WARMING daemon until the real server takes over, then
        retry the session start. The warming->ready swap severs
        established connections (serve.py WarmingServer.close), so a
        dropped connection here means progress, not failure — reopen
        and retry immediately. Two independent bounds raise
        :class:`TimeoutError` (an OSError, so reconnect loops treat it
        as a flap): ``deadline_s`` on total warming patience, and the
        reconnect deadline on time WITHOUT any answer at all — a daemon
        that died mid-warming must not consume the full warming budget
        before the caller hears about it."""
        import time as time_mod

        from vit_research_tpu_torch.serve import SessionClient

        t0 = time_mod.monotonic()
        deadline = t0 + deadline_s
        last_alive = t0
        while True:
            try:
                resp = self.client.request(req)
            except (OSError, ConnectionError):
                try:
                    self.client.close()
                except Exception:  # noqa: BLE001 - already broken
                    pass
                try:
                    self.client = SessionClient(self._args.socket,
                                                timeout=600.0)
                except (OSError, ConnectionError):
                    pass  # rebind gap, or the daemon died — bounded below
                else:
                    last_alive = time_mod.monotonic()
                    continue  # fresh connection: retry the request NOW
            else:
                last_alive = time_mod.monotonic()
                if resp.get("ok") or not resp.get("warming"):
                    return resp
            now = time_mod.monotonic()
            if now > deadline:
                raise TimeoutError(
                    f"daemon still warming up after {deadline_s:.0f}s; "
                    "retry once serve-ctl ping stops reporting warming")
            if now - last_alive > self.RECONNECT_DEADLINE_S:
                raise TimeoutError(
                    "daemon stopped answering while warming (no live "
                    f"socket for {self.RECONNECT_DEADLINE_S:.0f}s)")
            time_mod.sleep(1.0)

    @staticmethod
    def _ivs(clips):
        from vit_research_tpu_torch.segment.clips import ClipInterval

        return [ClipInterval(side=c["side"], start=int(c["start"]),
                             end=int(c["end"])) for c in clips]

    def _poison(self, why: str):
        """Refuse every further push: continuing on a partially-replayed
        session would silently misalign every later clip's global frame
        indices against the wrong frames."""
        self._poisoned = why
        return RuntimeError(f"daemon follow backend unrecoverable: {why} "
                            "— restart the follower")

    def _reconnect_and_replay(self, pending_paths):
        """New connection + session, replay the push history (and the
        interrupted push, when given); returns only the clips and events
        BEYOND those already returned to the follow loop. Any failure
        DURING the replay poisons the backend — a half-replayed session
        must never accept more pushes."""
        import time

        try:
            self.client.close()
        except Exception:  # noqa: BLE001 - already broken
            pass
        if self._args.write_back:
            # replay is only deterministic against the session's
            # start-time corpus; a write-back session grew the corpus
            # mid-game, so the reconnected decode could shift clip
            # boundaries and break the skip-by-count dedupe — refuse
            raise self._poison(
                "connection lost on a --write-back session (replay "
                "against the grown corpus is not deterministic)")
        print(f"WARNING: daemon connection lost after "
              f"{len(self._history)} pushes; reconnecting and replaying "
              "(session state is connection-scoped)", flush=True)
        deadline = time.monotonic() + self.RECONNECT_DEADLINE_S
        while True:
            try:
                self._connect(first=False)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise self._poison(
                        "daemon did not come back within "
                        f"{self.RECONNECT_DEADLINE_S:.0f}s")
                time.sleep(2.0)
        replay = self._history + (
            [pending_paths] if pending_paths is not None else [])
        all_clips, all_events = [], []
        for paths in replay:
            try:
                r = self.client.request({"op": "segment_push",
                                         "paths": paths})
            except Exception as e:  # noqa: BLE001 - poison, don't nest
                raise self._poison(f"replay failed mid-history: {e}")
            if not r.get("ok"):
                raise self._poison(
                    f"replay failed mid-history: {r.get('error')}")
            all_clips.extend(r["clips"])
            all_events.extend(r.get("events") or [])
        new_clips = all_clips[self._clips_returned:]
        new_events = (all_events[self._clips_returned:]
                      if self.scoring else None)
        self._clips_returned = len(all_clips)
        print(f"reconnected: replayed {len(replay)} pushes, "
              f"{len(new_clips)} new clip(s)", flush=True)
        return self._ivs(new_clips), new_events

    def push(self, names, paths):
        if self._poisoned:
            raise RuntimeError(
                f"daemon follow backend unrecoverable: {self._poisoned}")
        paths = [os.path.abspath(p) for p in paths]
        try:
            resp = self.client.request(
                {"op": "segment_push", "paths": paths})
        except OSError:
            # ConnectionError AND timeouts (a busy daemon past the 600s
            # recv window poisons the SessionClient the same way)
            clips, events = self._reconnect_and_replay(paths)
            self._history.append(paths)
            return clips, events
        if not resp.get("ok"):
            # surfaced like a local embed failure so the follow loop's
            # isolate/decode-retry logic applies unchanged (the daemon
            # embeds BEFORE advancing session state, so a failed push
            # consumed nothing)
            raise RuntimeError(f"daemon segment_push failed: "
                               f"{resp.get('error')}")
        self._history.append(paths)
        self._clips_returned += len(resp["clips"])
        return self._ivs(resp["clips"]), resp.get("events")

    def finish(self):
        if self._poisoned:
            raise RuntimeError(
                f"daemon follow backend unrecoverable: {self._poisoned}")
        pre_clips, pre_events = [], []
        try:
            resp = self.client.request({"op": "segment_finish"})
        except OSError:
            pre_clips, pre_events = self._reconnect_and_replay(None)
            pre_events = pre_events or []
            resp = self.client.request({"op": "segment_finish"})
        if not resp.get("ok"):
            raise SystemExit(
                f"daemon segment_finish failed: {resp.get('error')}")
        self.client.close()
        clips = pre_clips + self._ivs(resp["clips"])
        events = ((pre_events + (resp.get("events") or []))
                  if self.scoring else None)
        return clips, events, int(resp.get("forced", 0))


def _segment_follow(args, backend):
    """Live mode: tail --frames for newly arriving frames (increasing
    frame-number order — e.g. an ffmpeg dump in progress), feed them
    through the streaming kNN+HMM session, and write/announce each
    possession clip the moment its padded extent is final — mid-game,
    not after it. Stops after --idle-timeout seconds with no new
    frames, or when a file named STOP appears (drains everything on
    disk first). Robust to non-atomic writers: the highest-numbered
    frame is held back until a newer one appears (it may still be
    mid-write), a frame whose decode fails is retried on later polls
    (then skipped with a warning), and a frame that surfaces AFTER a
    higher-numbered one was consumed is dropped with a warning rather
    than corrupting the stream order the clip indices depend on. The
    reference's incremental loop (nba_proj/generate_clips_hmm.py:367-490)
    could only decode at the end.

    ``backend`` owns the embed+segment(+score) stack: in this process
    (:class:`_LocalFollowBackend`) or a shared daemon
    (:class:`_DaemonFollowBackend`). With --score-events every clip's
    eval row goes to ``events.jsonl`` under --out as the clip is
    written."""
    import shutil
    import time

    from vit_research_tpu_torch.data import naming

    os.makedirs(args.out, exist_ok=True)
    events_path = os.path.join(args.out, "events.jsonl")
    if backend.scoring:
        # one JSONL a session: a rerun into the same --out must not
        # append to the previous game's rows
        open(events_path, "w").close()
    consumed: list = []  # frame names in stream order
    seen: set = set()    # consumed or permanently skipped
    retries: dict = {}   # name -> failed decode attempts
    clip_count = 0
    event_count = 0
    last_num = -1        # highest consumed frame number

    def emit(clips, rows=None):
        nonlocal clip_count, event_count
        for j, iv in enumerate(clips):
            clip_count += 1
            cdir = os.path.join(
                args.out, naming.clip_dir_name(args.vid, clip_count,
                                               iv.side))
            os.makedirs(cdir, exist_ok=True)
            for f in consumed[iv.start: iv.end + 1]:
                src = os.path.join(args.frames, f)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(cdir, f))
            print(f"clip {clip_count}: {iv.side} frames "
                  f"{iv.start}..{iv.end} -> {cdir}", flush=True)
            if not backend.scoring:
                continue
            # score the possession the moment it is final: daemon rows
            # arrive with the clips, local clips score from the dir
            row = rows[j] if rows is not None else backend.score_dir(cdir)
            if row is None:
                print(f"  not scored: too short to chunk "
                      f"(< {args.chunk_size} frames)", flush=True)
                continue
            if "clip_key" not in row:  # the daemon's per-clip error row
                print(f"  WARNING: scoring failed: "
                      f"{row.get('error', row)}", flush=True)
                continue
            event_count += 1
            with open(events_path, "a") as fh:
                fh.write(json.dumps(row) + "\n")
            print(f"  {common._event_row_summary(row)}", flush=True)

    def scan_fresh():
        # os.scandir + seen-check BEFORE parsing: a 2-hour game leaves
        # ~200k consumed names; regex-parsing and sorting all of them
        # every poll would turn quadratic on the host.
        # is_canonical_frame_name (strict), NOT is_frame_name: the
        # tolerant parser accepts 'vid1_frame_5.jpg.part', so a lax
        # filter would race an atomic copy-then-rename writer (consume
        # the .part name, then drop the real frame as out-of-order).
        # Same-vid only: a dump dir shared across games must not leak
        # another video's frames into this stream's clip indices.
        fresh = []
        with os.scandir(args.frames) as it:
            for entry in it:
                f = entry.name
                if f in seen or not naming.is_canonical_frame_name(f):
                    continue
                if naming.parse_frame_name(f)[0] != args.vid:
                    continue
                fresh.append(f)
        fresh.sort(key=naming.frame_sort_key)
        return fresh

    def consume(chunk) -> bool:
        """Returns False when the stream must STALL at a not-yet-
        decodable frame — the caller must stop consuming this poll's
        later chunks too, or the held frame would come back
        'out-of-order' next poll and be dropped."""
        nonlocal last_num
        try:
            clips, rows = backend.push(
                chunk, [os.path.join(args.frames, f) for f in chunk])
        except Exception:
            if len(chunk) > 1:  # isolate the bad frame, preserve order
                for f in chunk:
                    if not consume([f]):
                        return False
                return True
            f = chunk[0]
            # Decode the frame alone to tell a bad FILE from a broken
            # ENGINE: if the bytes decode fine, the embed failure is
            # systemic (device down, out of memory) — re-raise instead of
            # silently skipping every frame and exiting 0 with
            # 'followed N frames -> 0 clips'.
            from vit_research_tpu_torch.data.preprocess import decode_image
            decoded_ok = False
            try:
                decode_image(os.path.join(args.frames, f))
                decoded_ok = True
            except Exception:
                pass
            if decoded_ok:
                raise
            retries[f] = retries.get(f, 0) + 1
            if retries[f] >= 3:
                seen.add(f)
                print(f"WARNING: skipping undecodable frame {f} "
                      f"after {retries[f]} attempts", flush=True)
                return True  # permanently skipped; stream continues
            return False  # likely still being written; retry next poll
        consumed.extend(chunk)
        seen.update(chunk)
        last_num = naming.frame_num(chunk[-1])
        emit(clips, rows)
        return True

    last_new = time.monotonic()
    while True:
        # STOP means "the producer is done": drain everything already
        # on disk, then finish — never abandon arrived frames.
        stopping = os.path.exists(os.path.join(args.frames, "STOP"))
        fresh = scan_fresh()
        late = [f for f in fresh if naming.frame_num(f) <= last_num]
        if late:
            seen.update(late)
            # remove by membership, not a prefix slice: robustness if
            # sort order and lateness ever disagree
            dropped = set(late)
            fresh = [f for f in fresh if f not in dropped]
            print(f"WARNING: dropping {len(late)} out-of-order "
                  f"frame(s) (<= already-consumed #{last_num}): "
                  f"{late[:3]}...", flush=True)
        idle = time.monotonic() - last_new > args.idle_timeout
        if fresh and not (stopping or idle):
            # the newest frame may still be mid-write; hold it back
            # until a newer name appears — on STOP or idle expiry it is
            # consumed rather than stranded (idle means it has been
            # stable on disk for the whole timeout)
            fresh = fresh[:-1]
        if not fresh:
            if stopping or idle:
                break
            time.sleep(args.poll_interval)
            continue
        last_new = time.monotonic()
        stalled = False
        for i in range(0, len(fresh), args.batch_size):
            if not consume(fresh[i: i + args.batch_size]):
                stalled = True
                break  # stalled at a mid-write frame; re-poll
        if stalled:
            # give the writer a real poll interval before the next
            # attempt — without this, the STOP-drain re-scans immediately
            # and burns all 3 decode retries back-to-back within
            # milliseconds, permanently skipping a frame that was merely
            # mid-write
            time.sleep(args.poll_interval)
    clips, rows, forced = backend.finish()
    emit(clips, rows)
    print(f"followed {len(consumed)} frames -> {clip_count} clips "
          f"({forced} forced commits)", flush=True)
    if backend.scoring:
        print(f"scored {event_count} clips live -> {events_path} "
              "(JSONL, one eval row per clip; score with: score-events)",
              flush=True)


def cmd_tune_segment(args):
    """Calibrate the kNN+HMM segmentation grid against manual intervals.

    The reference hand-tuned its HMM transitions, vote thresholds and
    streak/pad rules to one specific random-ViT feature space
    (nba_proj/hmm.py:10, nba_proj/generate_clips_hmm.py:58,155-165,262);
    any backbone change silently invalidates them. This embeds the
    frames once, runs ONE device top-k at the largest k, sweeps the
    cheap host stages over the whole grid, and reports clip-level F1 +
    frame accuracy per combo (segment/tune.py). The JSON output plugs
    straight back in via ``segment --transitions``."""
    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.data.labels import ManualIntervals
    from vit_research_tpu_torch.segment import tune as tune_mod
    from vit_research_tpu_torch.segment.knn import fused_confidence

    def grid(name, text):
        vals = [int(x) for x in str(text).split(",") if x != ""]
        if not vals:  # fail BEFORE the engine spins up / frames embed
            raise SystemExit(f"{name} is empty — pass a comma-separated "
                             f"list of integers (got {text!r})")
        return vals

    ks = grid("--k-grid", args.k_grid)
    min_lens = grid("--min-len-grid", args.min_len_grid)
    pads = grid("--pad-grid", args.pad_grid)
    _, col, corpus = common.load_corpus(args.db, args.corpus_collection,
                                        args.device)
    space = getattr(col, "space", "l2")
    manual = ManualIntervals.from_csv(args.manual_csv)
    frames = naming.list_frames(args.frames)
    if not frames:
        raise SystemExit(f"no frames found under {args.frames}")
    eng = common._engine(args.batch_size, args.device)
    embs = eng.embed_paths([os.path.join(args.frames, f) for f in frames])

    results, trans, knn = tune_mod.tune_knn_hmm(
        frames, embs, corpus, manual, device=eng.device, ks=ks,
        min_lens=min_lens, pads=pads,
        fit_transitions=not args.no_fit_transitions, metric=space,
        iou=args.iou)
    if not results:
        raise SystemExit("empty sweep — check the grids against the "
                         f"corpus size ({len(corpus['labels'])} rows)")

    best = results[0]
    # write-back threshold at the winning k: the sweep's k_max top-k is
    # score-sorted, so its k-prefix IS the k-NN result — no second
    # device top-k
    k = best.params["k"]
    fused = fused_confidence(knn["neighbor_labels"][:, :k],
                             knn["neighbor_probs"][:, :k], top_n=k)
    wb = tune_mod.writeback_threshold(
        fused["emissions"], fused["decision"],
        tune_mod.truth_states(manual, frames),
        target_precision=args.target_precision)

    print(f"swept {len(results)} combos over {len(frames)} frames "
          f"(corpus {len(corpus['labels'])} rows, metric {space})")
    print(f"{'f1':>6} {'P':>6} {'R':>6} {'frame_acc':>9}  params")
    for r in results[: args.top]:
        print(f"{r.f1:6.3f} {r.precision:6.3f} {r.recall:6.3f} "
              f"{r.frame_accuracy:9.4f}  {r.params}")
    if wb["threshold"] is not None:
        print(f"write-back threshold >= {wb['threshold']:.2f} gives "
              f"precision {wb['precision']:.4f} at coverage "
              f"{wb['coverage']:.2f} (target {args.target_precision})")
    else:
        best_seen = (f" (best observed: {wb['precision']:.4f} at "
                     f">= {wb['best_threshold']:.2f}, coverage "
                     f"{wb['coverage']:.2f})"
                     if wb.get("best_threshold") is not None else "")
        print("write-back: no threshold on the grid reaches precision "
              f"{args.target_precision} — leave --write-back off"
              f"{best_seen}")

    if args.out:
        payload = {
            "best": best.to_json(),
            "best_transition_matrix":
                trans[best.params["transitions"]].tolist(),
            "transition_matrices":
                {n: m.tolist() for n, m in trans.items()},
            "writeback": wb,
            "metric": space,
            "results": [r.to_json() for r in results],
        }
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
        print(f"wrote {args.out} — apply with: segment --method knn-hmm "
              f"--k {k} --min-len {best.params['min_len']} "
              f"--pad {best.params['pad']} --transitions {args.out}")


def cmd_self_label(args):
    """Two-pass kNN self-labelling against a labelled seed collection
    (reference: nba_proj/chroma.py:36-134,196-309). Writes a labels CSV;
    --upsert also writes accepted pass-1 frames back into the collection,
    enlarging the corpus like the reference's re-upserts."""
    import csv

    import numpy as np

    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.segment.knn import SIDES, two_pass_self_label

    frames = naming.list_frames(args.frames)
    if not frames:
        raise SystemExit(f"no frames under {args.frames}")
    client, col, corpus = common.load_corpus(args.db, args.collection,
                                             args.device)
    eng = common._engine(args.batch_size, args.device)
    embs = eng.embed_paths([os.path.join(args.frames, f) for f in frames])
    labels, probs, accepted = two_pass_self_label(
        embs, corpus["embeddings"], corpus["labels"], device=args.device,
        k=args.k, min_votes=args.min_votes, temperature=args.temperature)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "label", "pass", "left_prob", "right_prob",
                    "none_prob"])
        for i, frame in enumerate(frames):
            w.writerow([frame, SIDES[int(labels[i])],
                        1 if accepted[i] else 2] +
                       [f"{p:.6f}" for p in probs[i]])
    if args.upsert and accepted.any():
        # Writing engine embeddings into the corpus: a profile mismatch is
        # refused outright (reads only warn).
        common._stamp_profile(col)
        # New frames only: ids are frame names, and overwriting a seed row
        # would replace manual labels with a kNN guess.
        existing = set(col.get(ids=frames)["ids"])
        sel = [i for i in np.nonzero(accepted)[0]
               if frames[i] not in existing]
        if sel:
            col.upsert([frames[i] for i in sel], embs[sel],
                       [{"label": SIDES[int(labels[i])],
                         **{f"{s}_prob": float(probs[i][j])
                            for j, s in enumerate(SIDES)}} for i in sel])
            client.flush()
        skipped = int(accepted.sum()) - len(sel)
        if skipped:
            print(f"kept {skipped} existing corpus rows (not overwritten)")
    print(f"labeled {len(frames)} frames ({int(accepted.sum())} pass-1, "
          f"{len(frames) - int(accepted.sum())} pass-2) -> {args.out}")


def cmd_finalize_clips(args):
    """Per-clip refinement: re-embed each clip's frames, k-NN vote, a
    fresh HMM per clip, keep frames whose decoded state matches the clip
    label (reference: nba_proj/finalize_clips.py:134-192)."""
    from vit_research_tpu_torch.segment import knn as knn_mod
    from vit_research_tpu_torch.segment.clips import finalize_clip_dirs

    clip_dirs = common._list_clip_dirs(args.clips)
    _, _, corpus = common.load_corpus(args.db, args.collection, args.device)
    eng = common._engine(args.batch_size, args.device)

    def frame_probs(paths):
        nl, _, _ = knn_mod.knn_labels(eng.embed_paths(paths),
                                      corpus["embeddings"], corpus["labels"],
                                      args.k, device=args.device)
        return knn_mod.vote_counts(nl) / args.k

    out = finalize_clip_dirs(clip_dirs, frame_probs, args.out,
                             device=args.device)
    print(f"finalized {len(out)} clips -> {args.out}")


def cmd_merge_clips(args):
    """Merge adjacent same-side clips with gap <= --max-gap, rebuilding
    merged dirs from the full frame pool
    (reference: nba_proj/merge_clips.py:17-113)."""
    from vit_research_tpu_torch.segment.clips import merge_clip_dirs

    clip_dirs = common._list_clip_dirs(args.clips)
    out = merge_clip_dirs(clip_dirs, args.frame_pool, args.out,
                          max_gap=args.max_gap)
    print(f"merged {len(clip_dirs)} clips -> {len(out)} under {args.out}")


def cmd_clustering(args):
    """Embedding-space study + side classifier: class-mean separation
    distances, KMeans seeded at class means (host), and the SideMLP
    trained on --device, saved in the JAX package's npz format
    (reference: nba_proj/clustering.py:43-160 saved side_nn.keras)."""
    from vit_research_tpu_torch.models.convert import side_mlp_to_params
    from vit_research_tpu_torch.segment.clustering import (
        SIDES, class_mean_separation, kmeans_with_class_means,
        train_side_classifier)
    from vit_research_tpu_torch.train.checkpoint import save_params_npz

    # no new embeddings rank against this corpus (training only): the
    # cross-profile warning would be noise here
    _, _, corpus = common.load_corpus(args.db, args.collection, args.device,
                                      check_profile=False)
    embs, labels = corpus["embeddings"], corpus["labels"]
    sep = class_mean_separation(embs, labels)
    for (a, b), d in sorted(sep.items()):
        print(f"class-mean L2 {SIDES[a]}<->{SIDES[b]}: {d:.3f}")
    _, assign = kmeans_with_class_means(embs, labels)
    agree = float((assign == labels).mean())
    print(f"kmeans(class-mean init) label agreement: {agree:.3f}")
    model, history = train_side_classifier(
        embs, labels, device=args.device, num_epochs=args.epochs,
        batch_size=args.batch_size, seed=args.seed)
    if history:
        print(f"side MLP final train acc {history[-1]['acc']:.3f}")
    save_params_npz(side_mlp_to_params(model.state_dict()), args.out)
    print(f"saved side classifier params -> {args.out}")


def cmd_fresh_test(args):
    """Qualitative eval: classify unseen frames with the saved side
    classifier (an npz of either package) and copy them into
    left/right/none dirs (reference: nba_proj/fresh_test.py:64-101)."""
    import numpy as np

    from vit_research_tpu_torch.data import naming
    from vit_research_tpu_torch.evaluate.fresh_test import (
        dump_classified_frames)
    from vit_research_tpu_torch.models.convert import side_mlp_to_state_dict
    from vit_research_tpu_torch.segment.clustering import (SideMLP,
                                                           classify_sides)
    from vit_research_tpu_torch.train.checkpoint import load_params_npz

    eng = common._engine(args.batch_size, args.device)
    # Size the model from the npz itself: `clustering` builds it as
    # max(label)+1 classes over the embeddings' width.
    with np.load(args.params) as saved:
        in_dim, _ = saved["params/fc1/kernel"].shape
        _, n_classes = saved["params/out/kernel"].shape
    if in_dim != eng.out_dim:
        raise SystemExit(
            f"{args.params} was trained on {in_dim}-d embeddings but the "
            f"engine produces {eng.out_dim}-d (check VRT_TINY)")
    model = SideMLP(in_dim, n_classes)
    model.load_state_dict(side_mlp_to_state_dict(
        load_params_npz(None, args.params)))
    frames = naming.list_frames(args.frames)
    buckets = dump_classified_frames(
        [os.path.join(args.frames, f) for f in frames], eng.embed_paths,
        lambda e: classify_sides(model, e, device=args.device), args.out)
    counts = " ".join(f"{s}={len(v)}" for s, v in sorted(buckets.items()))
    print(f"classified {len(frames)} frames -> {args.out} ({counts})")


def register(sub):
    sg = sub.add_parser("segment", help="frames -> possession clips")
    sg.add_argument("frames")
    sg.add_argument("--method", choices=["temporal", "knn-hmm", "streaks"],
                    default="temporal")
    sg.add_argument("--window", type=int, default=50,
                    help="sliding window (streaks method)")
    sg.add_argument("--manual-csv", default=None,
                    help="manual intervals (temporal method)")
    sg.add_argument("--db", default=None, help="vector-store root")
    sg.add_argument("--corpus-collection", default=None,
                    help="labeled frame collection (write-frame-db)")
    sg.add_argument("--k", type=int, default=50, help="kNN neighbors")
    sg.add_argument("--confidence-threshold", type=float, default=0.7)
    sg.add_argument("--write-back", action="store_true",
                    help="upsert confident frames back into the corpus")
    sg.add_argument("--follow", action="store_true",
                    help="live mode (knn-hmm): tail the frames dir and "
                    "emit clips as they finalize, mid-game")
    sg.add_argument("--socket", default=None,
                    help="--follow through a running `cli serve` daemon "
                    "(unix socket): the daemon's warm engine embeds and "
                    "its collection is the kNN corpus — N games can "
                    "follow concurrently on one card, no engine spin-up "
                    "here")
    sg.add_argument("--idle-timeout", type=float, default=30.0,
                    help="--follow: stop after this many seconds with "
                    "no new frames (or on a STOP file)")
    sg.add_argument("--poll-interval", type=float, default=0.5)
    sg.add_argument("--max-lag", type=int, default=512,
                    help="--follow: fixed-lag Viterbi window")
    sg.add_argument("--out", required=True)
    sg.add_argument("--vid", type=int, required=True)
    sg.add_argument("--epochs", type=int, default=3000,
                    help="TemporalHead training epochs (temporal method)")
    sg.add_argument("--batch-size", type=int, default=256)
    sg.add_argument("--min-len", type=int, default=100)
    sg.add_argument("--pad", type=int, default=100)
    sg.add_argument("--frame-stride", type=int, default=1,
                    help="fast profile: embed every Nth frame and "
                         "interpolate between; offline methods only")
    sg.add_argument("--stride-refine", default=None, metavar="THRESH",
                    help="with --frame-stride > 1: re-embed exactly the "
                         "frames inside any stride gap whose bounding "
                         "keyframe embeddings differ by more than THRESH "
                         "cosine distance ('auto' = 0.05): near-free on "
                         "static footage, approaching full rate when "
                         "every frame changes. The gate only sees "
                         "keyframes: keep the stride <= the shortest "
                         "event you need localized")
    sg.add_argument("--stride-refine-radius", type=int, default=0,
                    help="also refine this many neighbouring gaps on "
                         "each side of every hot gap (--stride-refine)")
    sg.add_argument("--event-template", dest="event_template", default=None,
                    help="event-interval JSON (data/labels "
                         "save_event_template format): with "
                         "--frame-stride > 1, the run refuses a stride "
                         "longer than the template's shortest event")
    sg.add_argument("--force-stride", action="store_true",
                    help="downgrade the --event-template sub-stride "
                         "event check from an error to a warning")
    sg.add_argument("--transitions", default=None,
                    help="JSON with a 3x3 HMM transition matrix (bare "
                    "list or tune-segment output); default is the "
                    "reference's hand-tuned matrix (knn-hmm method)")
    sg.add_argument("--score-events", action="store_true",
                    help="score each clip for make/miss events the "
                    "moment it is written (live in --follow mode): "
                    "chunk + stage-1 encode + live retrieval + stage-2 "
                    "head, one eval row per clip")
    sg.add_argument("--score-ckpt", default=None,
                    help="checkpoint root holding the stage-1/stage-2 "
                    "runs (--score-events)")
    sg.add_argument("--stage1-run-id", default=None,
                    help="trained stage-1 (ChunkEncoder) run under "
                    "--score-ckpt; required with --score-events")
    sg.add_argument("--stage2-run-id", default=None,
                    help="trained stage-2 (RATTHeadV2) run under "
                    "--score-ckpt; required with --score-events")
    sg.add_argument("--score-db", default=None,
                    help="vector-store root of the chunk retrieval "
                    "collection (defaults to --db)")
    sg.add_argument("--score-collection", default=None,
                    help="chunk collection for live retrieval "
                    "(e.g. ratt_db)")
    sg.add_argument("--chunk-size", type=int, default=8)
    sg.add_argument("--chunk-stride", type=int, default=2)
    sg.add_argument("--k-sim", type=int, default=6)
    sg.add_argument("--k-contrast", type=int, default=6)
    sg.add_argument("--k-temporal", type=int, default=4)
    sg.add_argument("--future-step", type=int, default=2)
    common.device_arg(sg)
    sg.set_defaults(fn=cmd_segment)

    tn = sub.add_parser(
        "tune-segment",
        help="calibrate segmentation thresholds against manual intervals")
    tn.add_argument("frames")
    tn.add_argument("--manual-csv", required=True)
    tn.add_argument("--db", required=True)
    tn.add_argument("--corpus-collection", required=True)
    tn.add_argument("--k-grid", default="5,10,25,50")
    tn.add_argument("--min-len-grid", default="50,100,150")
    tn.add_argument("--pad-grid", default="0,50,100")
    tn.add_argument("--iou", type=float, default=0.5,
                    help="IoU for clip-interval matching")
    tn.add_argument("--target-precision", type=float, default=0.99,
                    help="required write-back precision when suggesting "
                    "a confidence threshold")
    tn.add_argument("--no-fit-transitions", action="store_true",
                    help="sweep only the reference transition matrix "
                    "(skip the counting fit from the manual labels)")
    tn.add_argument("--top", type=int, default=10)
    tn.add_argument("--out", default=None, help="JSON report path "
                    "(feed back via segment --transitions)")
    tn.add_argument("--batch-size", type=int, default=256)
    common.device_arg(tn)
    tn.set_defaults(fn=cmd_tune_segment)

    sl = sub.add_parser(
        "self-label", help="two-pass kNN self-labeling vs a seed corpus")
    sl.add_argument("frames")
    sl.add_argument("--db", required=True)
    sl.add_argument("--collection", required=True)
    sl.add_argument("--out", required=True, help="labels CSV")
    sl.add_argument("--k", type=int, default=25)
    sl.add_argument("--min-votes", type=int, default=20)
    sl.add_argument("--temperature", type=float, default=7.0)
    sl.add_argument("--upsert", action="store_true",
                    help="write accepted pass-1 frames back to the corpus")
    sl.add_argument("--batch-size", type=int, default=256)
    common.device_arg(sl)
    sl.set_defaults(fn=cmd_self_label)

    fc = sub.add_parser(
        "finalize-clips", help="per-clip kNN+HMM refinement")
    fc.add_argument("--clips", required=True, help="clip-dirs root")
    fc.add_argument("--db", required=True)
    fc.add_argument("--collection", required=True,
                    help="labeled frame collection for the kNN vote")
    fc.add_argument("--out", required=True)
    fc.add_argument("--k", type=int, default=5)
    fc.add_argument("--batch-size", type=int, default=256)
    common.device_arg(fc)
    fc.set_defaults(fn=cmd_finalize_clips)

    mc = sub.add_parser(
        "merge-clips", help="merge adjacent same-side clips")
    mc.add_argument("--clips", required=True, help="clip-dirs root")
    mc.add_argument("--frame-pool", required=True,
                    help="full frame dir to rebuild merged clips from")
    mc.add_argument("--out", required=True)
    mc.add_argument("--max-gap", type=int, default=30)
    mc.set_defaults(fn=cmd_merge_clips)

    cl = sub.add_parser(
        "clustering",
        help="class-mean separation + kmeans + side-MLP training")
    cl.add_argument("--db", required=True)
    cl.add_argument("--collection", required=True)
    cl.add_argument("--out", required=True, help="side classifier npz")
    cl.add_argument("--epochs", type=int, default=50)
    cl.add_argument("--batch-size", type=int, default=64)
    cl.add_argument("--seed", type=int, default=0)
    common.device_arg(cl)
    cl.set_defaults(fn=cmd_clustering)

    ft = sub.add_parser(
        "fresh-test",
        help="classify unseen frames into left/right/none dirs")
    ft.add_argument("frames")
    ft.add_argument("--params", required=True,
                    help="side classifier npz from 'clustering'")
    ft.add_argument("--out", required=True)
    ft.add_argument("--batch-size", type=int, default=256)
    common.device_arg(ft)
    ft.set_defaults(fn=cmd_fresh_test)
