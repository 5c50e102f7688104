"""Live event scoring and the evaluation verbs of the port against the JAX
package: LiveEventScorer (proxy labels, the self-similarity cap, frames
evicted from its cache and embedded again), infer_clip_sequences and
score_event_localization; the verbs smoke, metrics, eval-clips,
score-events and train-stage2 as subprocesses on ``--device cpu``;
``segment --score-events`` offline, with ``--follow`` and with ``--follow
--socket``; the daemon's scoring sessions beside the JAX daemon's, and
``reload_weights`` (generation pinning, all-or-nothing swaps, narrowing,
``serve-ctl reload-weights``).

Weights are drawn by the JAX package from fixed seeds and cross through
models/convert.py into the port's run checkpoints; inputs come from numpy
seeds. Tolerances: logits and probabilities 1e-5 (f32 on the CPU in other
summation orders through two encoders and the head); the top-k chunks
and the clips must be equal. Rows of one process's three segment routes
(the same weights and inputs through the same code): 1e-6.

Sockets live under a short ``mkdtemp`` in /tmp; every client has a
timeout of at most 30 s and every server thread is joined and checked. A
client starts only once its daemon's socket is bound (an event, not a
clock). The JAX references are built once a module (``jax_refs``), and
so is the daemon tests' world (``daemon_world``).
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from vit_research_tpu import serve as jax_serve
from vit_research_tpu.data import labels as jax_labels
from vit_research_tpu.cli import eval_cmds as jax_eval_cmds
from vit_research_tpu.data import synthetic
from vit_research_tpu.data.preprocess import PreprocessSpec as JaxSpec
from vit_research_tpu.evaluate import clip_sequences as jax_cseq
from vit_research_tpu.evaluate import event_scoring as jax_events
from vit_research_tpu.evaluate import live as jax_live
from vit_research_tpu.models import heads as jax_heads
from vit_research_tpu.models import ratt_v2 as jax_ratt_v2
from vit_research_tpu.models import vit as jax_vit
from vit_research_tpu.parallel import embed as jax_embed
from vit_research_tpu.store import vector_store as jax_store
from vit_research_tpu.train import train_chunk_encoder as jax_tce
from vit_research_tpu.utils import configs as jax_configs
from vit_research_tpu_torch import cli, serve
from vit_research_tpu_torch.data import chunks as chunks_mod
from vit_research_tpu_torch.data import labels as labels_mod
from vit_research_tpu_torch.data import samples as samples_mod
from vit_research_tpu_torch.data.preprocess import PreprocessSpec
from vit_research_tpu_torch.db.frame_store import (FrameStore,
                                                   build_chunk_index)
from vit_research_tpu_torch.evaluate import clip_sequences as cseq
from vit_research_tpu_torch.evaluate import event_scoring, live, scoring
from vit_research_tpu_torch.models import convert, heads
from vit_research_tpu_torch.models import vit as tvit
from vit_research_tpu_torch.parallel import embed as tembed
from vit_research_tpu_torch.store import vector_store as torch_store
from vit_research_tpu_torch.train import checkpoint as ckpt
from vit_research_tpu_torch.utils import configs
from vit_research_tpu_torch.utils.configs import ViTConfig

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=0, atol=1e-5)
ROUTE_TOL = dict(rtol=0, atol=1e-6)
TIMEOUT = 30.0
CHUNK, STRIDE = 4, 2
K = dict(k_sim=2, k_contrast=2, k_temporal=2)
TINY = dict(image_size=(32, 32), patch_size=8, hidden_size=64, num_layers=2,
            num_heads=2, mlp_dim=128, use_flash_attention=False)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_weights(dim, seed):
    """JAX stage-1 ChunkEncoder and stage-2 RATTHeadV2 of width ``dim``,
    as the port's loaders build them: (encode_batch, head_apply, encoder
    params, head params). The encoder's weights are the port's seeded
    init brought over by models/convert.py (no JAX init to compile); the
    head's come from a jitted flax init; apply is jitted."""
    kw = dict(embed_dim=dim, mlp_dim=4 * dim, max_len=CHUNK)
    ce = jax_heads.ChunkEncoder(jax_configs.ChunkEncoderConfig(**kw))
    ce_p = convert.chunk_encoder_to_params(
        heads.ChunkEncoder(configs.ChunkEncoderConfig(**kw),
                           generator=torch.Generator().manual_seed(seed))
        .state_dict(), configs.ChunkEncoderConfig(**kw))
    head = jax_ratt_v2.RATTHeadV2(jax_configs.HeadConfig(embed_dim=dim, **K))
    hp = _np_tree(jax.jit(head.init)(
        jax.random.PRNGKey(seed + 1), jnp.zeros((1, dim)),
        *(jnp.zeros((1, k, dim)) for k in K.values())))
    return (jax_tce.make_encode_fn(ce, ce_p),
            jax.jit(lambda q, s, c, t: head.apply(hp, q, s, c, t)[0]),
            ce_p, hp)


@pytest.fixture(scope="module")
def jax_refs():
    """``_jax_weights`` of each width, built once a module (the jitted
    functions keep their compiles across the tests): ``refs(dim)``."""
    made = {}

    def refs(dim):
        if dim not in made:
            made[dim] = _jax_weights(dim, dim)
        return made[dim]
    return refs


def _save_runs(root, ce_p, hp, s1="s1", s2="s2"):
    """The JAX weights as the port's run checkpoints under ``root``."""
    for run, sd in ((s1, convert.chunk_encoder_to_state_dict(ce_p)),
                    (s2, convert.ratt_v2_to_state_dict(hp))):
        mngr = ckpt.CheckpointManager(root, run)
        mngr.save(0, {"params": sd, "step": 0})
        mngr.maybe_update_best(0, 1.0)


def _frame_table(n, dim, seed):
    """``n`` frames of game 1 (``vid1_frame_{i}.jpg``) -> (dim,) rows:
    a side direction in the first half, another in the second, noise."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((n, dim)).astype(np.float32)
    rows[: n // 2, 0] += 2.0
    rows[n // 2:, 1] += 2.0
    return {f"vid1_frame_{i + 1}.jpg": rows[i] for i in range(n)}


def _chunk_rows(encode, table, names, vid, clip, side, label, stored):
    """Chunk rows (ratt_db schema) of one clip's frames, encoded by
    ``encode`` and L2-normalised, appended to ``stored``."""
    recs = [{"pth": f, "side": side, "t_norm": (i + 1) / len(names),
             "clip_num": clip, "vid_num": vid, "label": label,
             "status": "", "status_id": 0} for i, f in enumerate(names)]
    chunks = chunks_mod.build_chunks(recs, chunk_size=CHUNK,
                                     chunk_stride=STRIDE)
    embs, logits = encode(np.stack([[table[f] for f in c["frames"]]
                                    for c in chunks]))
    embs = embs / np.linalg.norm(embs, axis=1, keepdims=True)
    for c, e, lg in zip(chunks, embs, np.asarray(logits).reshape(-1)):
        stored["ids"].append(f"v{vid}c{clip}s{c['start_idx']}")
        stored["embs"].append(e)
        stored["metas"].append({
            "vid_num": vid, "clip_num": clip, "side": side, "label": label,
            "t_center": c["t_center"], "t_width": c["t_width"],
            "start_idx": c["start_idx"], "end_idx": c["end_idx"],
            "class_logit": float(lg)})
    return chunks


def _stored_game(encode, dim):
    """A stored game (vid 7, six clips, labels alternating) and the twin
    rows of the live game's first clip (vid 1): the rows, the live frame
    table and the live game's clips (frame names)."""
    stored = {"ids": [], "embs": [], "metas": []}
    table7 = {f.replace("vid1_", "vid7_"): v
              for f, v in _frame_table(60, dim, 5).items()}
    names7 = sorted(table7, key=lambda f: int(f.split("_")[-1][:-4]))
    for clip in range(6):
        _chunk_rows(encode, table7, names7[10 * clip: 10 * clip + 10], 7,
                    clip + 1, "left" if clip < 3 else "right", clip % 2,
                    stored)
    table = _frame_table(40, dim, 6)
    names = sorted(table, key=lambda f: int(f.split("_")[-1][:-4]))
    clips = [("left", 1, names[:14]), ("right", 2, names[20:35]),
             ("left", 3, names[36:39])]  # the last: shorter than a chunk
    # the first clip is stored too (a game re-scored against a collection
    # that already holds it): its twins come back at cosine ~1
    _chunk_rows(encode, table, clips[0][2], 1, 1, "left", 1, stored)
    return stored, table, clips


def _collections(stored):
    col = torch_store.Collection("ratt_db", space="cosine", device="cpu")
    jcol = jax_store.Collection("ratt_db", space="cosine")
    for c in (col, jcol):
        c.upsert(stored["ids"], np.stack(stored["embs"]), stored["metas"])
    return col, jcol


def _same_rows(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert list(g) == list(w)
        for key in ("raw_sequence", "prob_sequence"):
            np.testing.assert_allclose(g[key], w[key], **tol, err_msg=key)
        # z divides the logits' error by their spread
        np.testing.assert_allclose(
            g["z_sequence"], w["z_sequence"], rtol=0,
            atol=tol["atol"] / max(float(np.std(w["raw_sequence"])), 1e-3))
        assert [c["chunk_start_idx"] for c in g["topk_chunks"]] == \
            [c["chunk_start_idx"] for c in w["topk_chunks"]]
        for gc, wc in zip(g["topk_chunks"], w["topk_chunks"]):
            np.testing.assert_allclose(gc["prob"], wc["prob"], **tol)
            exact = ("logit", "prob")
            assert {k: v for k, v in gc.items() if k not in exact} \
                == {k: v for k, v in wc.items() if k not in exact}
        for key in w:
            if key not in ("raw_sequence", "prob_sequence", "z_sequence",
                           "topk_chunks"):
                assert g[key] == w[key], key


def test_live_scorer_matches_jax(tmp_path, jax_refs):
    """score_clip with the same weights (restored by the port's loaders
    from its run checkpoints) and the same rows: the stage-1 proxy labels
    select the branches, the cap drops the stored twins, and frames
    evicted from a 6-frame cache are embedded again through embed_fn in
    one call a clip, in both packages."""
    d = 64  # the daemon tests' width: one JAX reference for the module
    jenc, jhead, ce_p, hp = jax_refs(d)
    _save_runs(str(tmp_path), ce_p, hp)
    stack = scoring.load_scorer_stack(
        dim=d, ckpt=str(tmp_path), stage1_run_id="s1", stage2_run_id="s2",
        chunk_size=CHUNK, device="cpu", **K)
    stored, table, clips = _stored_game(stack[0], d)
    col, jcol = _collections(stored)
    calls = {"port": [], "jax": []}

    def embed_fn(key):
        def fn(paths):
            calls[key].append(len(paths))
            return np.stack([table[os.path.basename(p)] for p in paths])
        return fn

    kw = dict(chunk_size=CHUNK, chunk_stride=STRIDE, emb_cache_cap=6,
              search_k_content=16, search_k_temporal=8, **K)
    scorer = live.LiveEventScorer(embed_fn("port"), *stack, col, **kw)
    jscorer = jax_live.LiveEventScorer(embed_fn("jax"), jenc, jhead, jcol,
                                       **kw)
    names = sorted(table, key=lambda f: int(f.split("_")[-1][:-4]))
    rows = {"port": [], "jax": []}
    for s, key in ((scorer, "port"), (jscorer, "jax")):
        s.remember([f"/live/{f}" for f in names[:16]],
                   np.stack([table[f] for f in names[:16]]))
        for side, clip, frames in clips:
            rows[key].append(s.score_clip([f"/clips/{f}" for f in frames],
                                          side=side, clip_num=clip, vid=1))
    _same_rows(rows["port"], rows["jax"])
    assert calls["port"] == calls["jax"] and calls["port"]  # evictions
    assert rows["port"][2] is None
    first = rows["port"][0]
    assert first["label"] == -1 and first["num_chunks"] == 6
    # the cap at work: without it the first clip's stored twins rank
    # first, and the rows change
    scorer.self_sim_cap = jscorer.self_sim_cap = None
    uncapped = scorer.score_clip([f"/clips/{f}" for f in clips[0][2]],
                                 side="left", clip_num=1, vid=1)
    _same_rows([uncapped], [jscorer.score_clip(
        [f"/clips/{f}" for f in clips[0][2]], side="left", clip_num=1,
        vid=1)])
    assert uncapped["raw_sequence"] != first["raw_sequence"]


def test_clip_sequences_and_event_scoring_match_jax(tmp_path, jax_refs):
    """infer_clip_sequences over stored chunks (coordinate self-exclusion,
    the zeroed-query ablation), then score_event_localization against an
    event template and against the chunks' status ids, and save_results'
    files, against the JAX package."""
    d = 64  # the daemon tests' width: one JAX reference for the module
    jenc, jhead, ce_p, hp = jax_refs(d)
    _save_runs(str(tmp_path), ce_p, hp)
    enc = scoring.stage1_encode_batch(d, CHUNK, str(tmp_path), "s1",
                                      strict=True, device="cpu")
    head = scoring.stage2_head(d, str(tmp_path), "s2", strict=True,
                               device="cpu", **K)
    stored, table, _ = _stored_game(enc, d)
    col, jcol = _collections(stored)
    table7 = {f.replace("vid1_", "vid7_"): v
              for f, v in _frame_table(60, d, 5).items()}
    recs = []
    for clip in range(6):
        for i in range(10):
            f = 10 * clip + i + 1
            recs.append({"pth": f"/g/vid7_clip_{clip + 1}/vid7_frame_{f}.jpg",
                         "side": "left" if clip < 3 else "right",
                         "t_norm": (i + 1) / 10, "clip_num": clip + 1,
                         "vid_num": 7, "label": clip % 2,
                         "status": "", "status_id": 2 if 3 <= i < 6 else 0})
    chunks = chunks_mod.build_chunks(recs, chunk_size=CHUNK,
                                     chunk_stride=STRIDE)

    def encode_chunk(fn):
        def f(ch):
            e, _ = fn(np.stack([[table7[os.path.basename(p)]
                                 for p in ch["frames"]]]))
            return e[0] / np.linalg.norm(e[0])
        return f

    kw = dict(search_k_content=16, search_k_temporal=8, batch_size=5, **K)
    for zeros in (False, True):
        got = cseq.infer_clip_sequences(chunks, head, encode_chunk(enc), col,
                                        zeros_query=zeros, **kw)
        want = jax_cseq.infer_clip_sequences(chunks, jhead,
                                             encode_chunk(jenc), jcol,
                                             zeros_query=zeros, **kw)
        _same_rows(got, want)
    template = {f"/g/vid7_clip_{c + 1}_{'left' if c < 3 else 'right'}":
                {"event_make": [[10 * c + 4, 10 * c + 6]]} for c in range(5)}
    template["/g/vid7_clip_2_left"]["event_none"] = [[15, 15]]
    truth = event_scoring.truth_events_by_clip(template)
    assert truth == jax_events.truth_events_by_clip(template)
    for t in (truth, None):
        assert event_scoring.score_event_localization(got, t, ks=(1, 2, 3)) \
            == jax_events.score_event_localization(want, t, ks=(1, 2, 3))
    cseq.save_results(got, str(tmp_path / "r" / "p.json"),
                      str(tmp_path / "r" / "p.csv"))
    jax_cseq.save_results(got, str(tmp_path / "r" / "j.json"),
                          str(tmp_path / "r" / "j.csv"))
    for ext in ("json", "csv"):
        assert (tmp_path / "r" / f"p.{ext}").read_text() == \
            (tmp_path / "r" / f"j.{ext}").read_text()
    with pytest.raises(scoring.ScoringUnavailable, match="no run directory"):
        scoring.stage2_head(d, str(tmp_path), "nope", strict=True,
                            device="cpu", **K)


# ------------------------------------------------------------- the verbs

def _verb_world(root, d=32):
    """Two games of three clips (empty JPEG names: the store holds the
    rows), clip labels, an event template and a port frame store."""
    clip_labels, template = {}, {}
    for vid in (1, 2):
        for clip, side in ((1, "left"), (2, "right"), (3, "left")):
            cd = os.path.join(root, f"clips_{vid}",
                              f"vid{vid}_clip_{clip}_{side}")
            os.makedirs(cd)
            for f in range(10 * clip, 10 * clip + 8):
                open(os.path.join(cd, f"vid{vid}_frame_{f}.jpg"), "w").close()
            clip_labels[cd] = int(side == "left")
            template[cd] = {"event_make": [[10 * clip + 3, 10 * clip + 4]]}
    labels_csv = os.path.join(root, "labels.csv")
    labels_mod.save_clip_labels(clip_labels, labels_csv)
    events = os.path.join(root, "events.json")
    with open(events, "w") as f:
        json.dump(template, f)
    recs = samples_mod.load_samples([1, 2], os.path.join(root, "clips_{vid}"),
                                    clip_labels)
    chunks = chunks_mod.build_chunks(recs, chunk_size=CHUNK,
                                     chunk_stride=STRIDE)
    rng = np.random.default_rng(0)
    table = {r["pth"]: rng.standard_normal(d).astype(np.float32)
             + (r["side"] == "left") for r in recs}
    store_dir = os.path.join(root, "store")
    store = FrameStore.build(list(table), lambda ps: np.stack(
        [table[p] for p in ps]), store_dir,
        embedding_profile="torch|tiny|tome0|quant-none|gray0")
    build_chunk_index(chunks, store, store_dir)
    return store_dir, events


def _start(argv, cwd):
    """The port's CLI started as a subprocess (two threads)."""
    return subprocess.Popen(
        [sys.executable, "-m", "vit_research_tpu_torch.cli", *argv], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=REPO, VRT_TINY="1",
                 OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _jax_verb(fn, capsys, **args):
    """A JAX package verb called in this process; its standard output."""
    capsys.readouterr()
    fn(argparse.Namespace(**args))
    return capsys.readouterr().out


@pytest.fixture(scope="module", autouse=True)
def smoke_proc(tmp_path_factory):
    """``smoke`` through the command line as a subprocess, started as the
    module starts: it needs nothing of the tests' worlds, so its process
    start and full-width init run beside the other tests."""
    proc = _start(["smoke", "--device", "cpu"],
                  str(tmp_path_factory.mktemp("smoke")))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _main(argv, capsys):
    """The port's CLI called in this process: its standard output."""
    capsys.readouterr()
    cli.main(argv)
    return capsys.readouterr().out


def test_verbs_on_cpu(tmp_path, capsys, monkeypatch, smoke_proc):
    """train-stage2 (2 epochs, then --resume, then the stage3 preset from
    its best weights with --cached-val), eval-clips, score-events, metrics
    and smoke with VRT_TINY=1 --device cpu (smoke as a subprocess, the
    command line's start-up included, started with the module; the rest
    in this process);
    score-events, metrics and smoke print what the JAX package's verbs
    print (called in this process, on the port's results file, run ledgers
    and frame)."""
    root = str(tmp_path)
    monkeypatch.setenv("VRT_TINY", "1")
    monkeypatch.chdir(root)
    store_dir, events = _verb_world(root)
    ck, db = os.path.join(root, "ck"), os.path.join(root, "db")
    cache = os.path.join(root, "s2.pkl")
    cli.main(["train-stage1", "--store", store_dir, "--ckpt", ck,
              "--epochs", "1", "--batch-size", "4", "--run-id", "s1",
              "--device", "cpu"])
    cli.main(["write-ratt-db", "--store", store_dir, "--ckpt", ck, "--db",
              db, "--run-id", "s1", "--device", "cpu"])
    t2 = ["train-stage2", "--store", store_dir, "--db", db, "--ckpt", ck,
          "--collection", "ratt_db", "--stage1-run-id", "s1",
          "--train-vids", "1", "--val-vids", "2", "--batch-size", "4",
          "--k-sim", "2", "--k-contrast", "2", "--k-temporal", "2",
          "--device", "cpu"]
    out = _main(t2 + ["--cache", cache, "--epochs", "2", "--run-id", "s2"],
                capsys)
    assert "built stage-2 cache (" in out and "epoch 1:" in out
    assert "run s2: best val acc" in out and "best f1" in out
    capsys.readouterr()
    cli.main(t2 + ["--cache", cache, "--epochs", "3", "--run-id", "s2",
                   "--resume"])
    out = capsys.readouterr().out
    assert "loaded stage-2 cache" in out and "epoch 0:" not in out \
        and "epoch 2:" in out
    assert ckpt.CheckpointManager(ck, "s2").all_steps() == [0, 1, 2]
    cli.main(t2 + ["--cache", cache, "--epochs", "1", "--run-id", "s3",
                   "--preset", "stage3", "--init-run-id", "s2",
                   "--cached-val"])
    with open(os.path.join(ck, "s3", "experiment.json")) as f:
        assert json.load(f)["pinned_run_id"] == "s2"
    with pytest.raises(SystemExit, match="no such run"):
        cli.main(t2 + ["--cache", cache, "--init-run-id", "nope"])

    run = os.path.join(ck, "s2")
    out = _main(["eval-clips", "--store", store_dir, "--ckpt", ck, "--db",
                 db, "--collection", "ratt_db", "--vids", "2", "--out", "res",
                 "--stage1-run-id", "s1", "--stage2-run-id", "s2", "--k-sim",
                 "2", "--k-contrast", "2", "--k-temporal", "2",
                 "--device", "cpu"], capsys)
    assert "wrote 3 clip rows to res" in out
    results = os.path.join(root, "res", "logit_sequences.json")
    with open(results) as f:
        assert [r["clip_key"] for r in json.load(f)] == \
            ["vid2_clip1", "vid2_clip2", "vid2_clip3"]
    p_json, j_json = (os.path.join(root, f) for f in ("p.json", "j.json"))
    got = _main(["score-events", results, "--events", events, "--ks", "1,2",
                 "--out", p_json], capsys)
    want = _jax_verb(jax_eval_cmds.cmd_score_events, capsys,
                     results=results, events=events, ks="1,2", out=j_json)
    assert got.replace(p_json, "") == want.replace(j_json, "")
    assert "scored 3 clips (ground truth: template" in got
    with open(p_json) as a, open(j_json) as b:
        assert json.load(a) == json.load(b)

    got = _main(["metrics", run], capsys)
    assert got == _jax_verb(jax_eval_cmds.cmd_metrics, capsys, dir=run,
                            csv=None)
    assert got.count("epoch ") == 3 and "val_best_f1=" in got
    capsys.readouterr()
    cli.main(["metrics", ck])
    assert capsys.readouterr().out == _jax_verb(
        jax_eval_cmds.cmd_metrics, capsys, dir=ck, csv=None)
    cli.main(["metrics", run, "--csv", os.path.join(root, "s2.csv")])
    assert "wrote 3 rows" in capsys.readouterr().out

    # the JAX smoke prints these shapes for VIT_P32_432x768
    out, err = smoke_proc.communicate(timeout=300)
    assert smoke_proc.returncode == 0, err[-3000:]
    assert out.splitlines() == [
        "tokens_before_encoder: (1, 313, 768)",
        "encoded_tokens: (1, 313, 768)", "pooled: (1, 768)",
        "pre_logits: (1, 768)"]


# ----------------------------------------------- segment and the daemon

SEGMENTS = [("none", 4), ("left", 30), ("none", 4), ("right", 30),
            ("none", 4)]


@pytest.fixture
def sockdir():
    d = tempfile.mkdtemp(prefix="vrt", dir="/tmp")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@contextlib.contextmanager
def serving(srv, sock):
    ready = threading.Event()
    t = threading.Thread(target=srv.serve, args=(sock,),
                         kwargs={"ready_event": ready}, daemon=True)
    t.start()
    assert ready.wait(TIMEOUT)
    try:
        yield sock
    finally:
        srv.stop()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), "serve thread did not exit"


def _live_frames(src, dst):
    os.makedirs(dst)
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), dst)
    open(os.path.join(dst, "STOP"), "w").close()
    return dst


@pytest.fixture
def scored_world(sockdir, monkeypatch):
    """The verify skill's world on the tiny engine: a labelled corpus,
    offline clips, a labelled frame store of them (chunks of 4), a
    stage-1 run, its ratt_db rows and a stage-2 run, through the port's
    CLI on the CPU."""
    for key in ("VRT_TOME_R", "VRT_GEMM_QUANT", "VRT_GRAYSCALE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("VRT_TINY", "1")
    monkeypatch.chdir(sockdir)
    synthetic.write_video_frames("frames", 1, SEGMENTS, size=(32, 32))
    mi = jax_labels.ManualIntervals()
    for side, a, b in [("none", 1, 4), ("left", 5, 34), ("none", 35, 38),
                       ("right", 39, 68), ("none", 69, 72)]:
        mi.intervals[side].append((1, a, b))
    mi.to_csv("manual_intervals.csv")
    seg = ["--k", "5", "--min-len", "20", "--pad", "2", "--vid", "1",
           "--batch-size", "16"]
    cli.main(["write-frame-db", "frames", "--manual-csv",
              "manual_intervals.csv", "--db", "db", "--collection", "corpus",
              "--batch-size", "16", "--device", "cpu"])
    cli.main(["segment", "frames", "--method", "knn-hmm", "--db", "db",
              "--corpus-collection", "corpus", "--out", "clips", *seg,
              "--device", "cpu"])
    labels_mod.save_clip_labels(
        {os.path.join("clips", d): int("left" in d)
         for d in sorted(os.listdir("clips"))}, "labels.csv")
    cli.main(["build-frame-store", "--clip-root", "clips", "--vids", "1",
              "--clip-labels", "labels.csv", "--out", "store",
              "--chunk-size", str(CHUNK), "--chunk-stride", str(STRIDE),
              "--batch-size", "16", "--device", "cpu"])
    cli.main(["train-stage1", "--store", "store", "--ckpt", "ck", "--epochs",
              "1", "--batch-size", "8", "--run-id", "s1", "--device", "cpu"])
    cli.main(["write-ratt-db", "--store", "store", "--ckpt", "ck", "--db",
              "db", "--run-id", "s1", "--device", "cpu"])
    cli.main(["train-stage2", "--store", "store", "--db", "db", "--ckpt",
              "ck", "--collection", "ratt_db", "--cache", "s2.pkl",
              "--stage1-run-id", "s1", "--train-vids", "1", "--val-vids",
              "1", "--cached-val", "--epochs", "1", "--batch-size", "8",
              "--run-id", "s2", "--k-sim", "2", "--k-contrast", "2",
              "--k-temporal", "2", "--device", "cpu"])
    score = ["--score-events", "--score-ckpt", "ck", "--stage1-run-id", "s1",
             "--stage2-run-id", "s2", "--score-db", "db",
             "--score-collection", "ratt_db", "--chunk-size", str(CHUNK),
             "--chunk-stride", str(STRIDE), "--k-sim", "2", "--k-contrast",
             "2", "--k-temporal", "2"]
    return seg, score


class _BoundEvent:
    """``serve.WarmingServer`` that sets ``bound`` once the daemon's
    socket is bound: a client started after ``bound.wait()`` finds the
    socket (a client that finds none exits at once, by design)."""

    def __init__(self, monkeypatch):
        self.bound = threading.Event()
        outer, base = self, serve.WarmingServer

        class Announcing(base):
            def __init__(self, socket_path):
                super().__init__(socket_path)
                outer.bound.set()

        monkeypatch.setattr(serve, "WarmingServer", Announcing)


def test_segment_score_events_offline_follow_and_socket(scored_world,
                                                        sockdir, capsys,
                                                        monkeypatch):
    """The offline rows (events.json, from the written clip dirs) equal
    the in-process --follow rows and the --follow --socket rows
    (events.jsonl, scored by a serve daemon), and score-events reads
    them; --score-events without its runs exits before any embed."""
    seg, score = scored_world
    daemon_up = _BoundEvent(monkeypatch)
    capsys.readouterr()
    cli.main(["segment", "frames", "--method", "knn-hmm", "--db", "db",
              "--corpus-collection", "corpus", "--out", "scored", *seg,
              *score, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "scored 2/2 clips -> scored/events.json" in out
    with open(os.path.join("scored", "events.json")) as f:
        offline = json.load(f)
    assert [r["clip_key"] for r in offline] == ["vid1_clip1", "vid1_clip2"]
    follow = ["--follow", "--idle-timeout", "20", "--poll-interval", "0.05",
              "--max-lag", "64", *seg, *score]
    cli.main(["segment", _live_frames("frames", "live_a"), "--method",
              "knn-hmm", "--db", "db", "--corpus-collection", "corpus",
              "--out", "local", "--device", "cpu", *follow])
    assert "scored 2 clips live -> local/events.jsonl" in \
        capsys.readouterr().out
    sock = os.path.join(sockdir, "d.sock")
    t = threading.Thread(target=cli.main, args=([
        "serve", "--socket", sock, "--db", "db", "--collection", "corpus",
        "--batch-size", "16", "--warmup", "--device", "cpu"],), daemon=True)
    t.start()
    try:
        # the client waits through the daemon's warming by itself, but it
        # needs the socket: started before the bind, it exits
        assert daemon_up.bound.wait(TIMEOUT)
        cli.main(["segment", _live_frames("frames", "live_b"), "--method",
                  "knn-hmm", "--socket", sock, "--out", "daemon", *follow])
        capsys.readouterr()
        cli.main(["serve-ctl", "stats", "--socket", sock])
        stats = json.loads(capsys.readouterr().out)
        cli.main(["serve-ctl", "shutdown", "--socket", sock])
    finally:
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert stats["segment"]["events_scored"] == 2
    assert stats["segment"]["scoring_active"] == 0
    assert stats["scorer_stacks"] == 1
    for out_dir in ("local", "daemon"):
        with open(os.path.join(out_dir, "events.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        _same_rows(rows, offline, ROUTE_TOL)
    capsys.readouterr()
    cli.main(["score-events", os.path.join("daemon", "events.jsonl"),
              "--ks", "1,3"])
    assert "ground truth: status_id" in capsys.readouterr().out
    no_run = score[:5] + score[7:]  # without --stage2-run-id s2
    assert "--stage2-run-id" not in no_run
    for argv, msg in ((no_run, "--score-events needs"),
                      (score + ["--chunk-stride", "0"], "positive")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(["segment", "frames", "--method", "knn-hmm", "--db",
                      "db", "--corpus-collection", "corpus", "--out", "x",
                      *seg, *argv, "--device", "cpu"])
    assert not os.path.exists("x")


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) with equal weights, batch size 4: the
    port's seeded init, brought to the flax tree by models/convert.py."""
    tcfg = ViTConfig(**TINY)
    tm = tvit.init_vit(tcfg, seed=0, device="cpu")
    params = convert.state_dict_to_params(tm.state_dict(), tcfg)
    jeng = jax_embed.EmbeddingEngine(
        jax_vit.VisionTransformer(jax_configs.ViTConfig(**TINY)), params,
        JaxSpec(size=(32, 32)), batch_size=4, use_fused_patch_embed=False)
    teng = tembed.EmbeddingEngine(tm.eval(), PreprocessSpec(size=(32, 32)),
                                  device="cpu", batch_size=4)
    return jeng, teng


@pytest.fixture(scope="module")
def daemon_world(engines, jax_refs, tmp_path_factory):
    """``_daemon_world`` built once a module; ``world(root)`` copies its
    runs and stored collection under ``root`` (a test may write there)
    and returns (frame paths, corpus rows, JAX weights)."""
    base = str(tmp_path_factory.mktemp("daemon_world"))
    paths, corpus, w = _daemon_world(base, engines[1], jax_refs)

    def world(root):
        for sub in ("ck", "sdb"):
            shutil.copytree(os.path.join(base, sub), os.path.join(root, sub))
        return paths, corpus, w
    return world


def _daemon_world(root, teng, jax_refs):
    """Frames of one game on disk, its labelled corpus rows (the port
    engine's embeddings) and a stored scoring collection on disk: the
    same game's chunks encoded by the stage-1 weights, labelled by side.
    Returns (frame paths, corpus rows, JAX weights)."""
    paths = synthetic.write_video_frames(os.path.join(root, "frames"), 1,
                                         SEGMENTS, size=(32, 32))
    embs = teng.embed_batch(np.stack([np.asarray(Image.open(p))
                                      for p in paths]))
    sides = [s for s, n in SEGMENTS for _ in range(n)]
    corpus = ([f"c{i}" for i in range(len(paths))], embs,
              [{"label": s, **{f"{t}_prob": 0.9 if t == s else 0.05
                               for t in ("left", "right", "none")}}
               for s in sides])
    w = jax_refs(teng.out_dim)
    _save_runs(os.path.join(root, "ck"), *w[2:])
    table = {os.path.basename(p): e for p, e in zip(paths, embs)}
    names = [os.path.basename(p) for p in paths]
    stored = {"ids": [], "embs": [], "metas": []}
    for clip, (a, b, side) in enumerate(((4, 34, "left"), (38, 68, "right"),
                                         (10, 30, "left"))):
        _chunk_rows(w[0], table, names[a:b], 3 + clip, 1, side,
                    int(side == "left"), stored)
    client = torch_store.PersistentClient(os.path.join(root, "sdb"),
                                          device="cpu")
    col = client.get_or_create_collection(
        "ratt_db", metadata={"hnsw:space": "cosine"})
    col.upsert(stored["ids"], np.stack(stored["embs"]), stored["metas"])
    client.flush()
    return paths, corpus, w


def _score_cfg(root, **kw):
    return {"ckpt": os.path.join(root, "ck"), "stage1_run_id": "s1",
            "stage2_run_id": "s2", "db": os.path.join(root, "sdb"),
            "collection": "ratt_db", "chunk_size": CHUNK,
            "chunk_stride": STRIDE, "emb_cache_cap": 16, **K, **kw}


def _scored_session(sock, paths, cfg, sizes=(9, 20, 5), finish=True,
                    client=None):
    """Drive one scoring session; returns (start reply, push and finish
    replies, the open client when ``finish`` is False)."""
    c = client or serve.SessionClient(sock, timeout=TIMEOUT)
    start = c.request({"op": "segment_start", "k": 5, "min_len": 20,
                       "pad": 2, "max_lag": 16, "drain_every": 4, "vid": 1,
                       "score_events": cfg})
    assert start["ok"], start
    replies, i, j = [], 0, 0
    while i < len(paths):
        chunk = paths[i:i + sizes[j % len(sizes)]]
        r = c.request({"op": "segment_push", "paths": chunk})
        assert r["ok"], r
        replies.append(r)
        i, j = i + len(chunk), j + 1
    if not finish:
        return start, replies, c
    replies.append(c.request({"op": "segment_finish"}))
    c.close()
    return start, replies, None


def _perturbed(state_dict, seed):
    """``state_dict`` with seeded noise of a tenth of each tensor's scale
    added: other weights of the same head."""
    g = torch.Generator().manual_seed(seed)
    return {k: v + 0.1 * v.abs().mean() * torch.randn(v.shape, generator=g)
            for k, v in state_dict.items()}


def _events(replies):
    clips, rows = [], []
    for r in replies:
        assert len(r["events"]) == len(r["clips"])
        clips += r["clips"]
        rows += r["events"]
    return clips, rows


def test_daemon_scoring_sessions_match_the_jax_daemon(engines, daemon_world,
                                                      sockdir):
    """A score_events session on the port's daemon (stacks restored from
    the port's runs) and on the JAX daemon (the same weights, its stack
    cache seeded): the same reply keys, clips and event rows, a clip
    mid-game; the stats counters."""
    jeng, teng = engines
    paths, corpus, w = daemon_world(sockdir)
    tcol = torch_store.Collection("corpus", device="cpu")
    jcol = jax_store.Collection("corpus")
    for c in (tcol, jcol):
        c.upsert(*corpus)
    cfg = _score_cfg(sockdir)
    jsrv = jax_serve.EmbedServer(jeng, collection=jcol)
    key = (cfg["ckpt"], "s1", "s2", CHUNK, *K.values())
    jsrv._scorer_stacks[key] = (0, (w[0], w[1]))
    with serving(jsrv, os.path.join(sockdir, "j.sock")) as js, \
            serving(serve.EmbedServer(teng, collection=tcol),
                    os.path.join(sockdir, "t.sock")) as ts:
        want = _scored_session(js, paths, cfg)
        got = _scored_session(ts, paths, cfg)
        stats = serve.request(ts, {"op": "stats"}, timeout=TIMEOUT)
    assert list(got[0]) == list(want[0])
    assert got[0]["weights_generation"] == 0 and got[0]["scoring"] is True
    for g, w_ in zip(got[1], want[1]):
        assert list(g) == list(w_)
    gclips, grows = _events(got[1])
    wclips, wrows = _events(want[1])
    assert gclips == wclips and len(gclips) == 2
    assert any(r["clips"] for r in got[1][:-1])  # scored mid-game
    _same_rows(grows, wrows)
    seg = stats["segment"]
    assert (seg["events_scored"], seg["event_errors"],
            seg["scoring_active"], stats["scorer_stacks"],
            stats["weights_generation"]) == (2, 0, 0, 1, 0)


def test_reload_weights_pins_sessions_and_swaps_all_or_nothing(
        engines, daemon_world, sockdir, capsys):
    """reload_weights: an open session keeps generation 0 and its scores
    while a session opened after the reload scores with the new best
    weights; a failed restore swaps nothing; ids narrow the reload; the
    dims without the full id triple are refused; serve-ctl reload-weights
    answers end to end."""
    _, teng = engines
    paths, corpus, _ = daemon_world(sockdir)
    tcol = torch_store.Collection("corpus", device="cpu")
    tcol.upsert(*corpus)
    ck = os.path.join(sockdir, "ck")
    cfg = _score_cfg(sockdir)
    # a second stage-2 run, cached by the daemon beside s2
    mngr2 = ckpt.CheckpointManager(ck, "s2")
    s2_params = mngr2.restore_best()["params"]
    mngr3 = ckpt.CheckpointManager(ck, "s3")
    mngr3.save(0, {"params": _perturbed(s2_params, 1), "step": 0})
    mngr3.maybe_update_best(0, 1.0)
    sock = os.path.join(sockdir, "t.sock")
    with serving(serve.EmbedServer(teng, collection=tcol), sock):
        _, before, _ = _scored_session(sock, paths, cfg)
        _, _, _ = _scored_session(sock, paths[:10],
                                  dict(cfg, stage2_run_id="s3"))
        # session A stays open across the reload
        start_a, first_a, client_a = _scored_session(
            sock, paths[:40], cfg, finish=False)
        assert start_a["weights_generation"] == 0
        # training wrote a new best into s2
        mngr2.save(1, {"params": _perturbed(s2_params, 2), "step": 1})
        mngr2.maybe_update_best(1, 2.0)
        # a failed restore swaps nothing: s3's best is torn
        good = open(mngr3._path(0), "rb").read()
        with open(mngr3._path(0), "wb") as f:
            f.write(b"torn")
        r = serve.request(sock, {"op": "reload_weights", "ckpt": ck},
                          timeout=TIMEOUT)
        assert not r["ok"] and "stage-2" in r["error"]
        _, same, _ = _scored_session(sock, paths, cfg)
        assert same[-1].get("events") is not None
        _same_rows(_events(same)[1], _events(before)[1], ROUTE_TOL)
        stats = serve.request(sock, {"op": "stats"}, timeout=TIMEOUT)
        assert stats["weights_generation"] == 0
        with open(mngr3._path(0), "wb") as f:
            f.write(good)
        # the dims describe a preload target only
        r = serve.request(sock, {"op": "reload_weights", "ckpt": ck,
                                 "k_sim": 3}, timeout=TIMEOUT)
        assert not r["ok"] and "only apply when" in r["error"]
        r = serve.request(sock, {"op": "reload_weights",
                                 "stage2_run_id": "nope"}, timeout=TIMEOUT)
        assert not r["ok"] and "matched no scorer stacks" in r["error"]
        # narrowed to s2: one stack reloads, the generation rises once
        r = serve.request(sock, {"op": "reload_weights",
                                 "stage2_run_id": "s2"}, timeout=TIMEOUT)
        assert r["ok"] and r["generation"] == 1
        assert list(r) == ["ok", "generation", "reloaded",
                           "active_sessions_pinned"]
        assert [x["stage2_run_id"] for x in r["reloaded"]] == ["s2"]
        assert r["active_sessions_pinned"] == 1
        # the pinned session finishes on generation 0's weights
        rest_a = []
        for i in range(40, len(paths), 16):
            rest_a.append(client_a.request({"op": "segment_push",
                                             "paths": paths[i:i + 16]}))
        rest_a.append(client_a.request({"op": "segment_finish"}))
        client_a.close()
        _same_rows(_events(first_a + rest_a)[1], _events(before)[1],
                   ROUTE_TOL)
        # a new session scores with the reloaded weights
        start_b, after, _ = _scored_session(sock, paths, cfg)
        assert start_b["weights_generation"] == 1
        _, new_rows = _events(after)
        assert new_rows[0]["raw_sequence"] != \
            _events(before)[1][0]["raw_sequence"]
        scorer = scoring.make_live_scorer(
            teng.embed_paths, dim=teng.out_dim, ckpt=ck, stage1_run_id="s1",
            stage2_run_id="s2", db=cfg["db"], collection="ratt_db",
            chunk_size=CHUNK, chunk_stride=STRIDE, device="cpu", **K)
        clips, _ = _events(after)
        want = [scorer.score_clip(paths[c["start"]: c["end"] + 1],
                                  side=c["side"], clip_num=n + 1, vid=1)
                for n, c in enumerate(clips)]
        _same_rows(new_rows, want)
        # the operator's client: a preload of the full target
        capsys.readouterr()
        cli.main(["serve-ctl", "reload-weights", "--socket", sock,
                  "--ckpt", ck, "--stage1-run-id", "s1", "--stage2-run-id",
                  "s3", "--chunk-size", str(CHUNK), "--k-sim", "2",
                  "--k-contrast", "2", "--k-temporal", "2"])
        reply = json.loads(capsys.readouterr().out)
        assert reply["generation"] == 2 and reply["reloaded"] == [{
            "ckpt": ck, "stage1_run_id": "s1", "stage2_run_id": "s3",
            "chunk_size": CHUNK, **K}]
        stats = serve.request(sock, {"op": "stats"}, timeout=TIMEOUT)
        assert stats["scorer_stacks"] == 2
        assert stats["segment"]["scoring_active"] == 0
