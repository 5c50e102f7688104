"""BENCHMARK.json against its shape and naming rules, and the
files it names, each found by its name."""

import json
import re

import pytest

from harness import manifest

MAN = manifest.load()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|_dim$|_rank$|expansion|experts_per_tok")


def test_top_level_keys_and_command():
    assert set(MAN) == TOP
    assert MAN["command"] == ["python3", "bench_port/run.py"]
    assert MAN["paths"] == ["bench_port"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_units_sources():
    assert manifest.problems(MAN) == []


@pytest.mark.parametrize("bad", ["a b", "x,y", "a/b", ".lead", "é", "x" * 65])
def test_bad_names_are_caught(bad):
    man = json.loads(json.dumps(MAN))
    man["per_layer"][0]["name"] = bad
    assert manifest.problems(man)


@pytest.mark.parametrize("unit,ok", [("tokens/s", True), ("%", True),
                                     ("frames per s", False), ("us", True),
                                     ("µs", False), ("a" * 17, False)])
def test_units(unit, ok):
    assert bool(manifest.UNIT_RE.fullmatch(unit)) is ok


def test_entries_have_only_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
    for text in ([c["why"] for c in MAN["configs"] + MAN["workloads"]]
                 + [c["source"] for c in MAN["configs"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_setup_bound_and_every_cell_reports_enough():
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    for w in MAN["workloads"]:
        e2e = manifest.reported(MAN["end_to_end"], w["name"])
        per = manifest.reported(MAN["per_layer"], w["name"])
        assert len(e2e) >= 2 and per
        names = {m["name"] for m in e2e}
        # each per-layer metric moves a metric its cells report
        assert all(m["moves"] in names for m in per)


def test_files_found_by_name():
    for c in MAN["configs"]:
        cfg = manifest.config(MAN, c["name"])
        assert c["file"].startswith("bench_port/configs/")
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"].startswith(c["source"].split()[0])
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
    for w in MAN["workloads"]:
        t = manifest.workload(w["name"])
        assert t["config"] == w["config"] and w["traffic"] == w["name"]
        assert (manifest.BENCH_DIR / "harness" / "entries"
                / f"{t['entry']}.py").is_file()
        assert t["limits"]
    for m in MAN["per_layer"]:
        assert (manifest.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_file_names_use_name_characters():
    for p in manifest.BENCH_DIR.rglob("*"):
        rel = p.relative_to(manifest.ROOT).as_posix()
        if "__pycache__" in rel or ".pytest_cache" in rel:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
