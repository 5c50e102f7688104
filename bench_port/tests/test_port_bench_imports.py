"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``vit_research_tpu_torch`` is not
``vit_research_tpu``); the yardstick imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from harness import manifest, runner

BENCH = manifest.BENCH_DIR
#: the yardstick: the reference, the comparison, the counts, the traffic,
#: the weights, the trace and the metric readers
YARDSTICK = (["harness/" + f for f in (
    "reference.py", "compare.py", "cost.py", "seeds.py", "traffic.py",
    "weights.py", "trace.py", "manifest.py")]
    + [f"metrics/{p.name}" for p in (BENCH / "metrics").glob("*.py")])


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(BENCH)) for p in BENCH.rglob("*.py")))
def test_no_jax_anywhere(path):
    assert not top_level_imports(BENCH / path) & set(runner.FORBIDDEN)


@pytest.mark.parametrize("path", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_port(path):
    assert "vit_research_tpu_torch" not in top_level_imports(BENCH / path)


@pytest.mark.parametrize("modules,bad", [
    (["vit_research_tpu_torch.ops.topk", "torch"], []),
    (["vit_research_tpu.ops", "jaxlib.xla"], ["jaxlib", "vit_research_tpu"]),
    (["jaxtyping", "flaxen"], []),
])
def test_forbidden_is_compared_whole(monkeypatch, modules, bad):
    fake = {m: object() for m in modules}
    monkeypatch.setattr(sys, "modules", fake)
    assert runner.loaded_forbidden() == bad


def test_a_run_loads_no_jax():
    """Import everything a run imports (the entries import the port's
    modules when they set up) in a fresh interpreter."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from harness import runner\n"
        "from harness.entries import embed, search\n"
        "from vit_research_tpu_torch.parallel.embed import EmbeddingEngine\n"
        "from vit_research_tpu_torch.models.vit import VisionTransformer\n"
        "from vit_research_tpu_torch.store.vector_store import Collection\n"
        "print(runner.loaded_forbidden())\n") % (str(BENCH),
                                                  str(manifest.ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a card the command fails and prints no result."""
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "search-200k-f32", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=manifest.ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
