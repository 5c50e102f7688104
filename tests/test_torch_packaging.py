"""The port's packaging and small entry points: every CUDA source and
header ships as package data (ops/_build.py compiles ``csrc/*.cu`` with
``-I csrc``, and the kernels include ``tc_gemm.cuh``), the console script
resolves, ``load_random_vit_weights`` defaults to the card like every
entry point, and the Mongo stub behaves as the JAX package's without
pymongo.
"""

import fnmatch
import importlib
import os
import tomllib

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pyproject() -> dict:
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_every_csrc_file_is_package_data():
    globs = _pyproject()["tool"]["setuptools"]["package-data"][
        "vit_research_tpu_torch"]
    csrc = os.path.join(REPO, "vit_research_tpu_torch", "csrc")
    files = sorted(os.listdir(csrc))
    assert any(f.endswith(".cuh") for f in files)
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f"csrc/{f}", g) for g in globs)]
    assert not missing, f"csrc files no package-data glob ships: {missing}"
    # the package itself is found by setuptools' include pattern
    include = _pyproject()["tool"]["setuptools"]["packages"]["find"][
        "include"]
    for pkg in ("vit_research_tpu_torch", "vit_research_tpu_torch.examples"):
        assert any(fnmatch.fnmatch(pkg, g) for g in include), pkg


def test_console_scripts_resolve():
    scripts = _pyproject()["project"]["scripts"]
    assert scripts["vit-research-tpu-torch"] == \
        "vit_research_tpu_torch.cli:main"
    assert "vit-research-tpu" in scripts
    for target in scripts.values():
        module, attr = target.split(":")
        assert callable(getattr(importlib.import_module(module), attr))


def test_load_random_vit_weights_defaults_to_the_card(tmp_path,
                                                      monkeypatch):
    from vit_research_tpu_torch.db import writers
    from vit_research_tpu_torch.utils.configs import ViTConfig

    tiny = ViTConfig(image_size=(32, 32), patch_size=8, hidden_size=32,
                     num_layers=1, num_heads=2, mlp_dim=64)
    path = str(tmp_path / "w.npz")
    writers.save_random_vit_weights(path, config=tiny, seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        writers.load_random_vit_weights(path, config=tiny)
    model = writers.load_random_vit_weights(path, config=tiny, device="cpu")
    assert next(model.parameters()).device.type == "cpu"


def test_mongo_stub_without_pymongo(monkeypatch, capsys):
    import sys

    from vit_research_tpu.store import mongo as jax_mongo
    from vit_research_tpu_torch.store import mongo

    # a None entry makes ``import pymongo`` raise ImportError
    monkeypatch.setitem(sys.modules, "pymongo", None)
    for mod in (mongo, jax_mongo):
        assert mod.get_client() is None
        assert mod.insert_one("clips", {"a": 1}) is False
        assert "pymongo unavailable" in capsys.readouterr().out
    assert mongo._clients == {}
