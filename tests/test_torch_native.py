"""The port's native JPEG decoder (vit_research_tpu_torch/native, its own
copy of jpeg_fast.c, built into the package's build directory) against
the JAX package's decoder built from the same source: byte-equal frames,
threaded equal to serial, corrupt files refused, and the
``load_frames(use_native=True)`` and engine routes through it. Skips only
where the port's decoder is not available (no compiler or libjpeg).

Tolerances: the two packages' decoders are one C source, so their frames
are equal byte for byte; against PIL (another bilinear convention) the
JAX test's bound, a mean absolute difference below 12.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from vit_research_tpu import native as jax_native
from vit_research_tpu.data import synthetic
from vit_research_tpu_torch import native
from vit_research_tpu_torch.data import preprocess as pp
from vit_research_tpu_torch.models.vit import init_vit
from vit_research_tpu_torch.native import jpeg
from vit_research_tpu_torch.parallel.embed import EmbeddingEngine
from vit_research_tpu_torch.utils.configs import ViTConfig

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not native.is_available(),
    reason=f"native decoder unavailable: {native.unavailable_reason()}")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    return synthetic.write_video_frames(
        str(root / "f"), 1, [("left", 5), ("right", 4), ("none", 3)],
        size=(96, 128))


def test_source_is_the_reference_copy_and_builds_in_the_build_dir():
    here = os.path.dirname(jpeg.__file__)
    assert filecmp.cmp(os.path.join(here, "jpeg_fast.c"),
                       os.path.join(os.path.dirname(jax_native.jpeg.__file__),
                                    "jpeg_fast.c"), shallow=False)
    so = jpeg._so_path()
    assert os.path.exists(so)
    assert os.path.dirname(os.path.dirname(so)) == os.path.join(
        os.path.dirname(here), "_build")
    assert native.unavailable_reason() is None


@pytest.mark.parametrize("target", [(48, 64), (224, 224), (96, 128)])
def test_decode_equals_jax_decoder_bytes(frames, target):
    got = native.decode_batch(frames, target)
    assert got.shape == (len(frames), *target, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_native.decode_batch(frames,
                                                               target))
    np.testing.assert_array_equal(native.decode_file(frames[3], target),
                                  jax_native.decode_file(frames[3], target))


def test_decode_close_to_pil_and_keeps_the_side(frames):
    got = native.decode_batch(frames, (48, 64))
    ref = pp.load_frames(frames, pp.PreprocessSpec(size=(48, 64)),
                         num_workers=1)
    assert np.abs(got.astype(int) - ref.astype(int)).mean() < 12.0
    # 'left' frames are brighter on the left half
    assert got[0, :, :32].mean() > got[0, :, 32:].mean()


def test_threaded_decode_equals_serial(frames):
    a = native.decode_batch(frames, (48, 64), num_workers=1)
    b = native.decode_batch(frames, (48, 64), num_workers=3)
    np.testing.assert_array_equal(a, b)
    out = np.empty((len(frames), 48, 64, 3), np.uint8)
    assert native.decode_batch(frames, (48, 64), out=out,
                               num_workers=4) is out
    np.testing.assert_array_equal(out, a)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.decode_batch(frames, (48, 64), out=out[:, ::2])


def test_corrupt_file_raises(tmp_path, frames):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(ValueError, match="jpeg decode failed"):
        native.decode_batch([frames[0], str(bad)], (32, 32))
    with pytest.raises(ValueError):
        native.decode_file(str(bad), (32, 32))


def test_load_frames_routes_to_native(frames, tmp_path):
    spec = pp.PreprocessSpec(size=(48, 64))
    np.testing.assert_array_equal(
        pp.load_frames(frames, spec, use_native=True),
        native.decode_batch(frames, (48, 64)))
    # the default stays PIL; a non-JPEG batch takes PIL as in the reference
    assert not np.array_equal(pp.load_frames(frames, spec),
                              native.decode_batch(frames, (48, 64)))
    from PIL import Image

    png = str(tmp_path / "vid1_frame_99.png")
    Image.open(frames[0]).save(png)
    np.testing.assert_array_equal(
        pp.load_frames([frames[1], png], spec, use_native=True),
        pp.load_frames([frames[1], png], spec))


def test_engine_embed_paths_use_native(frames):
    cfg = ViTConfig(image_size=(48, 64), patch_size=16, hidden_size=32,
                    num_layers=1, num_heads=2, mlp_dim=64)
    eng = EmbeddingEngine(init_vit(cfg, seed=0, device="cpu"),
                          pp.PreprocessSpec(size=(48, 64)), device="cpu",
                          batch_size=5)
    got = eng.embed_paths(frames, use_native=True)
    want = eng.embed_batch(native.decode_batch(frames, (48, 64)))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, eng.embed_paths(frames))
