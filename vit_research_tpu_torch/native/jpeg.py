"""ctypes bindings for the native JPEG decoder (jpeg_fast.c).

Port of vit_research_tpu/native/jpeg.py. The shared library compiles on
first use (``cc -O3 -shared -fPIC jpeg_fast.c -ljpeg``) into
``vit_research_tpu_torch/_build/jpeg-<hash of the source>/`` (git-ignored,
like the CUDA kernels), never next to the source; an unchanged source
loads the library already built. Where the compiler, libjpeg or its
headers are missing, ``is_available()`` is False (``unavailable_reason()``
says why) and callers decode with PIL, as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "jpeg_fast.c")
_BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")
_CFLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()
_error: str | None = None  # why the library could not be built or loaded


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_CFLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_ROOT, f"jpeg-{h.hexdigest()[:16]}",
                        "_jpeg_fast.so")


def _build(so: str) -> str | None:
    """Compile into a temporary file beside ``so`` and rename it into
    place (concurrent builders never see a partial library). Returns None
    on success, else the compilers' messages."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    errors = []
    for cc in ("cc", "gcc", "g++"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
        os.close(fd)
        try:
            result = subprocess.run(
                [cc, *_CFLAGS, _SRC, "-ljpeg", "-o", tmp],
                capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
            os.unlink(tmp)
            continue
        if result.returncode == 0:
            os.replace(tmp, so)
            return None
        os.unlink(tmp)
        lines = result.stderr.strip().splitlines() or ["no message"]
        errors.append(f"{cc}: " + next(
            (ln for ln in lines if "error" in ln), lines[-1]).strip())
    return "; ".join(errors)


def _get_lib():
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        so = _so_path()
        if not os.path.exists(so):
            err = _build(so)
            if err is not None:
                _error = f"build failed: {err}"
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _error = f"load failed: {e}"
            return None
        lib.decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.decode_resize.restype = ctypes.c_int
        lib.decode_files.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.decode_files.restype = ctypes.c_int
        _lib = lib
    return _lib


def is_available() -> bool:
    return _get_lib() is not None


def unavailable_reason() -> str | None:
    """None when the decoder is available, else why it is not."""
    _get_lib()
    return _error


def decode_file(path: str, target_hw: tuple) -> np.ndarray:
    """Decode one JPEG file to exactly (H, W, 3) uint8 RGB."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native jpeg decoder unavailable ({_error})")
    h, w = target_hw
    with open(path, "rb") as f:
        data = f.read()
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.decode_resize(data, len(data), h, w,
                           out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"jpeg decode failed ({rc}): {path}")
    return out


def decode_batch(paths, target_hw: tuple, out: np.ndarray | None = None,
                 num_workers: int = 1) -> np.ndarray:
    """Decode many files to (N, H, W, 3) uint8.

    The C call releases the GIL, so ``num_workers > 1`` decodes in
    parallel on the host's cores (each worker decodes a contiguous slice
    with one C call)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native jpeg decoder unavailable ({_error})")
    h, w = target_hw
    n = len(paths)
    if out is None:
        out = np.empty((n, h, w, 3), np.uint8)
    elif (not out.flags["C_CONTIGUOUS"] or out.dtype != np.uint8
          or out.shape != (n, h, w, 3)):
        # The C decoder writes n*h*w*3 bytes through a raw pointer.
        raise ValueError(
            f"out must be C-contiguous uint8 of shape {(n, h, w, 3)}; "
            f"got {out.dtype} {out.shape} "
            f"contiguous={out.flags['C_CONTIGUOUS']}")
    status = np.zeros((n,), np.int32)

    def run_slice(start, end):
        blob = b"\0".join(os.fsencode(p) for p in paths[start:end]) + b"\0"
        lib.decode_files(
            blob, end - start, h, w,
            out[start:end].ctypes.data_as(ctypes.c_void_p),
            status[start:end].ctypes.data_as(ctypes.c_void_p))

    if num_workers <= 1 or n <= 1:
        run_slice(0, n)
    else:
        import concurrent.futures as fut

        workers = min(num_workers, n)
        step = -(-n // workers)
        with fut.ThreadPoolExecutor(workers) as pool:
            list(pool.map(lambda s: run_slice(s, min(s + step, n)),
                          range(0, n, step)))
    bad = np.nonzero(status)[0]
    if len(bad):
        raise ValueError(
            f"jpeg decode failed for {len(bad)} files, first: "
            f"{paths[bad[0]]} (status {status[bad[0]]})")
    return out
