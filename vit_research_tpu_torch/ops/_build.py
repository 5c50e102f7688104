"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` file compiles into one shared library with a plain C
interface, at first use, into ``_build/<hash>/`` beside the package (the
hash covers the sources and the flags, so an edited kernel rebuilds and
an unchanged one loads at once). Nothing here runs at import time: the
CPU-only test environment has no nvcc and imports every module.

Each entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a nonzero code into a RuntimeError, so a launch that
CUDA refused (too many threads, too much shared memory) never passes
silently.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libvrt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype)
    "vrt_patch_embed": ([_P] * 6 + [_I] * 8 + [_P], _I),
    "vrt_attention_fwd": ([_P] * 4 + [_I] * 3 + [ctypes.c_float, _I, _P], _I),
    "vrt_error_string": ([_I], ctypes.c_char_p),
}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from csrc/ at first use")


def _digest(srcs, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in srcs:
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode())
            h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if needed; returns the library's path."""
    srcs = sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(srcs, NVCC_FLAGS))
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    # Build under a temporary name and rename: a concurrent process never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(code: int, what: str) -> None:
    """Raise when a kernel's C entry returned a CUDA error."""
    if code != 0:
        msg = library().vrt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
