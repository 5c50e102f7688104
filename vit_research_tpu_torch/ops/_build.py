"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` file compiles (one nvcc process per file, all at once,
with ``-I csrc`` for the shared ``*.cuh`` headers) and links into one
shared library with a plain C interface, at first use, into
``_build/<hash>/`` beside the package (the hash covers the sources, the
headers and the flags, so an edited kernel or header rebuilds and an
unchanged tree loads at once). Nothing here runs at import time: the
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
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libvrt_kernels.so"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: ptxas reports each kernel's registers, shared memory and
# spills; build() keeps that report beside the library (ptxas_report).
COMPILE_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype)
    # img, w3, ldw, c, out, B, H, W, C, P, D, out_bf16, variant (0: the
    # rule), stream
    "vrt_patch_embed_u8": ([_P, _P, _I, _P, _P] + [_I] * 8 + [_P], _I),
    # img, w, avec, bvec, bias, out, B, H, W, C, P, D, out_bf16, stream
    "vrt_patch_embed_f32": ([_P] * 6 + [_I] * 7 + [_P], _I),
    # q, k, v, o, batch, heads, seq, dh, 12 strides (q, k, v, o x batch,
    # head, token), scale, is_bf16, key bias (or null), its batch stride,
    # variant (0: the rule), stream
    "vrt_attention_fwd": ([_P] * 4 + [_I] * 4
                          + [ctypes.POINTER(ctypes.c_longlong),
                             ctypes.c_float, _I, _P, ctypes.c_longlong, _I,
                             _P],
                          _I),
    # x, gamma, beta, w, bias, out, stats, M, K, N, ldw, eps, act, x_bf16,
    # w_bf16, out_bf16, variant (0: the rule), stream
    "vrt_ln_matmul": ([_P] * 7 + [ctypes.c_longlong, _I, _I, _I,
                                  ctypes.c_float] + [_I] * 5 + [_P], _I),
    # x, w, bias (or null), out, M, K, N, lda, stream
    "vrt_linear_f32": ([_P] * 4 + [ctypes.c_longlong, _I, _I,
                                   ctypes.c_longlong, _P], _I),
    "vrt_error_string": ([_I], ctypes.c_char_p),
}


def sources(csrc: str = CSRC) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc, "*.cu")))


def headers(csrc: str = CSRC) -> list[str]:
    return sorted(glob.glob(os.path.join(csrc, "*.cuh")))


def build_key(csrc: str = CSRC) -> str:
    """The build directory's name: a hash of the sources and headers in
    ``csrc`` and of the flags."""
    return _digest(sources(csrc) + headers(csrc), COMPILE_FLAGS + LINK_FLAGS)


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
    out_dir = os.path.join(BUILD_ROOT, build_key())
    lib = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    # Build under a temporary name and rename: a concurrent process never
    # loads a half-written library.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        # One nvcc per source, all started together, then one link; each
        # writes its report into its log, and its wall time beside it.
        jobs = []
        t0 = time.monotonic()
        for src in srcs:
            obj = os.path.join(tmp_dir, os.path.basename(src) + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
            log = open(os.path.join(out_dir, _log_name(obj)), "w")
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
        pending = list(jobs)
        while pending:
            for job in [j for j in pending if j[3].poll() is not None]:
                pending.remove(job)
                job[2].close()
                with open(os.path.join(out_dir, _time_name(job[1])),
                          "w") as fh:
                    fh.write(f"{time.monotonic() - t0:.2f}\n")
            time.sleep(0.05)
        failed = []
        for cmd, obj, _, proc in jobs:
            if proc.returncode != 0:
                with open(os.path.join(out_dir, _log_name(obj))) as fh:
                    failed.append(f"{' '.join(cmd)}\n{fh.read()}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(tmp_dir, LIB_NAME)
        _run([nvcc, *LINK_FLAGS, "-o", tmp, *(job[1] for job in jobs)])
        os.replace(tmp, lib)
    return lib


def _log_name(path: str) -> str:
    return os.path.basename(path).split(".")[0] + ".ptxas.log"


def _time_name(path: str) -> str:
    return os.path.basename(path).split(".")[0] + ".nvcc_s"


def nvcc_seconds(source: str) -> float:
    """Seconds from the build's start until the nvcc of ``csrc/<source>``
    ended (every source compiles at once); builds first if needed. NaN
    where the library was built before this record was kept."""
    path = os.path.join(os.path.dirname(build()),
                        _time_name(os.path.basename(source)))
    if not os.path.exists(path):
        return float("nan")
    with open(path) as fh:
        return float(fh.read())


def ptxas_report(source: str) -> list[str]:
    """ptxas's lines (registers, shared memory, spills per kernel, and its
    warnings, such as wgmma serialized) from the build of
    ``csrc/<source>``; builds first if needed."""
    path = os.path.join(os.path.dirname(build()), _log_name(source))
    with open(path) as fh:
        return [line.strip() for line in fh
                if "ptxas info" in line or "spill" in line
                or "warning" in line]


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. The cache takes
    no lock: a multi-threaded caller loads it first or from one thread
    at a time (the serve daemon: ``serve --warmup``, or its first
    forward under the device lock)."""
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
