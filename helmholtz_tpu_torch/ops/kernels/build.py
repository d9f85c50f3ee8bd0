"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for sm_90a into an object file, all
sources at once in parallel processes, and the objects are linked into one
shared library with a plain C interface that `ctypes` loads.  No PyTorch
header is included, so the build takes seconds.  The library lives in
`helmholtz_tpu_torch/build/` (git-ignored), is built at the first launch and
rebuilt when a source is newer than it.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_PATH = BUILD_DIR / "libhelmholtz_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
#: seconds the last build took and what the compiler printed (register and
#: shared-memory use per kernel); None until a build ran in this process
last_build_seconds = None
last_build_log = None

_P = ctypes.c_void_p
_SIGNATURES = {
    "hh_stencil_matvec": [_P, _P, _P, _P, _P, _P, _P,
                          ctypes.c_int, ctypes.c_int, _P],
    "hh_sweep": [ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_longlong, _P, _P, _P, _P, ctypes.c_int, _P, _P, _P,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    "hh_gj_inverse": [_P, _P, ctypes.c_int, ctypes.c_int, _P],
    "hh_bsr_spmm": [_P] * 8,
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(looked on PATH and under CUDA_HOME)")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources())


def build(force: bool = False) -> pathlib.Path:
    """Compile the sources (in parallel) and link the library if it is
    missing or older than a source.  Raises on any compiler failure."""
    global last_build_seconds, last_build_log
    if not force and not _stale():
        return LIB_PATH
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    last_build_log = "\n".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{last_build_log}")
    tmp = BUILD_DIR / f"{LIB_PATH.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n"
                           f"{link.stdout}")
    os.replace(tmp, LIB_PATH)
    last_build_seconds = time.perf_counter() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
