"""Build and load the CUDA kernels: nvcc into a shared library, bound with
ctypes.

At first use the sources under ``peapods_tpu_torch/csrc/`` are compiled for
Hopper (``sm_90a``) into ``build/kernels/`` at the repository root, under a
name keyed by a hash of the sources and flags, so a changed source builds
anew and an unchanged one loads at once.  The library has a plain C
interface (no PyTorch headers), so a build takes seconds.  Every entry point
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["library", "check", "NVCC_FLAGS", "BUILD_DIR", "SOURCE_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# -fmad=false and no --use_fast_math: the acceptance and PT arithmetic must
# round exactly as the plain torch version does (ops/sweep.py)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "peapods_colour_pass_blocks": [_I, _I],
    "peapods_colour_pass": [_P] * 7 + [_I] * 6 + [_P],
    "peapods_pt_step": [_P, _P, _I, _P, _P, _I] + [_P] * 7 + [_I] * 8 + [_P],
}

_lib = None
build_info = {}  # {"seconds": float, "log": str, "path": str} of the last load


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu")), sorted(SOURCE_DIR.glob("*.cuh"))


def library():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"peapods_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    build_info.update(seconds=time.perf_counter() - t0, log=log, path=str(out))
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
