"""Build and load the CUDA kernels: nvcc into shared libraries, bound with
ctypes.

At first use every ``*.cu`` under ``peapods_tpu_torch/csrc/`` is compiled
for Hopper (``sm_90a``) into its own shared library in ``build/kernels/``
at the repository root, all nvcc processes started together.  Each library
is named by a hash of its source, the headers and the flags, so a changed
source builds anew and an unchanged one loads at once.  The libraries have
a plain C interface (no PyTorch headers), so a build takes seconds.  Every
entry point returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on a non-zero code.  :func:`expect` and :func:`device_kind` are the
wrappers' argument checks, :func:`dims3` the lattice extents they pass.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from types import SimpleNamespace

__all__ = ["library", "check", "expect", "device_kind", "dims3", "NVCC_FLAGS",
           "BUILD_DIR", "SOURCE_DIR"]

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
    "peapods_colour_pass": [_P] * 7 + [_I] * 7 + [_P, _P],
    "peapods_pt_step": [_P, _P, _I, _I] + [_P] * 5 + [_I] + [_P] * 9 + [_I] * 9 + [_P],
    "peapods_smem_per_block_optin": [],
    "peapods_resident_max_clusters": [_I] * 3,
    "peapods_mega_resident": [_P] * 14 + [_I] * 15 + [_P],
    "peapods_sweep_2d": [_P] * 6 + [_I] * 9 + [_P],
    "peapods_fk_blocks": [_I],
    "peapods_fk_bonds": [_P] * 6 + [_I] * 3 + [_P],
    "peapods_fk_bonds_staged": [_P] * 6 + [_I] * 3 + [_P],
    "peapods_fk_link": [_P, _P] + [_I] * 9 + [_P],
    "peapods_fk_link_border": [_P, _P] + [_I] * 8 + [_P],
    "peapods_fk_link_flatten": [_P] + [_I] * 2 + [_P],
    "peapods_fk_finish": [_P] * 8 + [_I] * 3 + [_P],
    "peapods_cc_link": [_P] * 3 + [_I] * 2 + [_P],
    "peapods_cc_link_border": [_P] * 3 + [_I] + [_P],
    "peapods_winding": [_P] * 4 + [_I] * 4 + [_P],
    "peapods_winding_link": [_P] * 4 + [_I] * 6 + [_P],
    "peapods_winding_border": [_P] * 2 + [_I] * 5 + [_P],
    "peapods_winding_wrap": [_P] * 4 + [_I] * 3 + [_P],
    "peapods_winding_check": [_P] * 5 + [_I] * 3 + [_P],
    "peapods_pair_overlap": [_P] * 4 + [_I] * 2 + [_P] * 2,
    "peapods_pair_overlap_table": [_P] * 7 + [_I] * 2 + [_P] * 2,
    "peapods_site_blocks": [_I],
    "peapods_ov_bonds": [_P] * 11 + [_I] * 2 + [_P],
    "peapods_ov_mid": [_P] * 11 + [_I] + [_P],
    "peapods_ov_finish": [_P] * 8 + [_I] * 2 + [_P],
    "peapods_houdn_bonds": [_P] * 7 + [_I] * 2 + [_P],
    "peapods_houdn_finish": [_P] * 8 + [_I] * 2 + [_P],
    "peapods_ov_bonds_table": [_P] * 12 + [_I] * 3 + [_P],
    "peapods_ov_table_ctas": [_I] * 4,
    "peapods_ov_mid_table": [_P] * 14 + [_I] * 2 + [_P],
    "peapods_ov_finish_table": [_P] * 10 + [_I] * 2 + [_P],
    "peapods_houdn_bonds_table": [_P] * 8 + [_I] * 3 + [_P],
    "peapods_houdn_finish_table": [_P] * 9 + [_I] * 2 + [_P],
    "peapods_energy_partials": [_P] * 6,
    "peapods_nb_blocks": [_I],
    "peapods_sweep_nb": [_P] * 6 + [_I] * 5 + [_P],
    "peapods_measure_nb": [_P] * 5 + [_I] * 3 + [_P],
    "peapods_sweep_nb_table": [_P] * 7 + [_I] * 11 + [_P],
    "peapods_measure_nb_table": [_P] * 5 + [_I] * 5 + [_P],
    "peapods_fk_bonds_table": [_P] * 6 + [_I] * 6 + [_P],
    "peapods_cc_table_link": [_P] * 4 + [_I] + [_P],
    "peapods_cc_table_border": [_P] * 4 + [_I] + [_P],
    "peapods_halo_blocks": [_P, _I],
    "peapods_sweep_halo": [_P] * 9 + [_I] * 5 + [_P],
    "peapods_measure_halo": [_P] * 5 + [_I] * 2 + [_P],
    "peapods_cc_band_link": [_P] * 4 + [_I] + [_P],
    "peapods_cc_band_border": [_P] * 3 + [_I] + [_P],
    "peapods_cc_band_flatten": [_P] * 3 + [_I] + [_P],
    "peapods_cc_band_export": [_P] * 5 + [_I] * 2 + [_P],
    "peapods_cc_band_merge": [_P] * 2 + [_I] * 3 + [_P],
    "peapods_cc_band_resolve": [_P] * 3 + [_I] * 3 + [_P],
    "peapods_cc_band_write": [_P] * 5 + [_I] + [_P],
    "peapods_fk_bonds_band": [_P] * 6 + [_I] * 3 + [_P],
    "peapods_fk_finish_band": [_P] * 9 + [_I] * 5 + [_P],
}

_lib = None
# of the last load: {"seconds": float, "log": str, "paths": [str]}
build_info = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library():
    """The kernel entry points of every source, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    cu = sorted(SOURCE_DIR.glob("*.cu"))
    common = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SOURCE_DIR.glob("*.cuh")):
        common.update(p.name.encode())
        common.update(p.read_bytes())
    t0 = time.perf_counter()
    outs, procs = [], []
    for src in cu:
        h = common.copy()
        h.update(src.read_bytes())
        out = BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"
        outs.append(out)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    log = []
    for out, tmp, proc in procs:
        text = proc.communicate()[0]
        log.append(f"{out.name}:\n{text}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {out.name}:"
                               f"\n{text}")
        os.replace(tmp, out)
    libs = [ctypes.CDLL(str(p)) for p in outs]
    fns = {}
    for name, argtypes in _SIGNATURES.items():
        owners = [lib for lib in libs if hasattr(lib, name)]
        if len(owners) != 1:
            raise RuntimeError(f"{name} is defined in {len(owners)} kernel "
                               "libraries, expected 1")
        fn = getattr(owners[0], name)
        fn.argtypes = argtypes
        fn.restype = _I
        fns[name] = fn
    build_info.update(seconds=time.perf_counter() - t0, log="\n".join(log),
                      paths=[str(p) for p in outs])
    _lib = SimpleNamespace(**fns)
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def device_kind(t) -> str:
    """``"cpu"`` or ``"cuda"``; raise for any other device."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {t.device} are not supported")
    return kind


def dims3(shape):
    """A lattice's extents as the kernels take them: ``(L0, L1, L2)``, with
    ``L2 = 1`` for a 2D lattice."""
    return tuple(shape) + (1,) * (3 - len(shape))


def expect(t, name, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
