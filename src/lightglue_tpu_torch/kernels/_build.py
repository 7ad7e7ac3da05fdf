"""Build and bind the port's CUDA kernels.

All sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain ``extern "C"`` interface, loaded with ctypes.
Each source compiles in its own ``nvcc`` process, all started together, and
the objects link once. The library is cached in ``build/torch_kernels/`` at
the root of the checkout under a hash of the sources, so a checkout builds
at its first kernel launch and an unchanged checkout reuses the library.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# the package runs from a checkout's src/ tree: <root>/src/lightglue_tpu_torch
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# name -> argtypes; every function returns its launch's cudaError_t
_SIGNATURES = {
    "lg_conv3x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "lg_conv2_chain": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "lg_nms_candidates": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "lg_linear": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
    "lg_linear_tile": [_I, _I, ctypes.POINTER(_I)],
    "lg_attention": [
        _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P, _P, _I, _P,
        _I, _I, _I, _I, _F, _I, _I, _P,
    ],
    "lg_rope_qk": [_P, _L, _L, _P, _L, _L, _P, _P, _I, _I, _I, _P],
    "lg_attention_row_groups": [_I, _I, _I],
    "lg_ln_gelu": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _P],
    "lg_adaptive_decide": [
        _P, _P, _I, _I, _I, _I, _P, _P, _F, _P, _P, _F, _P, _P, _P, _P, _P,
        _I, _I, _F, _I, _P,
    ],
    "lg_fused_mha": [
        _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
        _I, _I, _I, _I, _P,
    ],
    "lg_flash_attention": [
        _P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _I, _I, _I, _I,
        _F, _I, _I, _I, _I, _I, _P,
    ],
    "lg_flash_attention_step": [
        _P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P,
    ],
    "lg_bidirectional_cross": [
        _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P, _P, _I, _I, _I,
        _I, _F, _I, _I, _P,
    ],
}

# dynamic shared memory one Hopper block may opt into (cudaFuncSetAttribute)
MAX_DYNAMIC_SMEM = 232_448

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a CUDA host")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_digest() -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into the cached library (if missing) and return its path."""
    target = BUILD_DIR / f"liblg_torch_{source_digest()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(
                (src, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                ))
            )
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name}:\n{out.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        staged = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(staged)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
        os.replace(staged, target)  # atomic: a concurrent build sees all or nothing
    return target


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (refused launches never run)."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
