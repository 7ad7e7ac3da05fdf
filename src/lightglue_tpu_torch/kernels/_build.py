"""Build and bind the port's CUDA kernels.

All sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain ``extern "C"`` interface, loaded with ctypes.
Each source compiles in its own ``nvcc`` process, all started together, and
the objects link once. The library is cached in ``build/torch_kernels/`` at
the root of the checkout under a hash of the sources, so a checkout builds
at its first kernel launch and an unchanged checkout reuses the library.
``runtime/aot.py:enable_compile_cache`` points the cache elsewhere, so a
process that finds the library there loads it without running ``nvcc``;
``builds`` counts the builds this process ran.

Every kernel wrapper is also an operator of the ``lightglue_tpu_torch``
namespace (``define_op``): a CUDA implementation (its launch), a CPU one
(its plain PyTorch version) and a fake one (output shapes, dtypes and
devices; it launches nothing), so that ``torch.export`` traces the port and
an exported program names the hand-written kernels. A wrapper called on
real tensors outside a trace runs the same two implementations without the
dispatcher; inside a trace it calls the operator (``run``).

Nothing here compiles or loads at import: the CPU tests import every
module, and this machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable

import torch

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
    "lg_conv_tile": [_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    "lg_conv_model_tile": [_I, _I, _I, ctypes.POINTER(_I)],
    "lg_conv2_chain": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "lg_chain_plan": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "lg_nms_candidates": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "lg_nms_smem_bytes": [_I],
    "lg_relu_conv1a_shift": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "lg_linear": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
    "lg_row_quant": [_P, _P, _I, _I, _I, _P, _P, _P],
    "lg_linear_s8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P],
    "lg_linear_plan": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "lg_s8_plan": [_I, _I, _I, ctypes.POINTER(_I)],
    "lg_attention": [
        _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _P, _I, _P,
        _I, _I, _I, _I, _F, _I, _I, _I, _P,
    ],
    "lg_rope_qk": [_P, _L, _L, _P, _L, _L, _P, _P, _I, _I, _I, _I, _P],
    "lg_attention_plan": [_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    "lg_ln_gelu": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _P],
    "lg_ln_gelu_plan": [_I, ctypes.POINTER(_I)],
    "lg_adaptive_decide": [
        _P, _P, _I, _I, _I, _I, _P, _P, _F, _P, _P, _F, _P, _P, _P, _P, _P,
        _I, _I, _F, _I, _P, _P, _P,
    ],
    "lg_decide_plan": [_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    "lg_fused_mha": [
        _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
        _I, _I, _I, _I, _I, _P,
    ],
    "lg_flash_attention": [
        _P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _I, _I, _I, _I,
        _F, _I, _I, _I, _I, _I, _I, _P,
    ],
    "lg_flash_attention_step": [
        _P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _P,
    ],
    "lg_flash_plan": [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
    "lg_bidirectional_cross": [
        _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _P, _P, _I, _I, _I,
        _I, _F, _I, _I, _P,
    ],
    "lg_bidir_plan": [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
}

# dynamic shared memory one Hopper block may opt into (cudaFuncSetAttribute)
MAX_DYNAMIC_SMEM = 232_448

_lib = None
_lib_dir = None  # the directory the loaded library came from
_lib_lock = threading.Lock()  # a tensor-parallel step's shard threads may load it at once
builds = 0  # nvcc builds this process ran (a warm cache runs none)


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
    global builds
    target = BUILD_DIR / f"liblg_torch_{source_digest()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    builds += 1
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
    global _lib, _lib_dir
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                path = build()
                handle = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib, _lib_dir = handle, path.parent.resolve()
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (refused launches never run)."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


# ---------------------------------------------------------------------------
# the operators: one library of the namespace, every kernel module defines
# its wrappers' operators in it
# ---------------------------------------------------------------------------

NAMESPACE = "lightglue_tpu_torch"
OPS = torch.library.Library(NAMESPACE, "DEF")


def define_op(schema: str, *, cpu: Callable, cuda: Callable, fake: Callable):
    """Define ``lightglue_tpu_torch::<schema>`` with its CPU (plain), CUDA
    (launch) and fake implementations; returns the operator's overload."""
    name = schema.split("(", 1)[0]
    OPS.define(schema)
    OPS.impl(name, cpu, "CPU")
    OPS.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=OPS)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def run(op, cpu: Callable, cuda: Callable, *args):
    """``op(*args)`` as a wrapper calls it. Given a plain tensor first,
    outside any trace (no dispatch mode, no compile), it runs the
    implementation itself, without the dispatcher: the plain version on a
    CPU tensor, the launch on any other (a meta tensor reaches its checks).
    Inside a trace (``torch.export``'s fake and functional tensors,
    ``make_fx``, ``torch.compile``) it calls the operator, so the trace
    records it. A CUDA graph capture takes the direct path, which records
    the launch. The first argument is a plain tensor while a trace runs
    under ``torch.jit.trace`` and functorch's transforms (``vmap``, ``grad``:
    their wrapped tensors are plain to Python); neither traces the port.

    Why not always the operator: on an H100's host the dispatcher adds about
    10 us to a ``linear`` call, 18 to an ``attention`` call and 6 to an
    ``ln_gelu`` call (medians of 10), which is 4.1 ms a BF16 pair eager
    (25.4 against 21.4 ms) and 2.4 ms a pair on the 4 x 1 mesh step (17.4
    against 15.0), each outside the spread of the tree without operators;
    a graph replay runs no Python either way (``scripts/
    tune_torch_dispatch.py``, PERF.md section 6)."""
    t = args[0]
    if (type(t) is torch.Tensor and not torch._C._len_torch_dispatch_stack()
            and not torch.compiler.is_compiling()):
        return (cpu if t.is_cpu else cuda)(*args)
    return op(*args)
