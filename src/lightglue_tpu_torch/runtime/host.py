"""ctypes binding to the native host-side ops (``native/lgtpu_native.cpp``).

Counterpart of ``lightglue_tpu/runtime/host.py``: the demo's fused
resize + grayscale + /255 conversion (``preprocess_image``) and its
fundamental-matrix RANSAC (``ransac_fundamental``), both in C++.

The port builds its own copy of the library with g++ at first use, into
``build/torch_native/`` at the root of the checkout (git-ignored), keyed by
a digest of the source and the flags as ``kernels/_build.py`` keys the CUDA
library, and written to a temporary file that is renamed into place, so two
processes that build at once never load a torn file. It never writes into
``native/``. A failed build raises with the compiler's output: nothing falls
back to numpy or cv2 (which compute other functions).

``preprocess_image_plain`` is the C++ loop restated in numpy float32 (the
tests hold the native call to it); the demo does not use it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[3]
SOURCE = _ROOT / "native" / "lgtpu_native.cpp"
BUILD_DIR = _ROOT / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "preprocess_image": (None, [_U8P, ctypes.c_int, ctypes.c_int, _F32P, ctypes.c_int,
                                ctypes.c_int]),
    "ransac_fundamental": (ctypes.c_int, [_F32P, _F32P, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_uint64, _U8P, _F64P]),
}
# demo/demo_mono.cpp:146-162's luma weights, applied before the /255
_LUMA = tuple(np.float32(c) / np.float32(255.0) for c in (0.299, 0.587, 0.114))

_lib = None


def _digest() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the native source into the cached library (if missing) and
    return its path; raise with the compiler's output if it fails."""
    target = BUILD_DIR / f"liblgtpu_native_{_digest()}.so"
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library builds with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        staged = Path(tmp) / target.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(staged), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed on {SOURCE.name}\n{proc.stdout}{proc.stderr}")
        os.replace(staged, target)  # atomic: a concurrent build sees all or nothing
    return target


def lib() -> ctypes.CDLL:
    """The loaded native library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = handle
    return _lib


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


def preprocess_image(rgb: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (out_h, out_w, 1) float32 gray in [0, 1]:
    bilinear taps at pixel centres, luma weights / 255, one pass in C++
    (demo/demo_mono.cpp:146-162 analog)."""
    out_h, out_w = out_hw
    rgb = _check_rgb(rgb)
    out = np.empty((out_h, out_w), np.float32)
    lib().preprocess_image(rgb.ctypes.data_as(_U8P), rgb.shape[0], rgb.shape[1],
                           out.ctypes.data_as(_F32P), out_h, out_w)
    return out[..., None]


def preprocess_image_plain(rgb: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """``preprocess_image`` in numpy: the C++ loop's float32 arithmetic in
    its order (taps at (o + 0.5) * in / out - 0.5, clamped to the image)."""
    f32 = np.float32
    out_h, out_w = out_hw
    rgb = _check_rgb(rgb)
    h, w = rgb.shape[:2]

    def taps(n_out, n_in):
        s = f32(n_in) / f32(n_out)
        f = (np.arange(n_out, dtype=f32) + f32(0.5)) * s - f32(0.5)
        i0 = np.floor(f).astype(np.int64)
        t = f - i0.astype(f32)
        return np.maximum(i0, 0), np.minimum(i0 + 1, n_in - 1), t

    y0, y1, ty = taps(out_h, h)
    x0, x1, tx = taps(out_w, w)
    c = rgb.astype(f32)
    gray = _LUMA[0] * c[..., 0] + _LUMA[1] * c[..., 1] + _LUMA[2] * c[..., 2]
    ty, tx = ty[:, None], tx[None, :]
    one = f32(1)
    out = (gray[y0][:, x0] * (one - ty) * (one - tx) + gray[y0][:, x1] * (one - ty) * tx
           + gray[y1][:, x0] * ty * (one - tx) + gray[y1][:, x1] * ty * tx)
    return out.astype(f32)[..., None]


def _check_rgb(rgb: np.ndarray) -> np.ndarray:
    if rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) RGB image, got {rgb.shape}")
    return np.ascontiguousarray(rgb, dtype=np.uint8)


def ransac_fundamental(
    pts0: np.ndarray,
    pts1: np.ndarray,
    max_iters: int = 500,
    threshold: float = 3.0,
    seed: int = 888,
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Fundamental-matrix RANSAC over matched points (the demo's
    cv::findFundamentalMat verification step, demo/demo_mono.cpp:339-346):
    normalised 8-point fits scored by Sampson distance, deterministic in
    ``seed``. Fewer than 8 points give 0 inliers and a zero F.

    Returns (num_inliers, inlier_mask bool (N,), F (3, 3) float64)."""
    pts0 = np.ascontiguousarray(pts0, np.float32).reshape(-1, 2)
    pts1 = np.ascontiguousarray(pts1, np.float32).reshape(-1, 2)
    if len(pts0) != len(pts1):
        raise ValueError(f"{len(pts0)} points against {len(pts1)}")
    n = len(pts0)
    mask = np.zeros(n, np.uint8)
    F = np.zeros(9, np.float64)
    count = lib().ransac_fundamental(
        pts0.ctypes.data_as(_F32P), pts1.ctypes.data_as(_F32P), n, max_iters, threshold,
        seed, mask.ctypes.data_as(_U8P), F.ctypes.data_as(_F64P))
    return count, mask.astype(bool), F.reshape(3, 3)
