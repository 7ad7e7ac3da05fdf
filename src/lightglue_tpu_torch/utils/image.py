"""Host-side image IO and preprocessing (copy of lightglue_tpu/utils/image.py).

Mirrors the reference's Python utils (lightglue_pytorch_with_plugin/utils.py:
8-76: cv2 read, area-interp resize of the longest edge or to a fixed size,
/255 normalize) and its demo pre-process (demo/demo_mono.cpp:146-162: resize
to 640x480 + grayscale + fp32/255). Output is NHWC float32, the layout the
port's ``MatcherSession`` takes.

cv2 is used when available; PIL is the fallback. The demo's per-frame
conversion runs in C++ instead (``runtime.host.preprocess_image``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


_GRAY_WEIGHTS = np.asarray([0.299, 0.587, 0.114], np.float32)  # utils.py:73-76


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Read an image as RGB uint8 (H, W, 3) or grayscale (H, W)."""
    if _HAS_CV2:
        mode = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
        img = cv2.imread(path, mode)
        if img is None:
            raise IOError(f"Could not read image at {path}.")
        if not grayscale:
            img = img[..., ::-1]  # BGR -> RGB
        return np.ascontiguousarray(img)
    from PIL import Image

    img = Image.open(path)
    img = img.convert("L" if grayscale else "RGB")
    return np.asarray(img)


def resize_image(
    image: np.ndarray,
    size: Union[int, Sequence[int]],
    fn: str = "max",
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Resize to a fixed (h, w) or scale the max/min edge to ``size``."""
    h, w = image.shape[:2]
    agg = {"max": max, "min": min}[fn]
    if isinstance(size, int):
        scale = size / agg(h, w)
        h_new, w_new = int(round(h * scale)), int(round(w * scale))
    else:
        h_new, w_new = size
    scales = (w_new / w, h_new / h)
    if _HAS_CV2:
        out = cv2.resize(image, (w_new, h_new), interpolation=cv2.INTER_AREA)
    else:
        from PIL import Image

        out = np.asarray(
            Image.fromarray(image).resize((w_new, h_new), Image.BILINEAR)
        )
    return out, scales


def rgb_to_grayscale(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) float or uint8 RGB -> (H, W) float32 luma."""
    if image.ndim == 2:
        return image.astype(np.float32)
    return (image.astype(np.float32) @ _GRAY_WEIGHTS).astype(np.float32)


def load_image(
    path: str,
    resize: Optional[Union[int, Sequence[int]]] = None,
    grayscale: bool = True,
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Load -> optional resize -> grayscale -> (H, W, 1) float32 in [0, 1]."""
    img = read_image(path, grayscale=False)
    scales = (1.0, 1.0)
    if resize is not None:
        img, scales = resize_image(img, resize)
    if grayscale:
        img = rgb_to_grayscale(img) / 255.0
        return img[..., None].astype(np.float32), scales
    return (img.astype(np.float32) / 255.0), scales


def pad_to_multiple(image: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Zero-pad H/W up to a multiple (SuperPoint needs stride-8 dims)."""
    h, w = image.shape[:2]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return image
    pads = [(0, ph), (0, pw)] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, pads)
