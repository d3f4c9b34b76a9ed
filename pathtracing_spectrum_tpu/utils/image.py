"""Host texture loading + the reference's nearest/border-black sampling rule.

Reference ``Image`` (PathTracing/src/image.{h,cpp}): stb_image RGBA8 load,
``tex2D(uv)`` returns vec4 in [0,1]; UV outside [0,1] -> black/transparent
(image.cpp:51-52); nearest-neighbour fetch at ``(int(W*u), int(H*v))`` with
row 0 at the image top (stb default). Here the standard-library PNG codec
(utils/png.py) replaces stb for PNG files, Pillow (optional) decodes other
formats, and sampling happens on-device (see ops/texturing.py) over a
padded texture table.
"""

from __future__ import annotations

import numpy as np

from . import png


class MissingDecoder(RuntimeError):
    """No decoder is installed for this image format."""


def _to_rgba(arr: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] gray / gray+alpha / RGB / RGBA -> [H, W, 4]."""
    h, w, ch = arr.shape
    if ch == 4:
        return arr
    alpha = np.full((h, w, 1), 255, np.uint8)
    if ch == 3:
        return np.concatenate([arr, alpha], axis=2)
    gray = arr[:, :, :1]
    a = arr[:, :, 1:2] if ch == 2 else alpha
    return np.concatenate([gray, gray, gray, a], axis=2)


def _decode_with_pil(path: str) -> np.ndarray:
    try:
        from PIL import Image as PILImage
    except ImportError:
        raise MissingDecoder(
            f"{path}: only 8-bit non-interlaced PNG decodes without "
            "Pillow; install Pillow for other image formats") from None
    try:
        with PILImage.open(path) as im:
            return np.asarray(im.convert("RGBA"), np.uint8)
    except OSError:
        return None


def load_rgba(path: str) -> "np.ndarray | None":
    """Load an image file as float32 RGBA [H, W, 4] in [0, 1].

    Returns None for a missing or corrupt file — the reference fails soft
    to black (image.cpp:48-49). A format no installed decoder reads
    raises :class:`MissingDecoder` instead of rendering black.
    """
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if data.startswith(png.SIGNATURE):
        try:
            arr = _to_rgba(png.decode_png(data))
        except png.UnsupportedPng:
            arr = _decode_with_pil(path)
        except png.PngError:
            return None
    else:
        arr = _decode_with_pil(path)
    if arr is None:
        return None
    return arr.astype(np.float32) / 255.0


def sample_nearest(img: "np.ndarray | None", u: float, v: float) -> np.ndarray:
    """Host-side ``tex2D`` for tests/tools (device path is ops/texturing.py)."""
    if img is None:
        return np.zeros(4, np.float32)
    if u > 1.0 or u < 0.0 or v > 1.0 or v < 0.0:
        return np.zeros(4, np.float32)
    h, w = img.shape[:2]
    x = min(int(w * u), w - 1)
    y = min(int(h * v), h - 1)
    return img[y, x]
