"""Minimal PNG codec on the standard library (``zlib`` + ``struct``).

Reads 8-bit, non-interlaced gray, gray+alpha, RGB and RGBA images with all
five scanline filters; writes 8-bit gray, RGB and RGBA. That covers the
textures the renderer samples and every PNG it saves, so the render path
needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# color type -> channels (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class PngError(ValueError):
    """The file is not a well-formed PNG (truncated, bad CRC, bad data)."""


class UnsupportedPng(PngError):
    """A well-formed PNG this codec does not decode (bit depth, palette,
    interlacing)."""


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PngError("truncated chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise PngError(f"CRC mismatch in {ctype!r} chunk")
        yield ctype, body
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise PngError("missing IEND chunk")


def _paeth_row(raw: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    upb = up.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = upb[i]
        c = upb[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    upb = up.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + upb[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise PngError("image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:     # Sub: running sum per channel, mod 256
            cur = (np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint32)
                   .astype(np.uint8).reshape(stride))
        elif ftype == 2:     # Up
            cur = line + prev
        elif ftype == 3:     # Average
            cur = _average_row(line, prev, bpp)
        elif ftype == 4:     # Paeth
            cur = _paeth_row(line, prev, bpp)
        else:
            raise PngError(f"unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C] (C = 1 gray, 2 gray+alpha, 3, 4)."""
    if not data.startswith(SIGNATURE):
        raise PngError("not a PNG file")
    header = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError("missing IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise UnsupportedPng(f"bit depth {depth}, color type {ctype}, "
                             f"interlace {interlace}")
    if comp != 0 or filt != 0:
        raise PngError("unknown compression or filter method")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngError(f"bad image data: {e}") from None
    ch = _CHANNELS[ctype]
    return _unfilter(raw, h, w, ch).reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] gray, [H, W, 3] RGB or [H, W, 4] RGBA -> PNG bytes."""
    arr = np.ascontiguousarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, ch = arr.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise ValueError(f"cannot write a PNG with {ch} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * ch)], axis=1)   # filter 0

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
