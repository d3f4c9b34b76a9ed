"""The standard-library PNG codec and texture loading without Pillow."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

from pathtracing_spectrum_tpu.utils import image, png

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets")


@pytest.mark.parametrize("shape", [(7, 5), (6, 9, 3), (4, 11, 4)])
def test_round_trip(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(
        0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    back = png.read_png(path)
    assert back.shape == (shape[0], shape[1],
                          shape[2] if len(shape) == 3 else 1)
    np.testing.assert_array_equal(back.reshape(img.shape), img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_filtered(img, ftype):
    """Encode uint8 [H, W, C] with every scanline filtered by ``ftype``
    (an independent encoder for the decoder's five filters)."""
    h, w, ch = img.shape
    raw = img.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    for y in range(h):
        out.append(ftype)
        for x in range(w * ch):
            a = raw[y, x - ch] if x >= ch else 0
            b = raw[y - 1, x] if y else 0
            c = raw[y - 1, x - ch] if (y and x >= ch) else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            out.append((raw[y, x] - pred) & 0xFF)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_decode_every_filter_and_color_type(ftype, ch):
    img = np.random.default_rng(ftype * 10 + ch).integers(
        0, 256, (5, 7, ch)).astype(np.uint8)
    np.testing.assert_array_equal(
        png.decode_png(_encode_filtered(img, ftype)), img)


def test_checker_asset_decodes_to_generated_pattern():
    sys.path.insert(0, ASSETS)
    import make_assets

    got = png.read_png(os.path.join(ASSETS, "checker.png"))
    assert got.shape == (128, 128, 4)
    np.testing.assert_array_equal(got, make_assets.checker_rgba())


def test_corrupt_png_raises_png_error():
    data = png.encode_png(np.zeros((4, 4), np.uint8))
    bad = data[:40] + bytes([data[40] ^ 0xFF]) + data[41:]
    with pytest.raises(png.PngError):
        png.decode_png(bad)
    with pytest.raises(png.PngError):
        png.decode_png(data[:30])


def test_load_rgba_without_pillow(tmp_path, monkeypatch):
    """A PNG texture loads with no imaging package; a missing or corrupt
    file fails soft to black (None); a format no decoder reads raises."""
    monkeypatch.setitem(sys.modules, "PIL", None)     # import PIL fails
    rgb = np.random.default_rng(0).integers(0, 256, (3, 5, 3)).astype(
        np.uint8)
    p = str(tmp_path / "t.png")
    png.write_png(p, rgb)
    got = image.load_rgba(p)
    assert got.shape == (3, 5, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :3], rgb / np.float32(255.0))
    assert (got[..., 3] == 1.0).all()

    assert image.load_rgba(str(tmp_path / "missing.png")) is None
    corrupt = str(tmp_path / "corrupt.png")
    with open(corrupt, "wb") as f:
        f.write(png.SIGNATURE + b"\x00garbage")
    assert image.load_rgba(corrupt) is None

    other = str(tmp_path / "t.jpg")
    with open(other, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(image.MissingDecoder):
        image.load_rgba(other)
