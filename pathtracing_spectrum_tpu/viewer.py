"""Framebuffer readback viewer.

The reference displays the running mean as a single-channel grayscale image:
each frame it converts ``spectrumResult[pixel][channel] * 255`` into an RGB8
texture (main.cpp:3437-3453) blitted by the quad shader, whose channel
selector mirrors the left-bar wave choice (shaders.h:29-52, main.cpp:2298+).
Here the GL/ImGui stack is replaced by host-side readback: grayscale
conversion, PNG export, and a terminal ASCII preview. Values are clamped to
[0, 255] (the reference's raw float->GLubyte conversion overflows instead).
"""

from __future__ import annotations

import numpy as np

from .utils.png import write_png


def to_grayscale(image: np.ndarray, channel: int,
                 scale: float = 255.0) -> np.ndarray:
    """[H, W, nw] spectral image -> uint8 [H, W] for one wave channel."""
    img = np.asarray(image)
    if img.ndim != 3 or not (0 <= channel < img.shape[2]):
        return np.zeros(img.shape[:2], np.uint8)
    chan = np.nan_to_num(img[:, :, channel], nan=0.0)
    return np.clip(chan * scale, 0.0, 255.0).astype(np.uint8)


def normalized_grayscale(image: np.ndarray, channel: int) -> np.ndarray:
    """Auto-exposure variant: channel max -> white (useful for thermal
    radiance values far from [0,1])."""
    img = np.asarray(image)
    chan = np.nan_to_num(img[:, :, channel], nan=0.0)
    mx = chan.max()
    if mx <= 0:
        return np.zeros(chan.shape, np.uint8)
    return np.clip(chan / mx * 255.0, 0.0, 255.0).astype(np.uint8)


def save_png(image: np.ndarray, channel: int, path: str,
             normalize: bool = True) -> None:
    gray = (normalized_grayscale(image, channel) if normalize
            else to_grayscale(image, channel))
    write_png(path, gray)


def save_all_channels_png(image: np.ndarray, path_prefix: str,
                          normalize: bool = True) -> list:
    paths = []
    for k in range(np.asarray(image).shape[2]):
        p = f"{path_prefix}_ch{k}.png"
        save_png(image, k, p, normalize=normalize)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# CIE XYZ -> sRGB for visible-range spectral renders (BASELINE.json north
# star; the reference displays one grayscale channel only). Scenes author
# wavenumbers in 1/cm: samples whose wavelength 1e7/v lies in the visible
# band contribute through the CIE 1931 2-degree observer; pure-thermal-IR
# scenes legitimately map to black.
# ---------------------------------------------------------------------------

def _cie_gauss(x, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz_bar(lambda_nm: np.ndarray) -> np.ndarray:
    """CIE 1931 2-deg color matching functions, [.., 3] (x̄, ȳ, z̄).

    Multi-lobe Gaussian fit of Wyman, Sloan & Shirley, JCGT 2013 — max
    error below 1% of peak, no 400-entry table needed."""
    lam = np.asarray(lambda_nm, np.float64)
    x = (1.056 * _cie_gauss(lam, 599.8, 37.9, 31.0)
         + 0.362 * _cie_gauss(lam, 442.0, 16.0, 26.7)
         - 0.065 * _cie_gauss(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _cie_gauss(lam, 568.8, 46.9, 40.5)
         + 0.286 * _cie_gauss(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _cie_gauss(lam, 437.0, 11.8, 36.0)
         + 0.681 * _cie_gauss(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], axis=-1)


_XYZ_TO_SRGB = np.array([[3.2406, -1.5372, -0.4986],
                         [-0.9689, 1.8758, 0.0415],
                         [0.0557, -0.2040, 1.0570]])


def spectral_to_srgb(image: np.ndarray, wavenumbers,
                     exposure: float = 0.0,
                     auto_expose: bool = True) -> np.ndarray:
    """[H, W, nw] spectral radiance + wavenumbers (1/cm) -> uint8 sRGB.

    XYZ is the CMF-weighted sum over the scene's spectral samples (the
    renderer's channels are point samples of the radiance spectrum), then
    the D65 sRGB matrix + gamma. ``auto_expose`` scales the 99.5th
    percentile of Y to white; ``exposure`` adds stops on top.
    """
    img = np.nan_to_num(np.asarray(image, np.float64), nan=0.0)
    lam_nm = 1e7 / np.maximum(np.asarray(wavenumbers, np.float64), 1e-9)
    cmf = cie_xyz_bar(lam_nm)                        # [nw, 3]
    xyz = img @ cmf                                  # [H, W, 3]
    if auto_expose:
        ref = np.percentile(xyz[:, :, 1], 99.5)
        if ref > 0:
            xyz = xyz / ref
    xyz = xyz * (2.0 ** exposure)
    rgb = xyz @ _XYZ_TO_SRGB.T
    rgb = np.clip(rgb, 0.0, 1.0)
    srgb = np.where(rgb <= 0.0031308, 12.92 * rgb,
                    1.055 * rgb ** (1.0 / 2.4) - 0.055)
    return np.clip(srgb * 255.0, 0.0, 255.0).astype(np.uint8)


def spectral_to_srgb_device(image, wavenumbers, exposure: float = 0.0,
                            auto_expose: bool = True):
    """Device (jnp) sRGB epilogue: [..., nw] spectral -> uint8 [..., 3].

    The same pipeline as :func:`spectral_to_srgb` (CMF weighting, 99.5th
    percentile auto-exposure, D65 sRGB matrix, gamma) run ON the
    accumulator's device, so a live viewer or ``--png-srgb`` reads back
    3 uint8 planes instead of the full f32 spectral image. f32 where the
    host path is f64 — agreement within 1-2 uint8 steps (pinned by
    test_cli_viewer.test_srgb_device_matches_host).
    """
    import jax
    import jax.numpy as jnp

    img = jnp.nan_to_num(jnp.asarray(image, jnp.float32), nan=0.0)
    # the CMF fit is nw tiny host-side values; the H*W*nw work is on device
    lam_nm = 1e7 / np.maximum(np.asarray(wavenumbers, np.float64), 1e-9)
    cmf = jnp.asarray(cie_xyz_bar(lam_nm), jnp.float32)       # [nw, 3]
    # HIGHEST: a default-precision f32 product may run in TF32 on a GPU
    hi = jax.lax.Precision.HIGHEST
    xyz = jnp.matmul(img, cmf, precision=hi)
    if auto_expose:
        ref = jnp.percentile(xyz[..., 1], 99.5)
        xyz = jnp.where(ref > 0, xyz / jnp.where(ref > 0, ref, 1.0), xyz)
    xyz = xyz * jnp.float32(2.0 ** exposure)
    rgb = jnp.matmul(xyz, jnp.asarray(_XYZ_TO_SRGB.T, jnp.float32),
                     precision=hi)
    rgb = jnp.clip(rgb, 0.0, 1.0)
    srgb = jnp.where(rgb <= 0.0031308, 12.92 * rgb,
                     1.055 * rgb ** (1.0 / 2.4) - 0.055)
    return jnp.clip(srgb * 255.0, 0.0, 255.0).astype(jnp.uint8)


def save_srgb_png(image, wavenumbers, path: str,
                  exposure: float = 0.0) -> None:
    if not isinstance(image, np.ndarray):
        try:
            import jax
            is_dev = isinstance(image, jax.Array)
        except Exception:
            is_dev = False
        if is_dev:
            # device epilogue + one small uint8 readback
            arr = np.asarray(spectral_to_srgb_device(image, wavenumbers,
                                                     exposure=exposure))
            write_png(path, arr)
            return
    write_png(path, spectral_to_srgb(image, wavenumbers, exposure=exposure))


_ASCII_RAMP = " .:-=+*#%@"


def ascii_preview(image: np.ndarray, channel: int, width: int = 64,
                  normalize: bool = True) -> str:
    """Terminal preview of one channel (rows subsampled 2:1 for aspect)."""
    gray = (normalized_grayscale(image, channel) if normalize
            else to_grayscale(image, channel)).astype(np.float32) / 255.0
    h, w = gray.shape
    step = max(1, w // width)
    sub = gray[::step * 2, ::step]
    idx = np.clip((sub * (len(_ASCII_RAMP) - 1)).astype(int), 0,
                  len(_ASCII_RAMP) - 1)
    return "\n".join("".join(_ASCII_RAMP[v] for v in row) for row in idx)
