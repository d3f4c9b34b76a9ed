"""Pinhole camera, exactly reproducing the reference's ray generation.

Reference ``PathTracer::RenderFrame`` camera setup (pathtracer.cpp:560-571)
and ``SetCamera``/``SetProjection`` clamps (pathtracer.cpp:336-353):

* image plane centred at ``pos + dir * focal``,
* plane height ``2 * focal * tan(fovy_deg/2)``, width ``height * aspect``,
* ``right = normalize(cross(up, dir))``,
* ray through the *top-left corner* of each pixel — the reference has **no
  sub-pixel jitter** (its ``seed`` variable at pathtracer.cpp:591 is unused).
  ``jitter=True`` enables proper sub-pixel sampling as an opt-in improvement;
  the default stays off for RMSE parity with the reference.

Rays are generated for all pixels at once as flat [N, 3] arrays; row 0 of the
output image is the top row (the reference stores rows flipped and flips
again on export — main.cpp:964, pathtracer.cpp:595 — so exported text is
top-to-bottom, which this ordering reproduces directly).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Camera:
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    focal: float = 0.1
    fovy_deg: float = 90.0

    def clamped(self) -> "Camera":
        """SetProjection clamps (pathtracer.cpp:343-353)."""
        f = self.focal if self.focal > 0.0 else 0.1
        fovy = self.fovy_deg
        if fovy <= 0.0:
            fovy = 0.1
        elif fovy >= 180.0:
            fovy = 179.5
        d = np.asarray(self.direction, np.float64)
        u = np.asarray(self.up, np.float64)
        d = d / np.linalg.norm(d)
        u = u / np.linalg.norm(u)
        return Camera(tuple(self.position), tuple(d), tuple(u), f, fovy)


def tile_order(width: int, height: int, tile: int = 32):
    """Permutation putting pixels in tile-major order, and its inverse.

    In scanline order a block of consecutive rays is a strip crossing the
    whole image; in 32x32 tile order it is a compact screen region, so the
    rays a kernel program or BVH traversal step handles together are
    spatially coherent.

    Returns (perm, inv_perm) int32 arrays of length width*height such that
    ``flat_tiled = flat[perm]`` and ``flat = flat_tiled[inv_perm]``.
    """
    idx = np.arange(width * height, dtype=np.int64)
    y, x = idx // width, idx % width
    ty, tx = y // tile, x // tile
    key = (((ty * ((width + tile - 1) // tile) + tx) << 20)
           + (y % tile) * tile + (x % tile))
    perm = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return perm, inv


class JitterCam(NamedTuple):
    """Device-side camera parameters for in-dispatch jittered ray
    generation (batched jitter mode: rays are re-generated per sample
    INSIDE ``render_samples``'s fori body instead of one host dispatch per
    sample).

    ``px``/``py`` are the integer pixel coordinates of each ray slot in
    the engine's ray order (tile order when tile_ordering is on), so the
    jitter is drawn directly in that order — same estimator as the
    host-side path, different (but equally i.i.d.) variate-to-pixel
    assignment."""

    px: jnp.ndarray        # [N] f32 pixel x in ray-slot order
    py: jnp.ndarray        # [N] f32 pixel y
    pos: jnp.ndarray       # [3]
    top_left: jnp.ndarray  # [3]
    right: jnp.ndarray     # [3]
    up: jnp.ndarray        # [3]
    dx: jnp.ndarray        # [] pixel width on the image plane
    dy: jnp.ndarray        # [] pixel height


def jitter_cam_arrays(cam: Camera, width: int, height: int,
                      perm: "np.ndarray | None" = None) -> JitterCam:
    """Build the JitterCam bundle (same image-plane setup as camera_rays,
    pathtracer.cpp:560-571). ``perm`` maps ray slots to scanline pixels."""
    cam = cam.clamped()
    pos = np.asarray(cam.position, np.float32)
    d = np.asarray(cam.direction, np.float32)
    up = np.asarray(cam.up, np.float32)
    img_center = pos + d * cam.focal
    img_h = 2.0 * cam.focal * math.tan(math.radians(cam.fovy_deg / 2.0))
    img_w = img_h * (float(width) / float(height))
    right = np.cross(up, d)
    right = (right / np.linalg.norm(right)).astype(np.float32)
    top_left = img_center - right * (img_w * 0.5) + up * (img_h * 0.5)
    idx = np.arange(width * height, dtype=np.int64)
    if perm is not None:
        idx = np.asarray(perm, np.int64)
    px = (idx % width).astype(np.float32)
    py = (idx // width).astype(np.float32)
    return JitterCam(jnp.asarray(px), jnp.asarray(py), jnp.asarray(pos),
                     jnp.asarray(top_left.astype(np.float32)),
                     jnp.asarray(right), jnp.asarray(up),
                     jnp.float32(img_w / float(width)),
                     jnp.float32(img_h / float(height)))


def jittered_dirs(jc: JitterCam, u, v):
    """[N, 3] normalized ray directions for sub-pixel offsets (u, v) in
    [0, 1) — the jittered form of camera_rays' pixel-corner rays."""
    xo = (jc.px + u) * jc.dx
    yo = (jc.py + v) * jc.dy
    pix = (jc.top_left[None, :] - jc.up[None, :] * yo[:, None]
           + jc.right[None, :] * xo[:, None])
    dirs = pix - jc.pos[None, :]
    return dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)


def camera_rays(cam: Camera, width: int, height: int,
                key: "jax.Array | None" = None, jitter: bool = False):
    """Generate primary rays.

    Returns (origins [N,3], directions [N,3]) with N = width*height, row-major
    with row 0 = image top.
    """
    cam = cam.clamped()
    pos = jnp.asarray(cam.position, jnp.float32)
    d = jnp.asarray(cam.direction, jnp.float32)
    up = jnp.asarray(cam.up, jnp.float32)

    img_center = pos + d * cam.focal
    img_h = 2.0 * cam.focal * math.tan(math.radians(cam.fovy_deg / 2.0))
    aspect = float(width) / float(height)
    img_w = img_h * aspect
    dx = img_w / float(width)
    dy = img_h / float(height)
    right = jnp.cross(up, d)
    right = right / jnp.linalg.norm(right)

    top_left = img_center - right * (img_w * 0.5) + up * (img_h * 0.5)

    jj, ii = jnp.meshgrid(jnp.arange(width, dtype=jnp.float32),
                          jnp.arange(height, dtype=jnp.float32))
    if jitter and key is not None:
        kx, ky = jax.random.split(key)
        jj = jj + jax.random.uniform(kx, jj.shape)
        ii = ii + jax.random.uniform(ky, ii.shape)
    pixel = (top_left[None, None, :]
             - up[None, None, :] * (ii * dy)[..., None]
             + right[None, None, :] * (jj * dx)[..., None])
    dirs = pixel - pos[None, None, :]
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    n = width * height
    origins = jnp.broadcast_to(pos, (n, 3))
    return origins, dirs.reshape(n, 3)
