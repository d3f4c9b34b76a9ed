"""Device-side texture tables and nearest sampling.

The reference samples textures per hit with nearest-neighbour lookup and a
border-black rule for UVs outside [0,1] (image.cpp:46-64) and reads ASCII
temperature grids the same way (pathtracer.h:29-35). On device, all textures
of a kind live in one padded table ``[K, Hmax, Wmax, C]`` with a per-texture
(w, h) so lookups are a single gather — no host round-trips per hit.

Exact-index note: the reference computes ``(int(W*u), int(H*v))`` which reads
out of bounds at u==1 or v==1 (undefined behaviour in C++); we clamp to the
last texel, the only defensible reading.
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp
import numpy as np


def build_texture_table(images: List[np.ndarray], channels: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad variable-size images into one table.

    Args:
      images: list of [H, W, C] (or [H, W] if channels == 0) float32 arrays.
      channels: 4 for RGBA textures, 0 for scalar grids.

    Returns:
      (table, sizes): table [K, Hmax, Wmax(, C)] and sizes [K, 2] = (w, h).
      With no images, returns a zero-length table ([0, 1, 1(, C)]) — its
      static shape lets jitted code skip sampling entirely.
    """
    shape_tail = (channels,) if channels else ()
    if not images:
        return (np.zeros((0, 1, 1) + shape_tail, np.float32),
                np.zeros((0, 2), np.int32))
    hm = max(im.shape[0] for im in images)
    wm = max(im.shape[1] for im in images)
    table = np.zeros((len(images), hm, wm) + shape_tail, np.float32)
    sizes = np.zeros((len(images), 2), np.int32)
    for i, im in enumerate(images):
        table[i, :im.shape[0], :im.shape[1]] = im
        sizes[i] = (im.shape[1], im.shape[0])
    return table, sizes


def sample_nearest_wh(table, tex_id, w, h, u, v):
    """Nearest fetch with per-ray (w, h) provided as arrays.

    Avoids the per-ray ``sizes[tid]`` int gathers: the engine fetches w/h
    with the rest of the packed shading table row instead.
    """
    tid = jnp.maximum(tex_id, 0)
    wi = jnp.maximum(w.astype(jnp.int32), 1)
    hi = jnp.maximum(h.astype(jnp.int32), 1)
    x = jnp.clip((w * u).astype(jnp.int32), 0, wi - 1)
    y = jnp.clip((h * v).astype(jnp.int32), 0, hi - 1)
    k, hm, wm = table.shape[0], table.shape[1], table.shape[2]
    flat = table.reshape((k * hm * wm,) + table.shape[3:])
    vals = flat[(tid * hm + y) * wm + x]
    in_bounds = ((u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
                 & (tex_id >= 0))
    if vals.ndim > in_bounds.ndim:
        in_bounds = in_bounds[..., None]
    return jnp.where(in_bounds, vals, 0.0)


def sample_nearest(table, sizes, tex_id, uv):
    """Nearest-neighbour fetch with the reference's border-black rule.

    Args:
      table: [K, Hm, Wm, C] or [K, Hm, Wm].
      sizes: [K, 2] int32 (w, h).
      tex_id: [N] int32, -1 = no texture (returns zeros).
      uv: [N, 2] float32.

    Returns:
      [N, C] (or [N]) float32 samples; zeros outside [0,1] or for tex_id -1.
    """
    u, v = uv[..., 0], uv[..., 1]
    tid = jnp.maximum(tex_id, 0)
    w = sizes[tid, 0].astype(jnp.float32)
    h = sizes[tid, 1].astype(jnp.float32)
    x = jnp.clip((w * u).astype(jnp.int32), 0, sizes[tid, 0] - 1)
    y = jnp.clip((h * v).astype(jnp.int32), 0, sizes[tid, 1] - 1)
    # Flatten to a single leading-axis row gather instead of a [tid, y, x]
    # multi-axis gather.
    k, hm, wm = table.shape[0], table.shape[1], table.shape[2]
    flat = table.reshape((k * hm * wm,) + table.shape[3:])
    vals = flat[(tid * hm + y) * wm + x]
    in_bounds = ((u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
                 & (tex_id >= 0))
    if vals.ndim > in_bounds.ndim:
        in_bounds = in_bounds[..., None]
    return jnp.where(in_bounds, vals, 0.0)
