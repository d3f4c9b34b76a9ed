"""Bounce-ray reorder primitives (sort keys, segments, scene bounds).

Kept separate from engine.py so the key schedule has exactly one home.
Reordering is opt-in (``trace_radiance(reorder=True)``): it pays only for
an intersection that culls per block of rays, which neither the dense
kernel nor the BVH does, so its only effect today is dead-ray compaction.

Design notes:

* Key = (dead bit, direction octant, origin morton cell). Octant first,
  morton second so each block of rays gets tight origin bounds. Dead
  rays key to the top bucket so live rays compact to the front.
* Sorts run per SEGMENT, not globally, and a segment-local permutation
  lets the inverse be another segmented argsort instead of a scatter.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

# Reorder key layout: morton bits per origin axis; PTS_REORDER_POS_BITS
# overrides it. Result-exact for any value (any permutation is).
REORDER_POS_BITS = int(os.environ.get("PTS_REORDER_POS_BITS", "4"))
if not 1 <= REORDER_POS_BITS <= 9:
    raise ValueError(f"PTS_REORDER_POS_BITS={REORDER_POS_BITS}: "
                     "expected 1..9 (3 bits/axis must fit int32 below "
                     "the material/dead bits)")

# Segment size for the segmented sorts (64 blocks of 1024 rays). Rays
# only move within their segment, so dead-ray compaction and octant
# grouping become per-segment; PTS_REORDER_SEGMENT overrides it
# (result-exact either way — any permutation is).
REORDER_SEGMENT = int(os.environ.get("PTS_REORDER_SEGMENT", "65536"))

# Size-aware GLOBAL segment: a globally sorted wavefront gives
# octant-pure blocks everywhere, which only pays where the bounce sweep
# dominates — large scenes at moderate wavefront widths. Policy: one
# global segment iff n_tris >= 128k AND the wavefront is <= 262144 rays;
# PTS_REORDER_SEGMENT overrides (then segment_for alone decides). The
# thresholds were tuned before the GPU port and await re-measurement on the
# GPU (ROADMAP).
REORDER_GLOBAL_SEG_MIN_TRIS = 131072
REORDER_GLOBAL_SEG_MAX_N = 262144


def segment_for(n: int) -> int:
    """Largest segment <= REORDER_SEGMENT dividing ``n`` in whole
    1024-ray blocks; falls back to one global segment."""
    for d in range(REORDER_SEGMENT // 1024, 0, -1):
        if n % (1024 * d) == 0:
            return 1024 * d
    return n


def segment_policy(n: int, n_tris: int) -> int:
    """The engine's segment choice: the size-aware default (global
    segment for large scenes at moderate wavefront widths — see above),
    unless PTS_REORDER_SEGMENT pins the cap."""
    if "PTS_REORDER_SEGMENT" not in os.environ \
            and n_tris >= REORDER_GLOBAL_SEG_MIN_TRIS \
            and n <= REORDER_GLOBAL_SEG_MAX_N:
        return n
    return segment_for(n)


def scene_bounds(scene):
    """(smin[3], 1/extent[3]) of the scene root box — the morton-cell
    quantisation frame."""
    smin, smax = scene.root_aabb[0], scene.root_aabb[1]
    return smin, 1.0 / jnp.maximum(smax - smin, 1e-6)


def sort_key(ox, oy, oz, dx, dy, dz, alive, smin, inv_ext, morton: bool,
             mat=None):
    """The engines' reorder key (see module docstring for the layout).

    ``morton=False`` keeps only the dead bit (backends without block
    culling gain nothing from coherence; the sort still compacts).

    ``mat`` (A/B gear, PTS_SORT_MAT): the previous hit's material type
    (int32 in 0..3) keyed ABOVE the octant — the "material-sorted
    shading queues" north-star hypothesis. Result-exact (any permutation
    is).
    """
    mat_shift = 3 * REORDER_POS_BITS + 3
    dead_bit = jnp.int32(1) << (mat_shift + (2 if mat is not None else 0))
    if not morton:
        return jnp.where(alive, 0, dead_bit)
    cells = 1 << REORDER_POS_BITS

    def q(v, lo, ie):
        return jnp.clip(((v - lo) * ie * cells).astype(jnp.int32),
                        0, cells - 1)

    qx = q(ox, smin[0], inv_ext[0])
    qy = q(oy, smin[1], inv_ext[1])
    qz = q(oz, smin[2], inv_ext[2])
    m = jnp.zeros_like(qx)
    for b in range(REORDER_POS_BITS):
        m = (m | (((qx >> b) & 1) << (3 * b + 2))
             | (((qy >> b) & 1) << (3 * b + 1))
             | (((qz >> b) & 1) << (3 * b)))
    octant = ((dx < 0).astype(jnp.int32) * 4
              + (dy < 0).astype(jnp.int32) * 2
              + (dz < 0).astype(jnp.int32))
    key = (octant << (3 * REORDER_POS_BITS)) | m
    if mat is not None:
        # mask to the 2-bit field: a future MaterialType >= 4 must not
        # overflow into the dead bit (mat=4 would equal dead_bit and key
        # live rays into the dead bucket, silently defeating compaction)
        key = key | ((mat & 3) << mat_shift)
    return jnp.where(alive, key, dead_bit)
