"""Flat, stackless BVH: host-side build + vectorised device traversal.

The reference builds a binary pointer tree by sorting ALL triangles along a
random axis at every level and median-splitting (mesh.cpp:177-221 — an
O(n log^2 n) build that duplicates single-triangle leaves), then traverses it
recursively per ray (mesh.cpp:239-280). Neither pointer-chasing nor
per-ray recursion maps to a vectorised wavefront, so this module
re-designs both:

* **Build** (host, numpy; optional C++ fast path in native/): top-down
  median split on the longest centroid axis, leaves up to ``leaf_size``
  triangles, triangles reordered so each leaf is a contiguous range.
* **Layout**: DFS preorder with *skip links* — node ``i``'s children start at
  ``i+1``; ``skip[i]`` is the next node when ``i`` is missed or finished.
  Traversal is then a data-independent ``while node < n_nodes`` loop: no
  stack, one int32 of state per ray.
* **Traversal** (device, jnp): all rays advance in lockstep inside one
  ``lax.while_loop``; finished rays idle until the last ray exits. Leaf hits
  use the same edge-inclusive same-side predicate as ops/intersect.py.

The AABB slab test keeps the reference's exact semantics (mesh.cpp:48-59):
boolean-only, no t-range pruning, miss iff ``tNear >= tFar``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import BIG


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray    # [NN, 3]
    node_max: np.ndarray    # [NN, 3]
    node_skip: np.ndarray   # [NN] int32
    node_first: np.ndarray  # [NN] int32 (valid for leaves)
    node_count: np.ndarray  # [NN] int32 (0 = internal)
    tri_order: np.ndarray   # [T] permutation applied to the triangle SoA


def build_bvh(soa, leaf_size: int = 4) -> FlatBVH:
    """Flat BVH build (host). Prefers the native binned-SAH builder
    (native/src/pts_native.cpp); falls back to Python median-split."""
    import os
    if os.environ.get("PTS_NATIVE", "1") != "0" and soa.count > 0:
        try:
            from ..native import build_bvh_native
            v1 = soa.v1.astype(np.float64)
            v2 = v1 + soa.e1.astype(np.float64)
            v3 = v1 + soa.e2.astype(np.float64)
            tri_min = np.minimum(np.minimum(v1, v2), v3).astype(np.float32)
            tri_max = np.maximum(np.maximum(v1, v2), v3).astype(np.float32)
            flat = build_bvh_native(tri_min, tri_max, leaf_size)
            if flat is not None:
                return flat
        except Exception:
            pass
    return build_bvh_median(soa, leaf_size)


def build_bvh_median(soa, leaf_size: int = 4) -> FlatBVH:
    """Median-split build over centroids (pure Python)."""
    t = soa.count
    v1 = soa.v1.astype(np.float64)
    v2 = v1 + soa.e1.astype(np.float64)
    v3 = v1 + soa.e2.astype(np.float64)
    tri_min = np.minimum(np.minimum(v1, v2), v3)
    tri_max = np.maximum(np.maximum(v1, v2), v3)
    centroid = (tri_min + tri_max) * 0.5

    order = np.arange(t, dtype=np.int64)

    node_min, node_max, node_skip, node_first, node_count = [], [], [], [], []

    # Iterative DFS preorder. Each frame: (index range into `order`,
    # patch list of nodes whose skip must point past this subtree).
    stack = [(0, t)]
    pending_skip: list = []  # (node_idx) to patch when subtree ends

    def emit(lo, hi) -> int:
        idx = len(node_min)
        sel = order[lo:hi]
        bmin = tri_min[sel].min(axis=0)
        bmax = tri_max[sel].max(axis=0)
        # degenerate-thickness fix (AABB::Check, mesh.cpp:32-46)
        same = bmax == bmin
        bmax = np.where(same, bmax + 1e-3, bmax)
        node_min.append(bmin.astype(np.float32))
        node_max.append(bmax.astype(np.float32))
        node_skip.append(-1)
        node_first.append(lo)
        node_count.append(0)
        return idx

    def build_range(lo, hi):
        idx = emit(lo, hi)
        n = hi - lo
        if n <= leaf_size:
            node_count[idx] = n
            node_skip[idx] = len(node_min)  # next emitted node
            return
        sel = order[lo:hi]
        ext = centroid[sel].max(axis=0) - centroid[sel].min(axis=0)
        axis = int(np.argmax(ext))
        key = centroid[sel, axis]
        mid = n // 2
        part = np.argpartition(key, mid)
        order[lo:hi] = sel[part]
        build_range(lo, lo + mid)
        build_range(lo + mid, hi)
        node_skip[idx] = len(node_min)

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 64 + 2 * int(np.ceil(np.log2(max(t, 2)))) * 64))
    try:
        # recursion depth ~ log2(T); explicit conversion to iterative is
        # unnecessary for realistic scenes but guard the limit anyway
        build_range(0, t)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        node_min=np.stack(node_min), node_max=np.stack(node_max),
        node_skip=np.asarray(node_skip, np.int32),
        node_first=np.asarray(node_first, np.int32),
        node_count=np.asarray(node_count, np.int32),
        tri_order=order,
    )


def _aabb_hit(ro, rd, bmin, bmax):
    """Reference slab test (mesh.cpp:48-59): boolean, no t-range output."""
    safe_rd = jnp.where(rd == 0.0, 1e-30, rd)
    t_lo = (bmin - ro) / safe_rd
    t_hi = (bmax - ro) / safe_rd
    t1 = jnp.minimum(t_lo, t_hi)
    t2 = jnp.maximum(t_lo, t_hi)
    t_near = jnp.max(t1, axis=-1)
    t_far = jnp.min(t2, axis=-1)
    return t_near < t_far


def _leaf_hits(ro, rd, v1, e1, e2, n, valid):
    """Hit distances for per-ray gathered leaf triangles.

    ro, rd: [N, 3]; v1/e1/e2/n: [N, L, 3]; valid: [N, L] bool.
    Returns t [N, L] with BIG where invalid (same predicate as
    ops/intersect.py — mesh.cpp:283-295).
    """
    ro_b = ro[:, None, :]
    rd_b = rd[:, None, :]
    denom = jnp.sum(rd_b * n, axis=-1)
    tt = jnp.sum((v1 - ro_b) * n, axis=-1) / jnp.where(denom == 0.0, 1.0, denom)
    p = ro_b + tt[..., None] * rd_b

    v2 = v1 + e1
    ba1 = e2 - e1
    s1 = jnp.sum(jnp.cross(ba1, p - v2) * jnp.cross(ba1, -e1), axis=-1)
    # s2/s3 double as barycentric numerators (alpha/beta = s * invDenom);
    # see ops/intersect.py for the triple-product identity.
    s2 = jnp.sum(jnp.cross(e2, p - v1) * jnp.cross(e2, e1), axis=-1)
    s3 = jnp.sum(jnp.cross(e1, p - v1) * jnp.cross(e1, e2), axis=-1)

    ok = (valid & (denom != 0.0) & (tt >= 0.0)
          & (s1 >= 0.0) & (s2 >= 0.0) & (s3 >= 0.0))
    return jnp.where(ok, tt, BIG), s2, s3


def intersect_bvh(ro, rd,
                  tri_v1, tri_e1, tri_e2, tri_n,
                  node_min, node_max, node_skip, node_first, node_count,
                  leaf_size: int = 4, count_iterations: bool = False):
    """Closest hit via lockstep skip-link traversal.

    Returns (hit, t, idx, s2, s3) with idx into the BVH-ordered SoA, plus
    the number of loop iterations with ``count_iterations`` (measurement:
    the loop's condition is an ``any()`` over all rays, which a GPU
    evaluates on the host once per iteration).
    """
    n_rays = ro.shape[0]
    n_nodes = node_min.shape[0]
    n_tris = tri_v1.shape[0]

    lane = jnp.arange(leaf_size, dtype=jnp.int32)[None, :]

    def cond(state):
        node = state[0]
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_t, best_i, best_s2, best_s3, iters = state
        active = node < n_nodes
        nid = jnp.where(active, node, 0)

        bmin = node_min[nid]
        bmax = node_max[nid]
        count = node_count[nid]
        first = node_first[nid]
        skip = node_skip[nid]

        box_hit = _aabb_hit(ro, rd, bmin, bmax) & active
        is_leaf = count > 0

        # --- leaf: intersect its (static leaf_size, masked) triangles ---
        do_leaf = box_hit & is_leaf
        tidx = jnp.clip(first[:, None] + lane, 0, n_tris - 1)
        valid = do_leaf[:, None] & (lane < count[:, None])
        t, s2, s3 = _leaf_hits(ro, rd, tri_v1[tidx],
                               tri_e1[tidx], tri_e2[tidx], tri_n[tidx], valid)
        local = jnp.argmin(t, axis=1)
        pick = lambda a: jnp.take_along_axis(a, local[:, None], axis=1)[:, 0]
        local_t = pick(t)
        better = local_t < best_t
        best_i = jnp.where(better, pick(tidx), best_i)
        best_t = jnp.where(better, local_t, best_t)
        best_s2 = jnp.where(better, pick(s2), best_s2)
        best_s3 = jnp.where(better, pick(s3), best_s3)

        # --- next node: descend on internal hit, else skip ---
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, node + 1, skip)
        node = jnp.where(active, nxt, node)
        return node, best_t, best_i, best_s2, best_s3, iters + 1

    state0 = (jnp.zeros(n_rays, jnp.int32), jnp.full(n_rays, BIG),
              jnp.zeros(n_rays, jnp.int32), jnp.zeros(n_rays, jnp.float32),
              jnp.zeros(n_rays, jnp.float32), jnp.zeros((), jnp.int32))
    node, best_t, best_i, best_s2, best_s3, iters = jax.lax.while_loop(
        cond, body, state0)
    out = (best_t < BIG, best_t, best_i, best_s2, best_s3)
    return out + (iters,) if count_iterations else out
