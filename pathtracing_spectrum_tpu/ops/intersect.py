"""Ray-triangle intersection (device side): the plain jnp dense sweep.

Semantics are the reference's exactly (mesh.cpp:283-295 plane hit +
blackpawn same-side point-in-triangle, mesh.cpp:225-237):

* ``t = dot(v1 - ro, n) / dot(rd, n)``; parallel (``dot(rd,n) == 0``) or
  ``t < 0`` miss;
* inside iff three same-side tests pass with ``>= 0``.

Re-formulation: the naive test materialises [N, C, 3] cross products.
Each same-side term is a scalar triple product, so by the identity
``cross(a, p) . c == p . cross(c, a)`` it collapses to a dot with a
*per-triangle constant vector*::

    s1 = (p - v2) . K1,  K1 = cross(cross(e2-e1, -e1), e2-e1)
    s2 = (p - v1) . K2,  K2 = cross(cross(e2, e1), e2)
    s3 = (p - v1) . K3,  K3 = cross(cross(e1, e2), e1)

and with ``p = ro + t*rd`` the entire predicate needs only ``ro . X`` and
``rd . X`` for X in {n, K1, K2, K3}, written out as elementwise [N, C]
math. No 3-vectors ever touch the hot loop.

The reference's closest-hit-over-all-triangles result (its recursive BVH,
mesh.cpp:239-280, returns the nearer child) comes from a dense sweep over
triangle chunks inside a ``lax.fori_loop`` — a regular, divergence-free
computation. For large scenes ops/bvh.py prunes instead.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


# numpy, NOT jnp: a module-level jnp scalar would initialize the jax
# backend at import time, before user code can choose a platform. A numpy
# scalar traces identically.
BIG = np.float32(3.0e38)


def precompute_intersect_tables(v1, e1, e2, face_n
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
    """Host-side per-triangle constants for the matmul-form inside test.

    Returns (k1, k2, k3 [T,3], consts [T,4]) with
    consts = (v1n, c1, c2, c3) = (v1.n, v2.K1, v1.K2, v1.K3).
    """
    v1 = np.asarray(v1, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    n = np.asarray(face_n, np.float64)
    v2 = v1 + e1
    ba1 = e2 - e1
    k1 = np.cross(np.cross(ba1, -e1), ba1)
    k2 = np.cross(np.cross(e2, e1), e2)
    k3 = np.cross(np.cross(e1, e2), e1)
    consts = np.stack([
        np.einsum("ij,ij->i", v1, n),
        np.einsum("ij,ij->i", v2, k1),
        np.einsum("ij,ij->i", v1, k2),
        np.einsum("ij,ij->i", v1, k3),
    ], axis=1)
    return (k1.astype(np.float32), k2.astype(np.float32),
            k3.astype(np.float32), consts.astype(np.float32))


def _chunk_hits(ro, rd, n, k1, k2, k3, consts):
    """Hit distances for one triangle chunk; BIG where invalid.

    ro, rd: [N, 3]; n/k1/k2/k3: [C, 3]; consts: [C, 4].
    Returns t [N, C].

    This is the plain jnp form; ops/intersect_pallas.py is the fused GPU
    kernel with the identical predicate and evaluation order.
    """
    # identical formula to the Pallas kernel: plane hit t from the n dots,
    # then the hit POINT, then the same-side tests against it (the
    # reference's own order — GetUV takes p, pathtracer.cpp:394-405).
    # The n dots are written out elementwise, not as a contraction: a
    # K=3 f32 dot could run in TF32 on a GPU's matrix unit, and the
    # elementwise form rounds exactly like the kernel.
    ro_n = (ro[:, 0:1] * n[None, :, 0] + ro[:, 1:2] * n[None, :, 1]
            + ro[:, 2:3] * n[None, :, 2])                  # [N, C]
    rd_n = (rd[:, 0:1] * n[None, :, 0] + rd[:, 1:2] * n[None, :, 1]
            + rd[:, 2:3] * n[None, :, 2])

    denom = rd_n
    safe = jnp.where(denom == 0.0, 1.0, denom)
    t = (consts[None, :, 0] - ro_n) / safe

    px = ro[:, 0:1] + t * rd[:, 0:1]
    py = ro[:, 1:2] + t * rd[:, 1:2]
    pz = ro[:, 2:3] + t * rd[:, 2:3]
    s1 = (px * k1[None, :, 0] + py * k1[None, :, 1] + pz * k1[None, :, 2]
          - consts[None, :, 1])
    s2 = (px * k2[None, :, 0] + py * k2[None, :, 1] + pz * k2[None, :, 2]
          - consts[None, :, 2])
    s3 = (px * k3[None, :, 0] + py * k3[None, :, 1] + pz * k3[None, :, 2]
          - consts[None, :, 3])

    valid = ((denom != 0.0) & (t >= 0.0)
             & (s1 >= 0.0) & (s2 >= 0.0) & (s3 >= 0.0))
    # s2/s3 double as barycentric numerators: by the BAC-CAB expansion,
    # K2 = e1*d11 - e2*d01 and K3 = e2*d00 - e1*d01, so
    # (p - v1).K2 = alpha/invDenom and (p - v1).K3 = beta/invDenom —
    # exactly the reference's GetUV dot products (pathtracer.cpp:394-405).
    return jnp.where(valid, t, BIG), s2, s3


def intersect_bruteforce(ro, rd, tri_n, tri_k1, tri_k2, tri_k3, tri_consts,
                         chunk: int = 512):
    """Closest hit over all triangles (dense sweep).

    Args:
      ro, rd: [N, 3] rays.
      tri_n/tri_k1/tri_k2/tri_k3: [T, 3]; tri_consts: [T, 4]
        (see precompute_intersect_tables; zero rows never hit).
      chunk: static triangle chunk size (lane-aligned).

    Returns (hit [N] bool, t [N] f32, idx [N] int32).
    """
    n_rays = ro.shape[0]
    n_tris = tri_n.shape[0]

    if n_tris == 0:
        z = jnp.zeros(n_rays, jnp.float32)
        return (jnp.zeros(n_rays, bool), jnp.full(n_rays, BIG),
                jnp.zeros(n_rays, jnp.int32), z, z)

    chunk = min(chunk, max(128, ((n_tris + 127) // 128) * 128))
    pad = (-n_tris) % chunk
    if pad:
        tri_n, tri_k1, tri_k2, tri_k3 = (
            jnp.concatenate([a, jnp.zeros((pad, 3), a.dtype)], axis=0)
            for a in (tri_n, tri_k1, tri_k2, tri_k3))
        tri_consts = jnp.concatenate(
            [tri_consts, jnp.zeros((pad, 4), tri_consts.dtype)], axis=0)
    n_chunks = (n_tris + pad) // chunk

    def fold(carry, t, s2, s3, offset):
        best_t, best_i, best_s2, best_s3 = carry
        local_i = jnp.argmin(t, axis=1)
        pick = lambda a: jnp.take_along_axis(a, local_i[:, None], axis=1)[:, 0]
        local_t = pick(t)
        better = local_t < best_t
        best_i = jnp.where(better, offset + local_i.astype(jnp.int32), best_i)
        best_t = jnp.where(better, local_t, best_t)
        best_s2 = jnp.where(better, pick(s2), best_s2)
        best_s3 = jnp.where(better, pick(s3), best_s3)
        return best_t, best_i, best_s2, best_s3

    init = (jnp.full(n_rays, BIG), jnp.zeros(n_rays, jnp.int32),
            jnp.zeros(n_rays, jnp.float32), jnp.zeros(n_rays, jnp.float32))

    if n_chunks == 1:
        t, s2, s3 = _chunk_hits(ro, rd, tri_n, tri_k1, tri_k2, tri_k3,
                                tri_consts)
        best_t, best_i, best_s2, best_s3 = fold(init, t, s2, s3, 0)
        return best_t < BIG, best_t, best_i, best_s2, best_s3

    def body(c, carry):
        s = c * chunk
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, s, chunk)
        t, s2, s3 = _chunk_hits(ro, rd, sl(tri_n), sl(tri_k1), sl(tri_k2),
                                sl(tri_k3), sl(tri_consts))
        return fold(carry, t, s2, s3, s)

    best_t, best_i, best_s2, best_s3 = jax.lax.fori_loop(
        0, n_chunks, body, init)
    return best_t < BIG, best_t, best_i, best_s2, best_s3
