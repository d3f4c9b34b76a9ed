"""Dense closest-hit sweep as a Pallas kernel on the Triton route (GPU).

Same predicate and formula order as the jnp sweep in ops/intersect.py
(reference mesh.cpp:283-295 plane hit + blackpawn same-side test in the
K-vector form), designed for the GPU's CUDA cores:

* **One ray per thread.** A program owns ``block`` rays (a power of two);
  the six ray components arrive as [block] vectors and the running
  ``(best_t, best_idx, s2, s3)`` lives in registers for the whole sweep.
* **The triangle table stays in L2.** The packed table is passed
  transposed, [16, T] (nx ny nz | k1 | k2 | k3 | c0 c1 c2 c3), at most
  512 KB at the 8,192-triangle dense limit. Each program walks all of it
  in a loop inside the kernel, one triangle per step with uniform scalar
  loads (a [block, tile] plane per step measured slower, PERF.md).
* **Ties go to the lowest index**, exactly as in ``intersect_bruteforce``:
  only a strictly nearer hit replaces the running best.
* **Padding rows are zeros**, which never hit (``denom == 0``); padding
  rays have a zero direction and miss everything.
* **f32 on the CUDA cores only**: no matrix unit, so no TF32 rounding.

The plain jnp sweep materialises [N, chunk] t/s2/s3 planes in device
memory (GBs per chunk at 1080p); here nothing but the four [N] results is
written. The kernel has no gradient rule: intersection is a discrete
selection and the renderer never differentiates it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intersect import BIG

# Rays per program, tuned on the card (PERF.md). BLOCK rays with one ray
# per thread means BLOCK // 32 warps.
BLOCK = 128

_BIG = float(BIG)   # python float: a jnp scalar would be a captured const


def pack_tri16(tri_n, tri_k1, tri_k2, tri_k3, tri_consts):
    """[T, 16] packed table from the SceneData intersect arrays."""
    return jnp.concatenate(
        [tri_n, tri_k1, tri_k2, tri_k3, tri_consts], axis=1)


def _tri_terms(ox, oy, oz, dx, dy, dz, col):
    """t, s2, s3 and validity of rays against one triangle.

    ``col(k)`` reads component k of the packed table. The formula and its
    evaluation order are those of ops/intersect._chunk_hits."""
    nx, ny, nz = col(0), col(1), col(2)
    denom = dx * nx + dy * ny + dz * nz
    ro_n = ox * nx + oy * ny + oz * nz
    safe = jnp.where(denom == 0.0, 1.0, denom)
    t = (col(12) - ro_n) / safe
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    s1 = px * col(3) + py * col(4) + pz * col(5) - col(13)
    s2 = px * col(6) + py * col(7) + pz * col(8) - col(14)
    s3 = px * col(9) + py * col(10) + pz * col(11) - col(15)
    valid = ((denom != 0.0) & (t >= 0.0)
             & (s1 >= 0.0) & (s2 >= 0.0) & (s3 >= 0.0))
    return t, s2, s3, valid


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tri_ref,
            t_ref, i_ref, s2_ref, s3_ref, *, n_tris):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    block = ox.shape[0]

    def step(j, carry):
        best_t, best_i, best_s2, best_s3 = carry
        t, s2, s3, valid = _tri_terms(ox, oy, oz, dx, dy, dz,
                                      lambda k: tri_ref[k, j])
        better = valid & (t < best_t)
        return (jnp.where(better, t, best_t),
                jnp.where(better, j, best_i),
                jnp.where(better, s2, best_s2),
                jnp.where(better, s3, best_s3))

    zero = jnp.zeros((block,), jnp.float32)
    best_t, best_i, best_s2, best_s3 = jax.lax.fori_loop(
        0, n_tris, step,
        (jnp.full((block,), _BIG, jnp.float32),
         jnp.zeros((block,), jnp.int32), zero, zero))
    t_ref[...] = best_t
    i_ref[...] = best_i
    s2_ref[...] = best_s2
    s3_ref[...] = best_s3


@functools.partial(jax.jit,
                   static_argnames=("block", "interpret"))
def intersect_dense_pallas_soa(rox, roy, roz, rdx, rdy, rdz, tri_pack, *,
                               block: int = BLOCK, interpret: bool = False):
    """Closest hit over all triangles (Pallas kernel, Triton route).

    Args:
      rox..rdz: [N] ray component planes.
      tri_pack: [T, 16] packed table (see :func:`pack_tri16`).
      block: rays per program (power of two; one ray per thread).
      interpret: run the kernel in the Pallas interpreter (CPU tests).

    Returns (hit [N] bool, t [N], idx [N] int32, s2 [N], s3 [N]) — the
    ``intersect_bruteforce`` contract.
    """
    n = rox.shape[0]
    n_tris = tri_pack.shape[0]
    if n_tris == 0:
        z = jnp.zeros(n, jnp.float32)
        return (jnp.zeros(n, bool), jnp.full(n, _BIG, jnp.float32),
                jnp.zeros(n, jnp.int32), z, z)

    pad_n = (-n) % block
    comps = (rox, roy, roz, rdx, rdy, rdz)
    if pad_n:
        comps = tuple(jnp.pad(c, (0, pad_n)) for c in comps)
    tri_t = tri_pack.T                                    # [16, T]
    n_pad = n + pad_n

    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    out_f = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    best_t, best_i, s2, s3 = pl.pallas_call(
        functools.partial(_kernel, n_tris=n_tris),
        grid=(n_pad // block,),
        in_specs=[ray_spec] * 6 + [
            pl.BlockSpec(tri_t.shape, lambda i: (0, 0))],
        out_specs=[ray_spec] * 4,
        out_shape=[out_f, jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                   out_f, out_f],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name="dense_closest_hit",
    )(*comps, tri_t)
    best_t, best_i, s2, s3 = (a[:n] for a in (best_t, best_i, s2, s3))
    return best_t < _BIG, best_t, best_i, s2, s3
