"""Bounce-direction sampling for the four surface models.

Formula-exact port of the material branches of ``PathTracer::Trace``
(pathtracer.cpp:466-514), vectorised over rays. All four candidate
directions are computed for every ray and selected by material type — on a
vector machine that is cheaper than divergent branching, and XLA dedupes the
shared subexpressions.

Reference quirks preserved deliberately:

* DIFFUSE (pathtracer.cpp:471-479): "uniform hemisphere" sampling that is
  actually ``dir = w*cos(2 pi theta)*u + w*sin(2 pi theta)*v + sqrt(1-w^2)*n``
  with ``w ~ U[0,1)`` — the polar *sine* is uniform, not the solid angle. The
  tangent frame picks ``u = cross((1,0,0), n)`` unless ``|n.x| >= 1 - EPS``
  where it falls back to ``cross((1,1,1), n)``.
* GLOSSY (pathtracer.cpp:481-490): same construction around the mirror
  direction ``r`` with ``w ~ U[0,1) * roughness``; the fallback condition
  tests **n.x** (the normal!) while the frame is built around ``r``
  (pathtracer.cpp:484 — ``glm::abs(n.x) < 1 - FLT_EPSILON ? cross((1,0,0), r)
  : cross((1,1,1), r)``), the threshold uses FLT_EPSILON instead of EPS, and
  ``v = cross(u, r)`` is not re-normalised. Note u is NOT generally
  perpendicular to r when the (1,1,1) branch is taken, so v is not unit
  either — all preserved bit-for-formula.
* GLASS (pathtracer.cpp:491-514): Snell + Schlick with hardcoded
  nc=1.0, ng=1.5 and the Schlick power **2** (not 5). Total internal
  reflection reflects. On refraction the hit point steps back by 2*EPS along
  the normal and the ``inside`` flag flips.

For dispersion mode (wavelength-dependent IOR — a capability extension used
by the dielectric-dispersion benchmark config), pass ``eta_override``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from ..constants import EPS

FLT_EPSILON = 1.1920929e-07
TWO_PI = 2.0 * math.pi


class BounceSample(NamedTuple):
    direction: jnp.ndarray      # [N,3]
    refracted: jnp.ndarray      # [N] bool — glass ray crossed the interface
    new_inside: jnp.ndarray     # [N] bool


class BounceSampleSoA(NamedTuple):
    dx: jnp.ndarray             # [N]
    dy: jnp.ndarray
    dz: jnp.ndarray
    refracted: jnp.ndarray      # [N] bool
    new_inside: jnp.ndarray     # [N] bool


def _norm3(x, y, z):
    # rsqrt: native VPU op (sqrt+divide chains are ~7 cycles/element)
    s = x * x + y * y + z * z
    import jax
    inv = jnp.where(s > 0, jax.lax.rsqrt(jnp.where(s > 0, s, 1.0)), 0.0)
    return x * inv, y * inv, z * inv


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def sample_bounce_soa(mat_type, rdx, rdy, rdz, nx, ny, nz, roughness,
                      inside, u_rand, theta_rand, fresnel_rand,
                      eta_inside=None, eta_outside=None) -> BounceSampleSoA:
    """Component-wise (SoA) twin of ``sample_bounce``.

    Six [N] planes instead of [N, 3] vectors, so every operation is a
    full-width elementwise op. Identical math, identical reference quirks
    — see ``sample_bounce``.
    """
    ndot = rdx * nx + rdy * ny + rdz * nz
    rx, ry, rz = rdx - 2.0 * ndot * nx, rdy - 2.0 * ndot * ny, rdz - 2.0 * ndot * nz

    cos_a = jnp.cos(TWO_PI * theta_rand)
    sin_a = jnp.sin(TWO_PI * theta_rand)

    # --- DIFFUSE: frame around n (threshold EPS) -------------------------
    x_small = jnp.abs(nx) < (1.0 - EPS)
    #   cross((1,0,0), n) = (0, -nz, ny); cross((1,1,1), n) = (nz-ny, nx-nz, ny-nx)
    ux = jnp.where(x_small, 0.0, nz - ny)
    uy = jnp.where(x_small, -nz, nx - nz)
    uz = jnp.where(x_small, ny, ny - nx)
    ux, uy, uz = _norm3(ux, uy, uz)
    vx, vy, vz = _cross3(ux, uy, uz, nx, ny, nz)
    vx, vy, vz = _norm3(vx, vy, vz)
    w = u_rand
    wz = jnp.sqrt(jnp.maximum(1.0 - w * w, 0.0))
    ddx = w * cos_a * ux + w * sin_a * vx + wz * nx
    ddy = w * cos_a * uy + w * sin_a * vy + wz * ny
    ddz = w * cos_a * uz + w * sin_a * vz + wz * nz
    ddx, ddy, ddz = _norm3(ddx, ddy, ddz)

    # --- GLOSSY: frame around r, but the branch condition tests n.x
    # (pathtracer.cpp:484; threshold FLT_EPSILON, v not normalised) ---------
    gx_small = jnp.abs(nx) < (1.0 - FLT_EPSILON)
    gux = jnp.where(gx_small, 0.0, rz - ry)
    guy = jnp.where(gx_small, -rz, rx - rz)
    guz = jnp.where(gx_small, ry, ry - rx)
    gux, guy, guz = _norm3(gux, guy, guz)
    gvx, gvy, gvz = _cross3(gux, guy, guz, rx, ry, rz)
    wg = u_rand * roughness
    wgz = jnp.sqrt(jnp.maximum(1.0 - wg * wg, 0.0))
    gdx = wg * cos_a * gux + wg * sin_a * gvx + wgz * rx
    gdy = wg * cos_a * guy + wg * sin_a * gvy + wgz * ry
    gdz = wg * cos_a * guz + wg * sin_a * gvz + wgz * rz

    # --- GLASS ------------------------------------------------------------
    nc, ng = 1.0, 1.5
    eta_in = eta_inside if eta_inside is not None else jnp.float32(ng / nc)
    eta_out = eta_outside if eta_outside is not None else jnp.float32(nc / ng)
    eta = jnp.where(inside, eta_in, eta_out)
    r0 = ((nc - ng) / (nc + ng)) ** 2
    c = jnp.abs(ndot)
    k = 1.0 - eta * eta * (1.0 - c * c)
    re = r0 + (1.0 - r0) * (1.0 - c) ** 2  # Schlick power 2 (reference parity)
    reflect_glass = (k < 0.0) | (fresnel_rand < re)
    coef = eta * ndot + jnp.sqrt(jnp.maximum(k, 0.0))
    tx, ty, tz = _norm3(eta * rdx - coef * nx, eta * rdy - coef * ny,
                        eta * rdz - coef * nz)
    glx = jnp.where(reflect_glass, rx, tx)
    gly = jnp.where(reflect_glass, ry, ty)
    glz = jnp.where(reflect_glass, rz, tz)

    # --- select by material type ------------------------------------------
    is_spec = mat_type == 1
    is_diff = mat_type == 0
    is_glos = mat_type == 2
    is_glass = mat_type == 3
    dx = jnp.where(is_spec, rx, jnp.where(is_diff, ddx,
                   jnp.where(is_glos, gdx, glx)))
    dy = jnp.where(is_spec, ry, jnp.where(is_diff, ddy,
                   jnp.where(is_glos, gdy, gly)))
    dz = jnp.where(is_spec, rz, jnp.where(is_diff, ddz,
                   jnp.where(is_glos, gdz, glz)))
    refracted = is_glass & ~reflect_glass
    new_inside = jnp.where(refracted, ~inside, inside)
    return BounceSampleSoA(dx, dy, dz, refracted, new_inside)


def _frame_u(axis, threshold, cond_axis=None):
    """u = |cond.x| < 1-threshold ? cross((1,0,0),axis) : cross((1,1,1),axis).

    ``cond_axis`` defaults to ``axis``; GLOSSY passes the shading normal as
    the condition while framing around the mirror direction
    (pathtracer.cpp:484 parity quirk).
    """
    cond = axis if cond_axis is None else cond_axis
    x_small = jnp.abs(cond[..., 0]) < (1.0 - threshold)
    ex = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], jnp.float32), axis.shape)
    ones = jnp.broadcast_to(jnp.array([1.0, 1.0, 1.0], jnp.float32), axis.shape)
    u = jnp.where(x_small[..., None], jnp.cross(ex, axis), jnp.cross(ones, axis))
    norm = jnp.linalg.norm(u, axis=-1, keepdims=True)
    return u / jnp.where(norm > 0, norm, 1.0)


def reflect(rd, n):
    """glm::reflect: rd - 2*dot(rd,n)*n."""
    return rd - 2.0 * jnp.sum(rd * n, axis=-1, keepdims=True) * n


def sample_bounce(mat_type, rd, n, roughness, inside,
                  u_rand, theta_rand, fresnel_rand,
                  eta_inside=None, eta_outside=None) -> BounceSample:
    """Compute the bounce direction for every ray.

    Args:
      mat_type: [N] int32 (MaterialType codes).
      rd: [N,3] incoming unit direction.
      n: [N,3] shading normal, already front-facing (dot(n, rd) <= 0).
      roughness: [N] glossy cone scale.
      inside: [N] bool glass state.
      u_rand, theta_rand, fresnel_rand: [N] U[0,1) variates.
      eta_inside/eta_outside: optional [N] per-ray refraction ratios for
        dispersion mode (defaults: ng/nc = 1.5 and nc/ng = 1/1.5).

    Returns:
      BounceSample(direction, refracted, new_inside).
    """
    r = reflect(rd, n)

    # --- DIFFUSE ----------------------------------------------------------
    u_d = _frame_u(n, EPS)
    v_d = jnp.cross(u_d, n)
    v_d = v_d / jnp.where(jnp.linalg.norm(v_d, axis=-1, keepdims=True) > 0,
                          jnp.linalg.norm(v_d, axis=-1, keepdims=True), 1.0)
    w = u_rand[..., None]
    ang = TWO_PI * theta_rand[..., None]
    d_diff = (w * jnp.cos(ang) * u_d + w * jnp.sin(ang) * v_d
              + jnp.sqrt(jnp.maximum(1.0 - w * w, 0.0)) * n)
    norm = jnp.linalg.norm(d_diff, axis=-1, keepdims=True)
    d_diff = d_diff / jnp.where(norm > 0, norm, 1.0)

    # --- GLOSSY -----------------------------------------------------------
    u_g = _frame_u(r, FLT_EPSILON, cond_axis=n)
    v_g = jnp.cross(u_g, r)  # not re-normalised (reference parity)
    wg = (u_rand * roughness)[..., None]
    d_gloss = (wg * jnp.cos(ang) * u_g + wg * jnp.sin(ang) * v_g
               + jnp.sqrt(jnp.maximum(1.0 - wg * wg, 0.0)) * r)

    # --- GLASS ------------------------------------------------------------
    nc, ng = 1.0, 1.5
    eta_in = eta_inside if eta_inside is not None else jnp.float32(ng / nc)
    eta_out = eta_outside if eta_outside is not None else jnp.float32(nc / ng)
    eta = jnp.where(inside, eta_in, eta_out)
    r0 = ((nc - ng) / (nc + ng)) ** 2
    c = jnp.abs(jnp.sum(rd * n, axis=-1))
    k = 1.0 - eta * eta * (1.0 - c * c)
    re = r0 + (1.0 - r0) * (1.0 - c) ** 2  # Schlick power 2 (reference parity)
    tir = k < 0.0
    reflect_glass = tir | (fresnel_rand < re)
    ndotd = jnp.sum(n * rd, axis=-1)
    d_refr = (eta[..., None] * rd
              - (eta * ndotd + jnp.sqrt(jnp.maximum(k, 0.0)))[..., None] * n)
    norm = jnp.linalg.norm(d_refr, axis=-1, keepdims=True)
    d_refr = d_refr / jnp.where(norm > 0, norm, 1.0)
    d_glass = jnp.where(reflect_glass[..., None], r, d_refr)

    # --- select by material type ------------------------------------------
    is_spec = (mat_type == 1)[..., None]
    is_diff = (mat_type == 0)[..., None]
    is_glos = (mat_type == 2)[..., None]
    is_glass = (mat_type == 3)[..., None]
    direction = jnp.where(is_spec, r,
                jnp.where(is_diff, d_diff,
                jnp.where(is_glos, d_gloss, d_glass)))

    refracted = is_glass[..., 0] & ~reflect_glass
    new_inside = jnp.where(refracted, ~inside, inside)
    return BounceSample(direction, refracted, new_inside)
