"""Per-hit shading blocks factored for phase-isolated measurement.

The lockstep engine (engine.py) keeps its bounce body inline — it carries
the primary-hoist / hero-dispersion specialisations and is the
reference-parity hot path. These blocks expose the *identical formulas*
as standalone functions over [M] component planes so the per-phase
profiler (tools/profile_phases.py) can time each phase in isolation with the
production attribute layout. tests/test_engine_parity.py pins them
against engine.py's inline body so they cannot drift.

All functions take a ``ShadeCtx`` built by :func:`make_ctx` — the static
per-trace configuration (packed-column layout subset, texture gates,
resolved backend) — and [M] component planes. Formula provenance is the
reference ``Trace`` (pathtracer.cpp:424-541); see engine.py's module
docstring for the quirk list.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .constants import EPS
from .ops import planck
from .ops.shade_pack import layout as shade_layout
from .ops.texturing import sample_nearest_wh
from .engine import (_column_subset, _fetch_attrs_t, _norm3, _texture_flags,
                     make_intersector)


class ShadeCtx(NamedTuple):
    scene: object           # SceneData
    sub: dict               # attr name -> row slice in the subset
    shade_sub: jnp.ndarray  # [T, F'] packed column subset
    has_ntex: bool
    has_rtex: bool
    has_grids: bool
    backend: str            # resolved backend string
    intersect: object       # intersect(ox..dz) -> (hit, t, idx, s2, s3)


def make_ctx(scene, backend: str = "auto", leaf_size: int = 4) -> ShadeCtx:
    nw = scene.wavenumbers.shape[0]
    intersect, rbackend = make_intersector(scene, backend, leaf_size)
    has_ntex, has_rtex, has_grids = _texture_flags(scene)
    sub, cols_idx = _column_subset(shade_layout(nw), has_ntex,
                                   has_rtex, has_grids, False)
    shade_sub = scene.tri_shade[:, cols_idx]
    return ShadeCtx(scene, sub, shade_sub, has_ntex, has_rtex, has_grids,
                    rbackend, intersect)


def row(ctx: ShadeCtx, attrs_t, name):
    return attrs_t[ctx.sub[name].start]


def row3(ctx: ShadeCtx, attrs_t, name):
    s = ctx.sub[name].start
    return attrs_t[s], attrs_t[s + 1], attrs_t[s + 2]


def rows(ctx: ShadeCtx, attrs_t, name):
    return attrs_t[ctx.sub[name]]


def fetch_attrs(ctx: ShadeCtx, idx):
    """[F', M] attribute planes for each ray's hit triangle."""
    return _fetch_attrs_t(idx, ctx.shade_sub)


def shade_geometry(ctx: ShadeCtx, attrs_t, rox, roy, roz, rdx, rdy, rdz,
                   t, s2, s3):
    """Hit point, shading frame, roughness, UV (engine.body's geometry
    block over [M] planes — identical formulas, pathtracer.cpp:429-453)."""
    px, py, pz = rox + t * rdx, roy + t * rdy, roz + t * rdz
    inv_denom = row(ctx, attrs_t, "inv_denom")
    alpha = s2 * inv_denom
    beta = s3 * inv_denom
    w0 = 1.0 - alpha - beta

    s = ctx.sub["uv1"].start
    uvu = w0 * attrs_t[s] + alpha * attrs_t[s + 2] + beta * attrs_t[s + 4]
    uvv = (w0 * attrs_t[s + 1] + alpha * attrs_t[s + 3]
           + beta * attrs_t[s + 5])

    fnx, fny, fnz = row3(ctx, attrs_t, "face_n")
    n1x, n1y, n1z = row3(ctx, attrs_t, "n1")
    n2x, n2y, n2z = row3(ctx, attrs_t, "n2")
    n3x, n3y, n3z = row3(ctx, attrs_t, "n3")
    smx, smy, smz = _norm3(w0 * n1x + alpha * n2x + beta * n3x,
                           w0 * n1y + alpha * n2y + beta * n3y,
                           w0 * n1z + alpha * n2z + beta * n3z)
    smooth = row(ctx, attrs_t, "smoothing") > 0.5
    nx = jnp.where(smooth, smx, fnx)
    ny = jnp.where(smooth, smy, fny)
    nz = jnp.where(smooth, smz, fnz)
    backface = (nx * rdx + ny * rdy + nz * rdz) > 0.0
    nx = jnp.where(backface, -nx, nx)
    ny = jnp.where(backface, -ny, ny)
    nz = jnp.where(backface, -nz, nz)

    roughness = row(ctx, attrs_t, "roughness")
    if ctx.has_ntex:
        ntex = row(ctx, attrs_t, "normal_tex").astype(jnp.int32)
        nwh = ctx.sub["normal_tex_wh"].start
        tex = sample_nearest_wh(ctx.scene.textures, ntex,
                                attrs_t[nwh], attrs_t[nwh + 1], uvu, uvv)
        ntx, nty, ntz = (tex[:, 0] * 2.0 - 1.0, tex[:, 1] * 2.0 - 1.0,
                         tex[:, 2] * 2.0 - 1.0)
        ntz = jnp.where(ntz < 0.0, 0.0, ntz)
        ntx, nty, ntz = _norm3(ntx, nty, ntz)
        tax, tay, taz = row3(ctx, attrs_t, "tangent")
        bx, by, bz = row3(ctx, attrs_t, "bitangent")
        mnx, mny, mnz = _norm3(tax * ntx + bx * nty + nx * ntz,
                               tay * ntx + by * nty + ny * ntz,
                               taz * ntx + bz * nty + nz * ntz)
        use_map = ntex >= 0
        nx = jnp.where(use_map, mnx, nx)
        ny = jnp.where(use_map, mny, ny)
        nz = jnp.where(use_map, mnz, nz)
    if ctx.has_rtex:
        rtex = row(ctx, attrs_t, "roughness_tex").astype(jnp.int32)
        rwh = ctx.sub["roughness_tex_wh"].start
        rough_tex = sample_nearest_wh(ctx.scene.textures, rtex,
                                      attrs_t[rwh], attrs_t[rwh + 1],
                                      uvu, uvv)
        roughness = jnp.where(rtex >= 0, rough_tex[:, 0], roughness)

    pox, poy, poz = px + nx * EPS, py + ny * EPS, pz + nz * EPS
    return pox, poy, poz, nx, ny, nz, roughness, uvu, uvv


def material_spectra(ctx: ShadeCtx, attrs_t, uvu, uvv):
    """Baked + temperature-grid-effective emissivity/reflectivity,
    [nw, M] (pathtracer.cpp:520-528 re-bake; RR kill uses the BAKED
    emissivity, so both are returned)."""
    emis_t = rows(ctx, attrs_t, "emissivity")
    refl_t = rows(ctx, attrs_t, "reflectivity")
    if ctx.has_grids:
        grid = row(ctx, attrs_t, "temp_grid").astype(jnp.int32)
        gwh = ctx.sub["temp_grid_wh"].start
        temp = sample_nearest_wh(ctx.scene.temp_grids, grid,
                                 attrs_t[gwh], attrs_t[gwh + 1], uvu, uvv)
        bbp_t = planck.planck_bbp(temp + planck.CELSIUS_OFFSET,
                                  ctx.scene.wavenumbers).T
        eps_t = rows(ctx, attrs_t, "eps_curve")
        has_grid = (grid >= 0)[None, :]
        emis_eff = jnp.where(has_grid, bbp_t * eps_t, emis_t)
        refl_eff = jnp.where(has_grid, bbp_t * (1.0 - eps_t), refl_t)
    else:
        emis_eff = emis_t
        refl_eff = refl_t
    return emis_t, emis_eff, refl_eff
