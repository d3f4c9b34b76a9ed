"""Wavefront spectral path-tracing engine (device side).

The reference's recursive per-pixel ``Trace`` (pathtracer.cpp:424-541) is
re-designed as a *wavefront* over a ray-state SoA: the recurrence
``L = emissivity + Trace(next) * reflectivity`` unrolls exactly to::

    radiance   += throughput * emissivity
    throughput *= reflectivity

so one ``lax.fori_loop`` over bounces replaces recursion, with every live ray
advancing in lockstep. Reference behaviours preserved bit-for-formula:

* depth cap ``2 * max_depth`` hits, after which a surviving ray contributes
  the **sky** spectrum (the fall-through at pathtracer.cpp:536-540 — a quirk,
  but load-bearing for parity);
* Russian roulette from the ``max_depth``-th hit on, kill probability
  ``1 - min(0.95, max(baseColor))``; a killed ray contributes the **baked**
  material emissivity (pathtracer.cpp:458-464), *not* the temperature-map
  adjusted one (the RR check precedes the override in the reference);
* smooth normals by barycentric interpolation when the triangle's smoothing
  group is set; backface flip; tangent-space normal mapping with the
  ``nt.z < 0 -> z = 0`` clamp (pathtracer.cpp:436-448);
* hit-point offset ``p += n * EPS``; glass refraction steps back ``2*EPS``
  (pathtracer.cpp:449, 510);
* roughness-texture override of scalar roughness (pathtracer.cpp:451-453);
* per-hit temperature-grid re-bake of emissivity/reflectivity through the
  Planck curve (pathtracer.cpp:520-528).

Data flow:

* rays, normals and all per-hit scalars live as **[N] component planes**
  (SoA), so every per-ray op is a full-width elementwise op;
* intersection runs in the dense Pallas kernel (ops/intersect_pallas.py)
  or the plain jnp sweep (ops/intersect.py) up to DENSE_MAX_TRIS
  triangles, and in the lockstep BVH (ops/bvh.py) above;
* per-hit attributes come from ONE packed [T, F] table fetched
  *transposed*, so every attribute arrives as a ready [N] plane;
* spectra are [nw, N] planes;
* texture sampling and the temperature re-bake are statically skipped when
  the scene has no textures/grids (zero-length tables).

RNG: counter-based (threefry) keys per (sample, bounce), replacing the
reference's single shared mt19937 (pathtracer.cpp:12 — racy across OpenMP
threads). For tests, ``rand_override`` injects fixed variates so a host
oracle can replay the identical random sequence.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .constants import EPS
from .scene import SceneData
from .ops import planck, sampling
from .ops.shade_pack import layout as shade_layout
from .ops.intersect import BIG, intersect_bruteforce
from .ops.intersect_pallas import intersect_dense_pallas_soa, pack_tri16
from .ops.bvh import intersect_bvh
from .ops.texturing import sample_nearest_wh
# Reorder constants + key/segment/bounds primitives live in reorder.py
# (one home for the key schedule); re-exported here for compatibility.
from .reorder import (REORDER_POS_BITS, REORDER_SEGMENT,  # noqa: F401
                      scene_bounds, segment_for, segment_policy, sort_key)

# "auto" backend: a dense sweep up to this many triangles, the BVH above.
# Not measured on the GPU (PERF.md open questions).
DENSE_MAX_TRIS = 8192

# Hero mode: read the baked per-(triangle, hero-channel) spectra via ONE
# [N, 2] row gather from a flat [T*nw, 2] table (instead of fetching all
# 2*nw emissivity/reflectivity rows and one-hot selecting) from this
# wavelength count on. Both paths produce the exact same table entries —
# bit-identical. The crossover was tuned before the GPU port and awaits
# re-measurement on the GPU (ROADMAP).
HERO_FLAT_GATHER_MIN_NW = 128

# Size-aware default for ``reorder_from`` (first looped bounce iteration
# that sorts, when reordering is on). Early iterations are nearly fully
# live, so the sort's dead-to-front packing has nothing to pack there;
# tiny scenes sort only the LAST iteration. Tuned before the GPU port;
# awaits re-measurement on the GPU (ROADMAP).
REORDER_FROM_TINY_TRIS = 4096      # below: sort the last iteration only
REORDER_FROM_SMALL_TRIS = 32768    # below: skip the h=1 sort

# A/B gear (PTS_SORT_MAT=1): key the bounce-ray sort by the PREVIOUS
# hit's material type above the octant — the "material-sorted shading
# queues" hypothesis. Result-exact either way.
SORT_MAT = os.environ.get("PTS_SORT_MAT", "") not in ("", "0")


def reorder_from_policy(n_tris: int, max_depth: int = 3) -> int:
    """Resolve ``reorder_from="auto"`` from the scene's triangle count.
    The loop runs ``2*max_depth - 1`` sortable iterations
    (h = 1 .. 2*max_depth-1)."""
    if n_tris < REORDER_FROM_TINY_TRIS:
        # 2*max_depth - 1 is the last sortable iteration; unclamped so
        # depth 1 still sorts its single looped iteration
        return 2 * max_depth - 1
    if n_tris < REORDER_FROM_SMALL_TRIS:
        return 2
    return 1


def device_platform() -> str:
    """Platform of the device the computation runs on: "cpu" or "gpu".

    The one place the engine asks what it runs on; every backend choice
    goes through it. That is the ``jax.default_device`` in force if one
    is set (e.g. a CPU reference render inside a GPU process), else JAX's
    default backend. Any other platform raises."""
    dev = jax.config.jax_default_device
    if dev is None:
        platform = jax.default_backend()
    elif isinstance(dev, str):
        platform = jax.devices(dev)[0].platform
    else:
        platform = dev.platform
    if platform not in ("cpu", "gpu"):
        raise RuntimeError(f"unsupported JAX platform {platform!r}: this "
                           "renderer runs on 'cpu' or 'gpu'")
    return platform


# Backends whose intersection is a Pallas kernel (a custom call).
KERNEL_BACKENDS = ("dense_pallas",)
BACKENDS = ("auto", "dense", "bvh") + KERNEL_BACKENDS


def resolve_backend(backend: str, n_tris: int,
                    interpret: bool = False) -> str:
    """Map ``backend`` to a concrete intersection for this platform.

    "auto": up to DENSE_MAX_TRIS triangles the dense Pallas kernel on the
    GPU and the jnp dense sweep on the CPU; the lockstep BVH above.
    "dense" is always the jnp sweep. A kernel backend on the CPU needs
    ``interpret=True`` (the Pallas interpreter, for tests): it raises
    otherwise rather than quietly running interpreted.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    platform = device_platform()
    if backend == "auto":
        if n_tris > DENSE_MAX_TRIS:
            return "bvh"
        return "dense_pallas" if platform == "gpu" else "dense"
    if backend in KERNEL_BACKENDS and platform == "cpu" and not interpret:
        raise ValueError(f"backend {backend!r} is a GPU kernel; on the CPU "
                         "it runs only with interpret=True")
    return backend


class TraceResult(NamedTuple):
    radiance: jnp.ndarray     # [N, nw]
    rays_traced: jnp.ndarray  # [] int32 — total rays cast (for Mrays/s)


def _column_subset(lay, has_ntex: bool, has_rtex: bool,
                   has_grids: bool, want_ior: bool, hero: bool = False):
    """Static column subset of the packed shading table for one config.

    Only the attribute rows this configuration actually reads are fetched
    (barycentric alpha/beta come from the intersection's s2/s3, so the
    geometry rows are never fetched). Returns (sub: name -> row slice in
    the subset, cols_idx int32 array of source columns)."""
    needed: list = []
    sub: dict = {}

    def want(name):
        cols = lay[name]
        sub[name] = slice(len(needed), len(needed) + cols.stop - cols.start)
        needed.extend(range(cols.start, cols.stop))

    for nm in ("uv1", "uv2", "uv3", "face_n", "n1", "n2", "n3", "smoothing",
               "inv_denom", "mat_type", "rr_prob", "roughness"):
        want(nm)
    if not hero:
        # hero mode reads the spectral curves via flat per-(triangle,
        # hero-channel) row gathers instead (O(N) per iteration; the
        # 2*nw-row fetch here would scale with nw)
        for nm in ("emissivity", "reflectivity"):
            want(nm)
    if has_ntex:
        for nm in ("tangent", "bitangent", "normal_tex", "normal_tex_wh"):
            want(nm)
    if has_rtex:
        for nm in ("roughness_tex", "roughness_tex_wh"):
            want(nm)
    if has_grids:
        if not hero:
            want("eps_curve")
        for nm in ("temp_grid", "temp_grid_wh"):
            want(nm)
    if want_ior and not hero:
        want("ior_curve")
    return sub, jnp.asarray(needed, jnp.int32)


def _fetch_attrs_t(idx, shade_sub):
    """[F', N] attribute planes for each ray's hit triangle: one row
    gather from the [T, F'] table. (A one-hot [F', T] x [T, N] product
    selects the same bits; the gather is the faster of the two on the GPU,
    PERF.md.) The barrier keeps XLA from re-fusing the gather into each
    downstream fusion and running it several times."""
    return jax.lax.optimization_barrier(shade_sub[idx].T)


def _texture_flags(scene: SceneData):
    has_tex = scene.textures.shape[0] > 0
    return (has_tex and scene.normal_tex_any.shape[0] > 0,
            has_tex and scene.roughness_tex_any.shape[0] > 0,
            scene.temp_grids.shape[0] > 0)


def make_intersector(scene: SceneData, backend: str, leaf_size: int = 4,
                     interpret: bool = False):
    """Resolve the backend and return ``intersect(ox..dz) -> (hit, t, idx,
    s2, s3)`` over [N] component planes. Shared by the per-bounce loop and
    the primary-hit hoist in :func:`render_samples`."""
    n_tris = scene.tri_shade.shape[0]
    backend = resolve_backend(backend, n_tris=n_tris, interpret=interpret)

    def intersect(ox, oy, oz, dx, dy, dz):
        if backend == "dense_pallas":
            tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                               scene.tri_k3, scene.tri_consts)
            return intersect_dense_pallas_soa(ox, oy, oz, dx, dy, dz, tri16,
                                              interpret=interpret)
        o = jnp.stack([ox, oy, oz], axis=1)
        d = jnp.stack([dx, dy, dz], axis=1)
        if backend == "dense":
            return intersect_bruteforce(o, d, scene.tri_face_n, scene.tri_k1,
                                        scene.tri_k2, scene.tri_k3,
                                        scene.tri_consts)
        return intersect_bvh(o, d, scene.tri_v1, scene.tri_e1, scene.tri_e2,
                             scene.tri_face_n, scene.bvh_node_min,
                             scene.bvh_node_max, scene.bvh_node_skip,
                             scene.bvh_node_first, scene.bvh_node_count,
                             leaf_size=leaf_size)

    return intersect, backend


def _norm3(x, y, z):
    s = x * x + y * y + z * z
    inv = jnp.where(s > 0, jax.lax.rsqrt(jnp.where(s > 0, s, 1.0)), 0.0)
    return x * inv, y * inv, z * inv


def trace_radiance(scene: SceneData, ro, rd, key, max_depth: int,
                   backend: str = "auto", leaf_size: int = 4,
                   rand_override: Optional[jnp.ndarray] = None,
                   dispersion: bool = False,
                   reorder: object = "auto",
                   primary0=None,
                   reorder_period: int = 1,
                   reorder_from: object = "auto",
                   reorder_freeze: int = 0,
                   interpret: bool = False) -> TraceResult:
    """Trace radiance spectra for a batch of rays.

    Args:
      scene: compiled scene.
      ro, rd: [N, 3] primary rays.
      key: PRNG key for this sample.
      max_depth: the reference's trace depth (GUI range 1..10); the loop runs
        2*max_depth hit iterations (pathtracer.cpp:455).
      backend: "auto", "dense", "dense_pallas" or "bvh".
      rand_override: optional [2*max_depth, 4, N] fixed U[0,1) variates
        (testing: lets a host oracle replay the identical sequence).
      dispersion: spectral estimator mode.
        False (default): dense [nw, N] spectral state — reference parity.
        True: hero-wavelength dispersion — each ray samples ONE wavelength
        channel (throughput = nw * onehot(hero), an unbiased estimator of
        the per-channel image) and GLASS refracts with that channel's
        Cauchy index from the material's ior/dispersion_b instead of the
        reference's fixed 1.5.
        "hero": the same hero-packed estimator with UNCHANGED reference
        glass physics (hardcoded 1.5, pathtracer.cpp:493) — the scaling
        valve for large wavelength counts (SURVEY §7): per-bounce
        spectral work drops from O(nw·N) to O(N) + 2-3 [nw, N] selects,
        while staying unbiased for the exact reference render (pinned by
        test_dispersion.test_hero_mode_unbiased_with_glass; at nw == 1
        it is bit-identical to the dense path).
      reorder: True sorts bounce rays by (direction octant, origin morton
        cell) before each intersection from bounce 1 on, so terminated
        rays compact to the tail. "auto" and False leave them unsorted (no
        intersection backend culls per block, so nothing else gains from
        the sort). Per-ray hit selection is order-independent (the
        lowest-index tie rule), so results are bit-identical either way.
      primary0: optional (hit, t, idx, s2, s3) for THIS (ro, rd) batch. In
        progressive (non-jitter) rendering the primary rays never change, so
        the bounce-0 intersection is sample-invariant; render_samples
        computes it once per dispatch and reuses it for every sample.
        Results are bit-identical by construction — it is the same
        intersect call, hoisted.
      reorder_period: 2 = refresh the bounce sort every other iteration
        and reuse the previous permutation in between (skips the key +
        two segmented argsorts; both row gathers remain). Bit-identical
        output for any period — a stale permutation only loosens block
        coherence. 1 = fresh sort every iteration. Off-default
        measurement gear.
      reorder_from: first looped bounce iteration that sorts (1 = every
        one; "auto" = size-aware :func:`reorder_from_policy`). Early
        bounce iterations are nearly fully live, so the sort's
        dead-to-front packing buys nothing there.
        Result-exact for any value (the intersections are
        ray-order-independent, pinned by test_reorder_is_bit_identical
        / test_reorder_from_is_bit_identical). Ignored on the
        ``reorder_period >= 2`` path.
      reorder_freeze: if > 0, the LAST fresh sort happens at iteration
        ``reorder_freeze``; later iterations reuse that permutation
        (skip the key + two segmented argsorts, keep both row gathers).
        Late bounce iterations are mostly dead, and dead lanes never
        revive — a frozen permutation keeps them packed at the front
        forever; only the few still-live lanes' octant/morton grouping
        goes stale. Result-exact for any value (same argument as
        ``perm_in``). 0 = never freeze. Ignored on the
        ``reorder_period >= 2`` path and when it lands before
        ``reorder_from``'s first sort.
      interpret: run a Pallas kernel backend in the interpreter (CPU
        tests); a kernel backend on the CPU raises without it.

    Returns:
      TraceResult(radiance [N, nw], rays_traced scalar).
    """
    n = ro.shape[0]
    nw = scene.wavenumbers.shape[0]
    n_tris = scene.tri_shade.shape[0]
    lay = shade_layout(nw)
    intersect, backend = make_intersector(scene, backend, leaf_size,
                                          interpret)
    has_tex = scene.textures.shape[0] > 0
    # per-kind static gates: a texel gather for a texture kind no element
    # binds is pure waste
    has_ntex = has_tex and scene.normal_tex_any.shape[0] > 0
    has_rtex = has_tex and scene.roughness_tex_any.shape[0] > 0
    has_grids = scene.temp_grids.shape[0] > 0

    # hero packing fires for both dispersion modes; the Cauchy ior_curve
    # column (and the glass physics change) only for dispersion=True
    use_hero = bool(dispersion) and nw > 0
    use_cauchy = (dispersion is True) and nw > 0
    hero_flat = use_hero and nw >= HERO_FLAT_GATHER_MIN_NW
    sub, cols_idx = _column_subset(lay, has_ntex, has_rtex,
                                   has_grids, use_cauchy, hero=hero_flat)
    shade_sub = scene.tri_shade[:, cols_idx]   # [T, F'] — hoisted

    # ---- bounce-ray reordering (opt-in; see the ``reorder`` arg) ----
    do_reorder = reorder is True
    sort_mat = do_reorder and SORT_MAT
    if do_reorder:
        _SEG = segment_policy(n, n_tris)
        smin, inv_ext = scene_bounds(scene)

        def sort_perm(ox, oy, oz, dx, dy, dz, alive, mat=None):
            """Forward + inverse segment-local permutations from the
            shared reorder key (reorder.sort_key — octant, then origin
            morton cell; dead rays to the top bucket). The inverse is
            just another segmented argsort of the forward one — no
            scatter anywhere. The permutation is APPLIED as packed row
            gathers (see the do_sort branch)."""
            key = sort_key(ox, oy, oz, dx, dy, dz, alive, smin, inv_ext,
                           morton=True, mat=mat)
            ns = n // _SEG
            perm_l = jnp.argsort(key.reshape(ns, _SEG), axis=1,
                                 stable=True).astype(jnp.int32)
            inv_l = jnp.argsort(perm_l, axis=1).astype(jnp.int32)
            offs = (jnp.arange(ns, dtype=jnp.int32) * _SEG)[:, None]
            return ((perm_l + offs).reshape(-1),
                    (inv_l + offs).reshape(-1))

    def fetch_attrs_t(idx):
        """[F', N] attribute planes for each ray's hit triangle."""
        return _fetch_attrs_t(idx, shade_sub)

    def row(attrs_t, name):
        return attrs_t[sub[name].start]

    def row3(attrs_t, name):
        s = sub[name].start
        return attrs_t[s], attrs_t[s + 1], attrs_t[s + 2]

    def rows(attrs_t, name):
        return attrs_t[sub[name]]

    if use_hero:
        hero_u = jax.random.uniform(jax.random.fold_in(key, 0x0D15), (n,))
        hero = jnp.minimum((hero_u * nw).astype(jnp.int32), nw - 1)
        hero_onehot_t = (jnp.arange(nw, dtype=jnp.int32)[:, None]
                         == hero[None, :]).astype(jnp.float32)  # [nw, N]

        def hero_sel(rows_t):
            """Exact hero-channel select from [nw, N] rows (one nonzero
            term per column, so the reduce adds only zeros — bit-identical
            to indexing channel ``hero``)."""
            return jnp.sum(rows_t * hero_onehot_t, axis=0)

        sky_hero = hero_sel(scene.sky[:, None])
        wn_hero = (hero_sel(scene.wavenumbers[:, None])
                   if has_grids else None)
    if hero_flat:
        # flat per-(triangle, hero-channel) spectral tables: the baked
        # emissivity/reflectivity for each ray's hit arrive as ONE
        # [N, 2] 8-byte row gather per iteration instead of a 2*nw-row
        # fetch, which scales with nw (crossover at
        # HERO_FLAT_GATHER_MIN_NW). Values are the
        # exact table entries the one-hot select produced —
        # bit-identical.
        emis_tbl = scene.tri_shade[:, lay["emissivity"]]   # [T, nw]
        refl_tbl = scene.tri_shade[:, lay["reflectivity"]]
        er_flat = jnp.stack([emis_tbl.reshape(-1),
                             refl_tbl.reshape(-1)], axis=1)  # [T*nw, 2]
        eps_flat = (scene.tri_shade[:, lay["eps_curve"]].reshape(-1)
                    if has_grids else None)
        ior_flat = (scene.tri_shade[:, lay["ior_curve"]].reshape(-1)
                    if use_cauchy else None)

    def body(h, state, do_sort=False, hit0=None, perm_in=None,
             want_perm=False):
        (rox, roy, roz, rdx, rdy, rdz,
         throughput_t, radiance_t, inside, alive, rays_traced,
         *mat_tail) = state
        prev_mat = mat_tail[0] if sort_mat else None
        rays_traced = rays_traced + jnp.sum(alive.astype(jnp.int32))

        attrs0 = None
        if hit0 is not None:
            # sample-invariant primary intersection (and optionally the
            # attribute fetch), hoisted by the caller
            hit, t, idx, s2, s3 = hit0[:5]
            if len(hit0) > 5:
                attrs0 = hit0[5]
        elif do_sort:
            # Sort only around the intersection; the [nw, N] spectral state
            # never moves. The permutation is applied as ONE [N, 6] row
            # gather in and ONE [N, 4] row gather (by the inverse) out —
            # no scatter, hence the segmented-argsort inverse. idx rides
            # the f32 pack as an exact float VALUE (f32 represents
            # integers < 2^24 exactly; a bitcast would produce denormal
            # bit patterns that flush-to-zero float ops lose); `hit` is
            # recomputed from t < BIG, exactly how the kernel derives it.
            # ``perm_in`` reuses the previous iteration's permutation
            # (reorder_period=2): any permutation is result-exact (the
            # intersections are ray-order-independent, pinned by
            # test_reorder_is_bit_identical), a stale one only loosens
            # block coherence — bounce h+1 origins are bounce h hit
            # points, so origin grouping survives; only the direction
            # octants go stale. Saves the key + two segmented argsorts.
            if perm_in is not None:
                perm, inv = perm_in
            else:
                perm, inv = sort_perm(rox, roy, roz, rdx, rdy, rdz, alive,
                                      prev_mat)
            packed = jnp.stack([rox, roy, roz, rdx, rdy, rdz],
                               axis=1)[perm]                       # [N, 6]
            hit_s, t_s, idx_s, s2_s, s3_s = intersect(
                packed[:, 0], packed[:, 1], packed[:, 2],
                packed[:, 3], packed[:, 4], packed[:, 5])
            assert n_tris < (1 << 24), "float-exact idx pack needs T < 2^24"
            res = jnp.stack(
                [t_s, s2_s, s3_s, idx_s.astype(jnp.float32)], axis=1)
            out = res[inv]                                         # unsort
            t, s2, s3 = out[:, 0], out[:, 1], out[:, 2]
            idx = out[:, 3].astype(jnp.int32)
            hit = t < BIG   # exactly how every intersect backend derives it
        else:
            hit, t, idx, s2, s3 = intersect(rox, roy, roz, rdx, rdy, rdz)
        hit = hit & alive

        attrs_t = attrs0 if attrs0 is not None else fetch_attrs_t(idx)

        # ---- hit geometry ----
        px, py, pz = rox + t * rdx, roy + t * rdy, roz + t * rdz
        inv_denom = row(attrs_t, "inv_denom")
        # alpha/beta directly from the intersection's same-side terms:
        # s2 = (p-v1).K2 = alpha/invDenom, s3 = beta/invDenom (identical
        # products to the reference's GetUV, pathtracer.cpp:394-405)
        alpha = s2 * inv_denom
        beta = s3 * inv_denom
        w0 = 1.0 - alpha - beta

        s = sub["uv1"].start
        uvu = w0 * attrs_t[s] + alpha * attrs_t[s + 2] + beta * attrs_t[s + 4]
        uvv = (w0 * attrs_t[s + 1] + alpha * attrs_t[s + 3]
               + beta * attrs_t[s + 5])

        # ---- shading normal: smooth -> backface flip -> normal map ----
        fnx, fny, fnz = row3(attrs_t, "face_n")
        n1x, n1y, n1z = row3(attrs_t, "n1")
        n2x, n2y, n2z = row3(attrs_t, "n2")
        n3x, n3y, n3z = row3(attrs_t, "n3")
        smx = w0 * n1x + alpha * n2x + beta * n3x
        smy = w0 * n1y + alpha * n2y + beta * n3y
        smz = w0 * n1z + alpha * n2z + beta * n3z
        smx, smy, smz = _norm3(smx, smy, smz)
        smooth = row(attrs_t, "smoothing") > 0.5
        nx = jnp.where(smooth, smx, fnx)
        ny = jnp.where(smooth, smy, fny)
        nz = jnp.where(smooth, smz, fnz)
        backface = (nx * rdx + ny * rdy + nz * rdz) > 0.0
        nx = jnp.where(backface, -nx, nx)
        ny = jnp.where(backface, -ny, ny)
        nz = jnp.where(backface, -nz, nz)

        roughness = row(attrs_t, "roughness")
        if has_ntex:
            ntex = row(attrs_t, "normal_tex").astype(jnp.int32)
            nwh = sub["normal_tex_wh"].start
            tex = sample_nearest_wh(scene.textures, ntex,
                                    attrs_t[nwh], attrs_t[nwh + 1], uvu, uvv)
            ntx, nty, ntz = (tex[:, 0] * 2.0 - 1.0, tex[:, 1] * 2.0 - 1.0,
                             tex[:, 2] * 2.0 - 1.0)
            ntz = jnp.where(ntz < 0.0, 0.0, ntz)
            ntx, nty, ntz = _norm3(ntx, nty, ntz)
            tax, tay, taz = row3(attrs_t, "tangent")
            bx, by, bz = row3(attrs_t, "bitangent")
            mnx = tax * ntx + bx * nty + nx * ntz
            mny = tay * ntx + by * nty + ny * ntz
            mnz = taz * ntx + bz * nty + nz * ntz
            mnx, mny, mnz = _norm3(mnx, mny, mnz)
            use_map = ntex >= 0
            nx = jnp.where(use_map, mnx, nx)
            ny = jnp.where(use_map, mny, ny)
            nz = jnp.where(use_map, mnz, nz)

        if has_rtex:
            rtex = row(attrs_t, "roughness_tex").astype(jnp.int32)
            rwh = sub["roughness_tex_wh"].start
            rough_tex = sample_nearest_wh(scene.textures, rtex,
                                          attrs_t[rwh], attrs_t[rwh + 1],
                                          uvu, uvv)
            roughness = jnp.where(rtex >= 0, rough_tex[:, 0], roughness)

        pox, poy, poz = px + nx * EPS, py + ny * EPS, pz + nz * EPS

        # ---- randoms ----
        if rand_override is not None:
            rr_rand, u_rand, th_rand, fr_rand = (rand_override[h, 0],
                                                 rand_override[h, 1],
                                                 rand_override[h, 2],
                                                 rand_override[h, 3])
        else:
            k = jax.random.fold_in(key, h)
            rr_rand, u_rand, th_rand, fr_rand = jax.random.uniform(
                k, (4, n), jnp.float32)

        # ---- Russian roulette (from the max_depth-th hit on) ----
        rr_active = jnp.asarray(h >= max_depth - 1)
        killed = hit & rr_active & (rr_rand > row(attrs_t, "rr_prob"))

        # ---- emissivity / reflectivity (+ temperature-grid re-bake) ----
        # miss: sky, die. kill: BAKED emissivity, die. survive: effective
        # emissivity, throughput *= effective reflectivity.
        miss = alive & ~hit
        survive = hit & ~killed
        if use_hero:
            # hero-packed state: per-ray SCALAR throughput/radiance for
            # the hero channel (throughput_t/radiance_t are [N] here).
            # Two exact routes to the same baked table entries (see
            # HERO_FLAT_GATHER_MIN_NW): at large nw, ONE [N, 2] row
            # gather from the flat [T*nw, 2] table (barrier for the same
            # reason as _fetch_attrs_t — XLA re-fuses an unbarriered
            # gather into each consumer); below, the fetched [nw, N]
            # rows + one-hot select.
            if hero_flat:
                flat_idx = idx * nw + hero
                er = jax.lax.optimization_barrier(
                    er_flat[flat_idx])                       # [N, 2]
                emis_b = er[:, 0]
                refl_b = er[:, 1]
            else:
                emis_b = hero_sel(rows(attrs_t, "emissivity"))
                refl_b = hero_sel(rows(attrs_t, "reflectivity"))
            if has_grids:
                grid = row(attrs_t, "temp_grid").astype(jnp.int32)
                gwh = sub["temp_grid_wh"].start
                temp = sample_nearest_wh(scene.temp_grids, grid,
                                         attrs_t[gwh], attrs_t[gwh + 1],
                                         uvu, uvv)
                bbp_h = planck.planck_bbp_elem(
                    temp + planck.CELSIUS_OFFSET, wn_hero)
                eps_h = (eps_flat[flat_idx] if hero_flat
                         else hero_sel(rows(attrs_t, "eps_curve")))
                hg = grid >= 0
                emis_eff = jnp.where(hg, bbp_h * eps_h, emis_b)
                refl_eff = jnp.where(hg, bbp_h * (1.0 - eps_h), refl_b)
            else:
                emis_eff = emis_b
                refl_eff = refl_b
            contrib = (miss * sky_hero + killed * emis_b
                       + survive * emis_eff)
            radiance_t = radiance_t + throughput_t * contrib
            throughput_t = jnp.where(survive, throughput_t * refl_eff,
                                     throughput_t)
        else:
            emis_t = rows(attrs_t, "emissivity")        # [nw, N]
            refl_t = rows(attrs_t, "reflectivity")
            if has_grids:
                grid = row(attrs_t, "temp_grid").astype(jnp.int32)
                gwh = sub["temp_grid_wh"].start
                temp = sample_nearest_wh(scene.temp_grids, grid,
                                         attrs_t[gwh], attrs_t[gwh + 1],
                                         uvu, uvv)
                bbp_t = planck.planck_bbp(temp + planck.CELSIUS_OFFSET,
                                          scene.wavenumbers).T   # [nw, N]
                eps_t = rows(attrs_t, "eps_curve")
                has_grid = (grid >= 0)[None, :]
                emis_eff = jnp.where(has_grid, bbp_t * eps_t, emis_t)
                refl_eff = jnp.where(has_grid, bbp_t * (1.0 - eps_t), refl_t)
            else:
                emis_eff = emis_t
                refl_eff = refl_t
            contrib = (miss[None, :] * scene.sky[:, None]
                       + killed[None, :] * emis_t
                       + survive[None, :] * emis_eff)
            radiance_t = radiance_t + throughput_t * contrib
            throughput_t = jnp.where(survive[None, :],
                                     throughput_t * refl_eff, throughput_t)

        # ---- bounce ----
        if use_cauchy:
            ior_hero = (ior_flat[flat_idx] if hero_flat
                        else jnp.sum(rows(attrs_t, "ior_curve")
                                     * hero_onehot_t, axis=0))
            ior_hero = jnp.maximum(ior_hero, 1.0 + 1e-6)
            eta_kw = dict(eta_inside=ior_hero, eta_outside=1.0 / ior_hero)
        else:
            # dispersion="hero" keeps the reference glass (hardcoded 1.5,
            # pathtracer.cpp:493) — the estimator changes, the physics not
            eta_kw = {}
        mat_i = row(attrs_t, "mat_type").astype(jnp.int32)
        b = sampling.sample_bounce_soa(
            mat_i,
            rdx, rdy, rdz, nx, ny, nz, roughness, inside,
            u_rand, th_rand, fr_rand, **eta_kw)
        # Dead rays are parked far away with a zero direction: the triangle
        # predicate rejects them (denom == 0) and the BVH slab tests cull
        # them (t_near = t_far = -inf), so terminated rays stop paying for
        # traversal — soft compaction without any reordering.
        back = jnp.where(b.refracted, EPS * 2.0, 0.0)
        park = jnp.float32(1e30)
        rox = jnp.where(survive, pox - nx * back, park)
        roy = jnp.where(survive, poy - ny * back, park)
        roz = jnp.where(survive, poz - nz * back, park)
        rdx = jnp.where(survive, b.dx, 0.0)
        rdy = jnp.where(survive, b.dy, 0.0)
        rdz = jnp.where(survive, b.dz, 0.0)
        inside = jnp.where(survive, b.new_inside, inside)
        alive = survive
        new_state = (rox, roy, roz, rdx, rdy, rdz,
                     throughput_t, radiance_t, inside, alive, rays_traced)
        if sort_mat:
            new_state += (jnp.where(survive, mat_i, 0),)
        if want_perm:
            return new_state, (perm, inv)
        return new_state

    if use_hero:
        # hero estimator: E[nw * onehot(hero)] = 1 per channel; packed as a
        # scalar per ray, scattered to [nw, N] once at the end
        throughput0 = jnp.full((n,), jnp.float32(nw))
        radiance0 = jnp.zeros((n,), jnp.float32)
    else:
        throughput0 = jnp.ones((nw, n), jnp.float32)
        radiance0 = jnp.zeros((nw, n), jnp.float32)
    state = (ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2],
             throughput0, radiance0,
             jnp.zeros(n, bool),
             jnp.ones(n, bool),
             jnp.zeros((), jnp.int32))
    if sort_mat:
        state += (jnp.zeros(n, jnp.int32),)
    # bounce 0 is always peeled: primary rays are tile-ordered already (no
    # sort needed) and the caller may supply the hoisted intersection
    state = body(0, state, hit0=primary0)
    if do_reorder and reorder_period >= 2 and 2 * max_depth > 2:
        # permutation reuse: iterations pair as (fresh sort, reuse) — the
        # reuse iteration skips key + 2 argsorts but keeps both gathers.
        # Result-exact for ANY permutation; see the body() comment.
        n_pairs = (2 * max_depth - 1) // 2

        def pair(j, st):
            h0 = 1 + 2 * j
            st, pi = body(h0, st, do_sort=True, want_perm=True)
            return body(h0 + 1, st, do_sort=True, perm_in=pi)

        state = jax.lax.fori_loop(0, n_pairs, pair, state)
        if (2 * max_depth - 1) % 2:
            state = body(2 * max_depth - 1, state, do_sort=True)
    else:
        if reorder_from == "auto":
            reorder_from = reorder_from_policy(n_tris, max_depth)
        first_sorted = min(max(int(reorder_from), 1), 2 * max_depth)
        if do_reorder and first_sorted > 1:
            # early iterations are ~fully live: run them unsorted (the
            # parked-lane packing the sort provides has nothing to pack),
            # then sort from `first_sorted` on
            state = jax.lax.fori_loop(1, first_sorted,
                                      functools.partial(body,
                                                        do_sort=False),
                                      state)
        freeze = (min(int(reorder_freeze), 2 * max_depth - 1)
                  if reorder_freeze and do_reorder else 0)
        last_fresh = freeze if freeze >= first_sorted else 2 * max_depth
        state = jax.lax.fori_loop(first_sorted if do_reorder else 1,
                                  min(last_fresh, 2 * max_depth),
                                  functools.partial(body,
                                                    do_sort=do_reorder),
                                  state)
        if do_reorder and first_sorted <= last_fresh < 2 * max_depth:
            # freeze: one more fresh sort that also returns its
            # permutation, then reuse it for the remaining iterations
            # (see the reorder_freeze arg note — result-exact)
            state, pi = body(last_fresh, state, do_sort=True,
                             want_perm=True)
            state = jax.lax.fori_loop(last_fresh + 1, 2 * max_depth,
                                      functools.partial(body, do_sort=True,
                                                        perm_in=pi),
                                      state)
    throughput_t, radiance_t, alive, rays_traced = (state[6], state[7],
                                                    state[9], state[10])

    # depth-cap fall-through: surviving rays see the sky (pathtracer.cpp:536-540)
    if use_hero:
        radiance_s = radiance_t + alive * throughput_t * sky_hero
        radiance_t = hero_onehot_t * radiance_s      # scatter to [nw, N]
    else:
        radiance_t = (radiance_t
                      + alive[None, :] * throughput_t * scene.sky[:, None])
    return TraceResult(radiance_t.T, rays_traced)


@functools.partial(jax.jit,
                   static_argnames=("max_depth", "backend", "leaf_size",
                                    "dispersion", "reorder", "interpret"))
def render_sample(scene: SceneData, ro, rd, total, samples, key,
                  max_depth: int, backend: str = "auto", leaf_size: int = 4,
                  dispersion: bool = False, reorder: object = "auto",
                  interpret: bool = False):
    """One progressive sample: trace all pixels once and accumulate.

    Reproduces ``RenderFrame``'s accumulation (pathtracer.cpp:595-598):
    ``total += wave; out = total / samples``.

    Returns (total', samples', out, rays_traced).
    """
    res = trace_radiance(scene, ro, rd, key, max_depth, backend, leaf_size,
                         dispersion=dispersion, reorder=reorder,
                         interpret=interpret)
    total = total + res.radiance
    samples = samples + 1
    out = total / samples.astype(jnp.float32)
    return total, samples, out, res.rays_traced


@functools.partial(jax.jit,
                   static_argnames=("n_steps", "max_depth", "backend",
                                    "leaf_size", "dispersion", "reorder",
                                    "reorder_period", "reorder_from",
                                    "reorder_freeze", "chunks", "interpret"),
                   donate_argnums=(3,))
def render_samples(scene: SceneData, ro, rd, total, samples, base_key,
                   counter0, n_steps: int, max_depth: int,
                   backend: str = "auto", leaf_size: int = 4,
                   dispersion: bool = False, reorder: object = "auto",
                   jitter_cam=None, reorder_period: int = 1,
                   reorder_from: object = "auto",
                   reorder_freeze: int = 0, chunks: int = 1,
                   interpret: bool = False):
    """``n_steps`` progressive samples in ONE dispatch.

    The per-sample loop lives inside the compiled program, so a batch
    costs one launch and no host round trip per sample. Sample
    ``i`` uses ``fold_in(base_key, counter0 + i)`` — the same key schedule
    as repeated ``render_sample`` calls, so checkpoint-resume stays exact.

    Returns (total', samples', out, rays_traced_total).

    The primary-ray intersection AND its attribute fetch are sample-
    invariant (fixed rays, no RNG before the first hit), so both are
    computed ONCE here and reused by every sample in the batch — XLA's
    loop-invariant code motion cannot hoist the Pallas kernel (a custom
    call) by itself. The downstream pure geometry
    ops become loop-invariant too and XLA hoists them itself. Bit-
    identical: the same calls, made earlier.

    ``jitter_cam`` (models.camera.JitterCam) switches on batched sub-pixel
    jitter: sample ``i`` regenerates its ray directions in-dispatch from
    ``fold_in(fold_in(key_i, 0xC0FFEE))`` draws, so jitter renders batch
    exactly like non-jitter ones instead of paying one dispatch per sample.
    Primary rays then differ per sample, so the primary-hit hoist is
    disabled (it would be wrong).
    """
    if jitter_cam is None:
        pre_intersect, _ = make_intersector(scene, backend, leaf_size,
                                            interpret)
        hit0 = pre_intersect(ro[:, 0], ro[:, 1], ro[:, 2],
                             rd[:, 0], rd[:, 1], rd[:, 2])
        nw = scene.wavenumbers.shape[0]
        has_ntex, has_rtex, has_grids = _texture_flags(scene)
        sub0, cols_idx0 = _column_subset(
            shade_layout(nw), has_ntex, has_rtex, has_grids,
            (dispersion is True) and nw > 0,
            hero=bool(dispersion) and nw >= HERO_FLAT_GATHER_MIN_NW)
        attrs0 = _fetch_attrs_t(hit0[2], scene.tri_shade[:, cols_idx0])
        primary0 = hit0 + (attrs0,)
    else:
        primary0 = None

    if chunks > 1:
        # Bounded-width wavefront: trace the frame as `chunks` sequential
        # sub-wavefronts via lax.map (one traced body, scanned). It
        # bounds the device-memory working set (attrs planes scale with
        # chunk width, not frame width); whether it also pays in speed
        # at 4K is not measured on the GPU (ROADMAP).
        # Chunk c of sample i draws from fold_in(fold_in(base_key,
        # counter0+i), 0xC40000+c) — per-(chunks, seed) deterministic;
        # per-pixel math is width-independent, so results differ from
        # chunks=1 only by the variate stream (unbiased either way; the
        # trace-level equivalence under shared variates is pinned by
        # test_chunked_trace_bit_identical).
        if jitter_cam is not None:
            raise ValueError("chunks > 1 does not support jitter_cam yet")
        n = ro.shape[0]
        if n % chunks:
            raise ValueError(f"ray count {n} must be divisible by "
                             f"chunks={chunks}")
        nc = n // chunks
        ro_c = ro.reshape(chunks, nc, 3)
        rd_c = rd.reshape(chunks, nc, 3)
        if primary0 is not None:
            prim_c = tuple(p.reshape(chunks, nc) for p in primary0[:5])
            attrs_c = (primary0[5].reshape(-1, chunks, nc)
                       .transpose(1, 0, 2))          # [C, F', nc]
        cidx = jnp.arange(chunks, dtype=jnp.int32)

        def body(i, carry):
            total, samples, rays = carry
            k = jax.random.fold_in(base_key, counter0 + i)

            def chunk_fn(args):
                c = args[0]
                roc, rdc = args[1], args[2]
                prim = (tuple(args[3:8]) + (args[8],)
                        if primary0 is not None else None)
                kc = jax.random.fold_in(k, 0xC40000 + c)
                res = trace_radiance(scene, roc, rdc, kc, max_depth,
                                     backend, leaf_size,
                                     dispersion=dispersion,
                                     reorder=reorder, primary0=prim,
                                     reorder_period=reorder_period,
                                     reorder_from=reorder_from,
                                     reorder_freeze=reorder_freeze,
                                     interpret=interpret)
                return res.radiance, res.rays_traced

            operands = (cidx, ro_c, rd_c)
            if primary0 is not None:
                operands = operands + prim_c + (attrs_c,)
            rad_c, rays_c = jax.lax.map(chunk_fn, operands)
            return (total + rad_c.reshape(total.shape), samples + 1,
                    rays + jnp.sum(rays_c))
    else:
        def body(i, carry):
            total, samples, rays = carry
            k = jax.random.fold_in(base_key, counter0 + i)
            if jitter_cam is not None:
                from .models.camera import jittered_dirs
                ck = jax.random.fold_in(k, 0xC0FFEE)
                kx, ky = jax.random.split(ck)
                n = jitter_cam.px.shape[0]
                rd_i = jittered_dirs(jitter_cam,
                                     jax.random.uniform(kx, (n,)),
                                     jax.random.uniform(ky, (n,)))
            else:
                rd_i = rd
            res = trace_radiance(scene, ro, rd_i, k, max_depth, backend,
                                 leaf_size, dispersion=dispersion,
                                 reorder=reorder, primary0=primary0,
                                 reorder_period=reorder_period,
                                 reorder_from=reorder_from,
                                 reorder_freeze=reorder_freeze,
                                 interpret=interpret)
            return total + res.radiance, samples + 1, rays + res.rays_traced

    total, samples, rays = jax.lax.fori_loop(
        0, n_steps, body, (total, samples, jnp.zeros((), jnp.int32)))
    out = total / samples.astype(jnp.float32)
    return total, samples, out, rays
