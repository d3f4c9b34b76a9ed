"""Per-phase cost breakdown of one bounce iteration on the default device
(a GPU in practice): each phase runs as a loop-carried chain inside ONE
jit, with data-dependent per-iteration inputs and a scalar drain, so XLA
can neither hoist nor drop the work; then an in-context whole-sample
cross-check through RenderSession. Every line names the device.

    python tools/profile_phases.py textured      # 1080p textured sphere
    python tools/profile_phases.py terrain_200k  # 246k tris @ 512^2
    python tools/profile_phases.py terrain_52k

Phases (one engine bounce iteration = sort + intersect + fetch + shade
+ spectra + bounce; engine.py body()):
  sort       reorder keys + 2 segmented argsorts + [N,6]/[N,4] row
             gathers (engine.py sort_perm + do_sort branch)
  intersect  the resolved backend kernel (engine policy defaults) on
             real sorted bounce-1 rays
  fetch      attribute planes for hit triangles (_fetch_attrs_t path)
  shade      shade_geometry incl. texture sampling (engine_common)
  spectra    material_spectra + the [nw, N] radiance/throughput update
  bounce     RNG (4 uniform planes) + sample_bounce_soa
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import bench_suite as bs
from pathtracing_spectrum_tpu import engine_common as ec
from pathtracing_spectrum_tpu.models.camera import camera_rays, tile_order
from pathtracing_spectrum_tpu.ops import sampling
from pathtracing_spectrum_tpu.reorder import (scene_bounds, segment_for,
                                              sort_key)
from pathtracing_spectrum_tpu.render import RenderSession

K = int(os.environ.get("PTS_PROF_K", "8"))
SPP = int(os.environ.get("PTS_PROF_SPP", "4"))
# comma-separated subset of phases to run (default: all + in-context)
PHASES = set(p for p in os.environ.get("PTS_PROF_PHASES", "").split(",") if p)


def want(phase):
    return not PHASES or phase in PHASES


def scene_for(name):
    if name == "textured":
        return bs.textured_sphere_scene((1920, 1080)), (1920, 1080)
    res = int(os.environ.get("PTS_PROF_RES", "512"))
    if name == "prism":
        return bs.prism_scene((res, res)), (res, res)
    if name == "cornell":
        return bs.cornell_scene((res, res), 3), (res, res)
    return bs.terrain_scene((res, res), f"{name}.obj"), (res, res)


def bounce1_state(sc, sd, ctx, w, h):
    """Real bounce-1 rays (sorted, engine block order) + hit state."""
    n = w * h
    ro, rd = camera_rays(sc.camera(), w, h)
    perm, _ = tile_order(w, h)
    ro = jnp.asarray(np.asarray(ro)[perm])
    rd = jnp.asarray(np.asarray(rd)[perm])
    smin, inv_ext = scene_bounds(sd)

    @jax.jit
    def build():
        rox, roy, roz = ro[:, 0], ro[:, 1], ro[:, 2]
        rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
        hit, t, idx, s2, s3 = ctx.intersect(rox, roy, roz, rdx, rdy, rdz)
        attrs_t = ec.fetch_attrs(ctx, idx)
        pox, poy, poz, nx, ny, nz, rough, _, _ = ec.shade_geometry(
            ctx, attrs_t, rox, roy, roz, rdx, rdy, rdz, t, s2, s3)
        u = jax.random.uniform(jax.random.key(7), (4, n))
        b = sampling.sample_bounce_soa(
            ec.row(ctx, attrs_t, "mat_type").astype(jnp.int32),
            rdx, rdy, rdz, nx, ny, nz, rough, jnp.zeros((n,), bool),
            u[1], u[2], u[3])
        park = jnp.float32(1e30)
        nro = (jnp.where(hit, pox, park), jnp.where(hit, poy, park),
               jnp.where(hit, poz, park))
        nrd = (jnp.where(hit, b.dx, 0.0), jnp.where(hit, b.dy, 0.0),
               jnp.where(hit, b.dz, 0.0))
        keys = sort_key(*nro, *nrd, hit, smin, inv_ext, True)
        seg = segment_for(n)
        ns = n // seg
        p = (jnp.argsort(keys.reshape(ns, seg), axis=1).astype(jnp.int32)
             + (jnp.arange(ns, dtype=jnp.int32) * seg)[:, None]).reshape(-1)
        sorted_rays = jnp.stack(nro + nrd, axis=1)[p]
        return sorted_rays, hit

    sorted_rays, hit = build()
    pk = np.asarray(sorted_rays)
    rays = [jnp.asarray(pk[:, i]) for i in range(6)]
    live = float(np.asarray(hit).mean())
    return rays, live


def chain(label, fn, *args):
    """Time K loop-carried iterations of fn inside one jit.

    fn(i, carry, *args) -> carry; carry[−1] must be a scalar accumulator
    (the drain). Reports (t_K − t_compile-warm) / K.
    """
    @jax.jit
    def run(*a):
        def it(i, carry):
            return fn(i, carry, *a)
        init = fn(jnp.int32(0), None, *a)   # phase builds its own carry
        out = jax.lax.fori_loop(1, K + 1, it, init)
        return out[-1]

    float(run(*args))                        # compile + warm
    t0 = time.perf_counter()
    drain = float(run(*args))
    dt = time.perf_counter() - t0
    print(f"{label:>10}: {dt / (K + 1) * 1000:7.2f} ms/call "
          f"(drain {drain:.3e})", flush=True)
    return dt / (K + 1)


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "textured"
    sc, (w, h) = scene_for(name)
    sd = sc.compile()
    n = w * h
    nw = sd.wavenumbers.shape[0]
    n_tris = sd.tri_shade.shape[0]
    ctx = ec.make_ctx(sd, "auto")
    from pathtracing_spectrum_tpu.utils.device_info import device_fields
    print(f"config={name} res={w}x{h} n={n} tris={n_tris} "
          f"backend={ctx.backend} {device_fields()}", flush=True)

    rays, live = bounce1_state(sc, sd, ctx, w, h)
    print(f"bounce-1 live fraction: {live:.3f}", flush=True)
    rox, roy, roz, rdx, rdy, rdz = rays
    smin, inv_ext = scene_bounds(sd)
    seg = segment_for(n)
    ns = n // seg
    offs = (jnp.arange(ns, dtype=jnp.int32) * seg)[:, None]

    ms = {}

    # --- sort: keys + forward/inverse segmented argsort + row gathers ---
    def sort_fn(i, carry, rox, roy, roz, rdx, rdy, rdz):
        if carry is None:
            carry = (rox, roy, roz, jnp.float32(0))
        ox, oy, oz, acc = carry
        alive = rdx != 0.0
        key = sort_key(ox, oy, oz, rdx, rdy, rdz, alive, smin, inv_ext,
                       morton=True)
        perm_l = jnp.argsort(key.reshape(ns, seg), axis=1,
                             stable=True).astype(jnp.int32)
        inv_l = jnp.argsort(perm_l, axis=1).astype(jnp.int32)
        perm = (perm_l + offs).reshape(-1)
        inv = (inv_l + offs).reshape(-1)
        packed = jnp.stack([ox, oy, oz, rdx, rdy, rdz], axis=1)[perm]
        res = packed[:, :4][inv]                  # the [N,4] unsort gather
        d = jnp.float32(1e-7) * (1.0 + 1e-3 * i.astype(jnp.float32))
        return (ox + d * res[:, 3], oy + d * res[:, 0], oz + d * res[:, 1],
                acc + res[:, 2].sum())
    if want("sort"):
        ms["sort"] = chain("sort", sort_fn, rox, roy, roz, rdx, rdy, rdz)

    # --- intersect: the engine-resolved kernel on sorted bounce rays ---
    def isect_fn(i, carry, rox, roy, roz, rdx, rdy, rdz):
        if carry is None:
            carry = (rox, roy, roz, jnp.float32(0))
        ox, oy, oz, acc = carry
        hit, t, _, _, _ = ctx.intersect(ox, oy, oz, rdx, rdy, rdz)
        tt = jnp.where(hit, t, 0.0)
        s = jnp.float32(1e-5) * (1.0 + 1e-3 * i.astype(jnp.float32))
        return (ox + s * tt * rdx, oy + s * tt * rdy, oz + s * tt * rdz,
                acc + jnp.sum(tt))
    if want("intersect"):
        ms["intersect"] = chain("intersect", isect_fn, rox, roy, roz,
                            rdx, rdy, rdz)

    # one real intersection feeds the shading-phase chains
    hit, t, idx0, s2, s3 = jax.jit(ctx.intersect)(rox, roy, roz,
                                                  rdx, rdy, rdz)

    # --- fetch: attribute planes at data-dependent indices ---
    def fetch_fn(i, carry, idx0):
        if carry is None:
            carry = (idx0, jnp.float32(0))
        idx, acc = carry
        attrs_t = ec.fetch_attrs(ctx, idx)
        bump = (attrs_t[0] > 0).astype(jnp.int32) + i
        return ((idx + bump) % n_tris, acc + attrs_t[1].sum())
    if want("fetch"):
        ms["fetch"] = chain("fetch", fetch_fn, idx0)

    attrs_t = jax.jit(lambda i: ec.fetch_attrs(ctx, i))(idx0)

    # --- shade: geometry + textures (engine_common.shade_geometry) ---
    def shade_fn(i, carry, attrs_t, rox, roy, roz, rdx, rdy, rdz, t, s2, s3):
        if carry is None:
            carry = (t, jnp.float32(0))
        tc, acc = carry
        pox, poy, poz, nx, ny, nz, rough, uvu, uvv = ec.shade_geometry(
            ctx, attrs_t, rox, roy, roz, rdx, rdy, rdz, tc, s2, s3)
        d = jnp.float32(1e-6) * (1.0 + 1e-3 * i.astype(jnp.float32))
        return (tc + d * (nx + rough), acc + jnp.sum(uvu + poy * 0 + uvv))
    if want("shade"):
        ms["shade"] = chain("shade", shade_fn, attrs_t, rox, roy, roz,
                        rdx, rdy, rdz, t, s2, s3)

    # --- spectra: material curves + [nw, N] state update ---
    def spectra_fn(i, carry, attrs_t, hit):
        if carry is None:
            carry = (jnp.ones((nw, n), jnp.float32),
                     jnp.zeros((nw, n), jnp.float32), jnp.float32(0))
        thr, rad, acc = carry
        uv = jnp.float32(1e-4) * i.astype(jnp.float32)
        emis_t, emis_eff, refl_eff = ec.material_spectra(
            ctx, attrs_t, thr[0] * 0 + uv, thr[0] * 0)
        surv = hit[None, :]
        rad = rad + thr * jnp.where(surv, emis_eff, sd.sky[:, None])
        thr = jnp.where(surv, thr * refl_eff, thr)
        return (thr, rad, acc + rad[0].sum())
    if want("spectra"):
        ms["spectra"] = chain("spectra", spectra_fn, attrs_t, hit)

    # --- bounce: RNG planes + sample_bounce_soa ---
    mat = ec.row(ctx, attrs_t, "mat_type").astype(jnp.int32)
    rough = ec.row(ctx, attrs_t, "roughness")

    def bounce_fn(i, carry, rdx, rdy, rdz, nxv, nyv, nzv):
        if carry is None:
            carry = (rdx, rdy, rdz, jnp.float32(0))
        dx, dy, dz, acc = carry
        u = jax.random.uniform(jax.random.fold_in(jax.random.key(3), i),
                               (4, n), jnp.float32)
        b = sampling.sample_bounce_soa(mat, dx, dy, dz, nxv, nyv, nzv,
                                       rough, jnp.zeros((n,), bool),
                                       u[1], u[2], u[3])
        return (b.dx, b.dy, b.dz, acc + jnp.sum(b.dz))
    nxv = jnp.where(rdx == 0, 1.0, -rdx)  # stand-in shading normals
    nyv, nzv = jnp.abs(rdy), jnp.abs(rdz)
    if want("bounce"):
        ms["bounce"] = chain("bounce", bounce_fn, rdx, rdy, rdz, nxv, nyv, nzv)

    total = sum(ms.values())
    print(f"{'SUM':>10}: {total * 1000:7.2f} ms/iteration "
          f"(x6 iterations = {total * 6 * 1000:.0f} ms/sample)", flush=True)

    # --- in-context cross-check ---
    s = RenderSession(sc, seed=3)
    s.run(SPP, batch=SPP)
    t0 = time.perf_counter()
    s.run(2 * SPP, batch=SPP)
    img = np.asarray(s.result())
    dt = time.perf_counter() - t0
    print(f"in-context: {SPP / dt:.2f} spp/s -> {dt / SPP * 1000:.0f} "
          f"ms/sample (mean {img.mean():.5f})", flush=True)


if __name__ == "__main__":
    main()
