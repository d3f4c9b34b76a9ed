#!/usr/bin/env python3
"""Smoke test of the renderer on one GPU, through the entry points users call.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --devices 4   # four GPUs: the sharded path only

Phases (one process; it is the only one that opens the card):

1. device    — JAX's default device is a GPU; prints its kind, the device
               count and ``nvidia-smi``'s name and power limit.
2. cli       — ``cli.main(["render", ...])`` renders a Cornell 512x512
               ``.pts`` scene (depth 3, 4 wavelengths, 64 spp) with
               ``--out``, ``--png`` and ``--png-srgb``; checks the exported
               spectra.
3. scenes    — six scenes through ``RenderSession``, as bench_suite.py
               builds them: first-call (compile) seconds, steady spp/s and
               Mrays/s, peak device memory, resolved backend; and the BVH
               while-loop timing on the terrain scene.
4. fidelity  — Cornell, prism, textured and mixed depth-8 renders on the
               card against the dense reference on the CPU (in this
               process, on ``jax.devices("cpu")``): relative RMSE < 1%.
5. kernel    — the dense Pallas kernel against the jnp sweep at real
               widths (hit/index agreement, ``t``), per-call and end-to-end
               timings of both, and the attribute-fetch A/B.
6. gpu tests — the ``gpu``-marked tests, in this process.
7. devices N — (``--devices N`` only, instead of phases 2-6) TileSharding
               and SppAllreduce through ``RenderSession`` on Cornell 512²,
               each checked against a single-device replay.

Exits non-zero if any phase fails, and before printing any result when JAX
has no GPU. The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Phase functions take their sizes as arguments, so tests/test_chip_smoke.py
rehearses them at tiny sizes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(HERE, "assets")

# Kernel vs jnp sweep: both evaluate the same f32 formula in the same
# order, but the GPU compiler may contract a multiply-add into an FMA in
# one and not the other, which can flip a same-side test (s >= 0) for a
# ray grazing a triangle edge. So agreement is held to 99.99% of rays, not
# all, and t to 1e-5 relative where both pick the same triangle.
AGREE_MIN = 0.9999
T_REL_MAX = 1e-5
RMSE_MAX = 0.01


def log(msg) -> None:
    print(msg if isinstance(msg, str) else json.dumps(msg), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _bs():
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    import bench_suite
    return bench_suite


# ---------------------------------------------------------------- scenes

def terrain_200k_scene(res=(512, 512), depth=3):
    """bench_suite's terrain scene over the ~246k-triangle asset, generated
    on demand (alone, not the whole asset set)."""
    bs = _bs()
    path = os.path.join(ASSETS, "terrain_200k.obj")
    if not os.path.exists(path):
        sys.path.insert(0, ASSETS)
        import make_assets
        make_assets.make_terrain(path, grid=224, n_rocks=96, rock_sub=20)
    return bs.terrain_scene(res, "terrain_200k.obj", depth)


def scene_specs(scale: int = 1):
    """(name, builder, spp, session kwargs) of phase 3; ``scale`` divides
    the resolutions (and samples) for a CPU rehearsal."""
    bs = _bs()

    def r(w, h):
        return (max(8, w // scale), max(8, h // scale))

    def n(spp):
        return max(1, spp // scale)

    return [
        ("cornell_512", lambda: bs.cornell_scene(r(512, 512), 3), n(64), {}),
        ("prism_512_dispersion", lambda: bs.prism_scene(r(512, 512), 5),
         n(32), {"dispersion": True}),
        ("textured_1080p", lambda: bs.textured_sphere_scene(r(1920, 1080)),
         n(16), {}),
        ("cornell_512_nw256_hero",
         lambda: bs.cornell_scene_nw(r(512, 512), 3, 256 // scale), n(8),
         {"dispersion": "hero"}),
        ("cornell_4k", lambda: bs.cornell_scene(r(3840, 2160), 3), n(4), {}),
        ("terrain_200k_512", lambda: terrain_200k_scene(r(512, 512)), n(4),
         {}),
    ]


def fidelity_specs(scale: int = 1):
    """(name, builder, session kwargs) at bench_suite._rmse_gate's sizes."""
    bs = _bs()

    def r(w, h):
        return (max(8, w // scale), max(8, h // scale))

    return [
        ("cornell", lambda: bs.cornell_scene(r(128, 128), 3), {}),
        ("prism", lambda: bs.prism_scene(r(128, 128), 5),
         {"dispersion": True}),
        ("textured", lambda: bs.textured_sphere_scene(r(192, 108)), {}),
        ("mixed_depth8", lambda: bs.cornell_scene(
            r(128, 128), 8, block_types=("SPECULAR", "GLASS")), {}),
    ]


# ---------------------------------------------------------------- helpers

def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _median_time(fn, reps: int) -> float:
    import jax
    import numpy as np
    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _session_rate(scene, spp, **kw):
    """(first-call seconds, steady spp/s, steady Mrays/s, session)."""
    from pathtracing_spectrum_tpu.render import RenderSession
    s = RenderSession(scene, **kw)
    s.start()
    t0 = time.perf_counter()
    s.step(spp, readback=False)
    first = time.perf_counter() - t0
    r0, n0 = s.rays_traced, s.samples
    t0 = time.perf_counter()
    s.step(spp, readback=False)
    dt = time.perf_counter() - t0
    # samples, not steps: an SppAllreduce step adds one per device
    return first, (s.samples - n0) / dt, (s.rays_traced - r0) / dt / 1e6, s


# ------------------------------------------------------------------ phases

def phase_device(expect_platform: str = "gpu", expect_count: int = 1):
    """Returns the device dict of the final line; raises without a GPU."""
    import jax
    from pathtracing_spectrum_tpu.utils.device_info import card_info
    devs = jax.devices()
    check(devs[0].platform == expect_platform,
          f"JAX's default device is {devs[0].platform!r}, expected "
          f"{expect_platform!r}")
    check(len(devs) >= expect_count,
          f"{len(devs)} devices visible, {expect_count} needed")
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    log(f"card: {card_info()}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_cli(out_dir: str, res=(512, 512), spp: int = 64, depth: int = 3):
    """Render a Cornell .pts scene through ``cli.main`` and check the
    exported spectra and PNGs."""
    import numpy as np
    from pathtracing_spectrum_tpu import cli
    from pathtracing_spectrum_tpu.utils import scene_io, spectral_io
    from pathtracing_spectrum_tpu.utils.png import read_png
    bs = _bs()
    w, h = res
    scene_path = os.path.join(out_dir, "cornell.pts")
    scene_io.save_scene(bs.cornell_scene(res, depth), scene_path)
    out = os.path.join(out_dir, "cornell_spectra.txt")
    png = os.path.join(out_dir, "cornell")
    srgb = os.path.join(out_dir, "cornell_srgb.png")
    t0 = time.perf_counter()
    rc = cli.main(["render", scene_path, "--spp", str(spp), "--batch",
                   str(spp), "--out", out, "--png", png, "--png-srgb", srgb,
                   "--quiet"])
    check(rc == 0, f"cli render exited {rc}")
    img = spectral_io.import_spectrum(out, w, h, 4)
    check(img is not None, f"{out} does not read back as {w}x{h}x4")
    rows = img.reshape(-1, 4).shape[0]
    check(rows == w * h, f"{rows} pixel rows, expected {w * h}")
    check(np.isfinite(img).all(), "NaN/inf in the exported spectra")
    check(np.abs(img).max() > 0, "exported spectra are all zero")
    # the upper half holds the 500 C ceiling light, the lower the floor
    ceiling, floor = float(img[:h // 2].mean()), float(img[h // 2:].mean())
    check(ceiling > floor,
          f"ceiling half {ceiling} is not hotter than floor half {floor}")
    for k in range(4):
        check(read_png(f"{png}_ch{k}.png").shape == (h, w, 1),
              f"bad channel PNG {k}")
    check(read_png(srgb).shape == (h, w, 3), "bad sRGB PNG")
    log({"phase": "cli", "resolution": f"{w}x{h}", "spp": spp,
         "seconds": time.perf_counter() - t0, "ceiling_mean": ceiling,
         "floor_mean": floor})


def phase_scenes(specs, bvh_probe: bool = True):
    """Compile, warm up and step each scene; print its rates."""
    import jax
    import numpy as np
    dev = jax.devices()[0]
    for name, build, spp, kw in specs:
        sc = build()
        first, sps, mrays, s = _session_rate(sc, spp, **kw)
        out = np.asarray(s._out)
        check(np.isfinite(out).all() and out.mean() > 0,
              f"{name}: non-finite or empty image")
        w, h = s.resolution
        log({"phase": "scenes", "scene": name, "resolution": f"{w}x{h}",
             "triangles": s._scene_data.n_triangles, "spp": spp,
             "backend": s.resolved_backend(), "first_call_s": first,
             "spp_per_s": sps, "mrays_per_s": mrays,
             "peak_bytes_in_use_so_far": _peak_bytes(dev)})
        if bvh_probe and s.resolved_backend() == "bvh":
            _bvh_loop_probe(s)


def _bvh_loop_probe(session, reps: int = 3):
    """Time the BVH's primary-ray traversal and count its while-loop
    iterations; compare with a fixed-trip loop of the same body count to
    see what the data-dependent ``any()`` condition costs per iteration."""
    import jax
    import jax.numpy as jnp
    from pathtracing_spectrum_tpu.ops.bvh import intersect_bvh
    sd = session._scene_data
    ro, rd = session._ro, session._rd
    args = (sd.tri_v1, sd.tri_e1, sd.tri_e2, sd.tri_face_n, sd.bvh_node_min,
            sd.bvh_node_max, sd.bvh_node_skip, sd.bvh_node_first,
            sd.bvh_node_count)
    f = jax.jit(lambda o, d: intersect_bvh(o, d, *args,
                                           count_iterations=True))
    iters = int(f(ro, rd)[5])
    t_call = _median_time(lambda: f(ro, rd), reps)

    def spin(cond_any):
        x = jnp.zeros(ro.shape[0], jnp.int32)
        if cond_any:
            return jax.lax.while_loop(lambda v: jnp.any(v < iters),
                                      lambda v: v + 1, x)
        return jax.lax.fori_loop(0, iters, lambda i, v: v + 1, x)

    t_while = _median_time(jax.jit(lambda: spin(True)), reps)
    t_fori = _median_time(jax.jit(lambda: spin(False)), reps)
    log({"phase": "scenes", "probe": "bvh_while_loop", "rays": ro.shape[0],
         "iterations": iters, "call_s": t_call,
         "us_per_iteration": t_call / iters * 1e6,
         "empty_while_any_us_per_iter": t_while / iters * 1e6,
         "empty_fori_us_per_iter": t_fori / iters * 1e6})


def phase_fidelity(specs, spp: int = 8):
    """Device render (production backend) vs the dense reference rendered
    on the CPU device of this same process; relative RMSE < 1%."""
    import jax
    import numpy as np
    from pathtracing_spectrum_tpu.render import RenderSession
    cpu = jax.devices("cpu")[0]
    for name, build, kw in specs:
        s = RenderSession(build(), seed=0, **kw)
        img = s.run(target_spp=spp)
        backend = s.resolved_backend()
        with jax.default_device(cpu):
            ref = RenderSession(build(), backend="dense", seed=0,
                                **kw).run(target_spp=spp)
        rmse = float(np.sqrt(np.mean((img - ref) ** 2))
                     / max(np.sqrt(np.mean(ref ** 2)), 1e-20))
        log({"phase": "fidelity", "scene": name, "backend": backend,
             "spp": spp, "rmse_rel": rmse, "limit": RMSE_MAX})
        check(rmse < RMSE_MAX, f"{name}: relative RMSE {rmse} >= {RMSE_MAX}")


def _primary_rays(scene):
    """Tile-ordered primary rays, exactly as RenderSession traces them."""
    import jax.numpy as jnp
    import numpy as np
    from pathtracing_spectrum_tpu.models.camera import camera_rays, tile_order
    w, h = scene.resolution
    ro, rd = camera_rays(scene.camera(), w, h)
    perm, _ = tile_order(w, h)
    return (jnp.asarray(np.asarray(ro)[perm]),
            jnp.asarray(np.asarray(rd)[perm]))


def _bounce_rays(sd, ro, rd, hit, t, idx, seed=0):
    """Cosine-weighted diffuse bounce-1 rays off the primary hits; misses
    are parked with a zero direction, as the engine parks dead rays."""
    import jax
    import jax.numpy as jnp
    from pathtracing_spectrum_tpu.constants import EPS
    n = sd.tri_face_n[idx]
    n = jnp.where(jnp.sum(n * rd, axis=1, keepdims=True) > 0, -n, n)
    p = ro + t[:, None] * rd + n * EPS
    u = jax.random.normal(jax.random.key(seed), ro.shape)
    d = n + u / jnp.linalg.norm(u, axis=1, keepdims=True)
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    alive = hit[:, None]
    return (jnp.where(alive, p, 1e30), jnp.where(alive, d, 0.0))


def _kernel_compare(name, sd, ro, rd, interpret: bool, reps: int):
    import jax
    import numpy as np
    from pathtracing_spectrum_tpu.ops.intersect import intersect_bruteforce
    from pathtracing_spectrum_tpu.ops.intersect_pallas import (
        intersect_dense_pallas_soa, pack_tri16)
    tri16 = pack_tri16(sd.tri_face_n, sd.tri_k1, sd.tri_k2, sd.tri_k3,
                       sd.tri_consts)
    comps = [ro[:, k] for k in range(3)] + [rd[:, k] for k in range(3)]
    kern = jax.jit(lambda *c: intersect_dense_pallas_soa(
        *c, tri16, interpret=interpret))
    plain = jax.jit(lambda o, d: intersect_bruteforce(
        o, d, sd.tri_face_n, sd.tri_k1, sd.tri_k2, sd.tri_k3, sd.tri_consts))
    h1, t1, i1, _, _ = (np.asarray(a) for a in kern(*comps))
    h0, t0, i0, _, _ = (np.asarray(a) for a in plain(ro, rd))
    hit_mis = int((h0 != h1).sum())
    both = h0 & h1
    idx_mis = int((i0[both] != i1[both]).sum())
    agree = 1.0 - (hit_mis + idx_mis) / max(h0.shape[0], 1)
    same = both & (i0 == i1)
    t_rel = (float(np.max(np.abs(t1[same] - t0[same])
                          / np.maximum(np.abs(t0[same]), 1e-30)))
             if same.any() else 0.0)
    ms_kernel = _median_time(lambda: kern(*comps), reps) * 1e3
    ms_plain = _median_time(lambda: plain(ro, rd), reps) * 1e3
    log({"phase": "kernel", "rays": name, "n": int(h0.shape[0]),
         "triangles": int(tri16.shape[0]), "hits": int(h0.sum()),
         "hit_mismatches": hit_mis, "idx_mismatches": idx_mis,
         "agreement": agree, "t_rel_max": t_rel,
         "ms_per_call_kernel": ms_kernel, "ms_per_call_jnp_sweep": ms_plain})
    check(agree >= AGREE_MIN, f"{name}: agreement {agree} < {AGREE_MIN}")
    check(t_rel <= T_REL_MAX, f"{name}: t relative diff {t_rel} > "
          f"{T_REL_MAX}")
    return h0, t0, i0


def _fetch_ab(name, sd, idx, reps: int, chunk: int = 262144):
    """Row gather vs the one-hot [F, T] x [T, N] product (HIGHEST, in
    chunks of ``chunk`` rays) for the attribute fetch: same bits, times."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    table = sd.tri_shade
    n = idx.shape[0]
    pad = (-n) % chunk if n > chunk else 0
    chunk = min(chunk, n)

    def onehot(ix):
        ixc = jnp.pad(ix, (0, pad)).reshape(-1, chunk)

        def one(c):
            oh = (jnp.arange(table.shape[0], dtype=jnp.int32)[:, None]
                  == c[None, :]).astype(jnp.float32)
            return jnp.dot(table.T, oh, precision=jax.lax.Precision.HIGHEST)
        out = jax.lax.map(one, ixc)                    # [C, F, chunk]
        return out.transpose(1, 0, 2).reshape(table.shape[1], -1)[:, :n]

    g = jax.jit(lambda ix: table[ix].T)
    o = jax.jit(onehot)
    same = bool(np.array_equal(np.asarray(g(idx)), np.asarray(o(idx))))
    log({"phase": "kernel", "fetch": name, "n": int(n),
         "triangles": int(table.shape[0]), "columns": int(table.shape[1]),
         "bit_identical": same,
         "ms_gather": _median_time(lambda: g(idx), reps) * 1e3,
         "ms_onehot_highest": _median_time(lambda: o(idx), reps) * 1e3})
    check(same, f"{name}: gather and one-hot fetch differ")


def phase_kernel(cornell_res=(512, 512), textured_res=(1920, 1080),
                 reps: int = 10, interpret: bool = False,
                 e2e_spp=(64, 16)):
    """Kernel vs jnp sweep at real widths; per-call and end-to-end A/B."""
    bs = _bs()
    corn = bs.cornell_scene(cornell_res, 3)
    sd = corn.compile()
    ro, rd = _primary_rays(corn)
    hit, t, idx = _kernel_compare("cornell_primary", sd, ro, rd, interpret,
                                  reps)
    import jax.numpy as jnp
    _fetch_ab("cornell_primary", sd, jnp.asarray(idx), reps)
    bro, brd = _bounce_rays(sd, ro, rd, jnp.asarray(hit), jnp.asarray(t),
                            jnp.asarray(idx))
    _kernel_compare("cornell_bounce1", sd, bro, brd, interpret, reps)
    tex = bs.textured_sphere_scene(textured_res)
    tsd = tex.compile()
    tro, trd = _primary_rays(tex)
    _, _, tidx = _kernel_compare("textured_primary", tsd, tro, trd,
                                 interpret, reps)
    _fetch_ab("textured_primary", tsd, jnp.asarray(tidx), reps)
    if not e2e_spp:
        return
    # end to end through RenderSession: kernel, plain, kernel, plain
    from pathtracing_spectrum_tpu.engine import resolve_backend
    for name, scene, n_tris, spp in (
            ("cornell_512", corn, sd.n_triangles, e2e_spp[0]),
            ("textured_1080p", tex, tsd.n_triangles, e2e_spp[1])):
        rates = {"dense_pallas": [], "dense": []}
        for backend in ("dense_pallas", "dense", "dense_pallas", "dense"):
            _, sps, _, _ = _session_rate(scene, spp, backend=backend)
            rates[backend].append(sps)
        log({"phase": "kernel", "e2e": name, "spp": spp,
             "spp_per_s_kernel": rates["dense_pallas"],
             "spp_per_s_jnp_sweep": rates["dense"],
             "auto_resolves_to": resolve_backend("auto", n_tris)})


def phase_gpu_tests() -> None:
    """Run the gpu-marked tests in this process."""
    import pytest
    os.environ["PTS_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")])
    log({"phase": "gpu_tests", "pytest_exit_code": int(rc)})
    check(int(rc) == 0, f"gpu-marked tests failed (pytest exit {int(rc)})")


def phase_devices(n_dev: int, res=(512, 512), spp: int = 8, depth: int = 3):
    """TileSharding and SppAllreduce on ``n_dev`` devices, each checked
    against a single-device replay."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pathtracing_spectrum_tpu.engine import trace_radiance
    from pathtracing_spectrum_tpu.parallel.mesh import make_mesh
    from pathtracing_spectrum_tpu.parallel.tiling import (
        SppAllreduce, TileSharding, tile_shard_trace)
    bs = _bs()
    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"{len(devs)} devices, {n_dev} needed")
    mesh = make_mesh(devs)
    sc = bs.cornell_scene(res, depth)

    for strategy in (TileSharding(mesh), SppAllreduce(mesh)):
        first, sps, mrays, s = _session_rate(sc, spp, sharding=strategy)
        img = s.result()
        check(np.isfinite(img).all() and img.mean() > 0,
              f"{type(strategy).__name__}: bad image")
        log({"phase": "devices", "strategy": type(strategy).__name__,
             "devices": n_dev, "samples": s.samples,
             "first_call_s": first, "spp_per_s": sps, "mrays_per_s": mrays,
             "backend": s.resolved_backend()})

    trace = jax.jit(trace_radiance,
                    static_argnames=("max_depth", "backend", "dispersion"))
    sd = sc.compile()
    ro, rd = _primary_rays(sc)
    n = ro.shape[0]
    key = jax.random.key(7)

    # tiles: shared variates, no device key fold -> the unsharded render
    rand = jax.random.uniform(jax.random.key(8), (2 * depth, 4, n))
    ref = trace(sd, ro, rd, key, max_depth=depth, rand_override=rand)
    ts = TileSharding(mesh)
    ro_s, rd_s = ts.shard_rays(ro, rd)
    rand_s = jax.device_put(rand, NamedSharding(mesh, P(None, None, "tiles")))
    rad, nrays = tile_shard_trace(mesh, sd, ro_s, rd_s, key, depth,
                                  rand_override=rand_s, fold_device=False)
    ref_rad = np.asarray(ref.radiance)
    tile_rel = float(np.max(np.abs(np.asarray(rad) - ref_rad))
                     / max(np.max(np.abs(ref_rad)), 1e-30))
    check(int(nrays) == int(ref.rays_traced),
          f"tiles traced {int(nrays)} rays, single device "
          f"{int(ref.rays_traced)}")
    check(tile_rel <= 1e-5, f"tiles radiance rel diff {tile_rel} > 1e-5")

    # spp-allreduce: one step = one sample per device, psum'd; replay the
    # per-device folds on one device and sum them in device order. The
    # psum may add in another order: 1e-5 of the largest value covers
    # n_dev f32 additions.
    sp = SppAllreduce(mesh)
    ro_r, rd_r = sp.shard_rays(ro, rd)
    nw = len(sc.wavelengths)
    total, _, _, sp_rays = sp.render_samples(
        sd, ro_r, rd_r, sp.zeros_accumulator(n, nw),
        jax.numpy.zeros((), jax.numpy.int32), key, 0, n_steps=1,
        max_depth=depth)
    replay = np.zeros((n, nw), np.float32)
    replay_rays = 0
    for d in range(n_dev):
        r = trace(sd, ro, rd, jax.random.fold_in(jax.random.fold_in(key, 0),
                                                 d), max_depth=depth)
        replay = replay + np.asarray(r.radiance)
        replay_rays += int(r.rays_traced)
    spp_rel = float(np.max(np.abs(np.asarray(total) - replay))
                    / max(np.max(np.abs(replay)), 1e-30))
    check(int(sp_rays) == replay_rays,
          f"spp-allreduce traced {int(sp_rays)} rays, replay {replay_rays}")
    check(spp_rel <= 1e-5, f"spp-allreduce rel diff {spp_rel} > 1e-5")
    log({"phase": "devices", "tiles_vs_single_rel": tile_rel,
         "tiles_rays": int(nrays), "spp_allreduce_vs_replay_rel": spp_rel,
         "spp_allreduce_rays": int(sp_rays),
         "peak_bytes_in_use": [_peak_bytes(d) for d in devs]})


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1: run only the N-device sharded phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from pathtracing_spectrum_tpu.compile_cache import enable_compile_cache
    from pathtracing_spectrum_tpu.utils.device_info import card_info
    enable_compile_cache()
    device = phase_device("gpu", args.devices)

    if args.devices > 1:
        phases = [("devices", lambda: phase_devices(args.devices))]
    else:
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
        phases = [("cli", lambda: phase_cli(out_dir)),
                  ("scenes", lambda: phase_scenes(scene_specs())),
                  ("fidelity", lambda: phase_fidelity(fidelity_specs())),
                  ("kernel", phase_kernel),
                  ("gpu_tests", phase_gpu_tests)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            failed.append(name)
            traceback.print_exc()
            log(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
    if failed:
        log(f"failed phases: {failed}")
        return 1
    log(card_info())
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
