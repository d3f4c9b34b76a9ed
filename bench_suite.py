"""Full benchmark suite: the five BASELINE.json configs, on a GPU.

Prints one JSON line per config; every line names the platform, the device
kind and count, and the card's name and power limit. Exits non-zero without
a GPU, and when any config failed. `bench.py` remains the single headline
number.

Configs (BASELINE.json):
  1. Cornell box 512x512, diffuse-only spectral, 64 spp — plus the spectral
     RMSE gate vs the CPU reference implementation at equal spp/seed
     (gate run at 128x128/8spp to keep the CPU render tractable).
  2. Dielectric dispersion scene (glass wedge prism, Cauchy IOR).
  3. Textured OBJ mesh scene (sphere + checker roughness texture, full BVH
     path exercised), 1080p progressive.
  4. Mixed-material scene at depth-8, 4096 spp converged.
  5. Multi-device tiled render at 4K with tile sharding + spp-allreduce
     accumulation (runs on however many devices are visible).
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
RESULTS = []
_DEVICE = {}


def report(name, **kv):
    if not _DEVICE:
        from pathtracing_spectrum_tpu.utils.device_info import device_fields
        _DEVICE.update(device_fields())
    entry = {"config": name, **kv, **_DEVICE}
    RESULTS.append(entry)
    print(json.dumps(entry), flush=True)


def _session(scene, **kw):
    from pathtracing_spectrum_tpu.render import RenderSession
    return RenderSession(scene, **kw)


def _timed_spp(session, spp, batch=16):
    """Time `spp` progressive samples in steady state: one warm-up batch
    (compile), then the timed batches; ``step`` ends each one with
    ``block_until_ready``."""
    session.start()
    session.step(min(batch, spp), readback=False)  # compile + warm
    rays0 = session.rays_traced
    t0 = time.perf_counter()
    done = 0
    while done < spp:
        n = min(batch, spp - done)
        session.step(n, readback=False)
        done += n
    dt = time.perf_counter() - t0
    st = session.stats()
    st["mrays_per_s"] = (session.rays_traced - rays0) / dt / 1e6
    return dt, st


def cornell_scene(res, depth, block_types=("DIFFUSE", "DIFFUSE")):
    from pathtracing_spectrum_tpu import Material, MaterialType, Scene, \
        SpectrumMaterial
    sc = Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        SpectrumMaterial("white", [0.8, 0.7, 0.75, 0.8]),
        SpectrumMaterial("emitter", [1.0, 1.0, 1.0, 1.0]),
    ]
    sc.trace_depth = depth
    sc.resolution = res
    obj = sc.load_object(os.path.join(ASSETS, "cornell_box.obj"))
    for i, el in enumerate(obj.elements):
        t = 500.0 if el.name == "light" else 20.0
        sid = 1 if el.name == "light" else 0
        mtype = MaterialType.DIFFUSE
        if el.name == "tall_block":
            mtype = MaterialType[block_types[0]]
        elif el.name == "short_block":
            mtype = MaterialType[block_types[1]]
        sc.set_material(0, i, Material(type=mtype, temperature=t,
                                       spectrum_mat_id=sid, roughness=0.2))
    sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 50.0
    return sc


def config1_cornell():
    sc = cornell_scene((512, 512), 3)
    s = _session(sc)
    # batch=64: the whole 64-spp config in ONE dispatch, exactly how
    # `render scene --spp 64 --batch 64` runs it
    dt, st = _timed_spp(s, 64, batch=64)
    report("cornell_512_diffuse_64spp",
           spp=64, seconds=round(dt, 3), dispatches=1,
           spp_per_sec=round(64 / dt, 2),
           mrays_per_sec=round(st["mrays_per_s"], 1))

    # RMSE gate vs CPU reference implementation, equal spp + seed
    _rmse_gate("cornell_rmse_vs_cpu_ref", "bs.cornell_scene((128, 128), 3)",
               cornell_scene((128, 128), 3))


def _rmse_gate(name, builder_src, sc, spp=8, session_kw=None):
    """Equal-spp/seed fidelity gate: the device render (production backend
    policy) vs the same scene rendered by the dense CPU path in a separate
    process. Validates the full device pipeline — intersection kernel,
    attribute fetch, spectral accumulate — end-to-end per config.

    `builder_src` is a Python expression (evaluated in a subprocess where
    `bs` = this module) constructing the SAME scene `sc` was built from;
    `session_kw` is a dict of extra RenderSession kwargs (e.g. dispersion)
    applied to BOTH renders so only the device/backend differs — it is
    repr()-rendered into the subprocess source, the single source of truth
    for both sessions."""
    kw = dict(session_kw or {})
    ref_npy = os.path.join(tempfile.gettempdir(), f"pts_ref_cpu_{name}.npy")
    # One process per card: this parent holds the GPU, so the child is
    # forced onto the CPU (JAX_PLATFORMS in its environment, before JAX
    # starts) and never opens the card.
    code = f"""
import jax
jax.config.update('jax_platforms', 'cpu')
import sys, numpy as np
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
import bench_suite as bs
sc = {builder_src}
s = bs._session(sc, backend='dense', seed=0, **{kw!r})
s.run(target_spp={spp})
np.save({ref_npy!r}, s.result())
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=1800,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    cpu_img = np.load(ref_npy)

    s = _session(sc, seed=0, **kw)
    s.run(target_spp=spp)
    dev_img = s.result()
    rmse = float(np.sqrt(np.mean((dev_img - cpu_img) ** 2))
                 / max(np.sqrt(np.mean(cpu_img ** 2)), 1e-20))
    report(name, rmse_rel=round(rmse, 6),
           gate="<0.01", passed=bool(rmse < 0.01))


def prism_scene(res=(512, 512), depth=5):
    from pathtracing_spectrum_tpu import Material, MaterialType, Scene, \
        SpectrumMaterial
    sc = Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [SpectrumMaterial("glass", [0.0] * 4),
                             SpectrumMaterial("surface", [0.9] * 4),
                             SpectrumMaterial("emitter", [1.0] * 4)]
    sc.trace_depth = depth
    sc.resolution = res
    obj = sc.load_object(os.path.join(ASSETS, "prism.obj"))
    mats = {
        "floor": Material(type=MaterialType.DIFFUSE, spectrum_mat_id=1,
                          temperature=20.0),
        "back": Material(type=MaterialType.DIFFUSE, spectrum_mat_id=1,
                         temperature=20.0),
        "emitter": Material(type=MaterialType.DIFFUSE, spectrum_mat_id=2,
                            temperature=600.0),
        "prism": Material(type=MaterialType.GLASS, spectrum_mat_id=0,
                          temperature=500.0, ior=1.45, dispersion_b=0.2),
    }
    for i, el in enumerate(obj.elements):
        sc.set_material(0, i, mats[el.name])
    sc.set_camera([0.0, 0.5, -4.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 60.0
    return sc


def config2_dispersion():
    sc = prism_scene()
    s = _session(sc, dispersion=True)
    dt, st = _timed_spp(s, 32, batch=32)
    report("dispersion_prism_512_32spp", spp=32, seconds=round(dt, 3),
           dispatches=1,
           spp_per_sec=round(32 / dt, 2),
           mrays_per_sec=round(st["mrays_per_s"], 1))
    _rmse_gate("dispersion_rmse_vs_cpu_ref",
               "bs.prism_scene((128, 128), 5)", prism_scene((128, 128), 5),
               session_kw={"dispersion": True})


def textured_sphere_scene(res):
    from pathtracing_spectrum_tpu import Material, MaterialType, Scene, \
        SpectrumMaterial
    sc = Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [SpectrumMaterial("body", [0.7, 0.75, 0.8, 0.7]),
                             SpectrumMaterial("emitter", [1.0] * 4)]
    sc.trace_depth = 3
    sc.resolution = res
    obj = sc.load_object(os.path.join(ASSETS, "sphere.obj"))
    sc.set_material(0, 0, Material(
        type=MaterialType.GLOSSY, spectrum_mat_id=0, temperature=80.0,
        roughness=0.4,
        roughness_tex_file=os.path.join(ASSETS, "checker.png")))
    obj.set_location([0.0, 0.0, 3.0])
    box = sc.load_object(os.path.join(ASSETS, "cornell_box.obj"))
    for i, el in enumerate(box.elements):
        t = 400.0 if el.name == "light" else 15.0
        sid = 1 if el.name == "light" else 0
        sc.set_material(1, i, Material(type=MaterialType.DIFFUSE,
                                       temperature=t, spectrum_mat_id=sid))
    sc.set_camera([0.0, 0.0, -1.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 55.0
    return sc


def config3_textured_1080p():
    sc = textured_sphere_scene((1920, 1080))
    s = _session(sc)
    dt, st = _timed_spp(s, 16, batch=16)
    report("textured_sphere_1080p", spp=16, seconds=round(dt, 3),
           spp_per_sec_1080p=round(16 / dt, 3),
           triangles=st["triangles"],
           mrays_per_sec=round(st["mrays_per_s"], 1))
    # gate at the production backend policy for this triangle count,
    # small res so the CPU reference render stays tractable
    _rmse_gate("textured_rmse_vs_cpu_ref",
               "bs.textured_sphere_scene((192, 108))",
               textured_sphere_scene((192, 108)))


def config4_mixed_depth8():
    sc = cornell_scene((512, 512), 8, block_types=("SPECULAR", "GLASS"))
    s = _session(sc)
    spp = int(os.environ.get("PTS_SUITE_SPP4", "4096"))
    dt, st = _timed_spp(s, spp, batch=64)
    report("mixed_material_depth8", spp=spp, seconds=round(dt, 3),
           spp_per_sec=round(spp / dt, 2),
           mrays_per_sec=round(st["mrays_per_s"], 1))
    _rmse_gate("mixed_depth8_rmse_vs_cpu_ref",
               "bs.cornell_scene((128, 128), 8, "
               "block_types=('SPECULAR', 'GLASS'))",
               cornell_scene((128, 128), 8,
                             block_types=("SPECULAR", "GLASS")))


def config5_multichip_4k():
    from pathtracing_spectrum_tpu.parallel.mesh import make_mesh
    from pathtracing_spectrum_tpu.parallel.tiling import TileSharding
    n_dev = len(jax.devices())
    # the TileSharding wrapper only earns its overhead with >1 device; on
    # one device report the plain path (identical math, no tiling wrapper)
    sharding = TileSharding(make_mesh()) if n_dev > 1 else None
    # a 1-device run is not a multi-device number: report it under a
    # single-device name; the virtual-mesh entries below carry the
    # multi-device code paths
    name = "multichip_4k_tiled" if n_dev > 1 else "4k_singlechip"
    # chunks=32 traces the 8.3M-ray frame as 32 sequential 259200-ray
    # sub-wavefronts (~512² each), bounding the device-memory working set.
    # Whether 32 is also the fastest width on the GPU is not measured
    # (ROADMAP); PTS_4K_CHUNKS overrides it.
    chunks = int(os.environ.get("PTS_4K_CHUNKS", "32"))
    sc = cornell_scene((3840, 2160), 3)
    s = _session(sc, sharding=sharding,
                 chunks=(chunks if sharding is None else 1))
    # 16 spp in ONE dispatch, so the fixed costs (tile order, primary
    # hoist) are amortized
    dt, st = _timed_spp(s, 16, batch=16)
    report(name, devices=n_dev, spp=16, seconds=round(dt, 3), dispatches=1,
           chunks=(chunks if sharding is None else 1),
           tiled=bool(sharding), spp_per_sec_4k=round(16 / dt, 3),
           mrays_per_sec_total=round(st["mrays_per_s"], 1))
    if n_dev == 1:
        config5_virtual_mesh()


def config5_virtual_mesh():
    """Exercise the real tiled + spp-allreduce collective paths on a virtual
    8-device CPU mesh when no pod is attached. Numbers demonstrate the
    sharded code paths executing end-to-end (correctness/scaling shape), NOT
    device throughput — labeled virtual_mesh accordingly. The child is
    forced onto the CPU before JAX starts (one process per card). Resolutions are
    small because XLA's CPU collective rendezvous aborts when device threads
    arrive >40 s apart — the 8 fake devices share physical cores, so skew
    grows with shard size: tiles shards pixels (1/8 image per device);
    spp-allreduce renders the full image per device, so it runs smaller."""
    out_json = os.path.join(tempfile.gettempdir(), "pts_virtual_mesh.json")
    code = f"""
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update('jax_platforms', 'cpu')
import json, sys, time
sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})
import bench_suite as bs
from pathtracing_spectrum_tpu.parallel.mesh import make_mesh
from pathtracing_spectrum_tpu.parallel.tiling import SppAllreduce, TileSharding

import os as _os
results = []
# scaling SHAPE over 2/4/8 fake devices at FIXED total work: on this
# host the 8 XLA "devices" share {{ncpu}} physical core(s), so
# per-device-constant work cannot hold wall-clock flat — constant TOTAL
# work isolates what the curve can show here: partition/collective
# overhead staying flat as the mesh grows (labeled correctness/shape,
# not device throughput).
for ndev in (2, 4, 8):
    mesh = make_mesh(jax.devices()[:ndev])
    sc = bs.cornell_scene((480, 270), 3)
    s = bs._session(sc, sharding=TileSharding(mesh))
    s.start()
    s.step(1, readback=False)                 # compile
    t0 = time.perf_counter()
    s.step(2, readback=False)
    dt = time.perf_counter() - t0
    st = s.stats()
    # per-device ray counts: the observable that tiles DIVIDE the work
    # (the wall-clock curve on shared host cores is noise; this is the
    # partitioning signal)
    from pathtracing_spectrum_tpu.parallel.tiling import per_device_rays
    # the session's _ro/_rd are already tile-sharded over this mesh
    rpd = per_device_rays(mesh, s._scene_data, s._ro, s._rd,
                          jax.random.key(0), sc.trace_depth)
    results.append(dict(strategy="tiles", devices=ndev,
                        host_cpus=_os.cpu_count(), fixed_total_work=True,
                        resolution="480x270",
                        rays_per_device=[int(x) for x in rpd],
                        spp=int(s.samples), seconds_2spp=round(dt, 3),
                        mrays_per_sec_total=round(st["mrays_per_s"], 1)))
# chunks x tiles composition (BASELINE config 5's full story): per-device
# tiles each traced as bounded-width sub-wavefronts; rays_per_device is
# the partitioning observable, as for the plain tiles entries
mesh = make_mesh(jax.devices()[:8])
sc = bs.cornell_scene((256, 128), 3)
s = bs._session(sc, sharding=TileSharding(mesh), chunks=2)
s.start()
s.step(1, readback=False)
t0 = time.perf_counter()
s.step(2, readback=False)
dt = time.perf_counter() - t0
st = s.stats()
from pathtracing_spectrum_tpu.parallel.tiling import per_device_rays
rpd = per_device_rays(mesh, s._scene_data, s._ro, s._rd,
                      jax.random.key(0), sc.trace_depth)
results.append(dict(strategy="tiles_chunked", devices=8, chunks=2,
                    host_cpus=_os.cpu_count(), resolution="256x128",
                    rays_per_device=[int(x) for x in rpd],
                    spp=int(s.samples), seconds_2spp=round(dt, 3),
                    mrays_per_sec_total=round(st["mrays_per_s"], 1)))
mesh = make_mesh(jax.devices()[:8])
sc = bs.cornell_scene((192, 108), 3)
s = bs._session(sc, sharding=SppAllreduce(mesh))
s.start()
s.step(1, readback=False)
t0 = time.perf_counter()
s.step(2, readback=False)
dt = time.perf_counter() - t0
st = s.stats()
results.append(dict(strategy="spp_allreduce", devices=8,
                    host_cpus=_os.cpu_count(), resolution="192x108",
                    spp=int(s.samples), seconds_2spp=round(dt, 3),
                    mrays_per_sec_total=round(st["mrays_per_s"], 1)))
json.dump(results, open({out_json!r}, "w"))
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=3000,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    for entry in json.load(open(out_json)):
        report("multichip_tiled_virtual", virtual_mesh=True,
               correctness_only=True, **entry)


def terrain_scene(res, obj_name, depth=3):
    """Large-scene stress config (procedural terrain + rocks; the asset is
    generated on demand — it is deliberately not checked in)."""
    from pathtracing_spectrum_tpu import Material, MaterialType, Scene, \
        SpectrumMaterial
    path = os.path.join(ASSETS, obj_name)
    if not os.path.exists(path):
        subprocess.run([sys.executable,
                        os.path.join(ASSETS, "make_assets.py")], check=True)
    sc = Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        SpectrumMaterial("ground", [0.7, 0.75, 0.8, 0.7]),
        SpectrumMaterial("rock", [0.5, 0.55, 0.5, 0.45]),
        SpectrumMaterial("emitter", [1.0] * 4),
    ]
    sc.trace_depth = depth
    sc.resolution = res
    obj = sc.load_object(path)
    mats = {
        "terrain": Material(type=MaterialType.DIFFUSE, spectrum_mat_id=0,
                            temperature=15.0),
        "rocks": Material(type=MaterialType.GLOSSY, spectrum_mat_id=1,
                          temperature=15.0, roughness=0.3),
        "light": Material(type=MaterialType.DIFFUSE, spectrum_mat_id=2,
                          temperature=450.0),
    }
    for i, el in enumerate(obj.elements):
        sc.set_material(0, i, mats[el.name])
    sc.set_camera([0.0, 4.0, -10.0], [0.0, 0.5, 0.0])
    sc.camera_fovy = 55.0
    return sc


def config6_large_scenes():
    """Beyond the 5 BASELINE configs: large-scene anchors for the BVH
    intersection path (the production backend above DENSE_MAX_TRIS) — the
    reference's log-time BVH traversal analog (mesh.cpp:239-280)."""
    for name, obj_name, spp in (("terrain_52k_512", "terrain_52k.obj", 8),
                                ("terrain_200k_512", "terrain_200k.obj", 8),
                                ("terrain_1m_512", "terrain_1m.obj", 4)):
        sc = terrain_scene((512, 512), obj_name)
        extra = _agreement_gate(_terrain_agreement(sc), "bvh_vs_dense")
        s = _session(sc)
        dt, st = _timed_spp(s, spp, batch=spp)
        report(name, spp=spp, seconds=round(dt, 3), dispatches=1,
               triangles=st["triangles"],
               spp_per_sec=round(spp / dt, 2),
               mrays_per_sec=round(st["mrays_per_s"], 1), **extra)


# Hit-agreement gate of the BVH vs the exhaustive dense sweep. Not 100% by
# design: the BVH's leaf test evaluates the same-side predicate (reference
# mesh.cpp:283-295) in its own operation order, so at a grazing edge a
# rounding step can flip a hit. The image RMSE gates are the fidelity
# criterion; this one catches a traversal that loses hits.
AGREE_GATE_PCT = 99.8


def _agreement_gate(pct, label):
    return {f"{label}_agree_pct": pct,
            "agree_gate": f">={AGREE_GATE_PCT}",
            "agree_passed": bool(pct >= AGREE_GATE_PCT)}


def _terrain_agreement(sc, res=64, backend="bvh"):
    """Correctness probe for the large scenes: primary-hit selection of the
    BVH vs the jnp dense sweep on a res x res sampled ray set (the dense
    sweep is exhaustive ground truth; 1M tris x 4k rays is a one-off
    cost)."""
    from pathtracing_spectrum_tpu.engine import make_intersector
    from pathtracing_spectrum_tpu.models.camera import camera_rays
    sd = sc.compile()
    ro, rd = camera_rays(sc.camera(), res, res)
    args = tuple(jnp.asarray(np.asarray(x)[:, k])
                 for x in (ro, rd) for k in range(3))
    fast, _ = make_intersector(sd, backend)
    slow, _ = make_intersector(sd, "dense")
    h1, t1, i1, _, _ = fast(*args)
    h0, t0, i0, _, _ = slow(*args)
    same = np.asarray((h0 == h1) & ((~h0) | (i0 == i1)))
    return round(float(same.mean()) * 100.0, 2)


def cornell_scene_nw(res, depth, nw):
    """Cornell box with an nw-point wavelength grid (the reference's
    product is arbitrary user wavelength lists — wave.cpp:33-42, GUI
    CRUD main.cpp:2447-2560; every other config here runs nw=4)."""
    from pathtracing_spectrum_tpu import Material, MaterialType, Scene, \
        SpectrumMaterial
    waves = np.linspace(500.0, 2000.0, nw)
    # smooth emissivity curve through the nw=4 config's anchor values
    white = np.interp(waves, [500.0, 1000.0, 1500.0, 2000.0],
                      [0.8, 0.7, 0.75, 0.8])
    sc = Scene()
    sc.wavelengths = [float(v) for v in waves]
    sc.spectrum_materials = [
        SpectrumMaterial("white", [float(v) for v in white]),
        SpectrumMaterial("emitter", [1.0] * nw),
    ]
    sc.trace_depth = depth
    sc.resolution = res
    obj = sc.load_object(os.path.join(ASSETS, "cornell_box.obj"))
    for i, el in enumerate(obj.elements):
        t = 500.0 if el.name == "light" else 20.0
        sid = 1 if el.name == "light" else 0
        sc.set_material(0, i, Material(type=MaterialType.DIFFUSE,
                                       temperature=t, spectrum_mat_id=sid,
                                       roughness=0.2))
    sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 50.0
    return sc


def config7_wavelength_scaling():
    """spp/s vs wavelength count (SURVEY §5/§7: wavelengths are the
    spectral 'long axis'; hero sampling is the scaling valve). Dense
    [nw, N] spectra at nw = 4/16/64, plus the hero estimator at the
    largest grid (dispersion="hero": unchanged physics, O(N) spectral
    state — unbiased for the same image)."""
    for nw, mode in ((4, False), (16, False), (64, False),
                     (64, "hero"), (256, False), (256, "hero")):
        sc = cornell_scene_nw((512, 512), 3, nw)
        s = _session(sc, dispersion=mode)
        spp = 32
        dt, st = _timed_spp(s, spp, batch=spp)
        report("wavelength_scaling", n_waves=nw,
               estimator=("hero" if mode == "hero" else "dense"),
               spp=spp, seconds=round(dt, 3), dispatches=1,
               spp_per_sec=round(spp / dt, 2),
               mrays_per_sec=round(st["mrays_per_s"], 1))


def main():
    from pathtracing_spectrum_tpu.compile_cache import enable_compile_cache
    from pathtracing_spectrum_tpu.utils.device_info import require_gpu
    enable_compile_cache()
    require_gpu("bench_suite.py")
    failed = []
    for fn in (config1_cornell, config2_dispersion, config3_textured_1080p,
               config4_mixed_depth8, config5_multichip_4k,
               config6_large_scenes, config7_wavelength_scaling):
        try:
            fn()
        except Exception as e:  # keep the suite running; record the failure
            failed.append(fn.__name__)
            report(fn.__name__, error=f"{type(e).__name__}: {e}")
    gates = [r["config"] for r in RESULTS
             if r.get("passed") is False or r.get("agree_passed") is False]
    if failed or gates:
        raise SystemExit(f"bench_suite: failed configs {failed}, "
                         f"failed gates {gates}")


if __name__ == "__main__":
    main()
