"""Multi-chip paths on the virtual 8-device CPU mesh.

Tile sharding must reproduce the single-chip image exactly; spp-allreduce
must add n_devices samples per step with a psum over the mesh.
"""

import jax
import numpy as np
import pytest

from pathtracing_spectrum_tpu import camera_rays
from pathtracing_spectrum_tpu.engine import render_sample
from pathtracing_spectrum_tpu.parallel.mesh import make_mesh
from pathtracing_spectrum_tpu.parallel.tiling import SppAllreduce, TileSharding
from pathtracing_spectrum_tpu.render import RenderSession

from scene_helpers import cornell_scene

import jax.numpy as jnp


@pytest.fixture(scope="module")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


def test_tile_sharding_matches_single_chip(eight_devices):
    sc = cornell_scene(depth=2, res=(16, 12))
    scene = sc.compile()
    w, h = sc.resolution
    ro, rd = camera_rays(sc.camera(), w, h)
    key = jax.random.key(5)

    # single chip
    n = w * h
    total = jnp.zeros((n, 4), jnp.float32)
    samples = jnp.zeros((), jnp.int32)
    t1, s1, out1, _ = render_sample(scene, ro, rd, total, samples, key,
                                    max_depth=2, backend="dense")

    # 8-way tile sharding
    ts = TileSharding(make_mesh(eight_devices))
    ro_s, rd_s = ts.shard_rays(ro, rd)
    total_s = ts.zeros_accumulator(n, 4)
    t2, s2, out2, _ = ts.render_sample(scene, ro_s, rd_s, total_s, samples,
                                       key, max_depth=2, backend="dense")
    np.testing.assert_allclose(np.asarray(out1), ts.gather(out2),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_tile_shard_map_kernel_bitexact(eight_devices):
    """The dense Pallas kernel backend under a device mesh:
    tile_shard_trace runs the kernel per-shard inside shard_map (XLA
    cannot partition a custom call — the plain pjit path replicates it
    behind all-gathers) and, with shared variates and no device key
    fold, is BIT-identical to the unsharded render."""
    from pathtracing_spectrum_tpu.engine import trace_radiance
    from pathtracing_spectrum_tpu.parallel.tiling import tile_shard_trace
    from jax.sharding import NamedSharding, PartitionSpec as P

    sc = cornell_scene(depth=2, res=(16, 8))
    scene = sc.compile()
    w, h = sc.resolution
    ro, rd = camera_rays(sc.camera(), w, h)
    key = jax.random.key(5)
    n = w * h
    mesh = make_mesh(eight_devices)

    R = jax.random.uniform(jax.random.key(11), (4, 4, n))
    ref = trace_radiance(scene, ro, rd, key, 2, backend="dense_pallas",
                         rand_override=R, interpret=True)
    ts = TileSharding(mesh)
    ro_s, rd_s = ts.shard_rays(ro, rd)
    R_s = jax.device_put(R, NamedSharding(mesh, P(None, None, "tiles")))
    rad, nrays = tile_shard_trace(mesh, scene, ro_s, rd_s, key, 2,
                                  backend="dense_pallas", rand_override=R_s,
                                  fold_device=False, interpret=True)
    np.testing.assert_array_equal(np.asarray(ref.radiance),
                                  np.asarray(rad))
    assert int(nrays) == int(ref.rays_traced)


@pytest.mark.slow
def test_tile_shard_map_kernel_no_allgather(eight_devices):
    """The production batched tile path for Pallas backends compiles with
    ZERO all-gathers (each device sweeps only its tile) and renders a
    finite image with the engine.render_samples key schedule."""
    import re
    from pathtracing_spectrum_tpu.parallel.tiling import (
        _tile_shard_map_samples)

    sc = cornell_scene(depth=2, res=(16, 8))
    scene = sc.compile()
    w, h = sc.resolution
    ro, rd = camera_rays(sc.camera(), w, h)
    n = w * h
    mesh = make_mesh(eight_devices)
    ts = TileSharding(mesh)
    ro_s, rd_s = ts.shard_rays(ro, rd)
    total = ts.zeros_accumulator(n, 4)
    samples = jnp.zeros((), jnp.int32)
    key = jax.random.key(3)

    lowered = _tile_shard_map_samples.lower(
        mesh, scene, ro_s, rd_s, total, samples, key, 0,
        n_steps=2, max_depth=2, backend="dense_pallas", interpret=True)
    hlo = lowered.compile().as_text()
    assert len(re.findall(r"all-gather", hlo)) == 0

    t2, s2, out, nrays = _tile_shard_map_samples(
        mesh, scene, ro_s, rd_s, total, samples, key, 0, n_steps=2,
        max_depth=2, backend="dense_pallas", interpret=True)
    g = ts.gather(out)
    assert int(s2) == 2 and np.isfinite(g).all() and g.mean() > 0
    assert int(nrays) > 0


@pytest.mark.slow
def test_spp_allreduce_step(eight_devices):
    sc = cornell_scene(depth=2, res=(8, 8))
    scene = sc.compile()
    w, h = sc.resolution
    ro, rd = camera_rays(sc.camera(), w, h)
    key = jax.random.key(5)
    n = w * h

    sa = SppAllreduce(make_mesh(eight_devices))
    ro_s, rd_s = sa.shard_rays(ro, rd)
    total = sa.zeros_accumulator(n, 4)
    samples = jnp.zeros((), jnp.int32)
    t, s, out, nrays = sa.render_sample(scene, ro_s, rd_s, total, samples,
                                        key, max_depth=2, backend="dense")
    assert int(s) == 8  # one step = n_devices samples

    # equals the mean over the 8 per-device streams computed single-chip
    acc = np.zeros((n, 4), np.float32)
    from pathtracing_spectrum_tpu.engine import trace_radiance
    for dev in range(8):
        k = jax.random.fold_in(key, dev)
        acc += np.asarray(trace_radiance(scene, ro, rd, k, 2,
                                         backend="dense").radiance)
    np.testing.assert_allclose(np.asarray(out), acc / 8.0,
                               rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_spp_allreduce_batched(eight_devices):
    """Batched spp-allreduce: one dispatch = n_steps * n_devices samples,
    matching the per-device single-chip streams."""
    sc = cornell_scene(depth=2, res=(8, 8))
    scene = sc.compile()
    w, h = sc.resolution
    ro, rd = camera_rays(sc.camera(), w, h)
    key = jax.random.key(9)
    n = w * h

    sa = SppAllreduce(make_mesh(eight_devices))
    ro_s, rd_s = sa.shard_rays(ro, rd)
    total = sa.zeros_accumulator(n, 4)
    samples = jnp.zeros((), jnp.int32)
    t, s, out, nrays = sa.render_samples(scene, ro_s, rd_s, total, samples,
                                         key, 0, n_steps=3, max_depth=2,
                                         backend="dense")
    assert int(s) == 24  # 3 steps x 8 devices

    from pathtracing_spectrum_tpu.engine import trace_radiance
    acc = np.zeros((n, 4), np.float32)
    for i in range(3):
        for dev in range(8):
            k = jax.random.fold_in(jax.random.fold_in(key, i), dev)
            acc += np.asarray(trace_radiance(scene, ro, rd, k, 2,
                                             backend="dense").radiance)
    np.testing.assert_allclose(np.asarray(out), acc / 24.0,
                               rtol=1e-4, atol=1e-6)


@pytest.mark.slow
def test_session_with_tile_sharding(eight_devices):
    sc = cornell_scene(depth=2, res=(8, 8))
    base = RenderSession(sc, backend="dense", seed=1).run(target_spp=2)
    sess = RenderSession(sc, backend="dense", seed=1,
                         sharding=TileSharding(make_mesh(eight_devices)))
    sharded = sess.run(target_spp=2)
    np.testing.assert_allclose(base, sharded, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("strategy", ["tiles", "spp"])
def test_sharded_session_compiles_once(eight_devices, strategy):
    """A sharded session's later steps reuse the first step's program:
    its sample counter starts on the mesh, where each step leaves it."""
    from pathtracing_spectrum_tpu import engine
    from pathtracing_spectrum_tpu.parallel import tiling

    mesh = make_mesh(eight_devices[:4])
    sharding = (TileSharding(mesh) if strategy == "tiles"
                else SppAllreduce(mesh))
    fn = (engine.render_samples if strategy == "tiles"
          else tiling._spp_allreduce_steps)
    sess = RenderSession(cornell_scene(depth=1, res=(8, 8)), backend="dense",
                         sharding=sharding)
    sess.step(1, readback=False)
    compiled = fn._cache_size()
    sess.step(1, readback=False)
    sess.step(1, readback=False)
    assert fn._cache_size() == compiled


@pytest.mark.slow
def test_tile_sharding_batched_jitter_matches_unsharded(eight_devices):
    """Batched jitter under TileSharding (px/py shard with the rays) must
    reproduce the unsharded jitter image bit-for-bit: the same JitterCam
    draws, partitioned over pixels with no collectives."""
    sc = cornell_scene(depth=2, res=(16, 16))
    a = RenderSession(sc, backend="dense", jitter=True, seed=6)
    img_a = a.run(target_spp=3)

    sc2 = cornell_scene(depth=2, res=(16, 16))
    mesh = make_mesh(eight_devices)
    b = RenderSession(sc2, backend="dense", jitter=True, seed=6,
                      sharding=TileSharding(mesh))
    img_b = b.run(target_spp=3)
    np.testing.assert_array_equal(img_a, img_b)


def test_tile_sharding_chunked_exact_vs_manual_folds(eight_devices):
    """chunks x tiles composition (BASELINE config 5's full story):
    TileSharding.render_samples(chunks=C) must equal an independent
    replay of its documented key schedule — per (sample i, device dev,
    chunk c): fold_in(fold_in(fold_in(key, counter0+i), dev), 0xC40000+c)
    traced over that device's chunk slice."""
    from pathtracing_spectrum_tpu.engine import trace_radiance

    sc = cornell_scene(depth=2, res=(32, 8))
    scene = sc.compile()
    w, h = sc.resolution
    n = w * h                       # 256 rays -> 32/device -> 2 chunks of 16
    ro, rd = camera_rays(sc.camera(), w, h)
    key = jax.random.key(13)
    chunks, n_steps = 2, 2

    ts = TileSharding(make_mesh(eight_devices))
    ro_s, rd_s = ts.shard_rays(ro, rd)
    total_s = ts.zeros_accumulator(n, 4)
    tot, samples, out, nrays = ts.render_samples(
        scene, ro_s, rd_s, total_s, jnp.zeros((), jnp.int32), key, 0,
        n_steps=n_steps, max_depth=2, backend="dense", chunks=chunks)
    got = ts.gather(tot)

    nloc = n // 8
    nc = nloc // chunks
    want = np.zeros((n, 4), np.float32)
    for i in range(n_steps):
        for dev in range(8):
            kd = jax.random.fold_in(jax.random.fold_in(key, i), dev)
            for c in range(chunks):
                kc = jax.random.fold_in(kd, 0xC40000 + c)
                s = slice(dev * nloc + c * nc, dev * nloc + (c + 1) * nc)
                want[s] += np.asarray(trace_radiance(
                    scene, ro[s], rd[s], kc, 2, backend="dense").radiance)
    assert int(samples) == n_steps
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_session_chunked_with_tile_sharding(eight_devices):
    """RenderSession(chunks, sharding=TileSharding) end-to-end: runs,
    deterministic (same seed twice -> identical image), and rejects
    SppAllreduce composition."""
    mesh = make_mesh(eight_devices)

    def build():
        sc = cornell_scene(depth=2, res=(32, 8))
        return RenderSession(sc, sharding=TileSharding(mesh), seed=3,
                             chunks=2)

    a = build().run(target_spp=2)
    b = build().run(target_spp=2)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.mean() > 0

    with pytest.raises(ValueError, match="chunks"):
        RenderSession(cornell_scene(depth=2, res=(32, 8)),
                      sharding=SppAllreduce(mesh), chunks=2)
