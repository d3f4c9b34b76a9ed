"""The dense closest-hit Pallas kernel (Triton route) in interpret mode, the
backend resolution around it, the attribute fetch and the precision of
every f32 contraction on the render path."""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pathtracing_spectrum_tpu import engine

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from pathtracing_spectrum_tpu.ops.intersect import (
    intersect_bruteforce, precompute_intersect_tables)
from pathtracing_spectrum_tpu.ops.intersect_pallas import (
    intersect_dense_pallas_soa, pack_tri16)


def _triangles(n_tris, rng, dup=True):
    """Random triangles in a box; with ``dup`` the last few repeat the
    first ones (exact ties: the lowest index must win)."""
    v1 = rng.uniform(-2, 2, (n_tris, 3))
    e1 = rng.uniform(-1, 1, (n_tris, 3))
    e2 = rng.uniform(-1, 1, (n_tris, 3))
    if dup and n_tris >= 8:
        k = n_tris // 8
        v1[-k:], e1[-k:], e2[-k:] = v1[:k], e1[:k], e2[:k]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    k1, k2, k3, consts = precompute_intersect_tables(v1, e1, e2, n)
    return (v1, e1, e2, n.astype(np.float32), k1, k2, k3, consts)


def _rays(n_rays, tris, rng):
    """Rays aimed at triangle interiors (hits), random rays (mostly
    misses), and rays parallel to a triangle's plane (denom == 0)."""
    v1, e1, e2, n = tris[:4]
    ro = rng.uniform(-6, 6, (n_rays, 3))
    rd = rng.normal(size=(n_rays, 3))
    if v1.shape[0]:
        pick = rng.integers(0, v1.shape[0], n_rays)
        a, b = rng.uniform(0, 0.5, (2, n_rays, 1))
        target = v1[pick] + a * e1[pick] + b * e2[pick]
        aim = np.arange(n_rays) % 3 == 0
        rd[aim] = (target - ro)[aim]
        par = np.arange(n_rays) % 3 == 1
        # direction inside the picked triangle's plane: never hits it
        rd[par] = np.cross(n[pick], rng.normal(size=(n_rays, 3)))[par]
    rd /= np.maximum(np.linalg.norm(rd, axis=1, keepdims=True), 1e-12)
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.mark.parametrize("n_tris,n_rays", [(0, 200), (1, 200), (36, 300),
                                           (700, 333)])
def test_kernel_matches_bruteforce(n_tris, n_rays):
    rng = np.random.default_rng(n_tris)
    tris = _triangles(n_tris, rng)
    ro, rd = _rays(n_rays, tris, rng)
    n, k1, k2, k3, consts = (jnp.asarray(a) for a in tris[3:])
    ref = intersect_bruteforce(jnp.asarray(ro), jnp.asarray(rd), n, k1, k2,
                               k3, consts)
    tri16 = pack_tri16(n, k1, k2, k3, consts)
    got = intersect_dense_pallas_soa(
        *(jnp.asarray(ro[:, k]) for k in range(3)),
        *(jnp.asarray(rd[:, k]) for k in range(3)), tri16, interpret=True)
    hit0, t0, i0, s20, s30 = (np.asarray(a) for a in ref)
    hit1, t1, i1, s21, s31 = (np.asarray(a) for a in got)
    assert n_rays % 128 != 0
    if n_tris:
        assert hit0.sum() > n_rays // 10       # the aimed rays do hit
    np.testing.assert_array_equal(hit1, hit0)
    np.testing.assert_array_equal(i1, i0)
    # Same formula, same order; but XLA's CPU compiler fuses the
    # interpreted kernel body (scalar triangle, [block] rays) differently
    # from the [N, C] sweep, which can move the last bit of a result. On
    # the card the two agree bit for bit (PERF.md).
    np.testing.assert_allclose(t1, t0, rtol=1e-6, atol=0)
    np.testing.assert_allclose(s21, s20, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s31, s30, rtol=1e-5, atol=1e-5)


def test_kernel_ties_go_to_lowest_index():
    rng = np.random.default_rng(3)
    tris = _triangles(16, rng, dup=True)          # rows 14, 15 == rows 0, 1
    v1, e1, e2 = tris[:3]
    target = v1[:2] + 0.25 * e1[:2] + 0.25 * e2[:2]
    ro = (target - 3.0 * tris[3][:2]).astype(np.float32)
    rd = tris[3][:2].astype(np.float32)
    tri16 = pack_tri16(*(jnp.asarray(a) for a in tris[3:]))
    hit, t, idx, _, _ = intersect_dense_pallas_soa(
        *(jnp.asarray(ro[:, k]) for k in range(3)),
        *(jnp.asarray(rd[:, k]) for k in range(3)), tri16, interpret=True)
    assert np.asarray(hit).all()
    # the duplicates at 14/15 tie exactly and lose; another triangle may
    # be nearer, but never the later copy
    assert not np.isin(np.asarray(idx), [14, 15]).any()


@pytest.mark.parametrize("block", [32, 64, 256])
def test_kernel_block_size_does_not_change_results(block):
    """Rays per program (and the padding of the last program) change
    nothing but the grid."""
    rng = np.random.default_rng(5)
    tris = _triangles(90, rng)
    ro, rd = _rays(150, tris, rng)
    tri16 = pack_tri16(*(jnp.asarray(a) for a in tris[3:]))
    comps = [jnp.asarray(ro[:, k]) for k in range(3)] + [
        jnp.asarray(rd[:, k]) for k in range(3)]
    a = intersect_dense_pallas_soa(*comps, tri16, interpret=True)
    b = intersect_dense_pallas_soa(*comps, tri16, block=block,
                                   interpret=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_kernel_inside_shard_map_8_devices():
    """A Pallas call is a custom call the SPMD partitioner cannot split:
    under shard_map each device runs the kernel on its own ray tile, and
    the result equals the unsharded call."""
    from jax.sharding import PartitionSpec as P
    from pathtracing_spectrum_tpu.parallel.mesh import TILE_AXIS, make_mesh

    devs = jax.devices()
    assert len(devs) == 8
    rng = np.random.default_rng(8)
    tris = _triangles(36, rng)
    ro, rd = _rays(8 * 40, tris, rng)
    tri16 = pack_tri16(*(jnp.asarray(a) for a in tris[3:]))
    comps = [jnp.asarray(ro[:, k]) for k in range(3)] + [
        jnp.asarray(rd[:, k]) for k in range(3)]
    mesh = make_mesh(devs)
    sharded = jax.shard_map(
        lambda *c: intersect_dense_pallas_soa(*c[:6], c[6], interpret=True),
        mesh=mesh, in_specs=(P(TILE_AXIS),) * 6 + (P(),),
        out_specs=(P(TILE_AXIS),) * 5, check_vma=False)
    got = sharded(*comps, tri16)
    ref = intersect_dense_pallas_soa(*comps, tri16, interpret=True)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------- backends

@pytest.mark.parametrize("platform,n_tris,want", [
    ("cpu", 36, "dense"), ("gpu", 36, "dense_pallas"),
    ("cpu", 100000, "bvh"), ("gpu", 100000, "bvh")])
def test_resolve_backend_auto(monkeypatch, platform, n_tris, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert engine.device_platform() == platform
    assert engine.resolve_backend("auto", n_tris) == want


def test_resolve_backend_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="metal"):
        engine.resolve_backend("auto", 36)


def test_kernel_backend_on_cpu_needs_interpret():
    assert engine.device_platform() == "cpu"
    with pytest.raises(ValueError, match="interpret"):
        engine.resolve_backend("dense_pallas", 36)
    assert engine.resolve_backend("dense_pallas", 36,
                                  interpret=True) == "dense_pallas"
    with pytest.raises(ValueError, match="unknown backend"):
        engine.resolve_backend("shortlist", 36)


def test_device_platform_follows_default_device():
    with jax.default_device(jax.devices("cpu")[0]):
        assert engine.device_platform() == "cpu"
    with jax.default_device("cpu"):
        assert engine.device_platform() == "cpu"


# ------------------------------------------------------------------- fetch

def test_fetch_gather_matches_onehot_bits():
    """The row gather selects exactly the bits a one-hot product at
    HIGHEST precision selects (one nonzero term per output)."""
    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.normal(size=(37, 21)).astype(np.float32)
                        * np.float32(1e3))
    idx = jnp.asarray(rng.integers(0, 37, 500).astype(np.int32))
    gathered = engine._fetch_attrs_t(idx, table)
    onehot = (jnp.arange(37)[:, None] == idx[None, :]).astype(jnp.float32)
    product = jnp.dot(table.T, onehot, precision=jax.lax.Precision.HIGHEST)
    assert gathered.shape == (21, 500)
    np.testing.assert_array_equal(np.asarray(gathered), np.asarray(product))


# --------------------------------------------------------------- precision

def _f32_dots_below_highest(jaxpr):
    """dot_general eqns with f32 operands whose precision is not HIGHEST,
    anywhere in ``jaxpr`` and its sub-jaxprs."""
    hi = jax.lax.Precision.HIGHEST
    bad = []

    def subs(v):
        if isinstance(v, jax.extend.core.ClosedJaxpr):
            yield v.jaxpr
        elif isinstance(v, jax.extend.core.Jaxpr):
            yield v
        elif isinstance(v, (tuple, list)):
            for x in v:
                yield from subs(x)

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general" and any(
                    v.aval.dtype == jnp.float32 for v in eqn.invars):
                p = eqn.params.get("precision")
                if not (p == hi or (isinstance(p, tuple)
                                    and all(q == hi for q in p))):
                    bad.append(eqn)
            for v in eqn.params.values():
                for s in subs(v):
                    walk(s)

    walk(jaxpr.jaxpr)
    return bad


def _render_jaxpr(dispersion, nw=4):
    import bench_suite
    from pathtracing_spectrum_tpu import camera_rays

    sc = bench_suite.cornell_scene_nw((8, 8), 2, nw)
    scene = sc.compile()
    ro, rd = camera_rays(sc.camera(), 8, 8)
    total = jnp.zeros((64, nw), jnp.float32)
    return jax.make_jaxpr(
        lambda s, o, d, t: engine.render_samples(
            s, o, d, t, jnp.zeros((), jnp.int32), jax.random.key(0), 0,
            n_steps=2, max_depth=2, dispersion=dispersion))(
        scene, ro, rd, total)


@pytest.mark.parametrize("dispersion,nw", [(False, 4), ("hero", 4),
                                           ("hero", 160)])
def test_render_path_f32_dots_are_highest(dispersion, nw):
    assert _f32_dots_below_highest(_render_jaxpr(dispersion, nw)) == []


def test_precision_walker_sees_the_srgb_epilogue():
    """The walker finds the viewer's pinned contractions, and flags a
    default-precision one (so an empty result above means something)."""
    from pathtracing_spectrum_tpu.viewer import spectral_to_srgb_device

    img = jnp.ones((4, 4, 3), jnp.float32)
    jx = jax.make_jaxpr(lambda x: spectral_to_srgb_device(
        x, [1e7 / 450, 1e7 / 550, 1e7 / 650]))(img)
    n_dots = sum(e.primitive.name == "dot_general" for e in jx.jaxpr.eqns)
    assert n_dots == 2
    assert _f32_dots_below_highest(jx) == []
    loose = jax.make_jaxpr(lambda x: x @ x.T)(jnp.ones((3, 3), jnp.float32))
    assert len(_f32_dots_below_highest(loose)) == 1
