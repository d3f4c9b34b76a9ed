"""Tests that need the GPU: the dense kernel compiled for the card.

They skip elsewhere (the ``gpu`` fixture decides when the test runs);
``chip_smoke.py`` runs them on the card with ``-m gpu``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pathtracing_spectrum_tpu import engine
from pathtracing_spectrum_tpu.ops.intersect import intersect_bruteforce
from pathtracing_spectrum_tpu.ops.intersect_pallas import (
    intersect_dense_pallas_soa, pack_tri16)

from test_dense_kernel import _rays, _triangles


@pytest.mark.gpu
@pytest.mark.parametrize("n_tris,n_rays", [(1, 200), (36, 3000),
                                           (700, 5001)])
def test_compiled_kernel_matches_bruteforce(gpu, n_tris, n_rays):
    rng = np.random.default_rng(n_tris)
    tris = _triangles(n_tris, rng)
    ro, rd = _rays(n_rays, tris, rng)
    cols = [jnp.asarray(a) for a in tris[3:]]
    with jax.default_device(gpu):
        ref = intersect_bruteforce(jnp.asarray(ro), jnp.asarray(rd), *cols)
        got = intersect_dense_pallas_soa(
            *(jnp.asarray(ro[:, k]) for k in range(3)),
            *(jnp.asarray(rd[:, k]) for k in range(3)), pack_tri16(*cols))
    hit0, t0, i0 = (np.asarray(a) for a in ref[:3])
    hit1, t1, i1 = (np.asarray(a) for a in got[:3])
    # a grazing edge may flip under a different FMA contraction
    # (chip_smoke.AGREE_MIN); these random rays never graze that closely
    np.testing.assert_array_equal(hit1, hit0)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(t1, t0, rtol=1e-5)


@pytest.mark.gpu
def test_auto_resolves_to_kernel_on_gpu(gpu):
    with jax.default_device(gpu):
        assert engine.device_platform() == "gpu"
        assert engine.resolve_backend("auto", 36) == "dense_pallas"
        assert engine.resolve_backend("auto", 100000) == "bvh"


@pytest.mark.gpu
def test_render_kernel_matches_jnp_sweep(gpu):
    from scene_helpers import cornell_scene
    from pathtracing_spectrum_tpu.render import RenderSession

    imgs = {}
    with jax.default_device(gpu):
        for backend in ("dense_pallas", "dense"):
            s = RenderSession(cornell_scene(res=(64, 64)), backend=backend)
            imgs[backend] = s.run(target_spp=4)
    a, b = imgs["dense_pallas"], imgs["dense"]
    rel = np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2))
    assert np.isfinite(a).all() and rel < 1e-3
