"""Pixel-tile sharding and spp-allreduce across a device mesh.

Two complementary multi-chip strategies (SURVEY §2.3, BASELINE config 5):

* ``TileSharding`` — the image's flat pixel axis is sharded across chips;
  every device traces its own tile and accumulates locally. Zero
  inter-device traffic during rendering; one all-gather at framebuffer
  readback (jax performs it when the sharded array is fetched). This is
  the scaling path for large resolutions (4K tiled render).

* ``SppAllreduce`` — every device renders the FULL image with a
  device-distinct RNG stream; per-sample radiance is ``psum``'d inside
  ``shard_map`` so one step adds ``n_devices`` samples. This is the
  scaling path for convergence (high spp at modest resolution).

Both paths run the identical single-device engine inside the sharded
region — the same code executes on a CPU test mesh and on GPUs.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..engine import (KERNEL_BACKENDS, resolve_backend, trace_radiance,
                      render_sample as _render_sample_1chip)
from .mesh import TILE_AXIS, make_mesh, replicated, tile_sharded


def _needs_shard_map(backend: str, n_tris: int) -> bool:
    """Backends whose intersection runs as a Pallas kernel (a custom
    call). XLA's SPMD partitioner cannot split a custom call: under plain
    jit-with-sharded-inputs it REPLICATES the kernel — the compiled module
    all-gathers the sharded rays and every device sweeps the full image.
    Those backends route through shard_map instead, where each device's
    tile is a plain local array and the kernel runs per-shard with zero
    collectives."""
    return resolve_backend(backend, n_tris) in KERNEL_BACKENDS


def per_device_rays(mesh, scene_data, ro, rd, key, max_depth,
                    backend="auto"):
    """[n_devices] rays traced by each device for one tile-sharded
    sample — the observable that the tiles strategy actually divides
    the work (each device's count ≈ total / n_devices for a full-frame
    wavefront; recorded in the multichip bench entries)."""
    def device_fn(scene, o, d, k):
        k = jax.random.fold_in(k, jax.lax.axis_index(TILE_AXIS))
        res = trace_radiance(scene, o, d, k, max_depth, backend)
        return res.rays_traced[None]

    rep_scene = jax.tree.map(lambda _: P(), scene_data)
    counts = shard_map(
        device_fn, mesh=mesh,
        in_specs=(rep_scene, P(TILE_AXIS), P(TILE_AXIS), P()),
        out_specs=P(TILE_AXIS),
        check_vma=False,
    )(scene_data, ro, rd, key)
    return np.asarray(counts)


def tile_shard_trace(mesh, scene_data, ro, rd, key, max_depth,
                     backend="auto", rand_override=None, dispersion=False,
                     fold_device=True, interpret=False):
    """``trace_radiance`` inside ``shard_map`` over the pixel axis.

    Each device traces its local ray tile as a plain array, so Pallas
    kernels execute per-shard (no all-gathers — see _needs_shard_map).
    With ``fold_device`` each device folds its mesh index into the key
    (distinct variate streams per tile); with ``fold_device=False`` and a
    sharded ``rand_override`` the computation is bit-identical to the
    unsharded ``trace_radiance`` on the gathered rays (per-pixel math is
    pixel-local and the kernels are ray-order/batch-width independent —
    pinned by tests/test_sharding.py::test_tile_shard_map_kernel_bitexact).

    Returns (radiance [N_local stacked as sharded N, nw], rays_traced psum).
    """
    def device_fn(scene, o, d, k, rand_o):
        if fold_device:
            k = jax.random.fold_in(k, jax.lax.axis_index(TILE_AXIS))
        res = trace_radiance(scene, o, d, k, max_depth, backend,
                             rand_override=rand_o, dispersion=dispersion,
                             interpret=interpret)
        return res.radiance, jax.lax.psum(res.rays_traced, TILE_AXIS)

    rep_scene = jax.tree.map(lambda _: P(), scene_data)
    rand_spec = P(None, None, TILE_AXIS) if rand_override is not None else P()
    return shard_map(
        device_fn, mesh=mesh,
        in_specs=(rep_scene, P(TILE_AXIS), P(TILE_AXIS), P(), rand_spec),
        out_specs=(P(TILE_AXIS), P()),
        check_vma=False,
    )(scene_data, ro, rd, key, rand_override)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "n_steps", "max_depth",
                                    "backend", "dispersion", "chunks",
                                    "interpret"),
                   donate_argnums=(4,))
def _tile_shard_map_samples(mesh, scene_data, ro, rd, total, samples,
                            base_key, counter0, n_steps, max_depth,
                            backend, dispersion=False, jitter_cam=None,
                            chunks=1, interpret=False):
    """Batched tile-sharded sampling with the engine INSIDE shard_map.

    Sample ``i`` on device ``dev`` keys its variates with
    ``fold_in(fold_in(base_key, counter0 + i), dev)`` — the per-sample
    schedule matches engine.render_samples (exact checkpoint resume on
    the same mesh); the device fold keeps tiles' variate streams
    disjoint (without it every tile would draw identical local variate
    planes). Not bit-identical to a single-chip render — documented
    per-mesh determinism, like SppAllreduce.

    ``chunks > 1`` composes the bounded-width wavefront with the tile
    sharding (BASELINE config 5's full story: per-device tiles, each
    traced as sequential sub-wavefronts): each device maps its LOCAL
    tile through ``chunks`` trace_radiance calls per sample, chunk ``c``
    drawing from ``fold_in(sample_dev_key, 0xC40000 + c)`` — the same
    chunk fold as engine.render_samples, applied after the device fold.
    Requires the local tile width to divide ``chunks``; excludes jitter
    (as in the engine path).
    """
    def device_fn(scene, o, d, tot, k0, c0, jc):
        dev = jax.lax.axis_index(TILE_AXIS)

        def body(i, carry):
            tot, rays = carry
            k = jax.random.fold_in(
                jax.random.fold_in(k0, c0 + i), dev)
            if jc is not None:
                from ..models.camera import jittered_dirs
                ck = jax.random.fold_in(k, 0xC0FFEE)
                kx, ky = jax.random.split(ck)
                nloc = jc.px.shape[0]
                d_i = jittered_dirs(jc, jax.random.uniform(kx, (nloc,)),
                                    jax.random.uniform(ky, (nloc,)))
            else:
                d_i = d
            if chunks > 1:
                nc = o.shape[0] // chunks
                cidx = jnp.arange(chunks, dtype=jnp.int32)

                def chunk_fn(args):
                    c, oc, dc = args
                    kc = jax.random.fold_in(k, 0xC40000 + c)
                    res = trace_radiance(scene, oc, dc, kc, max_depth,
                                         backend, dispersion=dispersion,
                                         interpret=interpret)
                    return res.radiance, res.rays_traced

                rad_c, rays_c = jax.lax.map(
                    chunk_fn, (cidx, o.reshape(chunks, nc, 3),
                               d_i.reshape(chunks, nc, 3)))
                return (tot + rad_c.reshape(tot.shape),
                        rays + jnp.sum(rays_c))
            res = trace_radiance(scene, o, d_i, k, max_depth, backend,
                                 dispersion=dispersion, interpret=interpret)
            return tot + res.radiance, rays + res.rays_traced

        tot, rays = jax.lax.fori_loop(
            0, n_steps, body, (tot, jnp.zeros((), jnp.int32)))
        return tot, jax.lax.psum(rays, TILE_AXIS)

    rep_scene = jax.tree.map(lambda _: P(), scene_data)
    if jitter_cam is not None:
        jc_spec = jitter_cam._replace(
            px=P(TILE_AXIS), py=P(TILE_AXIS), pos=P(), top_left=P(),
            right=P(), up=P())
    else:
        jc_spec = P()
    total, nrays = shard_map(
        device_fn, mesh=mesh,
        in_specs=(rep_scene, P(TILE_AXIS), P(TILE_AXIS), P(TILE_AXIS),
                  P(), P(), jc_spec),
        out_specs=(P(TILE_AXIS), P()),
        check_vma=False,
    )(scene_data, ro, rd, total, base_key, counter0, jitter_cam)
    samples = samples + n_steps
    out = total / samples.astype(jnp.float32)
    return total, samples, out, nrays


class TileSharding:
    """Shard the flat pixel axis over a 1-D mesh."""

    supports_jitter_cam = True  # batched jitter: px/py shard like rays
    supports_chunks = True      # chunks x tiles compose (render_samples)

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_devices = self.mesh.size
        self._true_n = None

    def shard_jitter_cam(self, jc):
        """Pixel-coordinate planes shard with the rays; the camera scalars
        replicate. Padding slots ray through pixel (0,0) — their results
        land in padded accumulator rows that gather() discards."""
        sh = tile_sharded(self.mesh)
        rep = replicated(self.mesh)
        return jc._replace(
            px=jax.device_put(self._pad(jc.px), sh),
            py=jax.device_put(self._pad(jc.py), sh),
            pos=jax.device_put(jc.pos, rep),
            top_left=jax.device_put(jc.top_left, rep),
            right=jax.device_put(jc.right, rep),
            up=jax.device_put(jc.up, rep))

    def _pad(self, a):
        n = a.shape[0]
        pad = (-n) % self.n_devices
        if pad:
            a = jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
        return a

    def shard_rays(self, ro, rd):
        self._true_n = ro.shape[0]
        sh = tile_sharded(self.mesh)
        return (jax.device_put(self._pad(ro), sh),
                jax.device_put(self._pad(rd), sh))

    def shard_scene(self, scene_data):
        return jax.device_put(scene_data, replicated(self.mesh))

    def zeros_accumulator(self, n, nw):
        pad_n = n + ((-n) % self.n_devices)
        return jax.device_put(jnp.zeros((pad_n, nw), jnp.float32),
                              tile_sharded(self.mesh))

    def shard_accumulator(self, total):
        return jax.device_put(self._pad(total), tile_sharded(self.mesh))

    def render_sample(self, scene_data, ro, rd, total, samples, key,
                      max_depth, backend="auto", dispersion=False):
        """Same signature as engine.render_sample; inputs already sharded.

        Pure-XLA backends (dense/bvh): jit + input shardings partition the
        pixel work with no collectives (bit-identical to single-chip).
        Pallas backends route through shard_map (see _needs_shard_map —
        XLA would otherwise replicate the kernel), with a per-device key
        fold: per-mesh deterministic, like SppAllreduce.
        """
        scene_data = self.shard_scene(scene_data)
        if _needs_shard_map(backend, scene_data.tri_shade.shape[0]):
            total2, samples2, out, nrays = _tile_shard_map_samples(
                self.mesh, scene_data, ro, rd, total, samples, key, 0,
                n_steps=1, max_depth=max_depth, backend=backend,
                dispersion=dispersion)
            return total2, samples2, out, nrays
        return _render_sample_1chip(scene_data, ro, rd, total, samples, key,
                                    max_depth=max_depth, backend=backend,
                                    dispersion=dispersion)

    def render_samples(self, scene_data, ro, rd, total, samples, base_key,
                       counter0, n_steps, max_depth, backend="auto",
                       dispersion=False, jitter_cam=None, chunks=1):
        """Batched multi-sample step (one dispatch), sharded over pixels.

        Backend routing as in :meth:`render_sample`: Pallas backends run
        inside shard_map so the kernels execute per-tile. ``chunks > 1``
        traces each device's local tile as sequential sub-wavefronts
        (see _tile_shard_map_samples); on the pure-XLA path the chunk
        fold happens per-device too, so both routes stay per-mesh
        deterministic.
        """
        from ..engine import render_samples as _render_samples_1chip
        scene_data = self.shard_scene(scene_data)
        if chunks > 1:
            if jitter_cam is not None:
                raise ValueError("chunks > 1 does not support jitter_cam")
            nloc = ro.shape[0] // self.n_devices
            if nloc % chunks:
                raise ValueError(
                    f"per-device tile width {nloc} must be divisible by "
                    f"chunks={chunks}")
        if _needs_shard_map(backend, scene_data.tri_shade.shape[0]):
            return _tile_shard_map_samples(
                self.mesh, scene_data, ro, rd, total, samples, base_key,
                counter0, n_steps=n_steps, max_depth=max_depth,
                backend=backend, dispersion=dispersion,
                jitter_cam=jitter_cam, chunks=chunks)
        if chunks > 1:
            # pure-XLA backends partition by input shardings alone; run
            # the same per-device chunked body through shard_map so the
            # chunk fold composes with the device fold identically
            return _tile_shard_map_samples(
                self.mesh, scene_data, ro, rd, total, samples, base_key,
                counter0, n_steps=n_steps, max_depth=max_depth,
                backend=backend, dispersion=dispersion,
                jitter_cam=None, chunks=chunks)
        return _render_samples_1chip(scene_data, ro, rd, total, samples,
                                     base_key, counter0, n_steps=n_steps,
                                     max_depth=max_depth, backend=backend,
                                     dispersion=dispersion,
                                     jitter_cam=jitter_cam)

    def gather(self, out):
        arr = np.asarray(out)
        if self._true_n is not None:
            arr = arr[:self._true_n]
        return arr


class SppAllreduce:
    """Each device renders the full image; radiance psum'd over the mesh."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_devices = self.mesh.size

    def shard_rays(self, ro, rd):
        sh = replicated(self.mesh)
        return jax.device_put(ro, sh), jax.device_put(rd, sh)

    def zeros_accumulator(self, n, nw):
        return jax.device_put(jnp.zeros((n, nw), jnp.float32),
                              replicated(self.mesh))

    def shard_accumulator(self, total):
        return jax.device_put(total, replicated(self.mesh))

    def gather(self, out):
        return np.asarray(out)

    def render_sample(self, scene_data, ro, rd, total, samples, key,
                      max_depth, backend="dense", dispersion=False):
        """One step = n_devices samples, combined with a psum."""
        scene_data = jax.device_put(scene_data, replicated(self.mesh))
        return _spp_allreduce_step(self.mesh, scene_data, ro, rd, total,
                                   samples, key, max_depth, backend,
                                   dispersion)

    def render_samples(self, scene_data, ro, rd, total, samples, base_key,
                       counter0, n_steps, max_depth, backend="auto",
                       dispersion=False):
        """Batched: ONE dispatch adds n_steps * n_devices samples.

        Device d's sample i uses ``fold_in(fold_in(base_key, counter0+i), d)``
        so streams stay disjoint across both axes and resume is exact.
        """
        scene_data = jax.device_put(scene_data, replicated(self.mesh))
        return _spp_allreduce_steps(self.mesh, scene_data, ro, rd, total,
                                    samples, base_key, counter0, n_steps,
                                    max_depth, backend, dispersion)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "max_depth", "backend",
                                    "dispersion"))
def _spp_allreduce_step(mesh, scene_data, ro, rd, total, samples, key,
                        max_depth, backend, dispersion=False):
    def device_fn(scene, o, d, k):
        dev = jax.lax.axis_index(TILE_AXIS)
        k = jax.random.fold_in(k, dev)
        res = trace_radiance(scene, o, d, k, max_depth, backend,
                             dispersion=dispersion)
        # spp-allreduce: sum the per-device samples over the mesh
        rad = jax.lax.psum(res.radiance, TILE_AXIS)
        nrays = jax.lax.psum(res.rays_traced, TILE_AXIS)
        return rad, nrays

    rep_scene = jax.tree.map(lambda _: P(), scene_data)
    rad, nrays = shard_map(
        device_fn, mesh=mesh,
        in_specs=(rep_scene, P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(scene_data, ro, rd, key)

    total = total + rad
    samples = samples + mesh.size
    out = total / samples.astype(jnp.float32)
    return total, samples, out, nrays


@functools.partial(jax.jit,
                   static_argnames=("mesh", "n_steps", "max_depth",
                                    "backend", "dispersion"),
                   donate_argnums=(4,))
def _spp_allreduce_steps(mesh, scene_data, ro, rd, total, samples, base_key,
                         counter0, n_steps, max_depth, backend,
                         dispersion=False):
    def device_fn(scene, o, d, k0, c0):
        dev = jax.lax.axis_index(TILE_AXIS)

        def body(i, carry):
            rad_acc, rays = carry
            k = jax.random.fold_in(jax.random.fold_in(k0, c0 + i), dev)
            res = trace_radiance(scene, o, d, k, max_depth, backend,
                                 dispersion=dispersion)
            return rad_acc + res.radiance, rays + res.rays_traced

        rad_acc, rays = jax.lax.fori_loop(
            0, n_steps, body,
            (jnp.zeros((o.shape[0], scene.sky.shape[0]), jnp.float32),
             jnp.zeros((), jnp.int32)))
        return (jax.lax.psum(rad_acc, TILE_AXIS),
                jax.lax.psum(rays, TILE_AXIS))

    rep_scene = jax.tree.map(lambda _: P(), scene_data)
    rad, nrays = shard_map(
        device_fn, mesh=mesh,
        in_specs=(rep_scene, P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )(scene_data, ro, rd, base_key, counter0)

    total = total + rad
    samples = samples + n_steps * mesh.size
    out = total / samples.astype(jnp.float32)
    return total, samples, out, nrays
