"""Progressive render session: the host-side state machine.

Replaces the reference's two-thread flag machine (``render/pause/stop/
restart/init`` globals at main.cpp:88-99 driving ``PathTracerLoop`` at
main.cpp:4003-4063, with unsynchronised shared state) with an explicit
single-owner controller:

* ``start()``   — (re)compiles the scene if dirty, resets accumulators when
  coming from STOPPED/IDLE (the reference re-syncs the whole scene and calls
  ``ResetImage`` on start/restart/stop, main.cpp:4010-4027);
* ``pause()``/``resume()`` — keep the accumulator (main.cpp:4034-4039);
* ``stop()``    — next start resets (pathtracer.cpp:547-556 lazy reset);
* ``restart()`` — immediate reset, keep rendering;
* ``step(n)``   — render n progressive samples (one sample = one
  ``RenderFrame`` call in the reference);
* ``run(target_spp)`` — render until the target and auto-pause
  (main.cpp:4057-4061; target range 0..65535, main.cpp:1662-1669);
* ``start_async()`` — optional background thread mirroring the reference's
  GUI-thread/tracer-thread split, but with proper events instead of races.

Observability (SURVEY §5): per-session stats — samples, elapsed wall-clock,
average seconds/sample, rays traced, Mrays/s — matching the reference's
status bar (main.cpp:2780-2810) plus throughput metrics it never recorded.

Checkpoint/resume (SURVEY §5): the reference loses the accumulator on exit;
``save_checkpoint``/``load_checkpoint`` persist (total, samples, RNG counter)
for exact resume.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .engine import render_sample, render_samples
from .models.camera import camera_rays, tile_order
from .scene import Scene, SceneData

MAX_TARGET_SPP = 65535  # reference GUI clamp (main.cpp:1662-1669)

# Bumped whenever the per-sample RNG key derivation changes; checkpoints
# from a different schedule would silently resume with a different random
# sequence, so load_checkpoint refuses them.
KEY_SCHEDULE_VERSION = 1


class RenderStatus(enum.Enum):
    IDLE = "idle"
    RENDERING = "rendering"
    PAUSED = "paused"
    STOPPED = "stopped"


class RenderSession:
    """Owns the progressive accumulator for one scene + camera."""

    def __init__(self, scene: Scene, backend: str = "auto",
                 jitter: bool = False, seed: int = 0, dispersion: bool = False,
                 resolution: Optional[tuple] = None,
                 sharding=None, tile_ordering: bool = True,
                 chunks: int = 1):
        if chunks > 1 and jitter:
            raise ValueError("chunks > 1 (bounded-width wavefront) "
                             "does not support jitter (yet)")
        if (chunks > 1 and sharding is not None
                and not getattr(sharding, "supports_chunks", False)):
            raise ValueError("chunks > 1 composes only with a sharding "
                             "that supports it (TileSharding does; "
                             "SppAllreduce renders full frames per device "
                             "and does not)")
        self.chunks = int(chunks)
        self.scene = scene
        self.jitter = jitter
        self.seed = seed
        self.dispersion = dispersion
        self._backend = backend
        self._resolution_override = resolution
        self._sharding = sharding  # optional parallel.TileSharding
        self._tile_ordering = tile_ordering
        self._perm = None
        self._inv_perm = None

        self.status = RenderStatus.IDLE
        self.target_spp: int = 0  # 0 = unbounded (reference semantics)

        self._scene_data: Optional[SceneData] = None
        self._dirty = True
        self._synced_version = -1
        self._total = None
        self._samples = None
        self._out = None
        self._ro = None
        self._rd = None
        self._key = jax.random.key(seed)
        self._sample_counter = 0  # fold_in counter for reproducible resume

        # stats
        self.elapsed = 0.0
        self._t_start = None
        self.rays_traced = 0
        self.last_sample_time = 0.0

        self._thread: Optional[threading.Thread] = None
        self._pause_evt = threading.Event()
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()

    # -- scene/camera sync ---------------------------------------------------
    def mark_dirty(self) -> None:
        """Scene or camera changed: re-sync on next start (the reference
        re-syncs unconditionally on every start/restart/stop edge)."""
        self._dirty = True

    @property
    def resolution(self):
        return self._resolution_override or self.scene.resolution

    @property
    def backend(self) -> str:
        """The backend string handed to the engine; 'auto' resolves there
        (platform- and size-aware, see engine.resolve_backend)."""
        return self._backend

    def resolved_backend(self) -> str:
        from .engine import resolve_backend
        n_tris = (self._scene_data.n_triangles
                  if self._scene_data is not None else 0)
        return resolve_backend(self._backend, n_tris)

    def _sync(self) -> None:
        self._synced_version = self.scene.version
        self._scene_data = self.scene.compile()
        w, h = self.resolution
        cam = self.scene.camera()
        self._ro, self._rd = camera_rays(cam, w, h)
        if self._tile_ordering:
            # compact 32x32 screen tiles per ray block, so the rays of one
            # kernel block are spatially coherent. Permute on the HOST: a
            # device-gather result would carry a gather layout into the
            # jit signature.
            self._perm, self._inv_perm = tile_order(w, h)
            self._ro = jnp.asarray(np.asarray(self._ro)[self._perm])
            self._rd = jnp.asarray(np.asarray(self._rd)[self._perm])
        self._jitter_cam = None
        if self.jitter:
            from .models.camera import jitter_cam_arrays
            self._jitter_cam = jitter_cam_arrays(cam, w, h, perm=self._perm)
        if self._sharding is not None:
            self._ro, self._rd = self._sharding.shard_rays(self._ro, self._rd)
            if self._jitter_cam is not None and hasattr(self._sharding,
                                                        "shard_jitter_cam"):
                self._jitter_cam = self._sharding.shard_jitter_cam(
                    self._jitter_cam)
        self._dirty = False
        self._reset_accumulator()

    def _place_samples(self, samples):
        """Under a sharding, the sample counter lives replicated on the
        mesh, where each step's output puts it; a single-device input
        would make the second step compile again."""
        if self._sharding is None:
            return samples
        from .parallel.mesh import replicated
        return jax.device_put(samples, replicated(self._sharding.mesh))

    def _reset_accumulator(self) -> None:
        w, h = self.resolution
        n = w * h
        nw = len(self.scene.wavelengths)
        if self._sharding is not None:
            self._total = self._sharding.zeros_accumulator(n, nw)
        else:
            self._total = jnp.zeros((n, nw), jnp.float32)
        self._samples = self._place_samples(jnp.zeros((), jnp.int32))
        self._out = self._total
        self._sample_counter = 0
        self.elapsed = 0.0
        self.rays_traced = 0

    # -- state machine --------------------------------------------------------
    def start(self) -> None:
        # the reference re-syncs the full scene on every start edge
        # (main.cpp:4010-4027); we re-sync when the scene graph has mutated
        if self.scene.version != self._synced_version:
            self._dirty = True
        if self.status == RenderStatus.PAUSED and not self._dirty:
            self.status = RenderStatus.RENDERING
            return
        if self._dirty or self.status in (RenderStatus.STOPPED,
                                          RenderStatus.IDLE):
            self._sync()
        self.status = RenderStatus.RENDERING

    def pause(self) -> None:
        if self.status == RenderStatus.RENDERING:
            self.status = RenderStatus.PAUSED

    def resume(self) -> None:
        if self.status == RenderStatus.PAUSED:
            self.status = RenderStatus.RENDERING

    def stop(self) -> None:
        self.status = RenderStatus.STOPPED
        self._stop_evt.set()

    def restart(self) -> None:
        if self._dirty:
            self._sync()
        else:
            self._reset_accumulator()
        self.status = RenderStatus.RENDERING

    # -- rendering -------------------------------------------------------------
    def step(self, n_samples: int = 1, readback: bool = True):
        """Render n progressive samples synchronously; returns the running
        mean as [H, W, nw] (or None with ``readback=False`` — at 4K the
        device->host transfer + unpermute is costly; call ``result()``
        when you actually need pixels)."""
        if self.status != RenderStatus.RENDERING:
            self.start()
        t0 = time.monotonic()
        batched = (self._sharding is None
                   or hasattr(self._sharding, "render_samples"))
        if self.jitter:
            # batched jitter regenerates rays in-dispatch (JitterCam);
            # sharded strategies must opt in (TileSharding does)
            batched = batched and (self._sharding is None or getattr(
                self._sharding, "supports_jitter_cam", False))
        if batched and n_samples >= 1:
            # one device dispatch for the whole batch (no host round trip
            # per sample)
            step_fn = (self._sharding.render_samples if self._sharding
                       else render_samples)
            kw = ({"jitter_cam": self._jitter_cam} if self.jitter else {})
            if self.chunks > 1:
                kw["chunks"] = self.chunks
            self._total, self._samples, self._out, nrays = step_fn(
                self._scene_data, self._ro, self._rd, self._total,
                self._samples, self._key, self._sample_counter,
                n_steps=n_samples, max_depth=self.scene.trace_depth,
                backend=self.backend, dispersion=self.dispersion, **kw)
            self._sample_counter += n_samples
            self.rays_traced += int(nrays)
        else:
            for _ in range(n_samples):
                key = jax.random.fold_in(self._key, self._sample_counter)
                if self.jitter:
                    w, h = self.resolution
                    cam_key = jax.random.fold_in(key, 0xC0FFEE)
                    ro, rd = camera_rays(self.scene.camera(), w, h,
                                         key=cam_key, jitter=True)
                    if self._perm is not None:
                        ro, rd = ro[self._perm], rd[self._perm]
                    if self._sharding is not None:
                        ro, rd = self._sharding.shard_rays(ro, rd)
                else:
                    ro, rd = self._ro, self._rd
                step_fn = (self._sharding.render_sample if self._sharding
                           else render_sample)
                self._total, self._samples, self._out, nrays = step_fn(
                    self._scene_data, ro, rd, self._total, self._samples, key,
                    max_depth=self.scene.trace_depth, backend=self.backend,
                    dispersion=self.dispersion)
                self._sample_counter += 1
                self.rays_traced += int(nrays)
        jax.block_until_ready(self._out)
        dt = time.monotonic() - t0
        self.elapsed += dt
        self.last_sample_time = dt / max(n_samples, 1)
        return self.result() if readback else None

    def run(self, target_spp: Optional[int] = None,
            batch: int = 8) -> np.ndarray:
        """Render until target spp, then auto-pause (main.cpp:4057-4061).

        Samples are stepped ``batch`` at a time (one device dispatch
        each). Jitter mode batches too: ``step``
        regenerates jittered rays in-dispatch (JitterCam) when the
        sharding supports it, falling back to per-sample stepping
        otherwise. Either way results are identical to
        ``run(..., batch=1)`` (per-sample variates come from the same
        counter schedule).
        """
        target = min(target_spp if target_spp is not None else self.target_spp,
                     MAX_TARGET_SPP)
        batch = max(1, batch)
        self.start()
        while (self.status == RenderStatus.RENDERING
               and (target == 0 or self.samples < target)):
            n = batch if target == 0 else min(batch, target - self.samples)
            self.step(n, readback=False)
            if target and self.samples >= target:
                self.pause()
        return self.result()

    # -- async loop (the reference's tracer-thread analogue) -------------------
    def start_async(self, target_spp: Optional[int] = None) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        target = min(target_spp if target_spp is not None else self.target_spp,
                     MAX_TARGET_SPP)

        def loop():
            self.start()
            while not self._stop_evt.is_set():
                if self.status != RenderStatus.RENDERING:
                    time.sleep(0.01)
                    continue
                with self._lock:
                    self.step(1)
                if target and self.samples >= target:
                    self.pause()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    # -- results & stats --------------------------------------------------------
    @property
    def samples(self) -> int:
        return int(self._samples) if self._samples is not None else 0

    def result(self) -> np.ndarray:
        """Running mean as [H, W, nw] (row 0 = image top)."""
        w, h = self.resolution
        nw = len(self.scene.wavelengths)
        if self._out is None:
            return np.zeros((h, w, nw), np.float32)
        out = self._out
        if self._sharding is not None:
            out = self._sharding.gather(out)
        out = np.asarray(out)
        if self._inv_perm is not None:
            out = out[self._inv_perm]
        return out.reshape(h, w, nw)

    def result_srgb(self, exposure: float = 0.0) -> np.ndarray:
        """Running mean as uint8 sRGB [H, W, 3] via the DEVICE epilogue
        (viewer.spectral_to_srgb_device): the CMF weighting, auto-expose
        percentile, sRGB matrix and gamma run on the accumulator's device,
        so only 3 uint8 planes reach the host — the [H, W, nw] f32
        spectral image never does. Per-pixel + one global percentile, so
        it commutes with the tile-order unscramble (applied after, on
        uint8)."""
        from . import viewer

        w, h = self.resolution
        if self._out is None:
            # no device accumulator to convert on: host path on result()
            return viewer.spectral_to_srgb(self.result(),
                                           self.scene.wavelengths,
                                           exposure=exposure)
        out = self._out
        if self._sharding is not None:
            out = self._sharding.gather(out)   # [N, nw] (host on gather)
        srgb = np.asarray(viewer.spectral_to_srgb_device(
            out, self.scene.wavelengths, exposure=exposure))
        if self._inv_perm is not None:
            srgb = srgb[self._inv_perm]
        return srgb.reshape(h, w, 3)

    def stats(self) -> dict:
        s = self.samples
        return {
            "status": self.status.value,
            "samples": s,
            "elapsed_s": self.elapsed,
            "avg_time_per_sample_s": self.elapsed / s if s else 0.0,
            "rays_traced": self.rays_traced,
            "mrays_per_s": (self.rays_traced / self.elapsed / 1e6
                            if self.elapsed > 0 else 0.0),
            "triangles": (self._scene_data.n_triangles
                          if self._scene_data is not None else 0),
            "backend": self.resolved_backend(),
        }

    # -- checkpoint/resume --------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Persist accumulator state for exact resume (the reference cannot:
        pause keeps it in RAM only, stop discards — SURVEY §5)."""
        total = np.asarray(self._sharding.gather(self._total)
                           if self._sharding else self._total)
        if self._inv_perm is not None:
            total = total[self._inv_perm]  # persist in scanline order
        np.savez(path,
                 total=total,
                 samples=np.asarray(self._samples),
                 sample_counter=self._sample_counter,
                 seed=self.seed,
                 resolution=np.asarray(self.resolution),
                 n_waves=len(self.scene.wavelengths),
                 scene_hash=self.scene.content_digest(),
                 backend=self.resolved_backend(),
                 jitter=self.jitter,
                 chunks=self.chunks,
                 key_schedule=KEY_SCHEDULE_VERSION)

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        if tuple(data["resolution"]) != tuple(self.resolution):
            raise ValueError("checkpoint resolution mismatch")
        if int(data["n_waves"]) != len(self.scene.wavelengths):
            raise ValueError("checkpoint wavelength-count mismatch")
        # Content binding: matching shapes are NOT enough — a checkpoint from
        # a different scene must refuse rather than resume into a wrong image.
        if "scene_hash" in data.files:
            ck_hash = str(data["scene_hash"])
            here = self.scene.content_digest()
            if ck_hash != here:
                raise ValueError(
                    f"checkpoint scene mismatch: checkpoint was written for "
                    f"scene {ck_hash[:12]}, this session's scene is "
                    f"{here[:12]} (same shapes do not imply same scene)")
            if int(data["key_schedule"]) != KEY_SCHEDULE_VERSION:
                raise ValueError(
                    f"checkpoint RNG key-schedule version "
                    f"{int(data['key_schedule'])} != {KEY_SCHEDULE_VERSION}; "
                    f"resuming would change the random sequence")
            ck_backend = str(data["backend"])
            if ck_backend != self.resolved_backend():
                import warnings
                warnings.warn(
                    f"checkpoint was rendered with backend '{ck_backend}', "
                    f"resuming with '{self.resolved_backend()}'",
                    stacklevel=2)
        else:
            import warnings
            warnings.warn("legacy checkpoint without a scene hash — cannot "
                          "verify it matches this scene", stacklevel=2)
        ck_jitter = bool(data["jitter"]) if "jitter" in data.files else False
        if ck_jitter != self.jitter:
            raise ValueError(
                f"checkpoint was rendered with jitter={ck_jitter}, this "
                f"session has jitter={self.jitter} — the per-sample ray "
                f"schedule differs, resume would not be exact")
        # checkpoints of the retired compact and persistent engines encode
        # a per-sample schedule this session cannot reproduce
        if "compact" in data.files and bool(data["compact"]):
            raise ValueError("checkpoint was rendered by the retired "
                             "compact (shrinking-prefix) engine — resume "
                             "is not possible in this version")
        if "persistent" in data.files and bool(data["persistent"]):
            raise ValueError("checkpoint was rendered by the retired "
                             "persistent-wavefront engine — resume is not "
                             "possible in this version")
        ck_chunks = int(data["chunks"]) if "chunks" in data.files else 1
        if ck_chunks != self.chunks:
            raise ValueError(
                f"checkpoint was rendered with chunks={ck_chunks}, this "
                f"session has chunks={self.chunks} — the per-chunk key "
                f"fold differs, resume would not be exact")
        if self._dirty:
            self._sync()
        total_np = data["total"]
        if self._perm is not None:
            total_np = total_np[self._perm]
        total = jnp.asarray(total_np)
        if self._sharding is not None:
            total = self._sharding.shard_accumulator(total)
        self._total = total
        self._samples = self._place_samples(jnp.asarray(data["samples"]))
        self._out = self._total / jnp.maximum(
            self._samples.astype(jnp.float32), 1.0)
        self._sample_counter = int(data["sample_counter"])
        self.seed = int(data["seed"])
        self._key = jax.random.key(self.seed)
        self.status = RenderStatus.PAUSED
