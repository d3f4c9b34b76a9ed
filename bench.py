"""Headline benchmark: Mrays/s on the Cornell-box spectral scene, on a GPU.

Cornell box, 512x512, 4 wavelengths, trace depth 3, 256 progressive samples
in one dispatch through ``engine.render_samples``. Rays are counted exactly
as traced (sum of live rays per bounce iteration, including primaries), the
Mrays/s definition in BASELINE.json. One warm-up dispatch compiles, then
three timed dispatches, each ended by ``block_until_ready``; the median is
reported. Exits non-zero without a GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "platform": ..., "device_kind": ..., "device_count": ..., "card": ...}
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    from pathtracing_spectrum_tpu.compile_cache import enable_compile_cache
    from pathtracing_spectrum_tpu.utils.device_info import (device_fields,
                                                            require_gpu)
    enable_compile_cache()
    require_gpu("bench.py")

    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _tiny_scene
    from pathtracing_spectrum_tpu import camera_rays
    from pathtracing_spectrum_tpu.engine import render_samples

    w = h = 512
    depth = 3
    n_steps = 256
    sc = _tiny_scene(res=(w, h), depth=depth)
    scene = sc.compile()
    ro, rd = camera_rays(sc.camera(), w, h)
    nw = len(sc.wavelengths)
    key = jax.random.key(0)

    def run():
        total = jnp.zeros((w * h, nw), jnp.float32)
        samples = jnp.zeros((), jnp.int32)
        t0 = time.perf_counter()
        _, _, out, nrays = render_samples(
            scene, ro, rd, total, samples, key, 0, n_steps=n_steps,
            max_depth=depth)
        jax.block_until_ready(out)
        return time.perf_counter() - t0, int(nrays)

    run()                                          # compile + warm up
    times, rays = [], 0
    for _ in range(3):
        dt, rays = run()
        times.append(dt)
    mrays = rays / float(np.median(times)) / 1e6
    print(json.dumps({
        "metric": "Mrays/s (Cornell box 512x512, 4-wave spectral, depth 3)",
        "value": mrays,
        "unit": "Mray/s",
        "vs_baseline": mrays / 200.0,
        **device_fields(),
    }))


if __name__ == "__main__":
    main()
