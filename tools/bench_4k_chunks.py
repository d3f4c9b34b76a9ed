"""Chunked-4K A/B: the bounded-width wavefront at BASELINE config 5.

Measures `RenderSession(chunks=C)` on the 4K Cornell config for a sweep
of chunk widths (PTS_CHUNKS_SWEEP, comma-separated; default 1,8,16,32,64),
plus the 512-squared point at the width the chunks aim to reproduce. One
process measures all variants back-to-back, each a fresh session timed
by bench_suite._timed_spp (warm-up, then timed batches). Needs a GPU;
every line names the device and card.

    python tools/bench_4k_chunks.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_suite as bs
from pathtracing_spectrum_tpu.utils.device_info import (device_fields,
                                                        require_gpu)


def main():
    require_gpu("bench_4k_chunks.py")
    dev = device_fields()
    sweep = [int(v) for v in os.environ.get(
        "PTS_CHUNKS_SWEEP", "1,8,16,32,64").split(",")]
    spp = int(os.environ.get("PTS_CHUNKS_SPP", "16"))

    # reference point: the same scene/depth at 512^2, chunks=1 (the
    # wavefront width the chunk sizes aim to reproduce)
    sc = bs.cornell_scene((512, 512), 3)
    s = bs._session(sc)
    dt, st = bs._timed_spp(s, spp, batch=spp)
    entry = dict(config="cornell_512", chunks=1, spp=spp,
                 seconds=round(dt, 3), spp_per_sec=round(spp / dt, 2),
                 mrays_per_sec=round(st["mrays_per_s"], 1), **dev)
    print(json.dumps(entry), flush=True)

    for c in sweep:
        sc = bs.cornell_scene((3840, 2160), 3)
        s = bs._session(sc, chunks=c)
        t0 = time.time()
        dt, st = bs._timed_spp(s, spp, batch=spp)
        entry = dict(config="cornell_4k", chunks=c, spp=spp,
                     seconds=round(dt, 3),
                     spp_per_sec_4k=round(spp / dt, 3),
                     mrays_per_sec=round(st["mrays_per_s"], 1),
                     wall_incl_compile=round(time.time() - t0, 1), **dev)
        print(json.dumps(entry), flush=True)


if __name__ == "__main__":
    main()
