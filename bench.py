#!/usr/bin/env python
"""Benchmark: Mray/s on the RTIOW cover scene (BASELINE.json config 1).

Prints the device record, then ONE JSON line: {"metric", "value", "unit",
"device"}.  Fails when JAX finds no GPU.

Metric definition matches the reference's own throughput counter
(window.rs:315-324): rays = spp * W * H camera samples (bounce rays not
counted) / wall seconds.  The reference never recorded a number
(TODO.md:175-179).
"""

import json
import sys
import time


def main() -> None:
    import jax

    from rt_tpu import scenes
    from rt_tpu.render import render_pixel_colors
    from rt_tpu.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    device = require_gpu()
    print(json.dumps({"device": device}), flush=True)

    scene, camera, cfg = scenes.bench_cover_config()
    # A deep accumulation (the bench config's 10 spp x 64 sweeps = 640
    # spp) through the standard API: the reference's cumulative Mray/s
    # counter semantics (window.rs:315-324: total rays so far / elapsed).
    spp = 64 * cfg.samples_per_pixel
    frame = lambda: render_pixel_colors(scene, camera, cfg, spp=spp)

    jax.block_until_ready(frame())  # warm-up (compile)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(frame())
        best = min(best, time.perf_counter() - t0)

    rays = spp * camera.image_width * camera.image_height
    print(
        json.dumps(
            {
                "metric": "mray_per_s_cover_400x225_640spp",
                "value": rays / 1.0e6 / best,
                "unit": "Mray/s",
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
