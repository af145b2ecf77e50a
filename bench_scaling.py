#!/usr/bin/env python
"""Device-count scaling benchmark: sharded-render Mray/s at 1, 2, 4, ...
devices of one host (or of a multi-host mesh with --multihost).

    python bench_scaling.py                  # uses every visible device
    python bench_scaling.py --devices 2      # subset

Prints the device record, then one JSON line per device count with its
Mray/s and the ratio to the 1-device row.  Fails when JAX finds no GPU;
the code path itself is exercised by tests/test_distributed.py on a
simulated 8-device CPU mesh.
"""

import argparse
import json
import time


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--devices", type=int, default=None)
    parser.add_argument("--multihost", action="store_true")
    parser.add_argument("--spp", type=int, default=16)
    parser.add_argument("--size", default="400x225")
    args = parser.parse_args()

    if args.multihost:
        from rt_tpu.parallel import initialize_multihost

        initialize_multihost()

    import jax

    from rt_tpu import scenes
    from rt_tpu.config import RenderConfig
    from rt_tpu.parallel import make_mesh, render_sharded
    from rt_tpu.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    device = require_gpu()
    print(json.dumps({"device": device}), flush=True)

    width, height = (int(v) for v in args.size.split("x"))
    camera = scenes.cam1(width, height)
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=width, height=height, max_depth=50)

    n_avail = len(jax.devices())
    counts = []
    c = 1
    while c <= (args.devices or n_avail):
        counts.append(c)
        c *= 2

    base = None
    for n in counts:
        mesh = make_mesh(n, tiles=n)
        img = render_sharded(scene, camera, cfg, mesh, spp=args.spp)
        jax.block_until_ready(img)  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            img = render_sharded(scene, camera, cfg, mesh, spp=args.spp)
            jax.block_until_ready(img)
            best = min(best, time.perf_counter() - t0)
        mray = args.spp * width * height / 1e6 / best
        base = base or mray
        print(
            json.dumps(
                {
                    "devices": n,
                    "mray_per_s": mray,
                    "wall_s": best,
                    "scaling_vs_1dev": mray / base,
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
