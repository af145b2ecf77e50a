#!/usr/bin/env python
"""Gradient benchmark: pixel-grad backward-pass time per 1-spp frame.

The second BASELINE.json metric ("pixel-grad backward pass time per 1spp
frame tracked").  Measures jax.value_and_grad of the MSE pixel loss
w.r.t. all SceneParams (texture colors, atlas, fuzz, IOR, sky) on the
cover scene at 400x225 @ 1 spp, diff_max_depth bounces.

Prints the device record, then ONE JSON line: {"metric", "value", "unit",
"backward_over_forward", "device"} (the reference has no gradients, so
there is no external number to compare against).  Fails when JAX finds no
GPU.
"""

import json
import sys
import time


def main() -> None:
    import jax
    import jax.numpy as jnp

    from rt_tpu import grad as grad_mod
    from rt_tpu import scenes
    from rt_tpu.config import RenderConfig
    from rt_tpu.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    device = require_gpu()
    print(json.dumps({"device": device}), flush=True)

    camera = scenes.cam1(400, 225)
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=400, height=225, diff_max_depth=6)
    pixel_idx = jnp.arange(400 * 225, dtype=jnp.int32)
    key = jax.random.key(0)
    target = jnp.zeros((400 * 225, 3), jnp.float32)

    fwd = jax.jit(
        lambda p: grad_mod.pixel_loss(
            p, scene, camera, cfg, pixel_idx, target, key, spp=1
        )
    )
    bwd = jax.jit(
        jax.value_and_grad(
            lambda p: grad_mod.pixel_loss(
                p, scene, camera, cfg, pixel_idx, target, key, spp=1
            )
        )
    )
    params = grad_mod.get_params(scene)

    jax.block_until_ready(fwd(params))  # compile
    jax.block_until_ready(bwd(params))

    def best_of(fn, reps=5):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(params))
            best = min(best, time.perf_counter() - t0)
        return best

    t_fwd = best_of(fwd)
    t_bwd = best_of(bwd)
    print(
        json.dumps(
            {
                "metric": "pixel_grad_backward_s_400x225_1spp",
                "value": t_bwd,
                "unit": "s",
                "backward_over_forward": t_bwd / t_fwd,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
