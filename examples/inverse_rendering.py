#!/usr/bin/env python
"""Inverse rendering demo: recover material + sky parameters from pixels.

Renders a target image with known parameters, perturbs them, and runs
gradient descent through the differentiable path tracer until the render
matches — the end-to-end capability the reference (a forward-only CPU
tracer) has no analog of.

Runs on whatever device JAX finds (pass JAX_PLATFORMS=cpu for the CPU):
    python examples/inverse_rendering.py [--steps 60]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from rt_tpu import grad as grad_mod  # noqa: E402
from rt_tpu import scenes  # noqa: E402
from rt_tpu.config import CompatConfig, RenderConfig  # noqa: E402
from rt_tpu.render import render_chunk  # noqa: E402
from rt_tpu.scene import SceneBuilder  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--out", default=None, help="optional before/after PNG dir")
    args = parser.parse_args()

    b = SceneBuilder()
    lam = b.lambertian_rgb(0.75, 0.25, 0.2)  # ground truth albedo
    metal = b.metal_solid((0.7, 0.6, 0.5), 0.15)
    b.add_sphere((-0.6, 0.4, 0.0), 0.7, lam)
    b.add_sphere((0.7, -0.3, 0.1), 0.6, metal)
    scene = b.build(use_bvh=False)

    camera = scenes.cam1(48, 32)
    cfg = RenderConfig(
        width=48, height=32, diff_max_depth=4,
        detach_sampling=False, compat=CompatConfig(rr_clamp=0.6),
    )
    pixel_idx = jnp.arange(48 * 32, dtype=jnp.int32)
    key = jax.random.key(0)
    spp = 4

    true_params = grad_mod.get_params(scene)
    target = render_chunk(
        scene, camera, pixel_idx, cfg, spp, jnp.int32(0), key, differentiable=True
    )

    # Perturb: wrong albedo, wrong sky exposure.
    params = true_params._replace(
        tex_color=true_params.tex_color.at[0].set(jnp.array([0.2, 0.7, 0.7])),
        sky_exposure=true_params.sky_exposure * 1.8,
    )

    opt = optax.adam(5e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            return grad_mod.pixel_loss(
                p, scene, camera, cfg, pixel_idx, target, key, spp
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state)
        if i % 10 == 0 or i == args.steps - 1:
            albedo = np.asarray(params.tex_color[0]).round(3)
            print(f"step {i:3d}  loss {float(loss):.6f}  albedo {albedo}  "
                  f"exposure {float(params.sky_exposure):.3f}")

    got = np.asarray(params.tex_color[0])
    want = np.asarray(true_params.tex_color[0])
    err = np.abs(got - want).max()
    print(f"recovered albedo {got.round(3)} vs truth {want.round(3)} "
          f"(max err {err:.3f})")
    if args.out:
        from rt_tpu.io import write_png

        os.makedirs(args.out, exist_ok=True)
        final = render_chunk(
            grad_mod.set_params(scene, params), camera, pixel_idx, cfg, spp,
            jnp.int32(0), key, differentiable=True,
        )
        write_png(os.path.join(args.out, "target.png"),
                  np.asarray(target).reshape(32, 48, 3))
        write_png(os.path.join(args.out, "recovered.png"),
                  np.asarray(final).reshape(32, 48, 3))


if __name__ == "__main__":
    main()
