#!/usr/bin/env python
"""Bring-up check on the GPU, through the entry points a user calls.

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-cards  # the 4-card mesh path only

Phases, each printing one JSON line:

1. device: JAX's devices, the card (nvidia-smi), the compile cache in use
   and which BVH builder ran; exits non-zero when JAX finds no GPU;
2. goldens: every case of tests/make_goldens.py rendered on the card and
   compared with its committed PNG (rendered on the CPU) under
   tests/test_golden.py's tolerance;
3. kernel: the fused Triton intersection kernel against the XLA rows on
   65,536 bounce rays of the bench cover scene;
4. main path: the bench cover (400x225 @ 640 spp, depth 50) and the
   closed-mesh area-light scene (800x450 @ 64 spp, depth 16, BVH walk),
   cold and warm, in Mray/s by the reference's definition (camera samples
   / wall second);
5. progressive: 800x450 sweeps with a checkpoint, resumed in a fresh
   ProgressiveRenderer, equal to the uninterrupted run;
6. gradients: pixel gradients finite and non-zero, one finite-difference
   check, three sharded training steps on a one-card mesh with the loss
   falling.

``--four-cards`` runs only phase 7: the sharded wavefront on a 4-card mesh
against the one-card render, and one sharded training step on 4 cards
against one card.  A failed phase raises: the script then exits non-zero
and prints no ``ok`` line.  The last line is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Golden tolerance (tests/test_golden.py): mean |diff| within ~1.5
# quantization steps, at most 1% of pixels off by more than 8/255.
GOLDEN_MEAN_U8 = 1.5
GOLDEN_FRAC_OFF8 = 0.01
# Kernel parity.  Both sides evaluate the same f32 formula, but the
# compilers contract and order it differently, so t differs by a few ulp;
# near grazing incidence the square root of a small discriminant amplifies
# that (d sqrt(x) = dx / 2 sqrt(x)).  Most hits agree to 1e-6 relative, all
# to KERNEL_T_RTOL; prims may differ only where the two t tie within it.
KERNEL_T_RTOL = 1e-4
# Finite-difference check (tests/test_grad.py's lambertian-albedo case).
FD_REL_TOL = 0.08
# 4 cards vs 1: gradients summed in another order across cards.
MESH_GRAD_RTOL = 1e-4
# Sharded vs unsharded entry point: a one-ulp difference can flip a
# Russian-roulette draw and change that path, so compare the image mean.
DIRECT_MAD_TOL = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def phase_device(cache_dir: str) -> dict:
    import jax

    from rt_tpu.bvh import native
    from rt_tpu.runtime import require_gpu

    device = require_gpu()
    print(device["card"], flush=True)
    emit(
        "device",
        devices=str(jax.devices()),
        jax=jax.__version__,
        compile_cache=cache_dir,
        bvh_builder="c++ binned SAH" if native.available() else "numpy fallback",
        **device,
    )
    return device


def phase_goldens() -> None:
    from rt_tpu import color
    from rt_tpu.io.png_io import decode_png
    from tests.make_goldens import GOLDEN_DIR, golden_cases, render_case

    results, failed = {}, []
    for name, (scene, camera, cfg) in sorted(golden_cases().items()):
        with open(os.path.join(GOLDEN_DIR, f"{name}.png"), "rb") as f:
            want = decode_png(f.read()).astype(np.float32)
        img = render_case(scene, camera, cfg)
        got = np.asarray(color.to_u8_gamma(img), np.float32)
        diff = np.abs(got - want)
        mean, frac = float(diff.mean()), float((diff > 8).mean())
        results[name] = {"mean_abs_diff_u8": mean, "frac_off_by_gt8": frac}
        if got.shape != want.shape or mean >= GOLDEN_MEAN_U8 or frac >= GOLDEN_FRAC_OFF8:
            failed.append(name)
    emit("goldens", cases=results, failed=failed)
    if failed:
        raise AssertionError(f"goldens off on the GPU: {failed}")


def bounce_rays(scene, camera, cfg, n: int):
    """f32[8, n] rays after one bounce off the scene (camera rays where the
    first segment missed), from n (pixel, sample) pairs."""
    import jax
    import jax.numpy as jnp

    from rt_tpu import fast_shade

    w, h = camera.image_width, camera.image_height
    work = jnp.arange(n, dtype=jnp.int32)
    pix = work % (w * h)
    key = jax.random.key(cfg.seed)
    org, dirn = camera.generate_rays(pix % w, pix // w, work // (w * h), key, cfg.compat)
    z = jnp.zeros((n,), jnp.float32)
    rays = jnp.stack([*org.T, *dirn.T, z, z], axis=0)
    t, prim = fast_shade.nearest_rows(scene, rays, cfg.t_min, cfg.t_max, cfg.compat)
    out = fast_shade.shade_bounce(scene, rays, t, prim, jnp.uint32(7), work, work * 0, cfg)
    return jnp.where(out["hit"][None, :], out["new_rays"], rays)


def phase_kernel() -> None:
    import jax.numpy as jnp

    from rt_tpu import fast_shade, scenes
    from rt_tpu.pallas_ops import prim_nearest_shaded

    scene, camera, cfg = scenes.bench_cover_config()
    rays = bounce_rays(scene, camera, cfg, 1 << 16)
    t_k, p_k, params = prim_nearest_shaded(
        rays, scene.sph_center, scene.sph_radius,
        scene.tri_a, scene.tri_b, scene.tri_c, scene.shade_table,
        num_spheres=scene.num_spheres, num_triangles=scene.num_triangles,
        t_min=cfg.t_min, t_max=cfg.t_max,
        backface_cull=cfg.compat.triangle_backface_cull,
    )
    t_x, p_x = fast_shade.nearest_rows(scene, rays, cfg.t_min, cfg.t_max, cfg.compat)
    t_k, p_k, t_x, p_x = (np.asarray(a) for a in (t_k, p_k, t_x, p_x))
    gather = np.asarray(scene.shade_table)[:, np.maximum(p_k, 0)]
    hit = (p_x >= 0) & (p_k >= 0)
    rel = np.abs(t_k - t_x)[hit] / np.abs(t_x)[hit]
    differ = p_k != p_x
    tie = differ & (np.abs(t_k - t_x) <= KERNEL_T_RTOL * np.abs(t_x))
    emit(
        "kernel",
        rays=int(rays.shape[1]),
        hits=int(hit.sum()),
        hit_set_mismatch=int(((p_x >= 0) != (p_k >= 0)).sum()),
        t_max_rel_diff=float(rel.max(initial=0.0)),
        t_frac_within_1e6=float((rel <= 1e-6).mean()) if rel.size else 1.0,
        t_rtol=KERNEL_T_RTOL,
        prim_mismatch=int(differ.sum()),
        prim_mismatch_ties=int(tie.sum()),
        params_bit_equal=bool(np.array_equal(np.asarray(params), gather)),
    )
    assert (~differ | tie).all(), "kernel picked another primitive off a tie"
    assert rel.max(initial=0.0) <= KERNEL_T_RTOL, "kernel t off the XLA rows"
    assert np.array_equal(np.asarray(params), gather), "fetched params differ"


def timed(scene, camera, cfg) -> dict:
    """Cold (compile included) and warm render_image: wall seconds and
    Mray/s; asserts the image is finite and not black."""
    from rt_tpu.render import render_image

    img, cold = render_image(scene, camera, cfg)
    assert np.isfinite(img).all() and img.mean() > 1e-3, "image not finite or black"
    img, warm = render_image(scene, camera, cfg)
    assert np.isfinite(img).all() and img.mean() > 1e-3, "image not finite or black"
    return {
        "rays": warm["rays"],
        "cold_wall_s": cold["wall_s"],
        "cold_mray_per_s": cold["mray_per_s"],
        "warm_wall_s": warm["wall_s"],
        "warm_mray_per_s": warm["mray_per_s"],
        "image_mean": float(img.mean()),
    }


def phase_main_path() -> None:
    from rt_tpu import scenes
    from rt_tpu.config import RenderConfig
    from tools.gen_fixtures import ensure_fixtures

    scene, camera, cfg = scenes.bench_cover_config()
    cover = timed(scene, camera, cfg.replace(samples_per_pixel=640))
    emit("main_path", cell="cover_400x225_640spp_d50", prims=scene.num_prims, **cover)

    t0 = time.perf_counter()
    mesh = scenes.mesh_with_area_light(ensure_fixtures()["obj"])
    build_s = time.perf_counter() - t0
    assert mesh.bvh is not None
    camera = scenes.mesh_cam(800, 450)
    cfg = RenderConfig(width=800, height=450, samples_per_pixel=64, max_depth=16)
    blob = timed(mesh, camera, cfg)
    emit(
        "main_path", cell="closed_mesh_area_light_800x450_64spp_d16",
        tris=mesh.num_triangles, scene_build_s=build_s, **blob,
    )


def phase_progressive() -> None:
    from rt_tpu import scenes
    from rt_tpu.config import ProgressiveSchedule, RenderConfig
    from rt_tpu.progressive import ProgressiveRenderer

    camera = scenes.cam1(800, 450)
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=800, height=450, max_depth=50)
    schedule = ProgressiveSchedule(ramp=(4, 4, 4, 4), sustain_64=0, sustain_128=0, sustain_256=0)

    whole = ProgressiveRenderer(scene, camera, cfg, schedule=schedule)
    whole.run()
    tmp = tempfile.mkdtemp()
    try:
        ckpt = os.path.join(tmp, "sweeps.npz")
        first = ProgressiveRenderer(scene, camera, cfg, schedule=schedule, checkpoint_path=ckpt)
        first.run(max_passes=2)
        resumed = ProgressiveRenderer(scene, camera, cfg, schedule=schedule, checkpoint_path=ckpt)
        assert resumed.state.pass_index == 2, resumed.state.pass_index
        resumed.run()
    finally:
        shutil.rmtree(tmp)
    a, b = whole.state.accum, resumed.state.accum
    emit(
        "progressive",
        sweeps=len(schedule.passes()),
        total_spp=resumed.state.total_spp,
        resumed_equal=bool(np.array_equal(a, b)),
        max_abs_diff=float(np.abs(a - b).max()),
    )
    assert np.isfinite(a).all() and a.mean() > 1e-3
    assert np.array_equal(a, b), "resumed accumulator differs from the uninterrupted one"


def grad_setup():
    """tests/test_grad.py's scene: four spheres (lambertian, metal, glass,
    image-textured) with rr_clamp=0.6, so survival does not depend on the
    parameters and the per-sample loss is smooth under frozen keys."""
    import jax
    import jax.numpy as jnp

    from rt_tpu import scenes
    from rt_tpu.config import CompatConfig, RenderConfig
    from rt_tpu.scene import SceneBuilder

    b = SceneBuilder()
    lam = b.lambertian_rgb(0.8, 0.5, 0.3)
    metal = b.metal_solid((0.7, 0.6, 0.5), 0.1)
    glass = b.dielectric(1.5)
    img = np.linspace(0.6, 1.0, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    textured = b.lambertian(b.image_texture(img))
    b.add_sphere((-0.6, 0.4, 0.0), 0.7, lam)
    b.add_sphere((0.7, -0.3, 0.1), 0.6, metal)
    b.add_sphere((1.4, -1.5, 0.2), 0.5, glass)
    b.add_sphere((-1.3, -0.9, 0.0), 0.5, textured)
    scene = b.build(use_bvh=False)
    w, h = 48, 32
    camera = scenes.cam1(w, h)
    cfg = RenderConfig(
        width=w, height=h, diff_max_depth=4, detach_sampling=False,
        compat=CompatConfig(rr_clamp=0.6),
    )
    pixel_idx = jnp.arange(w * h, dtype=jnp.int32)
    return scene, camera, cfg, pixel_idx, jax.random.key(0)


def phase_gradients() -> None:
    import jax
    import jax.numpy as jnp

    from rt_tpu import grad as grad_mod
    from rt_tpu.parallel import make_mesh, train_step_sharded
    from rt_tpu.render import render_chunk

    scene, camera, cfg, pixel_idx, key = grad_setup()
    zeros = jnp.zeros((pixel_idx.shape[0], 3), jnp.float32)
    loss, g = grad_mod.pixel_grad(scene, camera, cfg, pixel_idx, zeros, key, spp=2)
    leaves = {k: np.asarray(v) for k, v in g._asdict().items()}
    finite = all(np.isfinite(v).all() for v in leaves.values())
    nonzero = {k: bool(np.abs(leaves[k]).max() > 0) for k in
               ("tex_color", "mat_fuzz", "sky_exposure", "sky_turbidity")}

    def loss_fn(p):
        return grad_mod.pixel_loss(p, scene, camera, cfg, pixel_idx, zeros, key, spp=2)

    params = grad_mod.get_params(scene)
    ad = float(jax.grad(loss_fn)(params).tex_color[0, 0])
    fd = grad_mod.finite_difference_grad(loss_fn, params, "tex_color", (0, 0), 1e-2)
    fd_rel = abs(ad - fd) / max(abs(ad), abs(fd), 1e-4)

    target = render_chunk(
        scene, camera, pixel_idx, cfg, 2, jnp.int32(0), key, differentiable=True
    )
    current = scene.replace(tex_color=scene.tex_color * 0.5)
    mesh = make_mesh(1, tiles=1)
    losses = []
    for _ in range(3):
        step_loss, current = train_step_sharded(
            current, camera, cfg, mesh, np.asarray(pixel_idx), np.asarray(target),
            spp=2, key=key, lr=0.02,
        )
        losses.append(float(step_loss))
    emit(
        "gradients", loss=float(loss), grads_finite=finite, nonzero=nonzero,
        fd_leaf="tex_color[0,0]", ad=ad, fd=fd, fd_rel_err=fd_rel,
        fd_rel_tol=FD_REL_TOL, train_losses=losses,
    )
    assert finite and all(nonzero.values()), "gradients not finite or zero"
    assert abs(fd) > 1e-6 and fd_rel < FD_REL_TOL, "finite difference disagrees"
    assert losses[2] < losses[1] < losses[0], "training loss not falling"


def phase_four_cards() -> None:
    import jax
    import jax.numpy as jnp

    from rt_tpu import grad as grad_mod
    from rt_tpu import scenes
    from rt_tpu.config import RenderConfig
    from rt_tpu.parallel import make_mesh, render_sharded_wavefront, train_step_sharded
    from rt_tpu.render import render_chunk
    from rt_tpu.wavefront import render_wavefront

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(jax.devices())}")
    camera = scenes.cam1(800, 450)
    w, h = camera.image_width, camera.image_height
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=2, max_depth=50)
    key = jax.random.key(cfg.seed)
    img4 = np.asarray(render_sharded_wavefront(scene, camera, cfg, make_mesh(4, tiles=4), spp=2))
    img1 = np.asarray(render_sharded_wavefront(scene, camera, cfg, make_mesh(1, tiles=1), spp=2))
    render_equal = bool(np.array_equal(img4, img1))
    # The unsharded entry point compiles the scene as arguments, the
    # sharded one as constants, so XLA may fold the camera math to other
    # roundings: compared by mean, not bit for bit.
    direct = np.asarray(
        render_wavefront(
            scene, camera, jnp.arange(w * h, dtype=jnp.int32), cfg, 2, jnp.int32(0), key
        )
    ).reshape(h, w, 3)
    direct_mad = float(np.abs(img4 - direct).mean())

    scene_g, camera_g, cfg_g, pixel_idx, key_g = grad_setup()
    target = np.asarray(render_chunk(
        scene_g, camera_g, pixel_idx, cfg_g, 2, jnp.int32(0), key_g, differentiable=True
    ))
    start = scene_g.replace(tex_color=scene_g.tex_color * 0.5)
    # The step returns updated params, not gradients: with a large rate the
    # update dwarfs the params, so (old - new) / lr recovers the gradient
    # to f32 rounding.
    lr = 1.0e4
    grads = {}
    for n in (1, 4):
        _, new = train_step_sharded(
            start, camera_g, cfg_g, make_mesh(n, tiles=n), np.asarray(pixel_idx), target,
            spp=2, key=key_g, lr=lr,
        )
        old_p, new_p = grad_mod.get_params(start), grad_mod.get_params(new)
        grads[n] = {
            k: (np.asarray(getattr(old_p, k)) - np.asarray(getattr(new_p, k))) / lr
            for k in old_p._fields
        }
    worst = max(
        float(np.abs(grads[4][k] - grads[1][k]).max() / max(np.abs(grads[1][k]).max(), 1e-12))
        for k in grads[1]
    )
    emit(
        "four_cards", devices=4, render_800x450_bit_equal_to_1_card=render_equal,
        mean_abs_diff_vs_unsharded=direct_mad, unsharded_mad_tol=DIRECT_MAD_TOL,
        grad_max_rel_diff=worst, grad_rtol=MESH_GRAD_RTOL,
    )
    assert render_equal, "4-card render differs from the one-card render"
    assert direct_mad < DIRECT_MAD_TOL, "sharded render off the unsharded one"
    assert worst <= MESH_GRAD_RTOL, "4-card gradients off the one-card ones"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the 4-card mesh phase (needs 4 GPUs)",
    )
    args = parser.parse_args()

    from rt_tpu.runtime import enable_compile_cache

    cache_dir = enable_compile_cache()
    device = phase_device(cache_dir)
    if args.four_cards:
        phase_four_cards()
        count = 4
    else:
        phase_goldens()
        phase_kernel()
        phase_main_path()
        phase_progressive()
        phase_gradients()
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"], "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
