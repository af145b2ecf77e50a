#!/usr/bin/env python
"""BASELINE configs 2-5 as named, timed workloads on one GPU.

Config 1 (RTIOW cover) is bench.py.  This script times the remaining
BASELINE.json configs end-to-end and prints the device record, then one
JSON line per config:

  2. cover textures + frosted glass, depth-8 (the bench cover scene IS
     config 2's shape — included here at depth 8 for the record)
  3. skull-class OBJ mesh (~100k tris, BVH path) + emissive area light,
     800x450 @ 64 spp
  4. armor-class glTF (metallic-roughness + baseColorTexture atlas)
     + Hosek-Wilkie sky, 800x450 @ 64 spp
  5. night-car-class multi-mesh glTF + low-sun H-W sky,
     1920x1080 @ 256 spp progressive render with checkpoint/resume
     (pass --quick to cap config 5 at 8 spp for smoke runs)

Reference anchors: scenes.rs:344-458 (mesh/gltf/sponza scenes),
window.rs:233-247 (progressive schedule), window.rs:315-324 (Mray/s).
Assets are procedural stand-ins (tools/gen_fixtures.py) — the reference's
skull/armor/car assets are hardcoded user paths that don't ship.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEVICE = {}


def mray(rays, seconds):
    return rays / 1.0e6 / seconds


def emit(name, rays, seconds, extra=None):
    rec = {
        "metric": f"mray_per_s_{name}",
        "value": mray(rays, seconds),
        "unit": "Mray/s",
        "wall_s": seconds,
        "device": DEVICE,
    }
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def time_frame(scene, camera, cfg, spp, trials=2):
    """Deep-frame wall time via the standard render API (render_image);
    reference Mray/s counter semantics (window.rs:315-324), warm-measured."""
    from rt_tpu.render import render_image

    cfg = cfg.replace(samples_per_pixel=spp)
    render_image(scene, camera, cfg)  # compile
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        render_image(scene, camera, cfg)
        best = min(best, time.perf_counter() - t0)
    rays = spp * camera.image_width * camera.image_height
    return rays, best


def config2():
    from rt_tpu import scenes
    from rt_tpu.config import RenderConfig

    camera = scenes.cam1(400, 225)
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
    # frosted dielectric present via cover mix; depth-8 bounces per config 2
    cfg = RenderConfig(width=400, height=225, samples_per_pixel=10, max_depth=8)
    rays, dt = time_frame(scene, camera, cfg, spp=640)
    emit("config2_cover_textures_d8_400x225_640spp", rays, dt)


def config3(fixtures, depthcheck=False):
    import numpy as np

    from rt_tpu import scenes
    from rt_tpu.config import RenderConfig
    from rt_tpu.render import render_image

    # PRIMARY row: the skull-class CLOSED mesh — BASELINE names "OBJ
    # skull mesh + emissive area light" (scenes.rs:344-368 loads
    # skull.obj), and a closed blob is the faithful stand-in.  The open
    # height-field terrain is kept as a SECONDARY row for the easier
    # locality class it represents.
    camera = scenes.mesh_cam(800, 450)
    cfg = RenderConfig(width=800, height=450, samples_per_pixel=64, max_depth=16)
    scene = scenes.mesh_with_area_light(fixtures["obj"])
    rays, dt = time_frame(scene, camera, cfg, spp=64)
    extra = {"tris": int(scene.num_triangles)}
    if depthcheck:
        # Justify the depth-16 label against the reference's
        # MAX_DEPTH=100 (scenes.rs:15): under Russian roulette almost
        # every path retires long before 16 bounces, so the depth-16
        # and depth-50 images must agree WITHIN SAMPLING NOISE (the
        # seed-to-seed difference at the same spp).
        c16 = cfg.replace(samples_per_pixel=32, max_depth=16)
        a16, _ = render_image(scene, camera, c16)
        b16, _ = render_image(scene, camera, c16.replace(seed=1))
        a50, _ = render_image(scene, camera, c16.replace(max_depth=50))
        noise = float(np.abs(a16 - b16).mean())
        delta = float(np.abs(a16 - a50).mean())
        extra.update(
            {
                "depth16_vs_depth50_mad": delta,
                "seed_noise_mad_32spp": noise,
                "depth_delta_over_noise": delta / max(noise, 1e-12),
            }
        )
    emit(
        "config3_skull_class_obj_area_light_800x450_64spp",
        rays,
        dt,
        extra,
    )
    hf = scenes.mesh_with_area_light(fixtures["heightfield"])
    rays, dt = time_frame(hf, camera, cfg, spp=64)
    emit(
        "config3b_heightfield_obj_area_light_800x450_64spp",
        rays,
        dt,
        {"tris": int(hf.num_triangles)},
    )


def config4(fixtures):
    from rt_tpu import scenes
    from rt_tpu import sky as sky_mod
    from rt_tpu.config import RenderConfig
    from rt_tpu.io.gltf_loader import add_gltf_to_scene
    from rt_tpu.scene import SceneBuilder

    b = SceneBuilder()
    even = b.solid_color((0.1, 0.1, 0.1))
    odd = b.solid_color((0.95, 0.95, 0.95))
    scenes.add_ground_plane(b, 10000.0, 10000.0, -0.2, b.lambertian(b.checker(0.75, even, odd)), True)
    add_gltf_to_scene(b, fixtures["glb"], compat_all_metal=False)
    scene = b.build().replace(
        sky=sky_mod.SkyParams.hosek(turbidity=3.0, albedo=0.3, elevation=0.8)
    )
    camera = scenes.mesh_cam(800, 450)
    cfg = RenderConfig(width=800, height=450, samples_per_pixel=64, max_depth=16)
    rays, dt = time_frame(scene, camera, cfg, spp=64)
    emit(
        "config4_armor_class_gltf_hw_sky_800x450_64spp",
        rays,
        dt,
        {"tris": int(scene.num_triangles)},
    )


def config5(fixtures, quick=False, spp5=0):
    import tempfile

    import numpy as np

    from rt_tpu import scenes
    from rt_tpu import sky as sky_mod
    from rt_tpu.config import RenderConfig
    from rt_tpu.io.gltf_loader import add_gltf_to_scene
    from rt_tpu.progressive import ProgressiveRenderer, ProgressiveSchedule
    from rt_tpu.scene import SceneBuilder

    b = SceneBuilder()
    even = b.solid_color((0.02, 0.02, 0.03))
    odd = b.solid_color((0.25, 0.25, 0.3))
    scenes.add_ground_plane(b, 10000.0, 10000.0, -0.2, b.lambertian(b.checker(0.75, even, odd)), True)
    add_gltf_to_scene(b, fixtures["car"], compat_all_metal=False)
    # Night: sun at 4 deg elevation, heavy turbidity, dim exposure.
    scene = b.build().replace(
        sky=sky_mod.SkyParams.hosek(
            turbidity=8.0, albedo=0.1, elevation=0.07, exposure=0.35
        )
    )
    w, h = 1920, 1080
    camera = scenes.mesh_cam(w, h, dist=7.0, height_z=2.6)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=1, max_depth=12)
    spp_target = spp5 or (8 if quick else 256)
    spw = 4 if spp_target % 4 == 0 else 1  # 4-spp sweeps: ~8.3M rays each
    passes = ProgressiveSchedule(
        ramp=(spw,) * (spp_target // spw),
        sustain_64=0, sustain_128=0, sustain_256=0,
    )
    ckpt = os.path.join(tempfile.gettempdir(), "bench_config5.ckpt.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    pr = ProgressiveRenderer(
        scene, camera, cfg,
        schedule=passes,
        checkpoint_path=ckpt,
        checkpoint_every=16,
    )
    # warm-up compile on the first sweep shape (all sweeps share it)
    t0 = time.perf_counter()
    done_spp = 0
    mid_checked = False
    while True:
        m = pr.step()
        if m is None:
            break
        done_spp = pr.state.total_spp
        if not mid_checked and done_spp >= spp_target // 2:
            # checkpoint/resume mid-run: reload state into a fresh engine
            # (resumes from the last 16-sweep checkpoint; the re-rendered
            # sweeps re-add identical pass-keyed colors onto the
            # checkpointed accumulator, so the result is unchanged)
            pr2 = ProgressiveRenderer(
                scene, camera, cfg,
                schedule=passes,
                checkpoint_path=ckpt,
                checkpoint_every=16,
            )
            assert 0 < pr2.state.total_spp <= done_spp, "resume mismatch"
            # Staleness bound in SWEEPS (checkpoint_every=16), not spp —
            # a pass can add >1 spp, so an spp-based bound would fail
            # spuriously on multi-sample schedules.
            assert pr2.state.pass_index > pr.state.pass_index - 16, (
                "stale checkpoint"
            )
            pr = pr2
            mid_checked = True
    dt = time.perf_counter() - t0
    img = pr.state.accum
    assert np.isfinite(img).all()
    rays = done_spp * w * h
    emit(
        f"config5_night_car_class_1080p_{done_spp}spp_progressive",
        rays,
        dt,
        {"tris": int(scene.num_triangles), "resumed_mid_run": mid_checked},
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="cap config 5 at 8 spp")
    ap.add_argument("--spp5", type=int, default=0, help="override config 5 spp")
    ap.add_argument("--only", type=int, default=0)
    ap.add_argument(
        "--depthcheck", action="store_true",
        help="config 3: also record depth-16 vs depth-50 agreement",
    )
    args = ap.parse_args()

    from rt_tpu.runtime import enable_compile_cache, require_gpu
    from tools.gen_fixtures import ensure_fixtures

    enable_compile_cache()
    DEVICE.update(require_gpu())
    print(json.dumps({"device": DEVICE}), flush=True)
    fixtures = ensure_fixtures()
    todo = [args.only] if args.only else [2, 3, 4, 5]
    if 2 in todo:
        config2()
    if 3 in todo:
        config3(fixtures, depthcheck=args.depthcheck)
    if 4 in todo:
        config4(fixtures)
    if 5 in todo:
        config5(fixtures, quick=args.quick, spp5=args.spp5)


if __name__ == "__main__":
    main()
