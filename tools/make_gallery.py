#!/usr/bin/env python
"""Render the showcase gallery into images/ (the reference's proof-of-life
artifacts: images/armor.png, images/car.png, images/final_render.png —
reference README.md:27-40).

  armor.png       config-4 armor-class glTF + Hosek-Wilkie sky, 800x450@256spp
  car_final.png   config-5 night car-class, 1920x1080@256spp (the reference's
                  final_render analog)
  cover_360k.png  360k-sphere cover at quality spp (overwrites the low-spp one)

Run from the repo root: python tools/make_gallery.py [names]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def save(path, img):
    from rt_tpu.io import write_png

    write_png(path, img)
    print(f"wrote {path}", flush=True)


def main():
    only = set(sys.argv[1:])

    from tools.gen_fixtures import ensure_fixtures
    from rt_tpu import scenes
    from rt_tpu import sky as sky_mod
    from rt_tpu.config import RenderConfig
    from rt_tpu.io.gltf_loader import add_gltf_to_scene
    from rt_tpu.render import render_image
    from rt_tpu.scene import SceneBuilder

    fixtures = ensure_fixtures()
    out = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "images")

    if not only or "armor" in only:
        b = SceneBuilder()
        even = b.solid_color((0.1, 0.1, 0.1))
        odd = b.solid_color((0.95, 0.95, 0.95))
        scenes.add_ground_plane(b, 10000.0, 10000.0, -0.2, b.lambertian(b.checker(0.75, even, odd)), True)
        add_gltf_to_scene(b, fixtures["glb"], compat_all_metal=False)
        scene = b.build().replace(
            sky=sky_mod.SkyParams.hosek(turbidity=3.0, albedo=0.3, elevation=0.8)
        )
        camera = scenes.mesh_cam(800, 450)
        cfg = RenderConfig(width=800, height=450, samples_per_pixel=256, max_depth=16)
        t0 = time.time()
        img, m = render_image(scene, camera, cfg)
        print(f"armor: {m['mray_per_s']:.2f} Mray/s, {time.time()-t0:.0f}s", flush=True)
        save(os.path.join(out, "armor.png"), img)

    if not only or "360k" in only:
        cam = scenes.cam1(800, 450)
        scene = scenes.cover_scene(300, 300, cam, z=-0.2, seed=0)
        cfg = RenderConfig(width=800, height=450, samples_per_pixel=512, max_depth=8)
        t0 = time.time()
        img, m = render_image(scene, cam, cfg)
        print(f"360k: {m['mray_per_s']:.2f} Mray/s, {time.time()-t0:.0f}s", flush=True)
        save(os.path.join(out, "cover_360k.png"), img)

    if not only or "car" in only:
        b = SceneBuilder()
        even = b.solid_color((0.02, 0.02, 0.03))
        odd = b.solid_color((0.25, 0.25, 0.3))
        scenes.add_ground_plane(b, 10000.0, 10000.0, -0.2, b.lambertian(b.checker(0.75, even, odd)), True)
        add_gltf_to_scene(b, fixtures["car"], compat_all_metal=False)
        scene = b.build().replace(
            sky=sky_mod.SkyParams.hosek(
                turbidity=8.0, albedo=0.1, elevation=0.07, exposure=0.35
            )
        )
        w, h = 1920, 1080
        camera = scenes.mesh_cam(w, h, dist=7.0, height_z=2.6)
        cfg = RenderConfig(width=w, height=h, samples_per_pixel=256, max_depth=12)
        t0 = time.time()
        img, m = render_image(scene, camera, cfg)
        print(f"car: {m['mray_per_s']:.2f} Mray/s, {time.time()-t0:.0f}s", flush=True)
        save(os.path.join(out, "car_final.png"), img)


if __name__ == "__main__":
    main()
