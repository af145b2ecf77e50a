"""Regenerate the committed golden images (CPU, deterministic).

Run from the repo root after an *intentional* rendering change:
    python tests/make_goldens.py
then eyeball the images and commit.  test_golden.py compares against
these with a small tolerance (see SURVEY.md §4: the reference validates
by eye against its images/ directory; rt_tpu pins deterministic goldens
instead, which its seeded scenes + counter-based RNG make possible).
"""

import os
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from rt_tpu import scenes  # noqa: E402
from rt_tpu.config import RenderConfig  # noqa: E402
from rt_tpu.render import render_pixel_colors  # noqa: E402
from rt_tpu.io import write_png  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def golden_cases():
    """name -> (scene, camera, cfg).  Small + low-spp: these gate
    *structure*, not noise level."""
    cases = {}

    camera = scenes.cam1(96, 54)
    cases["cover"] = (
        scenes.cover_scene(3, 3, camera, z=-0.2, seed=0),
        camera,
        RenderConfig(width=96, height=54, samples_per_pixel=8, max_depth=12),
    )

    # cam1 sits inside the lower 10-radius sphere; view from outside.
    from rt_tpu.camera import make_camera

    camera2 = make_camera(
        (35.0, 2.0, 3.0),
        (0.0, 0.0, 0.0),
        (0.0, 0.0, 1.0),
        focus_distance=35.0,
        defocus_angle=0.0,
        image_width=96,
        image_height=54,
        vertical_fov=40.0,
    )
    cases["checkered"] = (
        scenes.gen_checkered(),
        camera2,
        RenderConfig(width=96, height=54, samples_per_pixel=4, max_depth=8),
    )

    camera5 = scenes.cam1(96, 54)
    cases["textured_spheres"] = (
        scenes.textured_spheres_scene(),
        camera5,
        RenderConfig(width=96, height=54, samples_per_pixel=8, max_depth=8),
    )

    # Corrected-jitter mode (shared_halton_jitter=False): pins the unified
    # per-pixel hash scramble (camera.generate_rays == wavefront jitter).
    from rt_tpu.config import CompatConfig

    cases["cover_scrambled"] = (
        scenes.cover_scene(3, 3, camera, z=-0.2, seed=0),
        camera,
        RenderConfig(
            width=96, height=54, samples_per_pixel=8, max_depth=12,
            compat=CompatConfig(shared_halton_jitter=False),
        ),
    )

    camera3 = scenes.widecam(96, 54)
    cases["earth"] = (
        scenes.earth_scene(),
        camera3,
        RenderConfig(width=96, height=54, samples_per_pixel=4, max_depth=8),
    )

    # Close-up: widecam is 18 units out and the scene is unit-sized.
    camera4 = make_camera(
        (2.5, 2.5, 1.5),
        (0.2, 0.2, 0.3),
        (0.0, 0.0, 1.0),
        focus_distance=3.5,
        defocus_angle=0.0,
        image_width=96,
        image_height=54,
        vertical_fov=40.0,
    )
    cases["triangles"] = (
        scenes.triangle_scene(),
        camera4,
        RenderConfig(width=96, height=54, samples_per_pixel=4, max_depth=8),
    )

    # --- round-3 additions: pin every production render path ----------

    # BVH mesh path (stackless traversal; ~4.6k-tri deterministic
    # procedural mesh through the real OBJ loader).
    import tempfile

    from tools.gen_fixtures import make_obj_mesh

    obj_path = os.path.join(tempfile.gettempdir(), "golden_mesh_r48.obj")
    if not os.path.exists(obj_path):
        make_obj_mesh(obj_path, res=48, seed=0)
    camera6 = make_camera(
        (5.5, -5.5, 2.2),
        (0.0, 0.0, 1.0),
        (0.0, 0.0, 1.0),
        focus_distance=8.0,
        defocus_angle=0.0,
        image_width=96,
        image_height=54,
        vertical_fov=32.0,
    )
    cases["mesh_bvh"] = (
        scenes.mesh_scene({"plaster": obj_path}),
        camera6,
        RenderConfig(width=96, height=54, samples_per_pixel=2, max_depth=6),
    )

    # Emissive area light (MAT_EMISSIVE extension; config-3 shape).
    cases["emissive_mesh"] = (
        scenes.mesh_with_area_light(obj_path),
        camera6,
        RenderConfig(width=96, height=54, samples_per_pixel=2, max_depth=6),
    )

    # Larger sphere field (~3,500 spheres, no BVH: the fast path's
    # brute-force intersection over every primitive).
    camera7 = scenes.cam1(64, 36)
    cases["cover_clustered"] = (
        scenes.cover_scene(30, 30, camera7, z=-0.2, seed=0),
        camera7,
        RenderConfig(width=64, height=36, samples_per_pixel=2, max_depth=8),
    )

    # Hosek-Wilkie sky as a full frame (reference-parity configuration).
    from rt_tpu.sky import SkyParams

    cases["hosek_sky"] = (
        scenes.gen_checkered().replace(sky=SkyParams.hosek_reference()),
        camera2,
        RenderConfig(width=96, height=54, samples_per_pixel=4, max_depth=8),
    )
    return cases


def render_case(scene, camera, cfg) -> np.ndarray:
    return np.asarray(render_pixel_colors(scene, camera, cfg))


def main():
    jax.config.update("jax_platforms", "cpu")
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, (scene, camera, cfg) in golden_cases().items():
        img = render_case(scene, camera, cfg)
        path = os.path.join(GOLDEN_DIR, f"{name}.png")
        write_png(path, img)
        print(f"wrote {path}  mean={img.mean():.4f}")


if __name__ == "__main__":
    main()
