"""Fast wavefront (_render_fast, the BVH-less device path) vs the generic
wavefront (_render_generic, the readable correctness reference).

Both consume the same hash-RNG streams keyed on the global (sample,
pixel) id, so they agree pixel for pixel up to f32 rounding; a rounding
difference can flip one Russian-roulette or reflect/refract decision and
decorrelate that one path, so a small fraction of outlier pixels is
allowed and the image means must agree tightly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rt_tpu import scenes
from rt_tpu.camera import make_camera
from rt_tpu.config import CompatConfig, RenderConfig
from rt_tpu.scene import SceneBuilder
from rt_tpu.sky import SkyParams
from rt_tpu.wavefront import _render_fast, _render_generic

W, H = 32, 24


def _camera(defocus=0.0):
    return make_camera(
        (6, 0, 2), (0, 0, 1), (0, 0, 1), focus_distance=6.0,
        defocus_angle=defocus, image_width=W, image_height=H, vertical_fov=30.0,
    )


def _compare(scene, camera, cfg, spp=2, pix=None, offset=0, outlier_frac=0.01):
    assert scene.bvh is None and scene.shade_table is not None
    key = jax.random.key(cfg.seed)
    if pix is None:
        pix = jnp.arange(camera.image_width * camera.image_height, dtype=jnp.int32)
    args = (scene, camera, pix, cfg, spp, jnp.int32(offset), key)
    fast = np.asarray(_render_fast(*args))
    ref = np.asarray(_render_generic(*args))
    assert np.isfinite(fast).all() and fast.max() > 0.0
    err = np.abs(fast - ref) - (1e-3 + 1e-3 * np.abs(ref))
    bad = (err > 0).any(axis=-1)
    assert bad.mean() <= outlier_frac, f"{int(bad.sum())}/{bad.size} pixels differ"
    assert abs(fast.mean() - ref.mean()) < 5e-3


def _simple(mat_fn):
    b = SceneBuilder()
    g = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, -1000), 1000, g)
    mat_fn(b)
    return b.build(sky=SkyParams.default(), use_bvh=False)


def _sphere(rgb):
    return lambda b: b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color(rgb)))


@pytest.mark.parametrize(
    "name,mat_fn",
    [
        ("lambertian", _sphere((0.8, 0.2, 0.1))),
        ("metal", lambda b: b.add_sphere((0, 0, 1), 1, b.metal(b.solid_color((0.8, 0.7, 0.6)), fuzz=0.2))),
        ("dielectric", lambda b: b.add_sphere((0, 0, 1), 1, b.dielectric(1.5))),
        ("emissive", lambda b: b.add_sphere((0, 0, 1), 1, b.emissive((3.0, 2.0, 1.0)))),
        ("triangle", lambda b: b.add_triangle((-1, -1, 0.5), (2, -1, 0.5), (0, 1, 2.5), b.lambertian(b.solid_color((0.2, 0.4, 0.8))))),
    ],
)
def test_fast_matches_generic(name, mat_fn):
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=8)
    _compare(_simple(mat_fn), _camera(), cfg)


def test_defocus_camera():
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=8)
    _compare(_simple(_sphere((0.7, 0.3, 0.2))), _camera(defocus=0.6), cfg)


def test_cover_scene_with_image_texture():
    """The bench configuration in miniature: checker ground triangles,
    glass/metal/textured big spheres, image-atlas fetch."""
    camera = scenes.cam1(W, H)
    scene = scenes.cover_scene(4, 4, camera, z=-0.2, seed=0)
    assert scene.has_image_textures
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=12)
    _compare(scene, camera, cfg)


def test_scrambled_jitter_mode():
    """shared_halton_jitter=False (the moire fix) uses the same per-pixel
    hash scramble on both paths."""
    cfg = RenderConfig(
        width=W, height=H, samples_per_pixel=2, max_depth=8,
        compat=CompatConfig(shared_halton_jitter=False),
    )
    _compare(_simple(_sphere((0.6, 0.6, 0.2))), _camera(), cfg)


def test_quirk_sky():
    scene = _simple(_sphere((0.6, 0.2, 0.6)))
    scene = scene.replace(sky=scene.sky.replace(cos_gamma_as_angle=True))
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=8)
    _compare(scene, _camera(), cfg)


def test_sample_offset_and_pixel_subset():
    """A nonzero sample offset and a pixel subset (the lower half of the
    frame): both paths key their streams on the global (sample, pixel)."""
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=8)
    pix = jnp.arange(W * H // 2, W * H, dtype=jnp.int32)
    _compare(_simple(_sphere((0.3, 0.5, 0.7))), _camera(), cfg, pix=pix, offset=3)


def test_hosek_sky():
    scene = _simple(_sphere((0.5, 0.4, 0.3))).replace(sky=SkyParams.hosek_reference())
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=8)
    _compare(scene, _camera(), cfg)
