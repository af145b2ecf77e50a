"""BVH-routed renders vs brute-force renders of the same scene.

``render_wavefront`` sends a scene with a BVH through the generic wavefront
and the stackless per-ray walk (bvh/traverse.py), and a BVH-less one
through the fast path's brute-force intersection; building the same scene
with ``use_bvh=True`` and ``False`` therefore compares the two device
paths.  They share RNG streams, so pixels agree up to f32 rounding, with a
small fraction of decorrelated outliers allowed (see
test_fast_generic_parity.py).  Reference anchor for the walk:
hittable.rs:135-149.
"""

import numpy as np
import jax
import jax.numpy as jnp

from rt_tpu import wavefront
from rt_tpu.bvh.traverse import nearest_hit_bvh
from rt_tpu.camera import make_camera
from rt_tpu.config import CompatConfig, RenderConfig
from rt_tpu.geometry import nearest_hit_bruteforce
from rt_tpu.scene import SceneBuilder
from rt_tpu.sky import SkyParams
from rt_tpu.wavefront import render_wavefront

W, H = 32, 24


def _camera():
    return make_camera(
        (6, 0, 2), (0, 0, 1), (0, 0, 1), focus_distance=6.0,
        defocus_angle=0.0, image_width=W, image_height=H, vertical_fov=30.0,
    )


def _render(scene, cfg, spp=2, offset=0, pool_size=1 << 16):
    pix = jnp.arange(W * H, dtype=jnp.int32)
    key = jax.random.key(cfg.seed)
    return np.asarray(
        render_wavefront(
            scene, _camera(), pix, cfg, spp, jnp.int32(offset), key, pool_size
        )
    )


def _compare(make_scene, cfg, spp=2, outlier_frac=0.01):
    with_bvh, brute = make_scene(True), make_scene(False)
    assert with_bvh.bvh is not None and brute.bvh is None
    got, ref = _render(with_bvh, cfg, spp), _render(brute, cfg, spp)
    assert np.isfinite(got).all() and got.max() > 0.0
    err = np.abs(got - ref) - (2e-3 + 1e-3 * np.abs(ref))
    bad = (err > 0).any(axis=-1)
    assert bad.mean() <= outlier_frac, (
        f"{int(bad.sum())}/{bad.size} pixels differ "
        f"(max abs diff {np.abs(got - ref).max():.4g})"
    )
    assert abs(got.mean() - ref.mean()) < 5e-3


def _tri_cloud(n_tris=150, with_materials=True, seed=0):
    def make(use_bvh):
        rng = np.random.default_rng(seed)
        b = SceneBuilder()
        b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
        mats = [b.metal(b.solid_color((0.8, 0.7, 0.6)), fuzz=0.1)]
        if with_materials:
            mats += [
                b.lambertian(b.checker(
                    0.5, b.solid_color((0.1, 0.2, 0.3)), b.solid_color((0.9, 0.9, 0.8))
                )),
                b.dielectric(1.5),
                b.emissive((2.0, 1.5, 1.0)),
            ]
        for i in range(n_tris):
            c = rng.uniform(-3, 3, 3)
            c[2] = rng.uniform(0.2, 2.0)
            d1, d2 = rng.uniform(-0.3, 0.3, 3), rng.uniform(-0.3, 0.3, 3)
            b.add_triangle(tuple(c), tuple(c + d1), tuple(c + d2), mats[i % len(mats)])
        b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color((0.8, 0.2, 0.1))))
        return b.build(sky=SkyParams.default(), use_bvh=use_bvh)

    return make


def _shell(n_seg, radius=1.4, use_bvh=True):
    """A closed triangulated sphere shell on a ground: bounce rays inside
    the shell cross it at grazing angles."""
    b = SceneBuilder()
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.6, 0.6, 0.5))))
    mat = b.lambertian(b.solid_color((0.7, 0.4, 0.3)))
    met = b.metal(b.solid_color((0.8, 0.8, 0.9)), fuzz=0.05)

    def pt(th, ph):
        return (
            radius * np.sin(th) * np.cos(ph),
            radius * np.sin(th) * np.sin(ph),
            1.0 + radius * np.cos(th),
        )

    for i in range(n_seg):
        th0, th1 = np.pi * i / n_seg, np.pi * (i + 1) / n_seg
        for j in range(2 * n_seg):
            ph0, ph1 = np.pi * j / n_seg, np.pi * (j + 1) / n_seg
            m = mat if (i + j) % 2 else met
            b.add_triangle(pt(th0, ph0), pt(th1, ph0), pt(th1, ph1), m)
            b.add_triangle(pt(th0, ph0), pt(th1, ph1), pt(th0, ph1), m)
    return b.build(sky=SkyParams.default(), use_bvh=use_bvh)


def test_triangle_cloud():
    _compare(_tri_cloud(with_materials=False), RenderConfig(width=W, height=H, max_depth=6))


def test_all_materials_and_emissive():
    _compare(_tri_cloud(n_tris=140, seed=3), RenderConfig(width=W, height=H, max_depth=6))


def test_many_spheres():
    """>2048 small spheres: a deep sphere-only tree.  Thousands of tiny
    silhouettes put more rays on edges, so more paths decorrelate."""

    def make(use_bvh):
        rng = np.random.default_rng(1)
        b = SceneBuilder()
        g = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
        b.add_sphere((0, 0, -1000), 1000, g)
        for _ in range(2100):
            c = rng.uniform(-8, 8, 3)
            c[2] = rng.uniform(0.1, 1.5)
            b.add_sphere(tuple(c), 0.08, g)
        return b.build(sky=SkyParams.default(), use_bvh=use_bvh)

    _compare(make, RenderConfig(width=W, height=H, max_depth=4), spp=1, outlier_frac=0.02)


def test_image_textured_triangles():
    def make(use_bvh):
        rng = np.random.default_rng(7)
        b = SceneBuilder()
        b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
        img = rng.uniform(0.1, 1.0, (16, 16, 3)).astype(np.float32)
        mat = b.metal(b.image_texture(img), fuzz=0.05)
        for _ in range(140):
            c = rng.uniform(-3, 3, 3)
            c[2] = rng.uniform(0.2, 2.0)
            d1, d2 = rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.4, 0.4, 3)
            uv = rng.uniform(0, 1, (3, 2))
            b.add_triangle(
                tuple(c), tuple(c + d1), tuple(c + d2), mat,
                uv_a=tuple(uv[0]), uv_b=tuple(uv[1]), uv_c=tuple(uv[2]),
            )
        return b.build(sky=SkyParams.default(), use_bvh=use_bvh)

    _compare(make, RenderConfig(width=W, height=H, max_depth=6))


def test_mixed_spheres_and_triangles():
    def make(use_bvh):
        rng = np.random.default_rng(0)
        b = SceneBuilder()
        b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
        mats = [
            b.metal(b.solid_color((0.8, 0.7, 0.6)), fuzz=0.1),
            b.lambertian(b.solid_color((0.2, 0.5, 0.7))),
            b.dielectric(1.5),
            b.emissive((1.5, 1.2, 1.0)),
        ]
        for i in range(140):
            c = rng.uniform(-3, 3, 3)
            c[2] = rng.uniform(0.2, 2.0)
            d1, d2 = rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.4, 0.4, 3)
            b.add_triangle(tuple(c), tuple(c + d1), tuple(c + d2), mats[i % 4])
        for i in range(60):
            c = rng.uniform(-3, 3, 3)
            c[2] = rng.uniform(0.2, 1.5)
            b.add_sphere(tuple(c), rng.uniform(0.05, 0.25), mats[i % 3])
        return b.build(sky=SkyParams.default(), use_bvh=use_bvh)

    _compare(make, RenderConfig(width=W, height=H, max_depth=6))


def test_closed_shell():
    _compare(
        lambda use_bvh: _shell(10, use_bvh=use_bvh),
        RenderConfig(width=W, height=H, max_depth=6),
    )


def test_closed_shell_grazing_rays_nearest_hit():
    """Rays from inside a closed shell, nearly tangent to it: the walk
    finds the same nearest triangle as brute force over every triangle.
    The two evaluate Möller–Trumbore on differently shaped arrays, and at
    grazing incidence the small determinant amplifies their rounding, so
    t is compared to 1e-2 relative."""
    scene = _shell(24)
    rng = np.random.default_rng(5)
    n = 512
    org = np.zeros((n, 3), np.float32)
    org[:, 2] = 1.0
    org += rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32) * np.array([1, 1, 0.9], np.float32)
    radial = org - np.array([0, 0, 1.0], np.float32)
    tangent = np.cross(radial, rng.normal(size=(n, 3)).astype(np.float32))
    dirn = (tangent + 0.02 * radial).astype(np.float32)
    for compat in (CompatConfig(), CompatConfig(triangle_backface_cull=False)):
        t_w, p_w = nearest_hit_bvh(scene, jnp.asarray(org), jnp.asarray(dirn), 1e-3, 1e9, compat)
        t_b, p_b = nearest_hit_bruteforce(
            scene.replace(bvh=None), jnp.asarray(org), jnp.asarray(dirn), 1e-3, 1e9, compat
        )
        t_w, t_b = np.asarray(t_w), np.asarray(t_b)
        hit = t_b < 1e30
        np.testing.assert_array_equal(np.asarray(p_w) >= 0, hit)
        assert (np.asarray(p_w) == np.asarray(p_b)).mean() > 0.99
        np.testing.assert_allclose(t_w[hit], t_b[hit], rtol=1e-2)


def test_sample_offset_chunks_match_monolithic():
    """Progressive accumulation semantics hold on the BVH route: two
    2-spp chunks at offsets 0 and 2 average to the 4-spp render."""
    scene = _tri_cloud(n_tris=135, with_materials=False)(True)
    cfg = RenderConfig(width=W, height=H, max_depth=6)
    mono = _render(scene, cfg, spp=4)
    parts = [_render(scene, cfg, spp=2, offset=off) for off in (0, 2)]
    np.testing.assert_allclose((parts[0] + parts[1]) / 2, mono, atol=1e-5)


def test_pool_size_invariance_with_bvh():
    """Lane order and pool size do not enter the RNG keys, so the BVH
    route renders the same image from a small or a large pool."""
    scene = _tri_cloud(with_materials=False)(True)
    cfg = RenderConfig(width=W, height=H, max_depth=5)
    small = _render(scene, cfg, pool_size=256)
    large = _render(scene, cfg)
    np.testing.assert_allclose(small, large, atol=2e-5)


def test_routing_on_bvh(monkeypatch):
    """A scene with a BVH never takes the fast path; one without takes it."""
    with_bvh = _tri_cloud(with_materials=False)(True)
    brute = _tri_cloud(with_materials=False)(False)
    cfg = RenderConfig(width=8, height=8, max_depth=2)
    calls = []

    def spy(name, impl):
        def run(*args):
            calls.append(name)
            return impl(*args)

        return run

    monkeypatch.setattr(wavefront, "_render_fast", spy("fast", wavefront._render_fast))
    monkeypatch.setattr(wavefront, "_render_generic", spy("generic", wavefront._render_generic))
    pix = jnp.arange(64, dtype=jnp.int32)
    key = jax.random.key(0)
    render_wavefront(with_bvh, _camera(), pix, cfg, 1, jnp.int32(0), key)
    render_wavefront(brute, _camera(), pix, cfg, 1, jnp.int32(0), key)
    assert calls == ["generic", "fast"]
