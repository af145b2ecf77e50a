"""The fast path's brute-force intersection: the XLA rows against the
NumPy oracles transcribed from the reference (tests/oracles.py), the
parameter fetch against a plain gather, and the fused Triton kernel (in
interpret mode) against both."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rt_tpu import fast_shade, pallas_ops, scenes
from rt_tpu.config import CompatConfig
from rt_tpu.scene import SceneBuilder
from tests import oracles


def _rays(rng, n, spread=3.0):
    rays = np.zeros((8, n), np.float32)
    rays[0:3] = rng.uniform(-spread, spread, (3, n))
    rays[3:6] = rng.normal(size=(3, n))
    return rays


def _sphere_scene(rng, s=37):
    b = SceneBuilder()
    m = b.lambertian_rgb(0.5, 0.5, 0.5)
    for c, r in zip(rng.uniform(-4, 4, (s, 3)), rng.uniform(0.2, 1.5, s)):
        b.add_sphere(c, r, m)
    return b.build(use_bvh=False)


def test_sphere_rows_match_oracle(rng):
    scene = _sphere_scene(rng)
    rays = _rays(rng, 300)  # not a multiple of any block size
    t, idx = fast_shade.sphere_nearest_rows(scene, jnp.asarray(rays), 1e-3, 1e9)
    t, idx = np.asarray(t), np.asarray(idx)
    centers, radii = np.asarray(scene.sph_center), np.asarray(scene.sph_radius)
    for lane in range(rays.shape[1]):
        o, d = rays[0:3, lane].astype(np.float64), rays[3:6, lane].astype(np.float64)
        hits = [
            (th, k) for k in range(scene.num_spheres)
            if (th := oracles.sphere_hit_t(centers[k], radii[k], o, d, 1e-3, 1e9)) is not None
        ]
        if not hits:
            assert idx[lane] == -1 and t[lane] >= 1e30
            continue
        want_t, want_k = min(hits)
        np.testing.assert_allclose(t[lane], want_t, rtol=1e-4, atol=1e-5)
        # A different winner only on a near-tie.
        if idx[lane] != want_k:
            other = oracles.sphere_hit_t(centers[idx[lane]], radii[idx[lane]], o, d, 1e-3, 1e9)
            assert other is not None and abs(other - want_t) <= 1e-4 * want_t


def test_zero_radius_spheres_never_win():
    b = SceneBuilder()
    m = b.lambertian_rgb(0.5, 0.5, 0.5)
    b.add_sphere((0, 0, 2.0), 0.5, m)
    b.add_sphere((0, 0, 1.0), 0.0, m)
    scene = b.build(use_bvh=False)
    rays = np.zeros((8, 4), np.float32)
    rays[5] = 1.0
    t, idx = fast_shade.sphere_nearest_rows(scene, jnp.asarray(rays), 1e-3, 1e9)
    assert (np.asarray(idx) == 0).all()
    np.testing.assert_allclose(np.asarray(t), 1.5, rtol=1e-6)


@pytest.mark.parametrize("cull", [True, False])
def test_triangle_rows_match_oracle(rng, cull):
    b = SceneBuilder()
    m = b.lambertian_rgb(0.5, 0.5, 0.5)
    for _ in range(40):
        base = rng.uniform(-3, 3, 3)
        b.add_triangle(base, base + rng.normal(size=3), base + rng.normal(size=3), m)
    scene = b.build(use_bvh=False)
    rays = _rays(rng, 256)
    compat = CompatConfig(triangle_backface_cull=cull)
    t, idx = fast_shade.triangle_nearest_rows(scene, jnp.asarray(rays), 1e-3, 1e9, compat)
    t, idx = np.asarray(t), np.asarray(idx)
    tri = [np.asarray(getattr(scene, k), np.float64) for k in ("tri_a", "tri_b", "tri_c")]
    for lane in range(rays.shape[1]):
        o, d = rays[0:3, lane].astype(np.float64), rays[3:6, lane].astype(np.float64)
        best = None
        for k in range(scene.num_triangles):
            a, bb, c = tri[0][k], tri[1][k], tri[2][k]
            hit = oracles.triangle_hit(a, bb, c, o, d, 1e-3, 1e9)
            if hit is None and not cull:  # back face: the same triangle wound the other way
                hit = oracles.triangle_hit(a, c, bb, o, d, 1e-3, 1e9)
            if hit is not None and (best is None or hit[0] < best[0]):
                best = (hit[0], k)
        if best is None:
            assert t[lane] >= 1e30
        else:
            np.testing.assert_allclose(t[lane], best[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_spheres", [40, 2100])  # one-hot product / row gather
def test_fetch_params_equals_gather(rng, n_spheres):
    scene = _sphere_scene(rng, n_spheres)
    table = scene.shade_table
    prim = rng.integers(0, n_spheres, 512).astype(np.int32)
    got = np.asarray(fast_shade.fetch_params(table, jnp.asarray(prim)))
    np.testing.assert_array_equal(got, np.asarray(table)[:, prim])


@pytest.mark.parametrize("cull", [True, False])
def test_fused_kernel_matches_rows_interpret(rng, cull):
    """The Triton kernel run by the Pallas interpreter: same winners as the
    XLA rows, t to rounding, and the fetched columns equal a gather."""
    camera = scenes.cam1(32, 24)
    scene = scenes.cover_scene(8, 8, camera, z=-0.2, seed=0)
    assert scene.num_triangles > 0 and scene.num_spheres > pallas_ops.PRIM_CHUNK
    rays = jnp.asarray(_rays(rng, 512))
    compat = CompatConfig(triangle_backface_cull=cull)
    t_k, p_k, params = pallas_ops.prim_nearest_shaded(
        rays, scene.sph_center, scene.sph_radius,
        scene.tri_a, scene.tri_b, scene.tri_c, scene.shade_table,
        num_spheres=scene.num_spheres, num_triangles=scene.num_triangles,
        t_min=1e-3, t_max=3.0e38, backface_cull=cull, interpret=True,
    )
    t_x, p_x = fast_shade.nearest_rows(scene, rays, 1e-3, 3.0e38, compat)
    t_k, p_k, t_x, p_x = map(np.asarray, (t_k, p_k, t_x, p_x))
    np.testing.assert_array_equal(p_k, p_x)
    hit = p_x >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(t_k[hit], t_x[hit], rtol=1e-4)
    assert (t_k[~hit] >= 1e30).all()
    np.testing.assert_array_equal(
        np.asarray(params), np.asarray(scene.shade_table)[:, np.maximum(p_k, 0)]
    )


def test_kernel_rejects_ragged_ray_count(rng):
    scene = _sphere_scene(rng)
    with pytest.raises(ValueError, match="multiple"):
        pallas_ops.prim_nearest_shaded(
            jnp.asarray(_rays(rng, 100)), scene.sph_center, scene.sph_radius,
            scene.tri_a, scene.tri_b, scene.tri_c, scene.shade_table,
            num_spheres=scene.num_spheres, num_triangles=0,
            t_min=1e-3, t_max=1e9, interpret=True,
        )


def test_nearest_shaded_uses_rows_on_cpu(rng):
    """The CPU takes the XLA rows and leaves the fetch to shading."""
    scene = _sphere_scene(rng)
    rays = jnp.asarray(_rays(rng, 256))
    t, prim, params = pallas_ops.nearest_shaded(scene, rays, 1e-3, 1e9, CompatConfig())
    t_x, p_x = fast_shade.nearest_rows(scene, rays, 1e-3, 1e9, CompatConfig())
    assert params is None
    np.testing.assert_array_equal(np.asarray(prim), np.asarray(p_x))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t_x))


def test_fused_kernel_under_shard_map(rng):
    """The kernel inside shard_map, as parallel.render_sharded_wavefront
    calls it (check_vma off: pallas_call outputs carry no varying-axes
    annotation): each shard's result equals the unsharded one."""
    from jax.sharding import PartitionSpec as P

    from rt_tpu.parallel import make_mesh

    scene = _sphere_scene(rng)
    rays = jnp.asarray(_rays(rng, 512))
    kernel = lambda r: pallas_ops.prim_nearest_shaded(
        r, scene.sph_center, scene.sph_radius,
        scene.tri_a, scene.tri_b, scene.tri_c, scene.shade_table,
        num_spheres=scene.num_spheres, num_triangles=0,
        t_min=1e-3, t_max=1e9, interpret=True,
    )
    sharded = jax.shard_map(
        kernel, mesh=make_mesh(2, tiles=2),
        in_specs=P(None, ("tiles", "spp")),
        out_specs=(P(("tiles", "spp")), P(("tiles", "spp")), P(None, ("tiles", "spp"))),
        check_vma=False,
    )
    for got, want in zip(jax.jit(sharded)(rays), kernel(rays)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
