"""Distributed-behavior tests on a simulated 8-device CPU mesh
(SURVEY.md §4: the analog of multi-node-without-a-cluster)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rt_tpu import scenes
from rt_tpu.config import RenderConfig
from rt_tpu.parallel import make_mesh, render_sharded, train_step_sharded
from rt_tpu.render import render_pixel_colors


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    camera = scenes.cam1(32, 16)
    scene = scenes.cover_scene(2, 2, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=32, height=16, samples_per_pixel=2, max_depth=6, diff_max_depth=3)
    return scene, camera, cfg


def test_sharded_render_matches_single_device(setup):
    """Tile-sharded render == single-device render bit-for-bit (same keys):
    sharding must be a pure layout decision."""
    scene, camera, cfg = setup
    mesh = make_mesh(8, tiles=8)
    sharded = np.asarray(render_sharded(scene, camera, cfg, mesh, spp=2))
    mesh1 = make_mesh(1, tiles=1)
    single = np.asarray(render_sharded(scene, camera, cfg, mesh1, spp=2))
    np.testing.assert_array_equal(sharded, single)


def test_sharded_render_2d_mesh(setup):
    """(4 tiles x 2 spp-shards) mesh: sample axis contraction crosses
    devices (psum) and must still equal the single-device result."""
    scene, camera, cfg = setup
    mesh = make_mesh(8, tiles=4)
    sharded = np.asarray(render_sharded(scene, camera, cfg, mesh, spp=2))
    mesh1 = make_mesh(1, tiles=1)
    single = np.asarray(render_sharded(scene, camera, cfg, mesh1, spp=2))
    np.testing.assert_allclose(sharded, single, atol=1e-6)


def test_train_step_sharded_runs_and_reduces(setup):
    scene, camera, cfg = setup
    mesh = make_mesh(8, tiles=4)
    n_pixels = 32 * 16
    pixel_idx = np.arange(n_pixels, dtype=np.int32)
    target = np.zeros((n_pixels, 3), np.float32)
    loss, new_scene = train_step_sharded(
        scene, camera, cfg, mesh, pixel_idx, target, spp=2, lr=0.1
    )
    assert np.isfinite(float(loss))
    # A step toward a black target must darken texture colors.
    assert float(jnp.sum(new_scene.tex_color)) < float(jnp.sum(scene.tex_color))


def test_train_step_grads_match_single_device(setup):
    """Parameter update from the 8-device sharded step equals the
    1-device step (collectives must not change the math)."""
    scene, camera, cfg = setup
    n_pixels = 32 * 16
    pixel_idx = np.arange(n_pixels, dtype=np.int32)
    target = np.zeros((n_pixels, 3), np.float32)
    _, s8 = train_step_sharded(
        scene, camera, cfg, make_mesh(8, tiles=8), pixel_idx, target, spp=1, lr=0.1
    )
    _, s1 = train_step_sharded(
        scene, camera, cfg, make_mesh(1, tiles=1), pixel_idx, target, spp=1, lr=0.1
    )
    np.testing.assert_allclose(
        np.asarray(s8.tex_color), np.asarray(s1.tex_color), atol=1e-6
    )


def test_graft_dryrun_multichip():
    """The driver's multichip dryrun contract must hold on 8 devices."""
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_graft_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    out = jax.block_until_ready(out)
    assert np.all(np.isfinite(np.asarray(out)))


def test_sharded_wavefront_bit_identical(setup):
    """The production wavefront under shard_map: 8-device render must be
    bit-identical to 1-device (RNG keys on global (sample, pixel))."""
    from rt_tpu.parallel import render_sharded_wavefront

    scene, camera, cfg = setup
    img8 = np.asarray(
        render_sharded_wavefront(scene, camera, cfg, make_mesh(8, tiles=8), spp=2)
    )
    img1 = np.asarray(
        render_sharded_wavefront(scene, camera, cfg, make_mesh(1, tiles=1), spp=2)
    )
    np.testing.assert_array_equal(img8, img1)
    # And it matches the plain single-device wavefront render.
    from rt_tpu.render import render_pixel_colors

    direct = np.asarray(render_pixel_colors(scene, camera, cfg, spp=2))
    np.testing.assert_allclose(img1, direct, atol=1e-6)
