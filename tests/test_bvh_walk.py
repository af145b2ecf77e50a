"""BVH structure from both builders, and the stackless walk against brute
force over every primitive."""

import numpy as np
import jax.numpy as jnp
import pytest

from rt_tpu.bvh import native
from rt_tpu.bvh.builder import LEAF_SIZE, _build_python
from rt_tpu.bvh.traverse import nearest_hit_bvh
from rt_tpu.config import CompatConfig
from rt_tpu.geometry import nearest_hit, nearest_hit_bruteforce
from rt_tpu.scene import SceneBuilder

BUILDERS = {
    "cpp": lambda mins, maxs: native.build(mins, maxs, LEAF_SIZE),
    "numpy": lambda mins, maxs: _build_python(mins, maxs, LEAF_SIZE),
}


def _bounds(rng, n=600):
    centers = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    half = rng.uniform(0.05, 0.6, (n, 3)).astype(np.float32)
    return centers - half, centers + half


def _subtree_end(hit_next, leaf_start, i):
    """One past the last node of node i's preorder subtree."""
    if leaf_start[i] >= 0:
        return i + 1
    left_end = _subtree_end(hit_next, leaf_start, i + 1)
    return _subtree_end(hit_next, leaf_start, left_end)


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_builder_invariants(rng, builder):
    """Every primitive sits in exactly one leaf, and every node's box bounds
    every primitive of its subtree."""
    if builder == "cpp":
        assert native.available(), "C++ builder failed to build"
    mins, maxs = _bounds(rng)
    node_min, node_max, hit_next, miss_next, leaf_start, leaf_count, order = BUILDERS[builder](
        mins, maxs
    )
    owner = np.full(len(mins), -1)
    for i in np.nonzero(leaf_start >= 0)[0]:
        prims = order[leaf_start[i] : leaf_start[i] + leaf_count[i]]
        assert (owner[prims] == -1).all(), "primitive in two leaves"
        owner[prims] = i
    assert (owner >= 0).all(), "primitive in no leaf"
    for i in range(len(hit_next)):
        end = _subtree_end(hit_next, leaf_start, i)
        leaves = [j for j in range(i, end) if leaf_start[j] >= 0]
        prims = np.concatenate(
            [order[leaf_start[j] : leaf_start[j] + leaf_count[j]] for j in leaves]
        )
        assert (node_min[i] <= mins[prims].min(axis=0) + 1e-6).all()
        assert (node_max[i] >= maxs[prims].max(axis=0) - 1e-6).all()


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_hit_miss_threading(rng, builder):
    """hit_next descends into the first child (or escapes past a leaf);
    miss_next skips the node's whole subtree; -1 ends the walk."""
    if builder == "cpp":
        assert native.available(), "C++ builder failed to build"
    _, _, hit_next, miss_next, leaf_start, _, _ = BUILDERS[builder](*_bounds(rng, 300))
    n = len(hit_next)
    for i in range(n):
        end = _subtree_end(hit_next, leaf_start, i)
        escape = end if end < n else -1
        assert miss_next[i] == escape
        assert hit_next[i] == (i + 1 if leaf_start[i] < 0 else escape)


def _scene(rng, n_spheres, n_tris, use_bvh):
    b = SceneBuilder()
    m = b.lambertian_rgb(0.5, 0.5, 0.5)
    for _ in range(n_spheres):
        b.add_sphere(rng.uniform(-6, 6, 3), rng.uniform(0.2, 0.9), m)
    for _ in range(n_tris):
        base = rng.uniform(-6, 6, 3)
        b.add_triangle(base, base + rng.normal(size=3), base + rng.normal(size=3), m)
    return b.build(use_bvh=use_bvh)


@pytest.mark.parametrize(
    "n_spheres,n_tris,cull",
    [(300, 0, True), (0, 300, True), (0, 300, False), (150, 150, True), (1, 0, True), (0, 1, False)],
    ids=["spheres", "triangles", "triangles_no_cull", "mixed", "one_sphere", "one_triangle"],
)
def test_walk_matches_bruteforce(rng, n_spheres, n_tris, cull):
    scene = _scene(np.random.default_rng(11), n_spheres, n_tris, use_bvh=True)
    assert scene.bvh is not None
    compat = CompatConfig(triangle_backface_cull=cull)
    n = 384
    org = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    aim = rng.uniform(-1, 1, (n, 3)).astype(np.float32)  # toward the scene
    dirn = (aim - org / 8 + 0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    args = (jnp.asarray(org), jnp.asarray(dirn), 1e-3, 1e9, compat)
    t_w, p_w = nearest_hit_bvh(scene, *args)
    t_b, p_b = nearest_hit_bruteforce(scene.replace(bvh=None), *args)
    t_w, t_b, p_w, p_b = map(np.asarray, (t_w, t_b, p_w, p_b))
    hit = t_b < 1e30
    assert hit.any()
    np.testing.assert_array_equal(p_w >= 0, hit)
    np.testing.assert_allclose(t_w[hit], t_b[hit], rtol=2e-4, atol=2e-4)
    assert (p_w[hit] == p_b[hit]).mean() > 0.99
    assert (t_w[~hit] >= 1e30).all()


def test_empty_scene_misses_everything(rng):
    """No primitives: build() makes no BVH and the query misses."""
    b = SceneBuilder()
    b.lambertian_rgb(0.5, 0.5, 0.5)
    scene = b.build(use_bvh=True)
    assert scene.bvh is None and scene.num_prims == 0
    org = jnp.asarray(rng.uniform(-3, 3, (64, 3)).astype(np.float32))
    dirn = jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32))
    rec = nearest_hit(scene, org, dirn, 1e-3, 1e9)
    assert not np.asarray(rec.hit).any()
    assert (np.asarray(rec.prim) == -1).all()
