"""Wavefront path-tracing integrator.

The reference integrator is a recursive per-ray function (camera.rs:296-313):
nearest hit in [0.001, t_max) -> scatter -> Russian roulette at every depth
with p = max(attenuation channel) and survivor scaled 1/p (camera.rs:280-293)
-> recurse to max_depth=100; miss -> sky; absorb -> black.

Batched inversion: a per-ray recursion does not batch.  The integrator
here advances a SoA megabatch of rays (origin, direction, throughput,
radiance, alive) through a bounded ``lax.while_loop`` (forward) or
fixed-length ``lax.scan`` (differentiable) with masked termination:

  radiance_i = sum over bounces of [throughput * sky on the miss bounce]
  throughput *= attenuation / p   (Russian-roulette-scaled, masked)

Semantics parity with raycast(depth):
- depth d hit with d == max_depth  -> absorbed black (no recursion allowed):
  here rays alive after the final iteration simply contribute nothing.
- RR applies at *every* bounce including the first (camera.rs:300-304).
- The miss branch normalizes the direction before the sky lookup
  (camera.rs:310-311).

Safety divergence: the reference panics when an attenuation channel exceeds
1 (gen_bool(p > 1), camera.rs:288); rt_tpu clamps p into (0, rr_clamp].

f32 robustness (the reference demonstrated f32 shadow acne and hides behind
f64, TODO.md:38-40): bounce origins are offset from the hit point along the
geometric normal, signed toward the outgoing hemisphere, scaled by local
magnitude — in addition to the reference's t_min=1e-3 epsilon.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rt_tpu import materials, sky
from rt_tpu.config import RenderConfig
from rt_tpu.geometry import nearest_hit
from rt_tpu.scene import SceneData


def _bounce_step(
    scene: SceneData, cfg: RenderConfig, state, bounce_key, depth, impl="auto"
):
    """One wavefront bounce: intersect, accumulate sky on miss, scatter +
    Russian roulette on hit.  Pure function of (state, key, depth)."""
    org, dirn, throughput, radiance, alive = state

    rec = nearest_hit(scene, org, dirn, cfg.t_min, cfg.t_max, cfg.compat, impl=impl)

    # Miss -> sky (camera.rs:308-312).
    unit_dir = dirn / jnp.maximum(jnp.linalg.norm(dirn, axis=-1, keepdims=True), 1e-20)
    sky_rgb = sky.sky_color_toward(scene.sky, unit_dir)
    miss = alive & ~rec.hit
    radiance = radiance + jnp.where(miss[:, None], throughput * sky_rgb, 0.0)

    # Emissive hit -> deposit and terminate (extension; MAT_EMISSIVE).
    mat_id = jnp.clip(rec.material, 0, scene.mat_kind.shape[0] - 1)
    is_emissive = scene.mat_kind[mat_id] == 3
    from rt_tpu.textures import texture_value

    emit_rgb = texture_value(scene, scene.mat_texture[mat_id], rec.uv, rec.point)
    emit_hit = alive & rec.hit & is_emissive
    radiance = radiance + jnp.where(emit_hit[:, None], throughput * emit_rgb, 0.0)

    # Hit -> scatter + RR (camera.rs:298-304, 280-293).
    attenuation, new_dir = materials.scatter(scene, rec, dirn, bounce_key, cfg.compat)
    p = jnp.clip(jnp.max(attenuation, axis=-1), 0.0, cfg.compat.rr_clamp)
    if cfg.detach_sampling:
        p = jax.lax.stop_gradient(p)
    u = jax.random.uniform(jax.random.fold_in(bounce_key, 0x52), p.shape, jnp.float32)
    survive = u < p  # gen_bool(p) equivalent
    can_continue = depth < cfg.max_depth  # camera.rs:300
    cont = alive & rec.hit & survive & can_continue & ~is_emissive

    throughput = jnp.where(
        cont[:, None], throughput * attenuation / jnp.maximum(p, 1e-12)[:, None], throughput
    )

    # Scale-aware origin offset along the outgoing side of the surface.
    point_scale = jnp.maximum(jnp.max(jnp.abs(rec.point), axis=-1, keepdims=True), 1.0)
    side = jnp.sign(jnp.sum(new_dir * rec.normal, axis=-1, keepdims=True))
    new_org = rec.point + cfg.origin_offset * point_scale * side * rec.normal

    org = jnp.where(cont[:, None], new_org, org)
    dirn = jnp.where(cont[:, None], new_dir, dirn)
    return org, dirn, throughput, radiance, cont


def trace_radiance(
    scene: SceneData,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    key: jax.Array,
    cfg: RenderConfig,
) -> jnp.ndarray:
    """Forward radiance for a ray megabatch: f32[N,3].

    Bounded ``lax.while_loop`` over bounces with early exit once every ray
    has retired — the device-friendly replacement for the reference's
    recursion (camera.rs:296-313).  Forward-only (not differentiable);
    gradients use :func:`trace_radiance_diff`.
    """
    if scene.bvh is None and scene.shade_table is not None:
        # Fast-shade machinery (shared with trace_radiance_diff so the two
        # integrators agree bit-for-bit at equal depth: same keys, same
        # math), with the while_loop's early exit once every ray retires.
        step, init = _fast_trace_setup(scene, origins, directions, key, cfg)

        def cond(carry):
            depth, state = carry
            return (depth <= cfg.max_depth) & jnp.any(state[3])

        def body(carry):
            depth, state = carry
            return depth + 1, step(state, depth, cfg.max_depth)

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), init))
        return state[2].T
    n = origins.shape[0]
    state = (
        origins,
        directions,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n,), bool),
    )

    def cond(carry):
        depth, state = carry
        return (depth <= cfg.max_depth) & jnp.any(state[4])

    def body(carry):
        depth, state = carry
        bounce_key = jax.random.fold_in(key, depth)
        return depth + 1, _bounce_step(scene, cfg, state, bounce_key, depth)

    _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    return state[3]


def trace_radiance_diff(
    scene: SceneData,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    key: jax.Array,
    cfg: RenderConfig,
) -> jnp.ndarray:
    """Differentiable radiance: fixed ``cfg.diff_max_depth``-length
    ``lax.scan`` (reverse-mode AD needs a static trip count), each bounce
    rematerialized (``jax.checkpoint``) so residual memory stays O(state)
    instead of O(state * bounces).

    Discrete events (hit ids, RR survival, reflect-vs-refract) follow the
    detached-sampling / path-replay convention: decisions are made with
    stop_gradient'd quantities while the continuous factors (attenuation,
    sky params, refraction directions) carry gradients.
    """
    if scene.bvh is None and scene.shade_table is not None:
        return _trace_radiance_diff_fast(scene, origins, directions, key, cfg)
    n = origins.shape[0]
    init = (
        origins,
        directions,
        jnp.ones((n, 3), jnp.float32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.ones((n,), bool),
    )
    diff_cfg = cfg.replace(max_depth=cfg.diff_max_depth)

    @jax.checkpoint
    def step(state, depth):
        bounce_key = jax.random.fold_in(key, depth)
        # "detached" runs the winner search under stop_gradient
        # (geometry.nearest_hit), so the backward pass never keeps the
        # O(N*P) brute-force candidate tensors.
        return (
            _bounce_step(scene, diff_cfg, state, bounce_key, depth, impl="detached"),
            None,
        )

    state, _ = jax.lax.scan(step, init, jnp.arange(cfg.diff_max_depth + 1))
    return state[3]


def _trace_radiance_diff_fast(
    scene: SceneData,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    key: jax.Array,
    cfg: RenderConfig,
) -> jnp.ndarray:
    """Differentiable radiance on the fast-shade machinery: detached
    winner search (geometry.nearest_search_detached) + differentiable
    winner-t recompute + ONE one-hot parameter-fetch matmul per bounce
    over a differentiably re-assembled shade table
    (fast_shade.build_shade_table_diff) — replacing the megabatch path's
    ~10 XLA gathers per bounce, which dominated the backward-pass time.

    Draw streams use the wavefront's hash RNG (rng.py) keyed from
    ``key``, so this path is deterministic per (key, lane, depth) but not
    bit-identical to the megabatch scatter's jax.random draws (the
    integrators already differ by design, ROADMAP 'quirk decisions')."""
    step, init = _fast_trace_setup(scene, origins, directions, key, cfg)

    @jax.checkpoint
    def scan_step(state, depth):
        return step(state, depth, cfg.diff_max_depth), None

    state, _ = jax.lax.scan(scan_step, init, jnp.arange(cfg.diff_max_depth + 1))
    return state[2].T


def _fast_trace_setup(scene, origins, directions, key, cfg):
    """Shared bounce step + initial state for the fast-shade integrators:
    detached winner search + differentiable winner-t
    recompute + one one-hot parameter-fetch matmul per bounce over the
    differentiably re-assembled shade table.  Both trace_radiance (early
    -exit while_loop) and trace_radiance_diff (checkpointed scan) drive
    this step, so the two integrators agree at equal depth."""
    from rt_tpu import fast_shade
    from rt_tpu.geometry import nearest_search_detached
    from rt_tpu.wavefront import _seed_from_key

    n = origins.shape[0]
    table = fast_shade.build_shade_table_diff(scene)
    seed = _seed_from_key(key)
    work = jnp.arange(n, dtype=jnp.int32)
    z = jnp.zeros((n,), jnp.float32)
    rays0 = jnp.stack(
        [
            origins[:, 0], origins[:, 1], origins[:, 2],
            directions[:, 0], directions[:, 1], directions[:, 2],
            z, z,
        ],
        axis=0,
    )
    init = (
        rays0,
        jnp.ones((3, n), jnp.float32),  # throughput rows
        jnp.zeros((3, n), jnp.float32),  # radiance rows
        jnp.ones((n,), bool),
    )

    def step(state, depth, max_depth):
        rays, tp, rad, alive = state
        org = rays[0:3].T
        dirn = rays[3:6].T
        t, prim = nearest_search_detached(
            scene, org, dirn, cfg.t_min, cfg.t_max, cfg.compat
        )
        out = fast_shade.shade_bounce(
            scene, rays, t, prim, seed, work, depth, cfg, table=table
        )
        miss = alive & ~out["hit"]
        emis = alive & out["hit"] & out["emissive"]
        cont = (
            alive & out["hit"] & out["survive"] & (depth < max_depth) & ~out["emissive"]
        )
        sky_rows = jnp.stack(out["sky"], axis=0)
        emit_rows = jnp.stack(out["emit"], axis=0)
        rad = rad + jnp.where(miss[None, :], tp * sky_rows, 0.0)
        rad = rad + jnp.where(emis[None, :], tp * emit_rows, 0.0)
        att_rows = jnp.stack(out["att"], axis=0)  # attenuation * 1/p_rr
        tp = jnp.where(cont[None, :], tp * att_rows, tp)
        rays = jnp.where(cont[None, :], out["new_rays"], rays)
        return (rays, tp, rad, cont)

    return step, init
