"""Persistent-wavefront integrator with ray regeneration.

The naive wavefront (integrator.py) advances one megabatch of rays through
the bounce loop and pays full cost per iteration even when most lanes have
retired — and dielectric lanes (attenuation (1,1,1) => RR p=1,
material.rs:174-177) never retire early, so the loop runs to max_depth with
~1-5% occupancy.  This module is the fix, the classic "persistent
threads" wavefront:

- a fixed-size ray *pool* (static shape B) holds in-flight path segments;
- each ``lax.while_loop`` iteration advances every active lane one bounce;
- lanes that retire (miss -> sky contribution, absorb, RR kill) immediately
  *regenerate*: they claim the next (pixel, sample) work item from a global
  counter, emit a fresh camera ray, and keep the pool full;
- contributions land in a per-work-item buffer via unique-index scatter
  (radiance materializes exactly once per path — at the sky miss), and the
  pixel/sample mean is a dense reduction at the end.

Two implementations share that skeleton, and ``render_wavefront`` routes
on whether the scene has a BVH:

- the **fast path** (``_render_fast``, BVH-less scenes): ray state packed
  as f32[8, B] component rows, brute-force intersection over every
  primitive with the winner's shading parameters fetched in the same step
  (pallas_ops.nearest_shaded), then scalarized shading (fast_shade.py);
- the **generic path** (``_render_generic``): [B,3] arrays and the
  readable geometry/materials modules, with the stackless per-ray BVH walk
  (bvh/traverse.py) for scenes that have a BVH; it handles every scene
  and doubles as the correctness reference for the fast path.

RNG: the stateless hash generator (rt_tpu/rng.py) keyed on
(seed, work_id, depth, purpose) — per-sample deterministic and independent
of pool size, chunking, or which implementation runs.

Forward-only (the while_loop is not reverse-differentiable); gradients use
integrator.trace_radiance_diff.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rt_tpu import fast_shade, materials, pallas_ops, rng, sampling, sky
from rt_tpu.camera import Camera
from rt_tpu.config import RenderConfig
from rt_tpu.geometry import nearest_hit
from rt_tpu.scene import SceneData


def render_wavefront(
    scene: SceneData,
    camera: Camera,
    pixel_idx: jnp.ndarray,  # i32[P] flattened pixel ids (y * W + x)
    cfg: RenderConfig,
    spp: int,
    sample_offset: jnp.ndarray,
    key: jax.Array,
    pool_size: int = 1 << 16,
) -> jnp.ndarray:
    """Mean radiance per pixel f32[P,3] over ``spp`` samples."""
    fast_ok = scene.bvh is None and scene.shade_table is not None
    impl = _render_fast if fast_ok else _render_generic
    return impl(scene, camera, pixel_idx, cfg, spp, sample_offset, key, pool_size)


def _rank_of_idle(idle: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix count of idle lanes: cumsum(idle) - 1, computed
    in two exact stages (scans along [rows, 128] plus a short row scan)."""
    b = idle.shape[0]
    if b % 128 != 0:
        return jnp.cumsum(idle.astype(jnp.int32)) - 1
    rows = idle.astype(jnp.int32).reshape(b // 128, 128)
    within = jnp.cumsum(rows, axis=1)
    row_offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(within[:, -1])[:-1]]
    )
    return (within + row_offsets[:, None]).reshape(-1) - 1


def _seed_from_key(key: jax.Array) -> jnp.ndarray:
    """32-bit hash-RNG seed derived from the caller's key so the public
    API stays key-based."""
    return jax.random.key_data(key).reshape(-1)[-1].astype(jnp.uint32)


def _camera_jitter(camera: Camera, cfg: RenderConfig, seed, pix, sample):
    """Sub-pixel Halton jitter (+ optional per-pixel scramble) as rows."""
    off_u, off_v = sampling.halton_pair(sample)
    if not cfg.compat.shared_halton_jitter:
        off_u = jnp.mod(off_u + rng.uniform(seed, pix, 0, 5), 1.0)
        off_v = jnp.mod(off_v + rng.uniform(seed, pix, 0, 6), 1.0)
    return off_u, off_v


# ---------------------------------------------------------------------------
# Fast path: [8, B] row state + fused intersection + scalarized shading.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "spp", "pool_size"))
def _render_fast(
    scene: SceneData,
    camera: Camera,
    pixel_idx: jnp.ndarray,
    cfg: RenderConfig,
    spp: int,
    sample_offset: jnp.ndarray,
    key: jax.Array,
    pool_size: int = 1 << 16,
) -> jnp.ndarray:
    p = pixel_idx.shape[0]
    total_work = p * spp
    b = min(pool_size, max(-(-total_work // 256) * 256, 256))
    width = camera.image_width
    seed = _seed_from_key(key)

    # Camera frame as scalar components.
    p00 = camera.pixel00_loc
    du = camera.pixel_du
    dv = camera.pixel_dv
    dku = camera.defocus_disk_u
    dkv = camera.defocus_disk_v
    center = camera.center

    n_global = camera.image_width * camera.image_height

    def camera_rays(work_ids):
        slot = work_ids % p
        sample = (work_ids // p).astype(jnp.int32) + sample_offset
        pix = pixel_idx[jnp.clip(slot, 0, p - 1)]
        # RNG streams key on the *global* (sample, pixel) pair, so renders
        # are invariant to pool size, spp chunking, AND pixel sharding
        # (a device's local work ids don't enter the hash).  int32
        # wrap-around is fine for hashing.
        gwork = sample * n_global + pix
        px = (pix % width).astype(jnp.float32)
        py = (pix // width).astype(jnp.float32)
        off_u, off_v = _camera_jitter(camera, cfg, seed, pix, sample)
        fx = px + off_u
        fy = py + off_v
        sx = p00[0] + fx * du[0] + fy * dv[0]
        sy = p00[1] + fx * du[1] + fy * dv[1]
        sz = p00[2] + fx * du[2] + fy * dv[2]
        # Defocus disk sample (camera.rs:366-371), polar transform; draw
        # indices match rng.in_unit_disc(purpose=7) so both wavefront
        # implementations consume identical streams (c = 3*7 and 3*7+1).
        r = jnp.sqrt(rng.uniform(seed, gwork, 0, 21))
        th = rng.uniform(seed, gwork, 0, 22) * (2.0 * jnp.pi)
        dskx = r * jnp.cos(th)
        dsky = r * jnp.sin(th)
        use_dk = camera.defocus_angle > 0.0
        ox = jnp.where(use_dk, center[0] + dskx * dku[0] + dsky * dkv[0], center[0])
        oy = jnp.where(use_dk, center[1] + dskx * dku[1] + dsky * dkv[1], center[1])
        oz = jnp.where(use_dk, center[2] + dskx * dku[2] + dsky * dkv[2], center[2])
        zeros = jnp.zeros_like(ox)
        rays = jnp.stack([ox, oy, oz, sx - ox, sy - oy, sz - oz, zeros, zeros], 0)
        return rays, slot, gwork

    def intersect(rays, n):
        """(t, prim, params|None); params are the winners' shade columns
        when the fused kernel fetched them."""
        if scene.num_prims == 0:
            return (
                jnp.full((n,), fast_shade.BIG, jnp.float32),
                jnp.full((n,), -1, jnp.int32),
                None,
            )
        return pallas_ops.nearest_shaded(
            scene, rays, cfg.t_min, cfg.t_max, cfg.compat
        )

    def bounce(s, claiming: bool):
        """One wavefront iteration; ``claiming`` toggles work regeneration
        (phase 2 drains the pool without new claims)."""
        n = s["rays"].shape[1]
        if claiming:
            idle = ~s["active"]
            rank = _rank_of_idle(idle)
            claim_id = s["next_work"] + rank
            claim = idle & (claim_id < total_work)
            n_claimed = jnp.sum(claim.astype(jnp.int32))
            new_rays, _, new_gid = camera_rays(jnp.maximum(claim_id, 0))
            rays = jnp.where(claim[None, :], new_rays, s["rays"])
            tp = jnp.where(claim[None, :], 1.0, s["tp"])
            work = jnp.where(claim, claim_id, s["work"])
            gid = jnp.where(claim, new_gid, s["gid"])
            depth = jnp.where(claim, 0, s["depth"])
            active = s["active"] | claim
            next_work = s["next_work"] + n_claimed
        else:
            rays, tp = s["rays"], s["tp"]
            work, depth, active = s["work"], s["depth"], s["active"]
            gid = s["gid"]
            next_work = s["next_work"]

        t_best, prim, params = intersect(rays, n)
        out = fast_shade.shade_bounce(
            scene, rays, t_best, prim, seed, gid, depth, cfg, params=params
        )

        miss = active & ~out["hit"]
        emis = active & out["hit"] & out["emissive"]
        cont = (
            active
            & out["hit"]
            & out["survive"]
            & (depth < cfg.max_depth)
            & ~out["emissive"]
        )

        # Per-channel 1-D deposits (scatter rows of a [W,3] target pay the
        # padded minor-dim tax; three flat scatters don't).  A path deposits
        # at most once: at its sky miss, or at an emissive hit (extension).
        skr, skg, skb = out["sky"]
        emr, emg, emb = out["emit"]
        dep_r = jnp.where(miss, skr, emr)
        dep_g = jnp.where(miss, skg, emg)
        dep_b = jnp.where(miss, skb, emb)
        # Idle lanes all share the out-of-bounds sentinel index, so the
        # indices are NOT unique — JAX's unique_indices contract doesn't
        # exempt dropped writes, so don't claim it.
        deposit_idx = jnp.where(miss | emis, work, total_work)
        acc_r = s["acc_r"].at[deposit_idx].set(tp[0] * dep_r, mode="drop")
        acc_g = s["acc_g"].at[deposit_idx].set(tp[1] * dep_g, mode="drop")
        acc_b = s["acc_b"].at[deposit_idx].set(tp[2] * dep_b, mode="drop")

        ar, ag, ab = out["att"]  # already RR-scaled by 1/p
        tp = jnp.where(
            cont[None, :], jnp.stack([tp[0] * ar, tp[1] * ag, tp[2] * ab], 0), tp
        )
        rays = jnp.where(cont[None, :], out["new_rays"], rays)

        return dict(
            acc_r=acc_r,
            acc_g=acc_g,
            acc_b=acc_b,
            rays=rays,
            tp=tp,
            work=work,
            gid=gid,
            depth=depth + 1,
            active=cont,
            n_active=jnp.sum(cont.astype(jnp.int32)),
            next_work=next_work,
        )

    # Zeros derived from the (possibly sharded) pixel array: under
    # shard_map, constant-initialized while_loop carries are "unvarying"
    # while the loop outputs vary over the manual axes, which is a type
    # error — seeding every carry from a varying value fixes the types at
    # zero runtime cost.
    zf = 0.0 * pixel_idx[0].astype(jnp.float32)
    zi = 0 * pixel_idx[0]
    init = dict(
        acc_r=jnp.zeros((total_work,), jnp.float32) + zf,
        acc_g=jnp.zeros((total_work,), jnp.float32) + zf,
        acc_b=jnp.zeros((total_work,), jnp.float32) + zf,
        rays=jnp.concatenate(
            [jnp.zeros((3, b), jnp.float32), jnp.ones((5, b), jnp.float32)], axis=0
        )
        + zf,
        tp=jnp.zeros((3, b), jnp.float32) + zf,
        work=jnp.zeros((b,), jnp.int32) + zi,
        gid=jnp.zeros((b,), jnp.int32) + zi,
        depth=jnp.zeros((b,), jnp.int32) + zi,
        active=jnp.zeros((b,), bool) | (zi > 0),
        n_active=jnp.int32(0) + zi,
        next_work=jnp.int32(0) + zi,
    )

    tail = 4096
    two_phase = b >= tail * 4

    if two_phase:
        # Phase 1: keep the pool full while work remains; once the queue is
        # drained, keep bouncing only until the survivor count fits the
        # tail pool (straggler paths — deep dielectric chains — would
        # otherwise drag ~full-pool iterations at ~1% occupancy).
        def cond1(s):
            return (s["next_work"] < total_work) | (s["n_active"] > tail)

        state = jax.lax.while_loop(cond1, lambda s: bounce(s, True), init)

        # Compact survivors to the front (actives-first stable order).
        order = jnp.argsort(~state["active"])[:tail]
        small = dict(
            acc_r=state["acc_r"],
            acc_g=state["acc_g"],
            acc_b=state["acc_b"],
            rays=state["rays"][:, order],
            tp=state["tp"][:, order],
            work=state["work"][order],
            gid=state["gid"][order],
            depth=state["depth"][order],
            active=state["active"][order],
            n_active=state["n_active"],
            next_work=state["next_work"],
        )

        def cond2(s):
            return jnp.any(s["active"])

        state = jax.lax.while_loop(cond2, lambda s: bounce(s, False), small)
    else:
        def cond(s):
            return (s["next_work"] < total_work) | jnp.any(s["active"])

        state = jax.lax.while_loop(cond, lambda s: bounce(s, True), init)

    flat = jnp.stack([state["acc_r"], state["acc_g"], state["acc_b"]], axis=-1)
    return jnp.sum(flat.reshape(spp, p, 3), axis=0) / jnp.float32(spp)


# ---------------------------------------------------------------------------
# Generic path: works for every scene; correctness reference.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "spp", "pool_size"))
def _render_generic(
    scene: SceneData,
    camera: Camera,
    pixel_idx: jnp.ndarray,
    cfg: RenderConfig,
    spp: int,
    sample_offset: jnp.ndarray,
    key: jax.Array,
    pool_size: int = 1 << 16,
) -> jnp.ndarray:
    p = pixel_idx.shape[0]
    total_work = p * spp
    b = min(pool_size, max(total_work, 1))
    width = camera.image_width
    seed = _seed_from_key(key)

    n_global = camera.image_width * camera.image_height

    def camera_rays(work_ids):
        slot = work_ids % p
        sample = (work_ids // p).astype(jnp.int32) + sample_offset
        pix = pixel_idx[jnp.clip(slot, 0, p - 1)]
        gwork = sample * n_global + pix  # global (sample, pixel) stream
        px = pix % width
        py = pix // width
        off_u, off_v = _camera_jitter(camera, cfg, seed, pix, sample)
        fx = px.astype(jnp.float32) + off_u
        fy = py.astype(jnp.float32) + off_v
        pixel_sample = (
            camera.pixel00_loc[None, :]
            + fx[:, None] * camera.pixel_du[None, :]
            + fy[:, None] * camera.pixel_dv[None, :]
        )
        disk = rng.in_unit_disc(seed, gwork, 0, 7)
        defocus_origin = (
            camera.center[None, :]
            + disk[:, 0:1] * camera.defocus_disk_u[None, :]
            + disk[:, 1:2] * camera.defocus_disk_v[None, :]
        )
        org = jnp.where(
            camera.defocus_angle > 0.0, defocus_origin, camera.center[None, :]
        )
        return org, pixel_sample - org, gwork

    zf = 0.0 * pixel_idx[0].astype(jnp.float32)  # varying zero (see fast path)
    zi = 0 * pixel_idx[0]
    init = dict(
        accum=jnp.zeros((total_work, 3), jnp.float32) + zf,
        org=jnp.zeros((b, 3), jnp.float32) + zf,
        dirn=jnp.ones((b, 3), jnp.float32) + zf,
        throughput=jnp.zeros((b, 3), jnp.float32) + zf,
        work=jnp.zeros((b,), jnp.int32) + zi,
        gid=jnp.zeros((b,), jnp.int32) + zi,
        depth=jnp.zeros((b,), jnp.int32) + zi,
        active=jnp.zeros((b,), bool) | (zi > 0),
        next_work=jnp.int32(0) + zi,
    )

    def cond(s):
        return (s["next_work"] < total_work) | jnp.any(s["active"])

    def body(s):
        idle = ~s["active"]
        rank = _rank_of_idle(idle)
        claim_id = s["next_work"] + rank
        claim = idle & (claim_id < total_work)
        n_claimed = jnp.sum(claim.astype(jnp.int32))

        new_org, new_dir, new_gid = camera_rays(jnp.maximum(claim_id, 0))
        cm = claim[:, None]
        org = jnp.where(cm, new_org, s["org"])
        dirn = jnp.where(cm, new_dir, s["dirn"])
        throughput = jnp.where(cm, 1.0, s["throughput"])
        work = jnp.where(claim, claim_id, s["work"])
        gid = jnp.where(claim, new_gid, s["gid"])
        depth = jnp.where(claim, 0, s["depth"])
        active = s["active"] | claim

        rec = nearest_hit(scene, org, dirn, cfg.t_min, cfg.t_max, cfg.compat)

        unit_dir = dirn / jnp.maximum(
            jnp.linalg.norm(dirn, axis=-1, keepdims=True), 1e-20
        )
        sky_rgb = sky.sky_color_toward(scene.sky, unit_dir)
        miss = active & ~rec.hit

        # Emissive hits terminate with a deposit (extension; MAT_EMISSIVE).
        from rt_tpu.textures import texture_value

        mat_id = jnp.clip(rec.material, 0, scene.mat_kind.shape[0] - 1)
        is_emissive = scene.mat_kind[mat_id] == 3
        emis = active & rec.hit & is_emissive
        emit_rgb = texture_value(scene, scene.mat_texture[mat_id], rec.uv, rec.point)

        attenuation, new_bounce_dir = materials.scatter_hashed(
            scene, rec, dirn, seed, gid, depth, cfg.compat
        )
        rr_p = jnp.clip(jnp.max(attenuation, axis=-1), 0.0, cfg.compat.rr_clamp)
        survive = rng.uniform(seed, gid, depth, 10) < rr_p
        cont = active & rec.hit & survive & (depth < cfg.max_depth) & ~is_emissive

        contribution = throughput * jnp.where(miss[:, None], sky_rgb, emit_rgb)
        deposit_idx = jnp.where(miss | emis, work, total_work)
        accum = s["accum"].at[deposit_idx].set(contribution, mode="drop")

        throughput = jnp.where(
            cont[:, None],
            throughput * attenuation / jnp.maximum(rr_p, 1e-12)[:, None],
            throughput,
        )
        point_scale = jnp.maximum(
            jnp.max(jnp.abs(rec.point), axis=-1, keepdims=True), 1.0
        )
        side = jnp.sign(jnp.sum(new_bounce_dir * rec.normal, axis=-1, keepdims=True))
        new_org2 = rec.point + cfg.origin_offset * point_scale * side * rec.normal

        return dict(
            accum=accum,
            org=jnp.where(cont[:, None], new_org2, org),
            dirn=jnp.where(cont[:, None], new_bounce_dir, dirn),
            throughput=throughput,
            work=work,
            gid=gid,
            depth=depth + 1,
            active=cont,
            next_work=s["next_work"] + n_claimed,
        )

    state = jax.lax.while_loop(cond, body, init)
    return jnp.sum(state["accum"].reshape(spp, p, 3), axis=0) / jnp.float32(spp)
