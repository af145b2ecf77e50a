"""Batched ray-primitive intersection and nearest-hit queries.

Reference behavior being matched:
- Sphere: half-b quadratic with two-root range selection, outward normal
  flipped against the ray, oriented UV via ``front_direction``
  (hittable.rs:318-365).
- Triangle: Möller–Trumbore with backface culling (det < EPSILON reject,
  hittable.rs:408-494), flat precomputed normal, and the reference's
  UV-bbox-remap quirk (hittable.rs:466-481) behind a compat switch.
- Nearest hit: dense (t, prim_id) records with a +inf miss sentinel replace
  the reference's ``Option<Intersection>`` (intersection.rs:8-15).

Batched formulation: the per-(ray, sphere) quadratic coefficients factor
into two (N,3)x(3,S) products (d.c and o.c) plus rank-1 terms, followed by
a min-reduction over primitives.  Large scenes use the BVH path
(rt_tpu/bvh) instead.

Divergences (documented):
- The reference rejects sphere hits whose UV comes out NaN on glancing blows
  (hittable.rs:350-354); rt_tpu clamps the acos/atan2 inputs so UVs are
  never NaN and the hit stands.
- f32 epsilons: EPSILON comparisons use 1e-7 (f32 scale) instead of f64's
  2.2e-16.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from rt_tpu.config import CompatConfig
from rt_tpu.pytree import PyTreeNode
from rt_tpu.scene import SceneData

BIG = np.float32(3.0e38)  # numpy: module-level jnp would init a backend at import
TRI_EPS = np.float32(1.0e-7)  # f32 analog of f64::EPSILON (hittable.rs:428,461)


class HitRecord(PyTreeNode):
    """Dense SoA hit payload (reference analog: Intersection,
    intersection.rs:8-15; miss encoded as hit=False / t=BIG / prim=-1)."""

    t: jnp.ndarray  # f32[N]
    prim: jnp.ndarray  # i32[N] global prim id (spheres then triangles)
    hit: jnp.ndarray  # bool[N]
    point: jnp.ndarray  # f32[N,3]
    normal: jnp.ndarray  # f32[N,3] (flipped against ray for spheres)
    front: jnp.ndarray  # bool[N]
    uv: jnp.ndarray  # f32[N,2]
    material: jnp.ndarray  # i32[N]


# ---------------------------------------------------------------------------
# Sphere intersection (hittable.rs:318-365)
# ---------------------------------------------------------------------------


def sphere_candidate_t(org, dirn, center, radius, t_min, t_max):
    """Candidate hit distance per (ray, sphere) pair: f32[N,S].

    d.c and o.c are (N,3)x(3,S) products; everything else is rank-1
    broadcast math.  Root selection matches hittable.rs:330-338 (near root
    if in range, else far root, else miss).  The products run at full f32
    precision: c_coef = |c|^2 - 2 o.c + |o|^2 - r^2 cancels terms of order
    r^2 (1e6 for the ground sphere), which TF32's 10-bit mantissa would
    swamp.
    """
    highest = jax.lax.Precision.HIGHEST
    d_dot_c = jnp.matmul(dirn, center.T, precision=highest)  # [N,S]
    o_dot_c = jnp.matmul(org, center.T, precision=highest)  # [N,S]
    a = jnp.sum(dirn * dirn, axis=-1)  # [N]
    d_dot_o = jnp.sum(dirn * org, axis=-1)  # [N]
    c_sq = jnp.sum(center * center, axis=-1)  # [S]
    o_sq = jnp.sum(org * org, axis=-1)  # [N]

    h = d_dot_c - d_dot_o[:, None]
    c_coef = c_sq[None, :] - 2.0 * o_dot_c + o_sq[:, None] - (radius * radius)[None, :]
    disc = h * h - a[:, None] * c_coef
    # Floor keeps d/dx sqrt finite at disc == 0 (grazing hits) — an inf
    # there turns masked lanes' zero cotangents into NaNs in reverse mode.
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 1.0e-30))
    inv_a = 1.0 / a[:, None]
    t0 = (h - sqrt_disc) * inv_a
    t1 = (h + sqrt_disc) * inv_a

    ok = (disc >= 0.0) & (radius > 0.0)[None, :]
    in0 = ok & (t0 >= t_min) & (t0 < t_max)
    in1 = ok & (t1 >= t_min) & (t1 < t_max)
    return jnp.where(in0, t0, jnp.where(in1, t1, BIG))


def unit_sphere_uv(point, pitch_rads, yaw_rads, rotation_rads):
    """UV of a unit-sphere ``point`` with the texture pitched, yawed, and
    rotated (hittable.rs:367-388; the reference's public sphere-UV entry):
    rotation = Ry(pitch) @ Rz(-yaw); phi gains ``rotation_rads`` mod 2pi.

    ``point`` f32[...,3]; angles broadcastable scalars/arrays (radians).
    """
    px, py, pz = point[..., 0], point[..., 1], point[..., 2]
    cy, sy = jnp.cos(yaw_rads), jnp.sin(yaw_rads)
    qx = cy * px + sy * py
    qy = -sy * px + cy * py
    cp, sp = jnp.cos(pitch_rads), jnp.sin(pitch_rads)
    rx = cp * qx + sp * pz
    ry = qy
    rz = -sp * qx + cp * pz
    at_pole = rx * rx + ry * ry < 1.0e-12
    rx = jnp.where(at_pole, 1.0, rx)
    theta = jnp.arccos(jnp.clip(-rz, -1.0 + 1.0e-7, 1.0 - 1.0e-7))
    phi = jnp.mod(jnp.arctan2(ry, rx) + jnp.pi + rotation_rads, 2.0 * jnp.pi)
    return jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1)


def sphere_uv_facing(p, face_dir):
    """UV of unit-sphere point ``p`` with the texture pitched/yawed toward
    ``face_dir`` (hittable.rs:367-406): rotation = Ry(pitch) @ Rz(-yaw),
    theta = acos(-z'), phi = atan2(y', x') + pi; u = phi/2pi, v = theta/pi.

    All inputs f32[...,3]; acos input clamped (no NaN-UV miss path).
    """
    fx, fy, fz = face_dir[..., 0], face_dir[..., 1], face_dir[..., 2]
    pitch = jnp.arctan2(fz, jnp.sqrt(fx * fx + fy * fy + 1.0e-20))
    yaw = jnp.arctan2(fy, fx)

    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    qx = cy * px + sy * py
    qy = -sy * px + cy * py
    qz = pz
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    rx = cp * qx + sp * qz
    ry = qy
    rz = -sp * qx + cp * qz

    # Pole guards: d/dx arccos(+-1) and d/dx atan2 at (0,0) are inf/NaN,
    # and even masked-out lanes' NaN cotangents poison reverse-mode AD.
    # At the poles phi is arbitrary, so the forward perturbation is benign.
    at_pole = rx * rx + ry * ry < 1.0e-12
    rx = jnp.where(at_pole, 1.0, rx)
    theta = jnp.arccos(jnp.clip(-rz, -1.0 + 1.0e-7, 1.0 - 1.0e-7))
    phi = jnp.arctan2(ry, rx) + jnp.pi
    u = jnp.mod(phi, 2.0 * jnp.pi) / (2.0 * jnp.pi)
    v = theta / jnp.pi
    return jnp.stack([u, v], axis=-1)


# ---------------------------------------------------------------------------
# Triangle intersection (hittable.rs:408-494)
# ---------------------------------------------------------------------------


def triangle_candidate(org, dirn, a, b, c, t_min, t_max, compat: CompatConfig):
    """Möller–Trumbore per (ray, triangle) pair.

    Returns (t f32[N,T], u f32[N,T], v f32[N,T]); miss encoded as t=BIG.
    Brute-force path — materializes [N,T,3] intermediates, so callers chunk
    rays; the BVH path intersects only leaf ranges.
    """
    e1 = b - a  # [T,3]
    e2 = c - a  # [T,3]
    u_vec = jnp.cross(dirn[:, None, :], e2[None, :, :])  # [N,T,3]
    det = jnp.sum(e1[None, :, :] * u_vec, axis=-1)  # [N,T]

    if compat.triangle_backface_cull:
        det_ok = det > TRI_EPS  # hittable.rs:428
    else:
        det_ok = jnp.abs(det) > TRI_EPS
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)

    ao = org[:, None, :] - a[None, :, :]  # [N,T,3]
    u = jnp.sum(ao * u_vec, axis=-1) * inv_det
    v_vec = jnp.cross(ao, e1[None, :, :])  # [N,T,3]
    v = jnp.sum(dirn[:, None, :] * v_vec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * v_vec, axis=-1) * inv_det

    valid = (
        det_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t < t_max)
        & (t > TRI_EPS)  # hittable.rs:461
    )
    return jnp.where(valid, t, BIG), u, v


def triangle_uv(uv_abc, u, v, compat: CompatConfig):
    """Hit UV from barycentric (u, v) and per-vertex UVs f32[...,3,2].

    compat.triangle_uv_bbox_remap=True replicates the reference quirk
    (hittable.rs:466-481): (u, v) is remapped into the *bounding box* of the
    three vertex UVs.  False gives true barycentric interpolation.
    """
    if compat.triangle_uv_bbox_remap:
        lo = jnp.min(uv_abc, axis=-2)  # [...,2]
        hi = jnp.max(uv_abc, axis=-2)
        return lo + (hi - lo) * jnp.stack([u, v], axis=-1)
    w = 1.0 - u - v
    bary = jnp.stack([w, u, v], axis=-1)  # a, b, c weights
    return jnp.einsum(
        "...k,...kd->...d", bary, uv_abc, precision=jax.lax.Precision.HIGHEST
    )


# ---------------------------------------------------------------------------
# Nearest-hit query
# ---------------------------------------------------------------------------


def nearest_hit_bruteforce(scene: SceneData, org, dirn, t_min, t_max, compat: CompatConfig):
    """O(N*P) nearest hit over all primitives; returns (t f32[N], prim i32[N]).

    Equivalent to the reference's shrinking-range BVH walk result
    (hittable.rs:135-149) — the nearest valid hit in [t_min, t_max).
    """
    t_best = jnp.full(org.shape[:1], BIG, jnp.float32)
    prim_best = jnp.full(org.shape[:1], -1, jnp.int32)

    if scene.num_spheres > 0:
        ts = sphere_candidate_t(org, dirn, scene.sph_center, scene.sph_radius, t_min, t_max)
        s_idx = jnp.argmin(ts, axis=-1)
        s_t = jnp.take_along_axis(ts, s_idx[:, None], axis=-1)[:, 0]
        better = s_t < t_best
        t_best = jnp.where(better, s_t, t_best)
        prim_best = jnp.where(better, s_idx.astype(jnp.int32), prim_best)

    if scene.num_triangles > 0:
        tt, _, _ = triangle_candidate(
            org, dirn, scene.tri_a, scene.tri_b, scene.tri_c, t_min, t_max, compat
        )
        t_idx = jnp.argmin(tt, axis=-1)
        t_t = jnp.take_along_axis(tt, t_idx[:, None], axis=-1)[:, 0]
        better = t_t < t_best
        t_best = jnp.where(better, t_t, t_best)
        prim_best = jnp.where(
            better, t_idx.astype(jnp.int32) + scene.num_spheres, prim_best
        )

    return t_best, prim_best


def hit_attributes(
    scene: SceneData, org, dirn, t, prim, compat: CompatConfig
) -> HitRecord:
    """Compute the full hit payload for winning (t, prim) pairs — the SoA
    equivalent of constructing ``Intersection`` inside each ``hit``
    (hittable.rs:340-363, 462-490), but only for the nearest hit."""
    n = org.shape[0]
    hit = (prim >= 0) & (t < BIG)
    # Zero t on miss: BIG * dir overflows f32 to inf, and even fully masked
    # infs poison reverse-mode AD (0 * inf cotangents).
    t_safe = jnp.where(hit, t, 0.0)
    point = org + t_safe[:, None] * dirn

    is_sphere = (prim >= 0) & (prim < scene.num_spheres)
    s_idx = jnp.clip(prim, 0, max(scene.num_spheres - 1, 0))
    t_idx = jnp.clip(prim - scene.num_spheres, 0, max(scene.num_triangles - 1, 0))

    # Sphere attributes (hittable.rs:340-363).
    s_center = scene.sph_center[s_idx]
    s_radius = jnp.maximum(scene.sph_radius[s_idx], 1.0e-20)
    s_normal_out = (point - s_center) / s_radius[:, None]
    s_front = jnp.sum(dirn * s_normal_out, axis=-1) < 0.0
    s_normal = jnp.where(s_front[:, None], s_normal_out, -s_normal_out)
    s_uv = sphere_uv_facing(s_normal, scene.sph_front_dir[s_idx])
    s_mat = scene.sph_material[s_idx]

    # Triangle attributes: recompute barycentrics for the winner only.
    a = scene.tri_a[t_idx]
    b = scene.tri_b[t_idx]
    c = scene.tri_c[t_idx]
    e1, e2 = b - a, c - a
    u_vec = jnp.cross(dirn, e2)
    det = jnp.sum(e1 * u_vec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1.0e-20, det, 1.0)
    ao = org - a
    bu = jnp.sum(ao * u_vec, axis=-1) * inv_det
    bv = jnp.sum(dirn * jnp.cross(ao, e1), axis=-1) * inv_det
    # Triangle hit points from the barycentrics, not o + t d: they lie on
    # the triangle's plane exactly, so a texture evaluated there does not
    # follow the sign of o + t d's rounding error (a checker on an
    # axis-aligned triangle sits on a cell boundary, and that sign differs
    # between backends).
    t_point = a + bu[:, None] * e1 + bv[:, None] * e2
    point = jnp.where((hit & ~is_sphere)[:, None], t_point, point)
    t_normal = scene.tri_normal[t_idx]
    t_front = jnp.sum(dirn * t_normal, axis=-1) <= 0.0  # hittable.rs:464
    t_uv = triangle_uv(scene.tri_uv[t_idx], bu, bv, compat)
    t_mat = scene.tri_material[t_idx]

    sphere_mask = is_sphere[:, None]
    return HitRecord(
        t=t,
        prim=jnp.where(hit, prim, -1),
        hit=hit,
        point=point,
        normal=jnp.where(sphere_mask, s_normal, t_normal),
        front=jnp.where(is_sphere, s_front, t_front),
        uv=jnp.where(sphere_mask, s_uv, t_uv),
        material=jnp.where(is_sphere, s_mat, t_mat).astype(jnp.int32),
    )


def nearest_hit(
    scene: SceneData,
    org,
    dirn,
    t_min,
    t_max,
    compat: CompatConfig = CompatConfig(),
    impl: str = "auto",
) -> HitRecord:
    """Nearest-hit query — the World::hit analog (hittable.rs:135-149).

    impl:
      - "auto": BVH when the scene has one, else XLA brute force.  Fully
        differentiable (the gradient path must use this).
      - "detached": detached-argmin winner search + differentiable
        re-evaluation (used by trace_radiance_diff).  Applies only to
        bvh-less scenes; with a BVH it falls through to the BVH diff
        path below (same detach-then-recompute structure).
    """
    if impl == "detached" and scene.bvh is None:
        t, prim = nearest_search_detached(scene, org, dirn, t_min, t_max, compat)
        return hit_attributes(scene, org, dirn, t, prim, compat)
    if scene.bvh is not None:
        # The diff wrapper detaches the while_loop walk (no reverse rule)
        # and recomputes the winner's t differentiably, so "auto" stays
        # valid under jax.grad for >LEAF-threshold mesh scenes too.
        from rt_tpu.bvh.traverse import nearest_hit_bvh_diff

        t, prim = nearest_hit_bvh_diff(scene, org, dirn, t_min, t_max, compat)
    else:
        t, prim = nearest_hit_bruteforce(scene, org, dirn, t_min, t_max, compat)
    return hit_attributes(scene, org, dirn, t, prim, compat)


def nearest_search_detached(
    scene: SceneData, org, dirn, t_min, t_max, compat: CompatConfig
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Differentiable (t, prim) via the detached-decision estimator (the
    same convention nearest_hit_bvh_diff uses): the brute-force winner
    SEARCH runs fully stop_gradient'd, so reverse mode never keeps the
    O(N*P) candidate tensors, and only the winner's t is recomputed
    differentiably.  Gradients match the brute-force path a.e. (the argmin
    winner is locally constant)."""
    from rt_tpu.bvh.traverse import _prim_t

    sg = jax.lax.stop_gradient
    scene_sg = jax.tree.map(sg, scene)
    _, prim = nearest_hit_bruteforce(scene_sg, sg(org), sg(dirn), t_min, t_max, compat)
    t = _prim_t(scene, jnp.maximum(prim, 0), org, dirn, t_min, t_max, compat)
    t = jnp.where(prim >= 0, t, BIG)
    return t, prim
