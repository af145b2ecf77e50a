"""Scalarized fast shading path for the persistent wavefront.

The generic bounce (geometry.hit_attributes + textures.texture_value +
materials.scatter) gathers ~20 per-primitive table rows per lane and
reduces over the minor length-3 axis of [B,3] arrays.  This module packs
the work differently:

- ALL per-primitive shading parameters (geometry, material, texture) are
  packed into one dense f32[F, P] ``shade_table`` at scene-build time; the
  winning primitive's parameter bundle is fetched for every lane at once
  (``fetch_params``), in one operation (the image-texture atlas fetch is
  the one exception, gated on a static flag);
- every vector quantity lives as separate [B] component rows, so all math
  is elementwise with no cross-lane reductions.

The physics is identical to materials.py/textures.py/geometry.py (the
readable, differentiable reference implementations, each citing the Rust
source); tests assert statistical agreement between the two paths.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from rt_tpu import rng
from rt_tpu.config import CompatConfig
from rt_tpu.scene import (
    MAT_DIELECTRIC,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_SOLID,
    SceneData,
)

BIG = 3.0e38

# shade_table row indices (F rows of a transposed [F, P] table).
F_IS_SPHERE = 0
F_AX, F_AY, F_AZ = 1, 2, 3  # sphere center / triangle vertex a
F_RADIUS = 4
F_NX, F_NY, F_NZ = 5, 6, 7  # sphere front_dir / triangle flat normal
F_MAT_KIND = 8
F_FUZZ = 9
F_IOR = 10
F_TEX_KIND = 11
F_INV_SCALE = 12
F_CE = 13  # color even/solid rgb: 13,14,15
F_CO = 16  # color odd rgb: 16,17,18
F_RECT = 19  # image rect x0,y0,w,h: 19..22
F_BX, F_BY, F_BZ = 23, 24, 25  # triangle vertex b
F_CX, F_CY, F_CZ = 26, 27, 28  # triangle vertex c
F_UVA = 29  # triangle uvs: a.u a.v b.u b.v c.u c.v -> 29..34
# Precomputed sphere-UV orientation trig (cos/sin of the facing dir's yaw
# and pitch, hittable.rs:379-391): the rotation is per-PRIMITIVE, so the
# table carries its trig and the kernels skip 2 atan2 + 2 sincos per lane.
F_CYW, F_SYW, F_CP, F_SP = 35, 36, 37, 38
F_ROWS = 40  # padded to a sublane multiple


def build_shade_table(
    sph_center,
    sph_radius,
    sph_front,
    sph_mat,
    tri_a,
    tri_b,
    tri_c,
    tri_normal,
    tri_uv,
    tri_mat,
    mat_kind,
    mat_tex,
    mat_fuzz,
    mat_ior,
    tex_kind,
    tex_color,
    tex_inv_scale,
    tex_children,
    tex_rect,
    num_spheres: int,
    num_triangles: int,
) -> np.ndarray | None:
    """Pack per-primitive shading params into f32[F_ROWS, P_pad] (host).

    Returns None when a texture configuration is not expressible (checker
    whose children are not both solid colors) — callers fall back to the
    generic gather path.
    """
    p = num_spheres + num_triangles
    if p == 0:
        return None
    p_pad = -(-p // 128) * 128
    table = np.zeros((F_ROWS, p_pad), np.float32)
    ns, nt = num_spheres, num_triangles

    # Vectorized material/texture columns (a per-prim Python loop costs
    # minutes at cover-large scale).
    mids = np.concatenate([np.asarray(sph_mat[:ns]), np.asarray(tri_mat[:nt])]).astype(np.int64)
    kinds = np.asarray(mat_kind)[mids]
    tids = np.asarray(mat_tex)[mids]
    tkind = np.asarray(tex_kind)[tids]
    is_diel = kinds == MAT_DIELECTRIC

    checker = (tkind == TEX_CHECKER) & ~is_diel
    even = np.asarray(tex_children)[tids, 0]
    odd = np.asarray(tex_children)[tids, 1]
    bad = checker & (
        (np.asarray(tex_kind)[even] != TEX_SOLID)
        | (np.asarray(tex_kind)[odd] != TEX_SOLID)
    )
    if bad.any():
        return None  # checker with non-solid children: not expressible

    cols = slice(0, p)
    table[F_MAT_KIND, cols] = kinds
    table[F_FUZZ, cols] = np.asarray(mat_fuzz)[mids]
    table[F_IOR, cols] = np.asarray(mat_ior)[mids]
    table[F_TEX_KIND, cols] = np.where(is_diel, TEX_SOLID, tkind)
    table[F_INV_SCALE, cols] = np.where(checker, np.asarray(tex_inv_scale)[tids], 0.0)
    solid_rgb = np.asarray(tex_color)[tids]  # own color (solid) ...
    even_rgb = np.where(checker[:, None], np.asarray(tex_color)[even], solid_rgb)
    even_rgb = np.where(is_diel[:, None], 1.0, even_rgb)
    table[F_CE : F_CE + 3, cols] = even_rgb.T
    table[F_CO : F_CO + 3, cols] = np.where(
        checker[:, None], np.asarray(tex_color)[odd], 0.0
    ).T
    is_image = (tkind == TEX_IMAGE) & ~is_diel
    table[F_RECT : F_RECT + 4, cols] = np.where(
        is_image[:, None], np.asarray(tex_rect)[tids], 0
    ).T.astype(np.float32)

    # Geometry columns.
    table[F_IS_SPHERE, :ns] = 1.0
    table[F_AX : F_AZ + 1, :ns] = np.asarray(sph_center[:ns]).T
    table[F_RADIUS, :ns] = np.asarray(sph_radius[:ns])
    table[F_NX : F_NZ + 1, :ns] = np.asarray(sph_front[:ns]).T
    sfx, sfy, sfz = (np.asarray(sph_front[:ns], np.float32).T + 0.0)[:3]
    pitch = np.arctan2(sfz, np.sqrt(sfx * sfx + sfy * sfy + 1e-20))
    yaw = np.arctan2(sfy, sfx)
    table[F_CYW, :ns] = np.cos(yaw)
    table[F_SYW, :ns] = np.sin(yaw)
    table[F_CP, :ns] = np.cos(pitch)
    table[F_SP, :ns] = np.sin(pitch)
    tc = slice(ns, ns + nt)
    table[F_AX : F_AZ + 1, tc] = np.asarray(tri_a[:nt]).T
    table[F_BX : F_BZ + 1, tc] = np.asarray(tri_b[:nt]).T
    table[F_CX : F_CZ + 1, tc] = np.asarray(tri_c[:nt]).T
    table[F_NX : F_NZ + 1, tc] = np.asarray(tri_normal[:nt]).T
    table[F_UVA : F_UVA + 6, tc] = np.asarray(tri_uv[:nt]).reshape(nt, 6).T
    return table


def build_shade_table_diff(scene) -> jnp.ndarray | None:
    """Differentiable re-assembly of the PARAMETER rows of
    ``scene.shade_table`` from the live scene arrays.

    The host-built table (build_shade_table) bakes material/texture values
    into numpy, severing them from reverse-mode AD.  This mirror keeps the
    static rows (geometry, flags, precomputed trig) from the baked table
    and overwrites the rows that depend on differentiable SceneParams
    leaves (mat_fuzz, mat_ior, tex_color) with jnp gathers, so a
    fetch_params one-hot matmul carries gradients back to the params —
    the gradient path's replacement for textures.texture_value's ~10
    separate XLA gathers per bounce.
    """
    if scene.shade_table is None:
        return None
    base = scene.shade_table
    ns, nt = scene.num_spheres, scene.num_triangles
    p = ns + nt
    mids = jnp.concatenate(
        [
            jnp.asarray(scene.sph_material[:ns], jnp.int32),
            jnp.asarray(scene.tri_material[:nt], jnp.int32),
        ]
    )
    kinds = scene.mat_kind[mids]
    tids = scene.mat_texture[mids]
    tkind = scene.tex_kind[tids]
    is_diel = kinds == MAT_DIELECTRIC
    checker = (tkind == TEX_CHECKER) & ~is_diel
    even = scene.tex_children[tids, 0]
    odd = scene.tex_children[tids, 1]
    solid_rgb = scene.tex_color[tids]
    even_rgb = jnp.where(checker[:, None], scene.tex_color[even], solid_rgb)
    even_rgb = jnp.where(is_diel[:, None], 1.0, even_rgb)
    odd_rgb = jnp.where(checker[:, None], scene.tex_color[odd], 0.0)
    table = base.at[F_FUZZ, :p].set(scene.mat_fuzz[mids])
    table = table.at[F_IOR, :p].set(scene.mat_ior[mids])
    table = table.at[F_CE : F_CE + 3, :p].set(even_rgb.T)
    table = table.at[F_CO : F_CO + 3, :p].set(odd_rgb.T)
    return table


# ---------------------------------------------------------------------------
# Device-side scalarized bounce.
# ---------------------------------------------------------------------------


def fetch_params(table: jnp.ndarray, prim: jnp.ndarray) -> jnp.ndarray:
    """All shading params for each lane's winning primitive: f32[F, B].

    Tables of up to 2048 columns: a one-hot product (onehot[P, B] =
    (iota == prim), params = table @ onehot), pinned to full f32 so no
    backend rounds the fetched values (TF32 would keep ~3 digits).
    Larger tables: one row gather + transpose.
    """
    p_pad = table.shape[1]
    if p_pad <= 2048:
        ids = jnp.arange(p_pad, dtype=jnp.int32)
        onehot = (ids[:, None] == prim[None, :]).astype(jnp.float32)  # [P,B]
        return jnp.dot(table, onehot, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    rows = table.T[prim]  # [B, F] gather
    return rows.T


def shade_bounce(
    scene: SceneData,
    rays: jnp.ndarray,  # f32[8, B]: org xyz, dir xyz, pad, pad
    t: jnp.ndarray,  # f32[B] from the intersection kernel (BIG = miss)
    prim: jnp.ndarray,  # i32[B] (-1 = miss)
    seed: jnp.ndarray,
    work: jnp.ndarray,
    depth: jnp.ndarray,
    cfg,
    table: jnp.ndarray | None = None,
    params: jnp.ndarray | None = None,
) -> dict:
    """One scalarized bounce after intersection.

    ``prim`` indexes ``table`` (defaults to scene.shade_table).  When the
    intersection already fetched the winner's parameter columns
    (pallas_ops.prim_nearest_shaded), pass them as ``params`` f32[F, B]
    and the fetch here is skipped.

    Returns dict with: new_rays f32[8,B], attenuation rgb rows f32[3,B],
    sky rgb rows f32[3,B], hit bool[B], survive bool[B].
    Physics parity: materials.rs / texture.rs / hittable.rs as implemented
    in materials.py / textures.py / geometry.py.
    """
    compat: CompatConfig = cfg.compat
    if table is None:
        table = scene.shade_table
    ox, oy, oz = rays[0], rays[1], rays[2]
    dx, dy, dz = rays[3], rays[4], rays[5]

    hit = (prim >= 0) & (t < BIG)
    ts = jnp.where(hit, t, 0.0)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz

    f = params if params is not None else fetch_params(table, jnp.where(hit, prim, 0))
    is_sphere = f[F_IS_SPHERE] > 0.5

    # --- Normal + front face (hittable.rs:340-346, 464). ---------------
    inv_r = 1.0 / jnp.maximum(f[F_RADIUS], 1e-20)
    snx = (px - f[F_AX]) * inv_r
    sny = (py - f[F_AY]) * inv_r
    snz = (pz - f[F_AZ]) * inv_r
    d_dot_sn = dx * snx + dy * sny + dz * snz
    s_front = d_dot_sn < 0.0
    sgn = jnp.where(s_front, 1.0, -1.0)
    snx, sny, snz = snx * sgn, sny * sgn, snz * sgn

    tnx, tny, tnz = f[F_NX], f[F_NY], f[F_NZ]
    t_front = dx * tnx + dy * tny + dz * tnz <= 0.0

    nx = jnp.where(is_sphere, snx, tnx)
    ny = jnp.where(is_sphere, sny, tny)
    nz = jnp.where(is_sphere, snz, tnz)
    front = jnp.where(is_sphere, s_front, t_front)

    # --- UV (sphere: hittable.rs:367-406; tri: 466-481). ----------------
    # The facing rotation's trig is per-primitive and precomputed in the
    # shade table (F_CYW..F_SP) — no per-lane atan2/sincos needed.
    cyw, syw = f[F_CYW], f[F_SYW]
    qx = cyw * snx + syw * sny
    qy = -syw * snx + cyw * sny
    cp, sp = f[F_CP], f[F_SP]
    rx = cp * qx + sp * snz
    ry = qy
    rz = -sp * qx + cp * snz
    at_pole = rx * rx + ry * ry < 1e-12
    rx = jnp.where(at_pole, 1.0, rx)
    theta = jnp.arccos(jnp.clip(-rz, -1.0 + 1e-7, 1.0 - 1e-7))
    phi = jnp.arctan2(ry, rx) + jnp.pi
    s_u = jnp.mod(phi, 2.0 * jnp.pi) * (0.5 / jnp.pi)
    s_v = theta * (1.0 / jnp.pi)

    # Triangle barycentrics (recomputed for the winner, hittable.rs:433-452).
    e1x, e1y, e1z = f[F_BX] - f[F_AX], f[F_BY] - f[F_AY], f[F_BZ] - f[F_AZ]
    e2x, e2y, e2z = f[F_CX] - f[F_AX], f[F_CY] - f[F_AY], f[F_CZ] - f[F_AZ]
    uvx = dy * e2z - dz * e2y
    uvy = dz * e2x - dx * e2z
    uvz = dx * e2y - dy * e2x
    det = e1x * uvx + e1y * uvy + e1z * uvz
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    aox, aoy, aoz = ox - f[F_AX], oy - f[F_AY], oz - f[F_AZ]
    bu = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det
    vvx = aoy * e1z - aoz * e1y
    vvy = aoz * e1x - aox * e1z
    vvz = aox * e1y - aoy * e1x
    bv = (dx * vvx + dy * vvy + dz * vvz) * inv_det
    # Triangle hit points from the barycentrics (see geometry.hit_attributes).
    on_tri = hit & ~is_sphere
    px = jnp.where(on_tri, f[F_AX] + bu * e1x + bv * e2x, px)
    py = jnp.where(on_tri, f[F_AY] + bu * e1y + bv * e2y, py)
    pz = jnp.where(on_tri, f[F_AZ] + bu * e1z + bv * e2z, pz)
    ua_u, ua_v = f[F_UVA + 0], f[F_UVA + 1]
    ub_u, ub_v = f[F_UVA + 2], f[F_UVA + 3]
    uc_u, uc_v = f[F_UVA + 4], f[F_UVA + 5]
    if compat.triangle_uv_bbox_remap:
        lo_u = jnp.minimum(jnp.minimum(ua_u, ub_u), uc_u)
        hi_u = jnp.maximum(jnp.maximum(ua_u, ub_u), uc_u)
        lo_v = jnp.minimum(jnp.minimum(ua_v, ub_v), uc_v)
        hi_v = jnp.maximum(jnp.maximum(ua_v, ub_v), uc_v)
        t_u = lo_u + (hi_u - lo_u) * bu
        t_v = lo_v + (hi_v - lo_v) * bv
    else:
        w0 = 1.0 - bu - bv
        t_u = w0 * ua_u + bu * ub_u + bv * uc_u
        t_v = w0 * ua_v + bu * ub_v + bv * uc_v

    u = jnp.where(is_sphere, s_u, t_u)
    v = jnp.where(is_sphere, s_v, t_v)

    # --- Texture (texture.rs): solid / checker / image. -----------------
    tex_kind = f[F_TEX_KIND]
    cells = (
        jnp.floor(f[F_INV_SCALE] * px).astype(jnp.int32)
        + jnp.floor(f[F_INV_SCALE] * py).astype(jnp.int32)
        + jnp.floor(f[F_INV_SCALE] * pz).astype(jnp.int32)
    )
    is_even = jnp.mod(cells, 2) == 0
    use_even = (tex_kind < 0.5) | is_even  # solid always uses CE rows
    tr = jnp.where(use_even, f[F_CE + 0], f[F_CO + 0])
    tg = jnp.where(use_even, f[F_CE + 1], f[F_CO + 1])
    tb = jnp.where(use_even, f[F_CE + 2], f[F_CO + 2])
    if scene.has_image_textures:
        # The one gather on the path; only compiled in when the scene has
        # image textures at all (texture.rs:107-117: clamp + truncate).
        w_img = jnp.maximum(f[F_RECT + 2], 1.0)
        h_img = jnp.maximum(f[F_RECT + 3], 1.0)
        ix = (jnp.clip(u, 0.0, 1.0) * (w_img - 1.0)).astype(jnp.int32)
        iy = (jnp.clip(v, 0.0, 1.0) * (h_img - 1.0)).astype(jnp.int32)
        ax = jnp.clip(f[F_RECT + 0].astype(jnp.int32) + ix, 0, scene.atlas.shape[1] - 1)
        ay = jnp.clip(f[F_RECT + 1].astype(jnp.int32) + iy, 0, scene.atlas.shape[0] - 1)
        texel = scene.atlas[ay, ax]  # [B,3] gather
        is_image = tex_kind > 1.5
        tr = jnp.where(is_image, texel[:, 0], tr)
        tg = jnp.where(is_image, texel[:, 1], tg)
        tb = jnp.where(is_image, texel[:, 2], tb)

    # --- Scatter (material.rs). -----------------------------------------
    kind = f[F_MAT_KIND]
    ux3 = rng.uniform(seed, work, depth, 3) * 2.0 - 1.0
    uy3 = rng.uniform(seed, work, depth, 4) * 2.0 - 1.0
    uz3 = rng.uniform(seed, work, depth, 5) * 2.0 - 1.0
    inv_n1 = 1.0 / jnp.maximum(jnp.sqrt(ux3 * ux3 + uy3 * uy3 + uz3 * uz3), 1e-12)
    r1x, r1y, r1z = ux3 * inv_n1, uy3 * inv_n1, uz3 * inv_n1  # random_unit #1
    vx3 = rng.uniform(seed, work, depth, 6) * 2.0 - 1.0
    vy3 = rng.uniform(seed, work, depth, 7) * 2.0 - 1.0
    vz3 = rng.uniform(seed, work, depth, 8) * 2.0 - 1.0
    inv_n2 = 1.0 / jnp.maximum(jnp.sqrt(vx3 * vx3 + vy3 * vy3 + vz3 * vz3), 1e-12)
    r2x, r2y, r2z = vx3 * inv_n2, vy3 * inv_n2, vz3 * inv_n2  # random_unit #2
    noise = rng.uniform(seed, work, depth, 9)

    # Lambertian: dir = n + unit (near-zero fallback, material.rs:110-120).
    lx, ly, lz = nx + r1x, ny + r1y, nz + r1z
    near_zero = (
        (jnp.abs(lx) < 3.45e-4) & (jnp.abs(ly) < 3.45e-4) & (jnp.abs(lz) < 3.45e-4)
    )
    lx = jnp.where(near_zero, nx, lx)
    ly = jnp.where(near_zero, ny, ly)
    lz = jnp.where(near_zero, nz, lz)

    # Metal: reflect raw dir + fuzz * unit (material.rs:94-107).
    d_dot_n = dx * nx + dy * ny + dz * nz
    fuzz = f[F_FUZZ]
    mx = dx - 2.0 * d_dot_n * nx + fuzz * r2x
    my = dy - 2.0 * d_dot_n * ny + fuzz * r2y
    mz = dz - 2.0 * d_dot_n * nz + fuzz * r2z

    # Dielectric (material.rs:150-178).
    inv_dn = 1.0 / jnp.maximum(jnp.sqrt(dx * dx + dy * dy + dz * dz), 1e-20)
    udx, udy, udz = dx * inv_dn, dy * inv_dn, dz * inv_dn
    ri = jnp.where(front, 1.0 / f[F_IOR], f[F_IOR])
    cos_t = jnp.minimum(-(udx * nx + udy * ny + udz * nz), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)  # Schlick on the active ratio (material.rs:181-186)
    r0 = r0 * r0
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    choose_reflect = cannot | (reflectance > noise)
    # refract: perp = (ud + n cos) * ri; par = -sqrt(|1-|perp|^2|) n
    rpx = (udx + nx * cos_t) * ri
    rpy = (udy + ny * cos_t) * ri
    rpz = (udz + nz * cos_t) * ri
    perp_sq = rpx * rpx + rpy * rpy + rpz * rpz
    par = -jnp.sqrt(jnp.maximum(jnp.abs(1.0 - perp_sq), 1e-12))
    fzx = rpx + par * nx + fuzz * r2x
    fzy = rpy + par * ny + fuzz * r2y
    fzz = rpz + par * nz + fuzz * r2z
    ud_dot_n = udx * nx + udy * ny + udz * nz
    rfx = udx - 2.0 * ud_dot_n * nx
    rfy = udy - 2.0 * ud_dot_n * ny
    rfz = udz - 2.0 * ud_dot_n * nz
    ddx = jnp.where(choose_reflect, rfx, fzx)
    ddy = jnp.where(choose_reflect, rfy, fzy)
    ddz = jnp.where(choose_reflect, rfz, fzz)
    inv_dd = 1.0 / jnp.maximum(jnp.sqrt(ddx * ddx + ddy * ddy + ddz * ddz), 1e-20)
    ddx, ddy, ddz = ddx * inv_dd, ddy * inv_dd, ddz * inv_dd

    is_lam = kind < 0.5
    is_metal = (kind > 0.5) & (kind < 1.5)
    is_diel = (kind > 1.5) & (kind < 2.5)
    is_emissive = kind > 2.5  # extension (MAT_EMISSIVE): terminate + deposit
    new_dx = jnp.where(is_lam, lx, jnp.where(is_metal, mx, ddx))
    new_dy = jnp.where(is_lam, ly, jnp.where(is_metal, my, ddy))
    new_dz = jnp.where(is_lam, lz, jnp.where(is_metal, mz, ddz))
    att_r = jnp.where(is_diel, 1.0, tr)
    att_g = jnp.where(is_diel, 1.0, tg)
    att_b = jnp.where(is_diel, 1.0, tb)

    # RR survival (camera.rs:280-293; clamped, never panics).
    p_rr = jnp.clip(jnp.maximum(jnp.maximum(att_r, att_g), att_b), 0.0, compat.rr_clamp)
    survive = rng.uniform(seed, work, depth, 10) < p_rr
    inv_p = 1.0 / jnp.maximum(p_rr, 1e-12)

    # New origin with scale-aware offset along the outgoing side.
    scale = jnp.maximum(
        jnp.maximum(jnp.abs(px), jnp.maximum(jnp.abs(py), jnp.abs(pz))), 1.0
    )
    side = jnp.sign(new_dx * nx + new_dy * ny + new_dz * nz)
    off = cfg.origin_offset * scale * side
    new_rays = jnp.stack(
        [px + off * nx, py + off * ny, pz + off * nz, new_dx, new_dy, new_dz,
         jnp.zeros_like(px), jnp.zeros_like(px)],
        axis=0,
    )

    # Sky for miss lanes (hittable.rs:84-93) — scalarized Perez evaluation.
    sky_r, sky_g, sky_b = _sky_rows(scene, dx * inv_dn, dy * inv_dn, dz * inv_dn)

    return dict(
        new_rays=new_rays,
        att=(att_r * inv_p, att_g * inv_p, att_b * inv_p),
        sky=(sky_r, sky_g, sky_b),
        emit=(tr, tg, tb),  # emissive radiance (texture rows; HDR-capable)
        emissive=is_emissive,
        hit=hit,
        survive=survive,
    )


def sphere_nearest_rows(
    scene: SceneData, rays: jnp.ndarray, t_min: float, t_max: float
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Brute-force sphere query over [S, B] broadcasts: (t f32[B], BIG =
    miss; idx i32[B], -1 = miss).  Same math as hittable.rs:319-338 in the
    well-conditioned |oc|^2 form."""
    ox, oy, oz = rays[0][None], rays[1][None], rays[2][None]
    dx, dy, dz = rays[3][None], rays[4][None], rays[5][None]
    c = scene.sph_center  # [S, 3]
    cx, cy, cz = c[:, 0:1], c[:, 1:2], c[:, 2:3]
    rad = scene.sph_radius[:, None]
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    a = dx * dx + dy * dy + dz * dz
    h = dx * ocx + dy * ocy + dz * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = h * h - a * cc
    sd = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv_a = 1.0 / a
    t0 = (h - sd) * inv_a
    t1 = (h + sd) * inv_a
    t_cand = jnp.where(t0 >= t_min, t0, t1)
    ok = (disc >= 0.0) & (rad > 0.0) & (t_cand >= t_min) & (t_cand < t_max)
    t_cand = jnp.where(ok, t_cand, BIG)
    idx = jnp.argmin(t_cand, axis=0).astype(jnp.int32)
    t_best = jnp.min(t_cand, axis=0)
    return t_best, jnp.where(t_best < BIG, idx, -1)


def triangle_nearest_rows(
    scene: SceneData, rays: jnp.ndarray, t_min: float, t_max: float, compat: CompatConfig
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Scalarized brute-force Möller–Trumbore over all triangles via
    [T, B] broadcasts (hittable.rs:411-461).  Returns (t f32[B] BIG=miss,
    idx i32[B] into triangles).  Intended for small T (the fast wavefront
    path gates on it); large meshes use the BVH path."""
    ox, oy, oz = rays[0][None], rays[1][None], rays[2][None]  # [1,B]
    dx, dy, dz = rays[3][None], rays[4][None], rays[5][None]
    a = scene.tri_a
    e1 = scene.tri_b - a
    e2 = scene.tri_c - a
    ax_, ay_, az_ = a[:, 0:1], a[:, 1:2], a[:, 2:3]  # [T,1]
    e1x, e1y, e1z = e1[:, 0:1], e1[:, 1:2], e1[:, 2:3]
    e2x, e2y, e2z = e2[:, 0:1], e2[:, 1:2], e2[:, 2:3]

    uvx = dy * e2z - dz * e2y  # [T,B]
    uvy = dz * e2x - dx * e2z
    uvz = dx * e2y - dy * e2x
    det = e1x * uvx + e1y * uvy + e1z * uvz
    if compat.triangle_backface_cull:
        det_ok = det > 1e-7
    else:
        det_ok = jnp.abs(det) > 1e-7
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
    aox, aoy, aoz = ox - ax_, oy - ay_, oz - az_
    u = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det
    vvx = aoy * e1z - aoz * e1y
    vvy = aoz * e1x - aox * e1z
    vvz = aox * e1y - aoy * e1x
    v = (dx * vvx + dy * vvy + dz * vvz) * inv_det
    t = (e2x * vvx + e2y * vvy + e2z * vvz) * inv_det
    ok = (
        det_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t < t_max)
        & (t > 1e-7)
    )
    t = jnp.where(ok, t, BIG)
    idx = jnp.argmin(t, axis=0).astype(jnp.int32)  # [B]
    t_best = jnp.min(t, axis=0)
    return t_best, idx


def nearest_rows(
    scene: SceneData, rays: jnp.ndarray, t_min: float, t_max: float, compat: CompatConfig
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest primitive over all spheres and triangles (XLA rows): (t
    f32[B], BIG = miss; prim i32[B] global id, -1 = miss).  A sphere wins
    a tie with a triangle."""
    n = rays.shape[1]
    if scene.num_spheres > 0:
        t_s, id_s = sphere_nearest_rows(scene, rays, t_min, t_max)
    else:
        t_s, id_s = jnp.full((n,), BIG, jnp.float32), jnp.full((n,), -1, jnp.int32)
    if scene.num_triangles == 0:
        return t_s, id_s
    t_t, id_t = triangle_nearest_rows(scene, rays, t_min, t_max, compat)
    tri_better = t_t < t_s
    t_best = jnp.where(tri_better, t_t, t_s)
    prim = jnp.where(tri_better, id_t + scene.num_spheres, id_s)
    return t_best, jnp.where(t_best < BIG, prim, -1)


def _sky_rows(scene: SceneData, dx, dy, dz):
    """sky.sky_color_toward on component rows (sky.py holds the citations)."""
    from rt_tpu import color as color_mod
    from rt_tpu import sky as sky_mod

    params = scene.sky
    sun = params.sun_direction / jnp.linalg.norm(params.sun_direction)
    cos_theta = jnp.clip(dz, 0.01, 1.0)
    cos_gamma = jnp.clip(dx * sun[0] + dy * sun[1] + dz * sun[2], -1.0, 1.0)
    if params.cos_gamma_as_angle:  # hittable.rs:86 quirk (see sky.py)
        gamma = cos_gamma
        cos_gamma = jnp.cos(gamma)
    else:
        gamma = jnp.arccos(jnp.clip(cos_gamma, -1.0 + 1e-6, 1.0 - 1e-6))

    white_scale = 1.0 / color_mod.uncharted2_tonemap(jnp.float32(11.2))
    tm = lambda x: jnp.maximum(
        white_scale * color_mod.uncharted2_tonemap(1.1 * x), 0.0
    )
    if params.hw_params is not None:  # Hosek-Wilkie mode (sky.py)
        r, g, b = sky_mod.hosek_radiance_rgb(
            params.hw_params, cos_theta, gamma, cos_gamma
        )
        e = params.exposure
        return tm(r * e), tm(g * e), tm(b * e)
    theta_s = jnp.arccos(jnp.clip(sun[2], 0.0, 1.0 - 1e-6))
    cos_theta_s = jnp.cos(theta_s)

    coef_y, coef_x, coef_yc = sky_mod.perez_coefficients(params.turbidity)
    yz, xz, yz_c = sky_mod.zenith_values(params.turbidity, theta_s)

    def channel(coef, zenith):
        num = sky_mod._perez(coef, cos_theta, gamma, cos_gamma)
        den = sky_mod._perez(
            coef, jnp.asarray(1.0, jnp.float32), theta_s, cos_theta_s
        )
        return zenith * num / den

    y_lum = jnp.maximum(channel(coef_y, yz), 0.0) * params.exposure
    x_c = channel(coef_x, xz)
    y_c = jnp.maximum(channel(coef_yc, yz_c), 1e-6)
    big_x = x_c / y_c * y_lum
    big_z = (1.0 - x_c - y_c) / y_c * y_lum
    m = sky_mod._XYZ_TO_SRGB
    r = m[0, 0] * big_x + m[0, 1] * y_lum + m[0, 2] * big_z
    g = m[1, 0] * big_x + m[1, 1] * y_lum + m[1, 2] * big_z
    b = m[2, 0] * big_x + m[2, 1] * y_lum + m[2, 2] * big_z
    r = jnp.maximum(r, 0.0)
    g = jnp.maximum(g, 0.0)
    b = jnp.maximum(b, 0.0)
    # Uncharted2 per channel (the white scale is channel-independent).
    white_scale = 1.0 / color_mod.uncharted2_tonemap(jnp.float32(11.2))
    tm = lambda x: jnp.maximum(
        white_scale * color_mod.uncharted2_tonemap(1.1 * x), 0.0
    )
    return tm(r), tm(g), tm(b)
