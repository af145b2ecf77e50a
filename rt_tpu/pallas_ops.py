"""Fused nearest-primitive query and shade fetch for the fast wavefront.

One Pallas kernel, written for the GPU through the Triton route.  Each
program owns a block of ``RAY_BLOCK`` rays and loops over the sphere and
triangle tables in chunks of ``PRIM_CHUNK``, keeping the best (t, id) of
every (ray, lane) pair in registers; one reduction at the end picks each
ray's winner, and the epilogue gathers the winner's shade-table columns.
The XLA form of the same work (``fast_shade.nearest_rows`` followed by
``fast_shade.fetch_params``) writes a [P, B] one-hot matrix to device
memory and multiplies it by the table in f32.

The math is the XLA rows' (hittable.rs:319-338 for spheres, Möller–Trumbore
at hittable.rs:411-461 for triangles), in the same order, so the two agree
to rounding; ties go to the lowest primitive id, as ``jnp.argmin`` does.

:func:`nearest_shaded` is the one place that chooses between the kernel
and the XLA rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rt_tpu import fast_shade
from rt_tpu.config import CompatConfig
from rt_tpu.scene import SceneData

BIG = np.float32(fast_shade.BIG)
RAY_BLOCK = 128  # rays per program
PRIM_CHUNK = 32  # primitives per inner-loop step
_NO_ID = np.int32(2**31 - 1)


def nearest_shaded(scene: SceneData, rays, t_min, t_max, compat: CompatConfig):
    """Nearest primitive for each ray of ``rays`` f32[8, B].

    Returns (t f32[B] with BIG on a miss, prim i32[B] with -1 on a miss,
    params f32[F, B] or None).  On the GPU the fused kernel runs and
    ``params`` holds the winners' shade-table columns; on the CPU (where
    the tests run) the XLA rows run and ``params`` is None, so the shading
    step fetches the columns itself."""
    backend = jax.default_backend()
    if backend == "gpu":
        return prim_nearest_shaded(
            rays, scene.sph_center, scene.sph_radius,
            scene.tri_a, scene.tri_b, scene.tri_c, scene.shade_table,
            num_spheres=scene.num_spheres, num_triangles=scene.num_triangles,
            t_min=float(t_min), t_max=float(t_max),
            backface_cull=compat.triangle_backface_cull,
        )
    if backend == "cpu":
        t, prim = fast_shade.nearest_rows(scene, rays, t_min, t_max, compat)
        return t, prim, None
    raise NotImplementedError(f"no intersection path for backend {backend!r}")


def _pad_rows(rows, n_pad):
    """Stack 1-D rows into f32[len(rows), n_pad], zero-padded: a zero-radius
    sphere and a zero-area triangle never hit."""
    table = jnp.stack(rows, axis=0).astype(jnp.float32)
    return jnp.pad(table, ((0, 0), (0, n_pad - table.shape[1])))


def _kernel(
    rays_ref, sph_ref, tri_ref, table_ref, t_ref, prim_ref, params_ref,
    *, n_sph_chunks, n_tri_chunks, num_spheres, t_min, t_max, backface_cull,
):
    rs = pl.ds(pl.program_id(0) * RAY_BLOCK, RAY_BLOCK)
    ox, oy, oz = (rays_ref[i, rs][:, None] for i in range(3))
    dx, dy, dz = (rays_ref[i, rs][:, None] for i in range(3, 6))
    shape = (RAY_BLOCK, PRIM_CHUNK)
    lane = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    init = (jnp.full(shape, BIG, jnp.float32), jnp.zeros(shape, jnp.int32))

    def keep_best(carry, t, c):
        best_t, best_i = carry
        better = t < best_t
        return (
            jnp.where(better, t, best_t),
            jnp.where(better, lane + c * PRIM_CHUNK, best_i),
        )

    def sphere_chunk(c, carry):
        cs = pl.ds(c * PRIM_CHUNK, PRIM_CHUNK)
        ocx = sph_ref[0, cs][None, :] - ox
        ocy = sph_ref[1, cs][None, :] - oy
        ocz = sph_ref[2, cs][None, :] - oz
        rad = sph_ref[3, cs][None, :]
        a = dx * dx + dy * dy + dz * dz
        h = dx * ocx + dy * ocy + dz * ocz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = h * h - a * cc
        sd = jnp.sqrt(jnp.maximum(disc, 0.0))
        inv_a = 1.0 / a
        t0 = (h - sd) * inv_a
        t1 = (h + sd) * inv_a
        t = jnp.where(t0 >= t_min, t0, t1)
        ok = (disc >= 0.0) & (rad > 0.0) & (t >= t_min) & (t < t_max)
        return keep_best(carry, jnp.where(ok, t, BIG), c)

    def triangle_chunk(c, carry):
        cs = pl.ds(c * PRIM_CHUNK, PRIM_CHUNK)
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = (
            tri_ref[i, cs][None, :] for i in range(9)
        )
        uvx = dy * e2z - dz * e2y
        uvy = dz * e2x - dx * e2z
        uvz = dx * e2y - dy * e2x
        det = e1x * uvx + e1y * uvy + e1z * uvz
        det_ok = det > 1e-7 if backface_cull else jnp.abs(det) > 1e-7
        inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
        aox, aoy, aoz = ox - ax, oy - ay, oz - az
        u = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det
        vvx = aoy * e1z - aoz * e1y
        vvy = aoz * e1x - aox * e1z
        vvz = aox * e1y - aoy * e1x
        v = (dx * vvx + dy * vvy + dz * vvz) * inv_det
        t = (e2x * vvx + e2y * vvy + e2z * vvz) * inv_det
        ok = (
            det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t >= t_min) & (t < t_max) & (t > 1e-7)
        )
        return keep_best(carry, jnp.where(ok, t, BIG), c)

    def winner(carry):
        best_t, best_i = carry
        t = jnp.min(best_t, axis=1)
        ids = jnp.where(best_t == t[:, None], best_i, _NO_ID)
        return t, jnp.min(ids, axis=1)

    t_s, i_s = winner(jax.lax.fori_loop(0, n_sph_chunks, sphere_chunk, init))
    t_t, i_t = winner(jax.lax.fori_loop(0, n_tri_chunks, triangle_chunk, init))
    tri_better = t_t < t_s
    t_best = jnp.where(tri_better, t_t, t_s)
    prim = jnp.where(tri_better, i_t + num_spheres, i_s)
    prim = jnp.where(t_best < BIG, prim, -1)
    t_ref[rs] = t_best
    prim_ref[rs] = prim
    col = jnp.maximum(prim, 0)
    for f in range(params_ref.shape[0]):
        params_ref[f, rs] = table_ref[f, col]


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_spheres", "num_triangles", "t_min", "t_max", "backface_cull",
        "interpret",
    ),
)
def prim_nearest_shaded(
    rays, sph_center, sph_radius, tri_a, tri_b, tri_c, shade_table,
    *, num_spheres: int, num_triangles: int, t_min: float, t_max: float,
    backface_cull: bool = True, interpret: bool = False,
):
    """Fused nearest hit + shade fetch (see the module docstring).

    ``rays`` f32[8, N] with N a multiple of RAY_BLOCK; the primitive
    arrays are SceneData's.  Returns (t f32[N], prim i32[N],
    params f32[F, N])."""
    n = rays.shape[1]
    if n % RAY_BLOCK:
        raise ValueError(f"ray count {n} is not a multiple of {RAY_BLOCK}")
    n_sph_chunks = -(-num_spheres // PRIM_CHUNK)
    n_tri_chunks = -(-num_triangles // PRIM_CHUNK)
    sph = _pad_rows(
        [sph_center[:num_spheres, i] for i in range(3)] + [sph_radius[:num_spheres]],
        max(n_sph_chunks, 1) * PRIM_CHUNK,
    )
    a = tri_a[:num_triangles]
    e1 = tri_b[:num_triangles] - a
    e2 = tri_c[:num_triangles] - a
    tri = _pad_rows(
        [m[:, i] for m in (a, e1, e2) for i in range(3)],
        max(n_tri_chunks, 1) * PRIM_CHUNK,
    )
    f_rows = shade_table.shape[0]
    kernel = functools.partial(
        _kernel,
        n_sph_chunks=n_sph_chunks,
        n_tri_chunks=n_tri_chunks,
        num_spheres=num_spheres,
        t_min=t_min,
        t_max=t_max,
        backface_cull=backface_cull,
    )
    return pl.pallas_call(
        kernel,
        grid=(n // RAY_BLOCK,),
        out_shape=[
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((f_rows, n), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="prim_nearest_shaded",
    )(rays, sph, tri, shade_table)
