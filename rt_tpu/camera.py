"""Camera model and batched ray generation.

Matches the reference camera math (camera.rs:167-254): look-at basis
(u, v, w), vertical FoV in degrees, focus distance, thin-lens defocus disk
(defocus angle in degrees), viewport pixel deltas and ``pixel00_loc``.

Design inversion vs the reference: ``get_ray`` there produces one ray per
call per thread (camera.rs:231-254); here ``generate_rays`` produces a whole
SoA megabatch of (origin, direction) for (pixel, sample) index arrays in one
fused, jittable computation.  Directions are deliberately NOT normalized,
matching the reference (camera.rs:253 passes ``pixel_sample - origin`` raw;
only the sky lookup and dielectric math normalize).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rt_tpu import sampling
from rt_tpu.config import CompatConfig
from rt_tpu.pytree import PyTreeNode, static_field


class Camera(PyTreeNode):
    """Precomputed camera frame (reference analog: Camera struct,
    camera.rs:24-51).  A pytree so it can be jitted through / differentiated
    (e.g. gradients w.r.t. camera center for pose optimization)."""

    center: jnp.ndarray  # (3,)
    pixel00_loc: jnp.ndarray  # (3,)
    pixel_du: jnp.ndarray  # (3,)
    pixel_dv: jnp.ndarray  # (3,)
    defocus_disk_u: jnp.ndarray  # (3,)
    defocus_disk_v: jnp.ndarray  # (3,)
    defocus_angle: jnp.ndarray  # () degrees; <= 0 disables defocus
    image_width: int = static_field(800)
    image_height: int = static_field(600)

    # -- ray generation ----------------------------------------------------

    def generate_rays(
        self,
        pixel_x: jnp.ndarray,
        pixel_y: jnp.ndarray,
        sample_index: jnp.ndarray,
        key: jax.Array,
        compat: CompatConfig = CompatConfig(),
    ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Batched ``get_ray`` (camera.rs:231-254).

        Args:
          pixel_x, pixel_y: i32[N] pixel coordinates.
          sample_index: i32[N] per-pixel sample counter (Halton index).
          key: base key for defocus sampling (and jitter scrambling when
            ``compat.shared_halton_jitter`` is False).

        Returns:
          (origins f32[N,3], directions f32[N,3]) — directions unnormalized.
        """
        n = pixel_x.shape[0]
        off_u, off_v = sampling.halton_pair(sample_index)
        if not compat.shared_halton_jitter:
            # Per-pixel Cranley–Patterson rotation decorrelates pixels and
            # kills the reference's moiré artifact (scenes.rs:140-145).
            # Same hash-RNG stream as the wavefront (wavefront._camera_jitter:
            # purposes 5/6 keyed on the flat pixel id), so both integrators
            # render identical images in the corrected mode.
            from rt_tpu import rng as rng_mod

            seed = jax.random.key_data(key).reshape(-1)[-1].astype(jnp.uint32)
            pix_id = pixel_y.astype(jnp.int32) * jnp.int32(self.image_width) + (
                pixel_x.astype(jnp.int32)
            )
            off_u = jnp.mod(off_u + rng_mod.uniform(seed, pix_id, 0, 5), 1.0)
            off_v = jnp.mod(off_v + rng_mod.uniform(seed, pix_id, 0, 6), 1.0)

        # NOTE: reference jitter is in [0,1) *added to the pixel-center
        # location* (camera.rs:241-243) — a half-pixel skew it inherits from
        # indexing pixel00_loc at pixel centers.  Replicated as-is.
        px = pixel_x.astype(jnp.float32) + off_u
        py = pixel_y.astype(jnp.float32) + off_v
        pixel_sample = (
            self.pixel00_loc[None, :]
            + px[:, None] * self.pixel_du[None, :]
            + py[:, None] * self.pixel_dv[None, :]
        )

        disk = sampling.random_in_unit_disc(jax.random.fold_in(key, 0xD15C), (n,))
        defocus_origin = (
            self.center[None, :]
            + disk[:, 0:1] * self.defocus_disk_u[None, :]
            + disk[:, 1:2] * self.defocus_disk_v[None, :]
        )
        use_defocus = self.defocus_angle > 0.0
        origin = jnp.where(use_defocus, defocus_origin, self.center[None, :])
        direction = pixel_sample - origin
        return origin, direction

    def debug_ray(self, x: float, y: float) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Center-of-pixel ray with no jitter or defocus (camera.rs:256-260),
        used by the click-to-inspect probe."""
        pixel_sample = self.pixel00_loc + self.pixel_du * x + self.pixel_dv * y
        return self.center, pixel_sample - self.center


def make_camera(
    center,
    lookat,
    up,
    *,
    focus_distance: float,
    defocus_angle: float,
    image_width: int,
    image_height: int,
    vertical_fov: float,
) -> Camera:
    """Build the camera frame (camera.rs:169-227).

    All inputs accept python / numpy / jax values; math follows the reference
    line for line in f32: basis w = normalize(center - lookat),
    u = normalize(up x w), v = w x u; viewport sized by vfov at the focus
    plane; pixel00 at the top-left pixel *center*.
    """
    center = jnp.asarray(center, jnp.float32)
    lookat = jnp.asarray(lookat, jnp.float32)
    up = jnp.asarray(up, jnp.float32)

    w = center - lookat
    w = w / jnp.linalg.norm(w)
    u = jnp.cross(up, w)
    u = u / jnp.linalg.norm(u)
    v = jnp.cross(w, u)

    h = jnp.tan(jnp.deg2rad(vertical_fov) / 2.0)
    viewport_height = 2.0 * h * focus_distance
    aspect = image_width / image_height
    viewport_width = viewport_height * aspect

    viewport_u = u * viewport_width  # left -> right
    viewport_v = -v * viewport_height  # top -> bottom
    pixel_du = viewport_u / image_width
    pixel_dv = viewport_v / image_height

    vp_upper_left = center - w * focus_distance - viewport_u / 2.0 - viewport_v / 2.0
    pixel00_loc = vp_upper_left + (pixel_du + pixel_dv) / 2.0

    defocus_radius = focus_distance * jnp.tan(jnp.deg2rad(defocus_angle / 2.0))
    return Camera(
        center=center,
        pixel00_loc=pixel00_loc,
        pixel_du=pixel_du,
        pixel_dv=pixel_dv,
        defocus_disk_u=u * defocus_radius,
        defocus_disk_v=v * defocus_radius,
        defocus_angle=jnp.asarray(defocus_angle, jnp.float32),
        image_width=int(image_width),
        image_height=int(image_height),
    )
