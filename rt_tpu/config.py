"""Configuration layer.

The reference has no config system at all — resolution, spp, depth, scene
choice and asset paths are hardcoded constants and commented-out lines
(reference: window.rs:29-30, scenes.rs:15, main.rs:50-55; a CLI is an
unchecked TODO at TODO.md:136-140). rt_tpu makes configuration a first-class
subsystem: frozen dataclasses shared by the library, CLI and tests.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# f32 policy: the reference uses f64 everywhere (camera.rs:18) because f32
# produced shadow-acne artifacts (TODO.md:38-40).  rt_tpu renders in f32
# (the accelerator's native width) and instead fixes robustness
# structurally: ray origins are offset along the geometric normal after
# every bounce (see integrator.py), and epsilons are scene-scale aware.
DEFAULT_T_MIN = 1.0e-3  # shadow-acne epsilon (reference: camera.rs:297, `0.001..`)
DEFAULT_T_MAX = 3.0e38  # stand-in for Float::MAX (reference: camera.rs:22)


@dataclasses.dataclass(frozen=True)
class CompatConfig:
    """Flags reproducing (or fixing) reference quirks.

    Each flag defaults to the *reference-faithful* behavior so golden images
    track the reference; flip them for the "corrected" renderer.
    """

    # Triangle hit UVs: the reference remaps barycentric (u, v) into the
    # bounding box of the three vertex UVs instead of interpolating
    # (hittable.rs:466-481). True = replicate that quirk.
    triangle_uv_bbox_remap: bool = True

    # The reference's Halton jitter is indexed by sample index only, so every
    # pixel in a pass shares the same sub-pixel offset (camera.rs:239,
    # acknowledged moiré bug at scenes.rs:140-145).  True = replicate;
    # False = per-pixel scrambled offsets (fixes the moiré).
    shared_halton_jitter: bool = True

    # The reference applies Russian roulette with p = max(attenuation) and
    # panics if p > 1 (camera.rs:288).  rt_tpu clamps p into (0, rr_clamp]
    # so no input can crash the renderer.
    rr_clamp: float = 1.0

    # Backface culling for triangles (det < EPSILON reject, hittable.rs:428).
    triangle_backface_cull: bool = True

    # glTF materials: the reference maps *every* PBR material to Metal with
    # fuzz = roughness_factor (material.rs:20-33).  True = replicate;
    # False = a metallic-factor-aware mapping (dielectric-free PBR approx).
    gltf_all_metal: bool = True


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level render settings (reference analog: Camera fields +
    window.rs consts; here decoupled from the camera model)."""

    width: int = 800
    height: int = 600
    samples_per_pixel: int = 32
    # Reference MAX_DEPTH = 100 (scenes.rs:15).  Wavefront equivalent: the
    # bounce loop runs at most `max_depth` iterations; Russian roulette
    # retires nearly all rays long before that.
    max_depth: int = 100
    # Bounce count for the *differentiable* path (lax.scan needs a static
    # trip count for reverse-mode AD; 100 is wasteful for gradients).
    diff_max_depth: int = 8
    t_min: float = DEFAULT_T_MIN
    t_max: float = DEFAULT_T_MAX
    # Scale-aware ray-origin offset applied along the outward geometric
    # normal after each bounce (f32 robustness; see module docstring).
    origin_offset: float = 1.0e-4
    # Base RNG seed; all randomness is threefry-derived from this.
    seed: int = 0
    # Rays processed per device dispatch (pixels*spp are chunked to bound
    # the wavefront state's device memory).
    max_rays_per_batch: int = 1 << 20
    # Detach discrete sampling decisions in the backward pass (path-replay
    # style).  Keep True: unbiased detached-sampling estimator.
    detach_sampling: bool = True
    compat: CompatConfig = dataclasses.field(default_factory=CompatConfig)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ProgressiveSchedule:
    """Progressive refinement pass schedule.

    The reference hardcodes a 237-pass schedule totaling 40,055 spp
    (window.rs:233-247).  We keep the same geometric ramp shape but make it a
    config object.
    """

    ramp: Tuple[int, ...] = (1, 2, 4, 8, 8, 16, 16, 32, 32)
    sustain_64: int = 84
    sustain_128: int = 18
    sustain_256: int = 126

    def passes(self) -> Tuple[int, ...]:
        return (
            self.ramp
            + (64,) * self.sustain_64
            + (128,) * self.sustain_128
            + (256,) * self.sustain_256
        )

    @staticmethod
    def reference() -> "ProgressiveSchedule":
        """The exact reference schedule: 237 passes, 40,055 spp total."""
        return ProgressiveSchedule()
