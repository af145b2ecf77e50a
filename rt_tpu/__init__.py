"""rt_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference Rust
CPU path tracer `thabnir/rt` (see SURVEY.md). The reference is a recursive,
per-ray, AoS, pointer-chasing design; rt_tpu is an iterative, batched, SoA,
wavefront design:

- Rays live in structure-of-arrays megabatches; bounces advance in a bounded
  ``lax.while_loop``/``lax.scan`` with masked termination (Russian roulette).
- BVH-less scenes intersect every primitive per bounce, in one fused kernel
  that also fetches the winner's shading parameters (pallas_ops.py).
- Triangle meshes use a host-built BVH (C++ binned-SAH builder, flattened SoA
  nodes with skip/escape indices) and a stackless per-ray traversal.
- Randomness is counter-based, keyed by (pixel, sample, bounce) —
  deterministic and replayable, which the backward pass requires.
- The whole forward renderer is a pure function of scene parameters, so pixel
  gradients flow to material / texture / sky parameters via ``jax.grad``.
- Scale-out is pixel-tile sharding over a ``jax.sharding.Mesh`` with XLA
  collectives.
"""

from rt_tpu.config import RenderConfig, CompatConfig, ProgressiveSchedule
from rt_tpu.camera import Camera, make_camera
from rt_tpu.scene import SceneData, SceneBuilder
from rt_tpu.sky import SkyParams
from rt_tpu.render import render_image, render_pixel_colors

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "CompatConfig",
    "ProgressiveSchedule",
    "Camera",
    "make_camera",
    "SceneData",
    "SceneBuilder",
    "SkyParams",
    "render_image",
    "render_pixel_colors",
]
