"""Batch rendering: pixel megabatches -> radiance -> image.

Reference analog: ``Camera::render_pixel`` / ``render_image``
(camera.rs:315-341) — a Rayon par_iter over (y, x) pixels with a nested
par_iter over samples.  rt_tpu flattens (pixel, sample) into ray megabatches
(chunked to bound the wavefront state's device memory), traces each chunk
with one fused jitted program, and mean-reduces over samples on device.

The Mray/s metric follows the reference definition exactly
(window.rs:315-324): rays = spp * W * H camera samples (bounces NOT
counted), divided by wall seconds.
"""

from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from rt_tpu.camera import Camera
from rt_tpu.config import RenderConfig
from rt_tpu.integrator import trace_radiance, trace_radiance_diff
from rt_tpu.scene import SceneData


@partial(jax.jit, static_argnames=("cfg", "spp", "differentiable"))
def render_chunk(
    scene: SceneData,
    camera: Camera,
    pixel_idx: jnp.ndarray,
    cfg: RenderConfig,
    spp: int,
    sample_offset: jnp.ndarray,
    key: jax.Array,
    differentiable: bool = False,
) -> jnp.ndarray:
    """Render ``spp`` samples for a flat chunk of pixel indices.

    Args:
      pixel_idx: i32[P] flattened pixel ids (y * W + x).
      sample_offset: starting sample index (progressive accumulation uses
        the reference's indexing, camera.rs:239: pass k of n samples uses
        Halton entries [offset, offset+n)).

    Returns: mean radiance per pixel, f32[P,3].
    """
    p = pixel_idx.shape[0]
    width = camera.image_width

    pix = jnp.repeat(pixel_idx, spp)  # [P*spp]
    sample = jnp.tile(jnp.arange(spp, dtype=jnp.int32), (p,)) + sample_offset
    px = pix % width
    py = pix // width

    cam_key = jax.random.fold_in(key, 0xCA0)
    org, dirn = camera.generate_rays(px, py, sample, cam_key, cfg.compat)

    trace = trace_radiance_diff if differentiable else trace_radiance
    radiance = trace(scene, org, dirn, jax.random.fold_in(key, 0x7ACE), cfg)
    return jnp.mean(radiance.reshape(p, spp, 3), axis=1)


def render_pixel_colors(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    *,
    spp: int | None = None,
    sample_offset: int = 0,
    key: jax.Array | None = None,
    wavefront: bool = True,
) -> jnp.ndarray:
    """Render the full frame to a linear-color device array f32[H,W,3]
    (reference analog: render_image, camera.rs:327-341, minus file I/O).

    ``wavefront=True`` (default) uses the persistent-wavefront integrator
    with ray regeneration (rt_tpu/wavefront.py) — ~occupancy-1 regardless
    of path-length variance.  ``wavefront=False`` falls back to the simple
    chunked megabatch (used by the differentiable path and as a reference
    implementation)."""
    spp = spp if spp is not None else cfg.samples_per_pixel
    key = key if key is not None else jax.random.key(cfg.seed)
    w, h = camera.image_width, camera.image_height
    n_pixels = w * h

    if wavefront:
        from rt_tpu.wavefront import render_wavefront

        pixel_idx = jnp.arange(n_pixels, dtype=jnp.int32)
        # Chunk high sample counts: the wavefront's per-work deposit buffer
        # scales with pixels * spp (16M work items = 192 MB of f32 RGB).
        # The cap is untuned for the GPU.  RNG streams key on the global
        # (offset-folded) work id, so chunking changes nothing statistically.
        spp_chunk = max(1, min(spp, (16 << 20) // max(n_pixels, 1)))
        if spp_chunk >= spp:
            flat = render_wavefront(
                scene, camera, pixel_idx, cfg, spp, jnp.int32(sample_offset), key
            )
            return flat.reshape(h, w, 3)
        accum = jnp.zeros((n_pixels, 3), jnp.float32)
        done = 0
        while done < spp:
            ns = min(spp_chunk, spp - done)
            part = render_wavefront(
                scene, camera, pixel_idx, cfg, ns, jnp.int32(sample_offset + done), key
            )
            accum = accum + part * ns
            done += ns
        return (accum / spp).reshape(h, w, 3)

    pixels_per_chunk = max(cfg.max_rays_per_batch // max(spp, 1), 1)
    chunks = []
    all_idx = jnp.arange(n_pixels, dtype=jnp.int32)
    offset = jnp.int32(sample_offset)
    for start in range(0, n_pixels, pixels_per_chunk):
        idx = all_idx[start : start + pixels_per_chunk]
        # Pad the ragged tail so every chunk reuses one compiled program.
        pad = pixels_per_chunk - idx.shape[0]
        if pad and n_pixels > pixels_per_chunk:
            idx = jnp.pad(idx, (0, pad))
        colors = render_chunk(
            scene, camera, idx, cfg, spp, offset, jax.random.fold_in(key, start)
        )
        if pad and n_pixels > pixels_per_chunk:
            colors = colors[: pixels_per_chunk - pad]
        chunks.append(colors)
    flat = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, axis=0)
    return flat.reshape(h, w, 3)


def render_image(
    scene: SceneData, camera: Camera, cfg: RenderConfig, **kw
) -> tuple[np.ndarray, dict]:
    """Render and fetch to host; returns (f32[H,W,3] linear image, metrics).

    Metrics include the reference's Mray/s figure (window.rs:315-324)."""
    spp = kw.get("spp") or cfg.samples_per_pixel
    start = time.perf_counter()
    img = render_pixel_colors(scene, camera, cfg, **kw)
    img = np.asarray(jax.block_until_ready(img))
    elapsed = time.perf_counter() - start
    rays = spp * camera.image_width * camera.image_height
    metrics = {
        "wall_s": elapsed,
        "rays": rays,
        "mray_per_s": rays / 1.0e6 / elapsed,
    }
    return img, metrics
