"""Scale-out: pixel-tile sharding over a device mesh.

The reference's only parallelism is Rayon work-stealing over pixels and
samples on one machine (window.rs:270, camera.rs:317).  Here (SURVEY.md
§5.8) a ``jax.sharding.Mesh`` with a 2-D ('tiles', 'spp') layout:

- **tiles** axis: pixel-tile data parallelism.  The forward sweep is
  embarrassingly parallel; zero communication until image assembly.
- **spp** axis: sample parallelism.  The per-pixel sample mean becomes a
  mesh reduction (an all-reduce that XLA hands to NCCL on GPUs).

Parameters (materials/textures/sky) are replicated; in the training step
their gradients are all-reduced by the partitioner.  The cards of one host
all reach each other at the same rate (NVLink), so the mesh is a plain
reshape of the device list: its shape follows the algorithm alone.
Sharding is expressed with ``NamedSharding`` constraints and ``shard_map``;
the SPMD partitioner inserts the collectives.

Multi-host: the same code runs under ``jax.distributed.initialize`` with a
global mesh; host-local entry points need no changes (jax.jit handles the
global-array plumbing).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rt_tpu import grad as grad_mod
from rt_tpu.camera import Camera
from rt_tpu.config import RenderConfig
from rt_tpu.integrator import trace_radiance, trace_radiance_diff
from rt_tpu.scene import SceneData


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up: ``jax.distributed.initialize`` (SURVEY.md §5.8).

    Pass the coordinator address plus (num_processes, process_id) — e.g.
    the 2-process CPU smoke test (tests/test_multihost.py); nothing detects
    a cluster on its own.  After this,
    ``jax.devices()`` spans the slice and every mesh built by
    :func:`make_mesh` is global — the render/train entry points need no
    changes.  Call once per process, before any other JAX usage.
    """
    import jax

    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)


def put_global(arr, sharding: NamedSharding):
    """Place a host-replicated array onto a (possibly multi-process) mesh.

    ``jax.device_put`` only reaches process-addressable devices; on a
    global mesh each process must contribute its own shards, which
    ``make_array_from_callback`` expresses for both cases."""
    arr = np.asarray(arr)
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def make_mesh(n_devices: int | None = None, tiles: int | None = None) -> Mesh:
    """('tiles', 'spp') mesh.  With no arguments, uses every device on the
    tiles axis (the common render layout)."""
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    devices = np.asarray(devices[:n])
    t = tiles if tiles is not None else n
    s = n // t
    assert t * s == n, f"{n} devices cannot form ({t}, {s}) mesh"
    return Mesh(devices.reshape(t, s), ("tiles", "spp"))


@partial(jax.jit, static_argnames=("cfg", "spp", "width", "differentiable"))
def _trace_pixels(
    scene: SceneData,
    camera: Camera,
    pixel_idx: jnp.ndarray,  # i32[P] sharded over 'tiles'
    sample_idx: jnp.ndarray,  # i32[S] sharded over 'spp'
    cfg: RenderConfig,
    spp: int,
    width: int,
    key: jax.Array,
    differentiable: bool = False,
) -> jnp.ndarray:
    """Mean radiance per pixel f32[P,3] on a (pixels x samples) grid.

    The ray batch is the outer product of sharded pixel and sample index
    arrays, so rays inherit a 2-D sharding; the sample mean contracts the
    'spp'-sharded axis (partitioner inserts the psum)."""
    p = pixel_idx.shape[0]
    s = sample_idx.shape[0]
    pix = jnp.repeat(pixel_idx, s)
    sample = jnp.tile(sample_idx, (p,))
    px = pix % width
    py = pix // width
    org, dirn = camera.generate_rays(
        px, py, sample, jax.random.fold_in(key, 0xCA0), cfg.compat
    )
    trace = trace_radiance_diff if differentiable else trace_radiance
    radiance = trace(scene, org, dirn, jax.random.fold_in(key, 0x7ACE), cfg)
    return jnp.mean(radiance.reshape(p, s, 3), axis=1)


def render_sharded(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    *,
    spp: int | None = None,
    key: jax.Array | None = None,
) -> jnp.ndarray:
    """Full-frame render with pixels sharded over mesh axis 'tiles' and
    samples over 'spp'.  Returns f32[H,W,3] (replicated)."""
    spp = spp if spp is not None else cfg.samples_per_pixel
    key = key if key is not None else jax.random.key(cfg.seed)
    w, h = camera.image_width, camera.image_height
    n_pixels = w * h

    t = mesh.shape["tiles"]
    s = mesh.shape["spp"]
    pad_pixels = (-n_pixels) % t
    pad_spp = (-spp) % s

    pixel_idx = jnp.arange(n_pixels + pad_pixels, dtype=jnp.int32)
    sample_idx = jnp.arange(spp + pad_spp, dtype=jnp.int32)
    pixel_idx = put_global(pixel_idx, NamedSharding(mesh, P("tiles")))
    sample_idx = put_global(sample_idx, NamedSharding(mesh, P("spp")))

    colors = _trace_pixels(
        scene, camera, pixel_idx, sample_idx, cfg, spp, w, key
    )
    return colors[:n_pixels].reshape(h, w, 3)


def render_sharded_wavefront(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    *,
    spp: int | None = None,
    key: jax.Array | None = None,
) -> jnp.ndarray:
    """Production multi-chip forward render: each device runs the
    persistent wavefront (rt_tpu/wavefront.py) over its own pixel shard
    via ``shard_map`` — embarrassingly parallel, zero collectives until
    the final gather (SURVEY.md §5.8's "DCN only at image assembly").

    Because wavefront RNG keys on the global (sample, pixel) pair, the
    result is bit-identical to the single-device render regardless of the
    mesh shape (tested on the simulated 8-device CPU mesh)."""
    try:
        from jax import shard_map  # jax >= 0.6
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map

    from rt_tpu.wavefront import render_wavefront

    spp = spp if spp is not None else cfg.samples_per_pixel
    key = key if key is not None else jax.random.key(cfg.seed)
    w, h = camera.image_width, camera.image_height
    n_pixels = w * h
    t = mesh.shape["tiles"] * mesh.shape["spp"]
    n_pad = n_pixels + ((-n_pixels) % t)
    # Pad with repeats of pixel 0 (harmless extra work, dropped below).
    pixel_idx = jnp.concatenate(
        [
            jnp.arange(n_pixels, dtype=jnp.int32),
            jnp.zeros((n_pad - n_pixels,), jnp.int32),
        ]
    )
    pixel_idx = put_global(pixel_idx, NamedSharding(mesh, P(("tiles", "spp"))))

    import inspect

    kw = {}
    sig = inspect.signature(shard_map).parameters
    if "check_rep" in sig:
        kw["check_rep"] = False  # legacy jax.experimental API only
    if "check_vma" in sig:
        # pallas_call outputs carry no varying-axes annotation; every shard
        # renders on its own (no collectives), so the check adds nothing.
        kw["check_vma"] = False

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(("tiles", "spp")),),
        out_specs=P(("tiles", "spp")),
        **kw,
    )
    def shard_fn(pix_local):
        return render_wavefront(
            scene, camera, pix_local, cfg, spp, jnp.int32(0), key
        )

    colors = jax.jit(shard_fn)(pixel_idx)
    return colors[:n_pixels].reshape(h, w, 3)


@partial(jax.jit, static_argnames=("cfg", "spp", "width", "lr"))
def _train_step(
    params: grad_mod.SceneParams,
    scene: SceneData,
    camera: Camera,
    pixel_idx: jnp.ndarray,
    sample_idx: jnp.ndarray,
    target: jnp.ndarray,
    key: jax.Array,
    cfg: RenderConfig,
    spp: int,
    width: int,
    lr: float = 1e-2,
):
    """One inverse-rendering SGD step: render (sharded) -> MSE vs target ->
    grads w.r.t. material/texture/sky params (all-reduced by the
    partitioner) -> parameter update.  Params replicated, pixels sharded."""

    def loss_fn(p):
        s = grad_mod.set_params(scene, p)
        colors = _trace_pixels(
            s, camera, pixel_idx, sample_idx, cfg, spp, width, key, differentiable=True
        )
        return jnp.mean((colors - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return loss, new_params


def train_step_sharded(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    pixel_idx: np.ndarray,
    target: np.ndarray,
    *,
    spp: int = 1,
    key: jax.Array | None = None,
    lr: float = 1e-2,
):
    """Full sharded training step (the multi-chip dryrun entry): pixels
    over 'tiles', samples over 'spp', params replicated.

    Returns (loss, updated SceneData)."""
    key = key if key is not None else jax.random.key(cfg.seed)
    s = mesh.shape["spp"]
    spp_padded = spp + ((-spp) % s)

    pixel_sharding = NamedSharding(mesh, P("tiles"))
    replicated = NamedSharding(mesh, P())
    pixel_idx = put_global(np.asarray(pixel_idx, np.int32), pixel_sharding)
    target = put_global(np.asarray(target, np.float32), pixel_sharding)
    sample_idx = put_global(
        np.arange(spp_padded, dtype=np.int32), NamedSharding(mesh, P("spp"))
    )
    params = jax.tree.map(
        lambda a: put_global(np.asarray(a), replicated), grad_mod.get_params(scene)
    )

    loss, new_params = _train_step(
        params,
        scene,
        camera,
        pixel_idx,
        sample_idx,
        target,
        key,
        cfg,
        spp_padded,
        camera.image_width,
        lr,
    )
    return loss, grad_mod.set_params(scene, new_params)
