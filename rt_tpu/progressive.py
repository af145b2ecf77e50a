"""Progressive refinement engine with checkpoint/resume.

Reference analog: the preview render thread (window.rs:224-326) — a fixed
pass schedule ``[1,2,4,8,...,256]`` (237 passes, 40,055 spp), each pass
re-rendering every pixel at ``ns`` samples and blending into the display
buffer by sample-count ratio, with per-sweep and cumulative Mray/s prints.

Improvements over the reference, each deliberate and documented:
- accumulation in f32 (the reference blends through the quantized u8
  display buffer, a known precision bug: window.rs:279-310, TODO.md:31);
- checkpoint/resume: the accumulator state (accum, total_spp, pass index)
  persists to .npz after each sweep and resumes exactly (the reference has
  no resume path — restart means sweep 1, SURVEY.md §5.4).  This doubles as
  preemption fault-tolerance (§5.3);
- structured metrics: per-sweep Mray/s both printed (reference parity,
  window.rs:315-324) and appended as JSONL (§5.5).

Reference quirk kept by default (CompatConfig-controlled at call sites):
every pass reuses Halton jitter indices 0..ns (render_pixel indexes its
sample loop from zero each pass, camera.rs:315-325), while material RNG
differs per pass (thread_rng there, a per-pass key fold here).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from rt_tpu.camera import Camera
from rt_tpu.config import ProgressiveSchedule, RenderConfig
from rt_tpu.profiling import MetricsLog, ProgressBar, ThroughputTimer
from rt_tpu.scene import SceneData
from rt_tpu.wavefront import render_wavefront


@dataclasses.dataclass
class ProgressiveState:
    accum: np.ndarray  # f32[H,W,3] sum of (pass_mean * pass_spp)
    total_spp: int
    pass_index: int

    @property
    def image(self) -> np.ndarray:
        """Current linear estimate (valid after any sweep, like the
        reference's always-displayable buffer)."""
        return self.accum / max(self.total_spp, 1)


class ProgressiveRenderer:
    """Drives the sweep schedule; owns the accumulator and checkpointing."""

    def __init__(
        self,
        scene: SceneData,
        camera: Camera,
        cfg: RenderConfig,
        schedule: ProgressiveSchedule | None = None,
        checkpoint_path: str | None = None,
        metrics_path: str | None = None,
        reuse_sample_indices: bool = True,
        progress: bool = False,
        checkpoint_every: int = 1,
    ):
        """Sweeps run through the persistent wavefront
        (wavefront.render_wavefront).  ``checkpoint_every``: sweeps between
        checkpoint writes (a 1080p f32 accumulator is a ~25 MB npz per
        write; the final sweep always writes)."""
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.passes = (schedule or ProgressiveSchedule.reference()).passes()
        self.checkpoint_path = checkpoint_path
        self.reuse_sample_indices = reuse_sample_indices
        self.checkpoint_every = max(int(checkpoint_every), 1)
        h, w = camera.image_height, camera.image_width
        self.state = ProgressiveState(np.zeros((h, w, 3), np.float32), 0, 0)
        self._timer = ThroughputTimer(w, h)
        self._metrics = MetricsLog(metrics_path)
        self._bar = ProgressBar(len(self.passes)) if progress else None
        self._pixel_idx = jnp.arange(w * h, dtype=jnp.int32)
        if checkpoint_path and os.path.exists(checkpoint_path):
            self.load_checkpoint(checkpoint_path)

    # -- sweeps ------------------------------------------------------------

    def step(self) -> dict | None:
        """Render one sweep; returns its metrics, or None when done."""
        i = self.state.pass_index
        if i >= len(self.passes):
            return None
        ns = self.passes[i]
        w, h = self.camera.image_width, self.camera.image_height

        self._timer.begin_sweep()
        sweep_start = time.perf_counter()
        # Reference quirk: jitter indices restart at 0 every pass
        # (camera.rs:317-320); material randomness differs via the pass key.
        offset = 0 if self.reuse_sample_indices else self.state.total_spp
        key = jax.random.fold_in(jax.random.key(self.cfg.seed), i)
        colors = render_wavefront(
            self.scene,
            self.camera,
            self._pixel_idx,
            self.cfg,
            ns,
            jnp.int32(offset),
            key,
        )
        colors = np.asarray(jax.block_until_ready(colors)).reshape(h, w, 3)
        sweep_s = time.perf_counter() - sweep_start
        sweep_mray, cum_mray = self._timer.end_sweep(ns)

        self.state.accum += colors * ns
        self.state.total_spp += ns
        self.state.pass_index += 1

        metrics = {
            "sweep": i + 1,
            "sweep_spp": ns,
            "total_spp": self.state.total_spp,
            "sweep_s": sweep_s,
            "mray_per_s": sweep_mray,
            "cumulative_mray_per_s": cum_mray,
        }
        # Reference-parity print (window.rs:264-269, 319-324).
        print(
            f"On sweep {i + 1} adding {ns} sample(s) for a total of "
            f"{self.state.total_spp} sample(s) per pixel"
        )
        print(
            f"Rendered sweep {i + 1} at {metrics['mray_per_s']:.1f} million "
            f"rays/second, overall speed: {metrics['cumulative_mray_per_s']:.1f} Mray/s"
        )
        self._metrics.log(**metrics)
        if self._bar is not None:
            self._bar.update(
                self.state.pass_index,
                f"{self.state.total_spp} spp, {sweep_mray:.1f} Mray/s",
            )
        if self.checkpoint_path and (
            self.state.pass_index % self.checkpoint_every == 0
            or self.state.pass_index >= len(self.passes)
        ):
            self.save_checkpoint(self.checkpoint_path)
        return metrics

    def run(
        self,
        max_passes: int | None = None,
        on_sweep: Callable[[np.ndarray, dict], None] | None = None,
        should_stop: Callable[[], bool] | None = None,
    ) -> np.ndarray:
        """Run sweeps until the schedule (or ``max_passes``) is exhausted.
        ``on_sweep(image, metrics)`` fires after each sweep (the preview
        hook); ``should_stop`` is the closing-flag analog (window.rs:271)."""
        done = 0
        while max_passes is None or done < max_passes:
            if should_stop is not None and should_stop():
                break
            metrics = self.step()
            if metrics is None:
                break
            done += 1
            if on_sweep is not None:
                on_sweep(self.state.image, metrics)
        return self.state.image

    # -- checkpointing (SURVEY.md §5.4) ------------------------------------

    def save_checkpoint(self, path: str) -> None:
        tmp = path + ".tmp"
        np.savez(
            tmp,
            accum=self.state.accum,
            total_spp=self.state.total_spp,
            pass_index=self.state.pass_index,
            seed=self.cfg.seed,
        )
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)

    def load_checkpoint(self, path: str) -> None:
        data = np.load(path)
        assert int(data["seed"]) == self.cfg.seed, (
            "checkpoint seed mismatch — resuming with a different seed would "
            "double-count sample indices"
        )
        self.state = ProgressiveState(
            accum=np.asarray(data["accum"], np.float32),
            total_spp=int(data["total_spp"]),
            pass_index=int(data["pass_index"]),
        )
