"""Profiling and structured metrics.

Reference analog (SURVEY.md §5.1, §5.5): a Cargo `profiling` build profile
for external profilers (Cargo.toml:26-28), per-sweep and cumulative Mray/s
prints (window.rs:315-324), and indicatif progress bars.  rt_tpu keeps the
Mray/s definition as the canonical metric and adds what an accelerator
deployment actually needs: ``jax.profiler`` trace capture around render steps and
JSONL metrics for machines to read.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field


def mray_per_s(width: int, height: int, spp: int, seconds: float) -> float:
    """The reference's throughput formula (window.rs:317-323): camera
    samples only — bounce rays are NOT counted."""
    return spp * width * height / 1.0e6 / max(seconds, 1.0e-12)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture an XLA device trace viewable in TensorBoard/Perfetto —
    the device equivalent of attaching a native profiler to the reference's
    `profiling` build."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class MetricsLog:
    """Append-only JSONL metrics with wall-clock stamps (§5.5)."""

    path: str | None = None
    _start: float = field(default_factory=time.perf_counter)

    def log(self, **fields) -> dict:
        record = {"t_wall_s": round(time.perf_counter() - self._start, 6), **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record


class ProgressBar:
    """Terminal progress bar — the indicatif analog (SURVEY.md §2.2;
    reference: camera.rs:332's per-render bar).  Stdlib-only, single-line
    carriage-return redraw, ETA from the cumulative rate."""

    def __init__(self, total: int, unit: str = "sweeps", width: int = 28, stream=None):
        import sys

        self.total = max(total, 1)
        self.unit = unit
        self.width = width
        self.stream = stream if stream is not None else sys.stderr
        self.done = 0
        self._start = time.perf_counter()

    def update(self, done: int, suffix: str = "") -> None:
        self.done = min(done, self.total)
        frac = self.done / self.total
        filled = int(frac * self.width)
        bar = "#" * filled + "-" * (self.width - filled)
        elapsed = time.perf_counter() - self._start
        eta = elapsed * (1.0 - frac) / frac if frac > 0 else float("inf")
        eta_s = f"{eta:.0f}s" if eta < 1e4 else "--"
        self.stream.write(
            f"\r[{bar}] {self.done}/{self.total} {self.unit} "
            f"({100.0 * frac:3.0f}%) eta {eta_s} {suffix}"
        )
        self.stream.flush()
        if self.done >= self.total:
            self.stream.write("\n")


class ThroughputTimer:
    """Per-sweep + cumulative Mray/s, matching the reference's two printed
    figures (window.rs:315-324)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.total_rays = 0
        self._start = time.perf_counter()
        self._sweep_start = self._start

    def begin_sweep(self):
        self._sweep_start = time.perf_counter()

    def end_sweep(self, spp: int) -> tuple[float, float]:
        now = time.perf_counter()
        rays = spp * self.width * self.height
        self.total_rays += rays
        sweep = rays / 1.0e6 / max(now - self._sweep_start, 1e-12)
        cumulative = self.total_rays / 1.0e6 / max(now - self._start, 1e-12)
        return sweep, cumulative
