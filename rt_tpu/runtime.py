"""Process set-up for the entry points: compile cache and device report.

Importing rt_tpu changes no JAX setting; the command-line entry points
(``rt_tpu.cli``, the bench scripts, ``chip_smoke.py``) call
:func:`enable_compile_cache` once at start-up.
"""

from __future__ import annotations

import os
import subprocess

import jax

# Fixed path inside the checkout (git-ignored): the path is part of the
# cache's key, so a directory that moves between runs never hits.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here; otherwise the cache goes to CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def gpu_card() -> str:
    """``name, power.limit`` of each visible card, as nvidia-smi reports
    them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip()


def require_gpu() -> dict:
    """The device record every measurement prints; raises SystemExit when
    JAX finds no GPU, so no CPU number is ever reported as a device one."""
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {platform!r} ({devices})")
    return {
        "platform": platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": gpu_card(),
    }
