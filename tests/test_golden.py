"""Golden-image regression tests (SURVEY.md §4).

The reference has no tests and validates renders by eye against
images/*.png; rt_tpu's seeded scenes and counter-based RNG make exact
regression possible.  Goldens are committed PNGs (gamma-quantized u8);
comparison allows for quantization plus a small tolerance so benign
backend differences don't flake, while structural regressions (wrong
normal flip, broken texture fetch, sky changes) fail loudly.

Regenerate after intentional changes: python tests/make_goldens.py
"""

import os

import numpy as np
import pytest

from rt_tpu import color
from rt_tpu.io.png_io import decode_png
from tests.make_goldens import GOLDEN_DIR, golden_cases, render_case

CASES = golden_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    if not os.path.exists(path):
        pytest.skip(f"golden {name} not generated (run tests/make_goldens.py)")
    with open(path, "rb") as f:
        want = decode_png(f.read()).astype(np.float32)
    scene, camera, cfg = CASES[name]
    img = render_case(scene, camera, cfg)
    got = np.asarray(color.to_u8_gamma(img), np.float32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    # Mean within ~1 quantization step; no more than 1% of pixels off by
    # more than 8/255.
    assert diff.mean() < 1.5, f"{name}: mean abs diff {diff.mean():.3f}"
    frac_big = (diff > 8).mean()
    assert frac_big < 0.01, f"{name}: {frac_big:.2%} pixels off by >8"
