#!/usr/bin/env python
"""Fit the Hosek-Wilkie distribution (sky.hosek_radiance_rgb) to the sky
band of the reference's own golden render.

The reference evaluates hw-skymodel's SkyState::radiance(theta, gamma, ch)
with gamma = dot(dir, sun) (the cos-as-angle quirk, hittable.rs:86) and
sun = +z, so every sky sample it ever produces lies on the 1-D curve
radiance(theta, cos theta).  This script recovers that curve from
/root/reference/images/final_render.png by inverting the u8 -> gamma-2.2 ->
Uncharted2 display pipeline over the pure-sky top rows, then fits the
9-coefficient H-W form + radiance scale per channel.

Output: a python literal for sky.HW_REFERENCE_FIT.

Run: python tools/fit_hw_sky.py [path-to-final_render.png]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from rt_tpu import scenes  # noqa: E402
from rt_tpu import color as color_mod  # noqa: E402
from rt_tpu.sky import hosek_radiance_rgb  # noqa: E402

PATH = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/images/final_render.png"

A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
W_POINT = 11.2
BIAS = 1.1


def u2_tonemap(x):
    return (x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F) - E / F


def invert_uncharted2(y):
    """Solve ws * u2_tonemap(BIAS * rad) = y for rad >= 0."""
    ws = 1.0 / u2_tonemap(np.float64(W_POINT))
    t = y / ws + E / F
    # a(1-t) z^2 + b(C - t) z + D(E - t F) = 0   [z = BIAS * rad]
    qa = A * (1.0 - t)
    qb = B * (C - t)
    qc = D * (E - t * F)
    disc = np.maximum(qb * qb - 4.0 * qa * qc, 0.0)
    z = (-qb + np.sqrt(disc)) / (2.0 * qa)  # the positive branch
    return np.maximum(z, 0.0) / BIAS


def main():
    from PIL import Image

    img = np.asarray(Image.open(PATH).convert("RGB"), np.float64) / 255.0
    h, w, _ = img.shape

    # Pure-sky rows: contiguous top rows whose horizontal variation is tiny.
    row_std = img.std(axis=1).max(axis=1)
    n_sky = 0
    while n_sky < h and row_std[n_sky] < 0.003:
        n_sky += 1
    n_sky = max(n_sky - 2, 4)
    print(f"# sky rows: {n_sky} (row_std[{n_sky-1}]={row_std[n_sky-1]:.5f})")

    ys, xs = np.mgrid[0:n_sky, 0:w]
    camera = scenes.cam1(w, h)
    p00 = np.asarray(camera.pixel00_loc, np.float64)
    du = np.asarray(camera.pixel_du, np.float64)
    dv = np.asarray(camera.pixel_dv, np.float64)
    ctr = np.asarray(camera.center, np.float64)
    dirs = p00 + xs[..., None] * du + ys[..., None] * dv - ctr
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    tone = img[:n_sky] ** 2.2  # undo gamma
    rad = invert_uncharted2(tone)  # [n_sky, w, 3]

    # Subsample for speed.
    sel = np.random.default_rng(0).choice(n_sky * w, 4000, replace=False)
    d = dirs.reshape(-1, 3)[sel]
    target = rad.reshape(-1, 3)[sel]
    print(f"# target radiance range {target.min():.4f}..{target.max():.4f} "
          f"mean {target.mean(axis=0)}")
    print(f"# dir.z range {d[:, 2].min():.4f}..{d[:, 2].max():.4f}")
    cos_theta = np.clip(d[:, 2], 0.01, 1.0)
    gamma = np.clip(d[:, 2], -1.0, 1.0)  # quirk: dot(dir, +z) used AS gamma
    cos_gamma = np.cos(gamma)

    ct = jnp.asarray(cos_theta, jnp.float32)
    ga = jnp.asarray(gamma, jnp.float32)
    cg = jnp.asarray(cos_gamma, jnp.float32)
    tgt = jnp.asarray(target, jnp.float32)

    def unpack(raw):
        hw = raw.reshape(3, 10)
        return hw.at[:, 7].set(jnp.tanh(hw[:, 7]))  # chi g in (-1, 1)

    def loss_fn(raw):
        hw = unpack(raw)
        r, g, b = hosek_radiance_rgb(hw, ct, ga, cg)
        pred = jnp.stack([r, g, b], axis=-1)
        return jnp.mean(((pred - tgt) / (tgt + 1e-3)) ** 2)

    init = np.tile(
        np.array([[-1.1, -0.2, 1.0, 0.1, -1.0, 0.05, 0.05, 0.5, 0.3, 0.05]], np.float32),
        (3, 1),
    ).reshape(-1)
    raw = jnp.asarray(init)
    opt = optax.adam(3e-3)
    state = opt.init(raw)
    vgrad = jax.jit(jax.value_and_grad(loss_fn))
    for i in range(8000):
        val, g = vgrad(raw)
        upd, state = opt.update(g, state)
        raw = optax.apply_updates(raw, upd)
        if i % 1000 == 0:
            print(f"# iter {i}: loss {float(val):.6f}")
    hw = np.asarray(unpack(raw), np.float32)
    print(f"# final loss {float(loss_fn(raw)):.6f}")

    r, g, b = hosek_radiance_rgb(jnp.asarray(hw), ct, ga, cg)
    pred = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], -1)
    rel = np.abs(pred - target) / (np.abs(target) + 1e-3)
    print(f"# band relative error: mean {rel.mean():.4f} p99 {np.percentile(rel, 99):.4f}")

    print("HW_REFERENCE_FIT = np.array([")
    for ch in range(3):
        print("    [" + ", ".join(f"{v:.7g}" for v in hw[ch]) + "],")
    print("], np.float32)")


if __name__ == "__main__":
    main()
