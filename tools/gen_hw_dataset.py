#!/usr/bin/env python
"""Generate the Hosek-Wilkie coefficient dataset for sky.hosek_config().

The reference's hw-skymodel crate interpolates the published H-W 2012
coefficient tables over (turbidity, albedo, solar elevation) and then
evaluates the 9-coefficient distribution per RGB channel
(/root/reference/src/hittable.rs:84-93, Cargo.toml:15).  The published
tables themselves are a ~MB binary blob that cannot be fetched in this
environment (zero egress) and is not redistributable from memory, so this
script GENERATES a dataset with the same structure instead:

  for every grid point (turbidity 1..10, albedo {0,1}, elevation knot k)
  fit the 10 per-channel H-W parameters (A..I, radiance scale) to a
  ground-truth hemisphere radiance field.

Ground truth = the repo's own Preetham/Perez analytic daylight model
(sky.sky_radiance_rgb, published coefficient tables) plus an approximate
ground-albedo lift (higher albedo brightens the sky, strongest near the
horizon — the qualitative behavior of the real model's albedo axis; the
exact magnitudes are NOT the published H-W values and are documented as
such in sky.py).

Elevation knots follow the published model's warping: uniform in
x = (2*eta/pi)^(1/3), 9 knots.  Interpolation at eval time (sky.py) is
piecewise-linear in x, linear in turbidity and albedo.

Output: rt_tpu/data/hw_dataset.npz with
  params   f32[10, 9, 2, 3, 10]  (turbidity, elev-knot, albedo, rgb, A..I+scale)
  samples  f32[N, 7]             validation rows: T, eta, albedo,
                                 cos_theta, gamma, plus the fitted model's
                                 OWN radiance prediction is re-derived in
                                 tests; targets stored as rgb columns
  targets  f32[N, 3]             ground-truth radiance at the sample rows

Run: python tools/gen_hw_dataset.py   (CPU, ~2 min)
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from rt_tpu import sky as sky_mod  # noqa: E402

N_T = 10  # turbidity 1..10
N_E = 9  # elevation knots, uniform in (2 eta / pi)^(1/3)
N_A = 2  # albedo 0, 1
STEPS = 4000


def elevation_knots():
    x = np.linspace(0.0, 1.0, N_E)
    return (np.pi / 2.0) * x**3


def hemisphere_dirs(n_theta=24, n_phi=33):
    """Upper-hemisphere direction grid, denser toward the horizon."""
    # theta from 0 (zenith) to 88 deg; uniform in cos^(1/2) for horizon weight
    u = np.linspace(0.0, 1.0, n_theta)
    theta = u**0.7 * np.deg2rad(88.0)
    phi = np.linspace(0.0, 2.0 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], -1
    )
    return d.reshape(-1, 3)


def albedo_lift(albedo, cos_theta):
    """Approximate ground-albedo brightening (NOT published H-W data):
    flat 20% lift at albedo=1 plus up to 35% extra toward the horizon."""
    return 1.0 + albedo * (0.20 + 0.35 * (1.0 - np.clip(cos_theta, 0.0, 1.0)))


def ground_truth(turbidity, eta, albedo, dirs):
    """Perez RGB radiance with sun at elevation eta (azimuth 0)."""
    sun = np.array([np.cos(eta), 0.0, np.sin(eta)], np.float32)
    params = sky_mod.SkyParams(
        sun_direction=jnp.asarray(sun),
        # Perez tables are valid for T >= ~1.7; clamp the T=1 column.
        turbidity=jnp.asarray(max(float(turbidity), 1.7), jnp.float32),
        exposure=jnp.asarray(1.0, jnp.float32),
    )
    rgb = np.asarray(sky_mod.sky_radiance_rgb(params, jnp.asarray(dirs, jnp.float32)))
    ct = dirs[:, 2]
    rgb = rgb * albedo_lift(albedo, ct)[:, None]
    cos_gamma = np.clip(dirs @ sun, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)
    return rgb.astype(np.float32), ct.astype(np.float32), gamma.astype(np.float32)


def main():
    dirs = hemisphere_dirs()
    knots = elevation_knots()
    grid = []  # (ti, ei, ai, ct[N], gamma[N], target[N,3])
    for ti, T in enumerate(range(1, N_T + 1)):
        for ei, eta in enumerate(knots):
            for ai, alb in enumerate((0.0, 1.0)):
                tgt, ct, ga = ground_truth(T, eta, alb, dirs)
                grid.append((ti, ei, ai, ct, ga, tgt))
    P = len(grid)
    ct = jnp.asarray(np.stack([g[3] for g in grid]))  # [P, N]
    ga = jnp.asarray(np.stack([g[4] for g in grid]))  # [P, N]
    cg = jnp.cos(ga)
    tgt = jnp.asarray(np.stack([g[5] for g in grid]))  # [P, N, 3]

    def unpack(raw):  # raw [P, 3, 10] -> constrained params
        return jnp.concatenate(
            [
                raw[..., 0:1],  # A free
                -jax.nn.softplus(raw[..., 1:2]),  # B <= 0 (exp decays)
                raw[..., 2:7],  # C..G free
                jnp.tanh(raw[..., 7:8]) * 0.999,  # H in (-1, 1)
                raw[..., 8:9],  # I free
                jax.nn.softplus(raw[..., 9:10]),  # scale > 0
            ],
            axis=-1,
        )

    def predict(hw):  # hw [P, 3, 10] -> [P, N, 3]
        sq = jnp.sqrt(jnp.maximum(ct, 0.0))[:, :, None]  # [P, N, 1]
        a = hw[:, None, :, 0]
        b = hw[:, None, :, 1]
        c = hw[:, None, :, 2]
        d = hw[:, None, :, 3]
        e = hw[:, None, :, 4]
        f = hw[:, None, :, 5]
        g = hw[:, None, :, 6]
        h = hw[:, None, :, 7]
        i_ = hw[:, None, :, 8]
        sc = hw[:, None, :, 9]
        ctn = jnp.maximum(ct, 0.01)[:, :, None]
        cgn = cg[:, :, None]
        gan = ga[:, :, None]
        chi = (1.0 + cgn * cgn) / jnp.power(
            jnp.maximum(1.0 + h * h - 2.0 * h * cgn, 1e-6), 1.5
        )
        val = (1.0 + a * jnp.exp(b / ctn)) * (
            c + d * jnp.exp(e * gan) + f * cgn * cgn + g * chi + i_ * sq
        )
        return jnp.maximum(val * sc, 0.0)

    def loss_fn(raw):
        pred = predict(unpack(raw))
        return jnp.mean(((pred - tgt) / (tgt + 1e-2)) ** 2)

    init = np.tile(
        np.array([-1.0, 0.2, 1.0, 0.3, -0.8, 0.05, 0.02, 0.7, 0.2, 0.3], np.float32),
        (P, 3, 1),
    )
    raw = jnp.asarray(init)
    opt = optax.adam(2e-2)
    state = opt.init(raw)
    vgrad = jax.jit(jax.value_and_grad(loss_fn))
    for i in range(STEPS):
        val, gr = vgrad(raw)
        upd, state = opt.update(gr, state)
        raw = optax.apply_updates(raw, upd)
        if i % 500 == 0:
            print(f"# step {i}: loss {float(val):.6f}")
    hw = np.asarray(unpack(raw), np.float32)
    pred = np.asarray(predict(jnp.asarray(hw)))
    rel = np.abs(pred - np.asarray(tgt)) / (np.abs(np.asarray(tgt)) + 1e-2)
    print(f"# fit relative error: mean {rel.mean():.4f} p99 {np.percentile(rel, 99):.4f}")

    params = hw.reshape(N_T, N_E, N_A, 3, 10)

    # Validation rows for tests: a few (T, eta, albedo) x direction samples.
    rng = np.random.default_rng(0)
    rows, targs = [], []
    for T, eta, alb in [(2.0, knots[4], 0.0), (5.0, knots[6], 1.0), (9.0, knots[2], 0.5)]:
        tgt_v, ct_v, ga_v = ground_truth(T, eta, alb, dirs)
        sel = rng.choice(len(dirs), 40, replace=False)
        for j in sel:
            rows.append([T, eta, alb, ct_v[j], ga_v[j], 0.0, 0.0])
            targs.append(tgt_v[j])
    import os

    os.makedirs("/root/repo/rt_tpu/data", exist_ok=True)
    np.savez_compressed(
        "/root/repo/rt_tpu/data/hw_dataset.npz",
        params=params,
        samples=np.asarray(rows, np.float32),
        targets=np.asarray(targs, np.float32),
        knots=knots.astype(np.float32),
    )
    print(f"# wrote rt_tpu/data/hw_dataset.npz params{params.shape}")


if __name__ == "__main__":
    main()
