"""Trained-statistics SURFACE scene generator (see make_surface_scene), the
port's own copy of gags_tpu.utils._surface_scene: numpy only, so the same
arguments give the same arrays.

Kept in its own module so the numpy-heavy construction (normals,
alignment quaternions, multi-layer heightfields) doesn't crowd
synthetic.py's tiny test helpers.
"""

from __future__ import annotations

import math

import numpy as np


def _height(x0, y0, phase):
    """Smooth heightfield offset (world z units) over x0, y0 in [-1, 1]."""
    return 0.9 * np.sin(2.1 * x0 + 0.7 + phase) * np.cos(
        1.7 * y0 - 0.4 + 0.5 * phase
    ) + 0.5 * np.sin(4.3 * y0 + phase) * np.cos(3.1 * x0 - phase)


def make_surface_scene(
    n: int,
    width: int,
    height: int,
    seed: int = 0,
    fov_deg: float = 60.0,
    sigma_base: float = 2.4,
    opaque_frac: float = 0.7,
    feature_dim: int = 16,
    layers: int = 2,
):
    """Trained-statistics SURFACE scene: ``layers`` stacked heightfields
    of surface-aligned pancake Gaussians filling the frustum of
    ``make_camera(width, height, fov_deg)``.

    ``make_scene`` draws a uniform fog — per-pixel coverage is spotty and
    transmittance almost never saturates, so early termination cannot
    fire there (no tile stops early on it, even with 70% near-1
    opacities). Real trained 3DGS scenes (the reference's
    Mip-NeRF360/LERF working points, the reference's README) are
    SURFACES with occluded geometry behind them: every ray saturates
    within a short depth prefix and the CUDA rasterizer's per-pixel
    retirement (rasterize_impl's done-flag loop) skips the rest. This
    generator reproduces the three statistics that matter for that
    workload:

    * saturation: splats are surface-normal-aligned pancakes (random
      quats tilt footprints and cut per-pixel optical depth ~2x) with
      footprint sigma_px = sigma_base * sqrt(W*H*layers / n) px — the
      per-pixel expected optical depth is then density-invariant.
      Calibration (CPU, 2000 splats at 128x64, opaque_frac=0.7,
      tile-level chunk-stop counters): sigma_base 1.7 -> 0%, 2.2 ->
      12%, 2.8 -> 43% of chunks shed by the TILE-level exit alone
      (slab-level block_exit sheds more). NOTE the final T is floored
      at 1e-4 by the include rule (exactly the reference's
      semantics), so "alpha > 0.9999" can never measure saturation —
      use the kernel's exit counters.
    * occluded work: layer i sits ~2.6 world units behind layer i-1 with
      its own phase-shifted heightfield — fully occluded except through
      the front layer's sparse low-opacity holes. This is what early
      exit actually sheds.
    * opacity mixture: ``opaque_frac`` mass at beta(30, 1) (mean ~0.97 —
      sigmoid-saturated, as trained+pruned 3DGS opacities are), the rest
      U(0.01, 0.3).
    """
    rng = np.random.default_rng(seed)
    fx = width / (2 * math.tan(math.radians(fov_deg) / 2))
    sigma_px = sigma_base * math.sqrt(width * height * layers / max(n, 1))

    per = np.full(layers, n // layers)
    per[: n - per.sum()] += 1
    means_l, quats_l, scales_l = [], [], []
    for li in range(layers):
        m = int(per[li])
        z_base = 6.0 + 2.6 * li
        phase = 1.9 * li
        # screen-uniform placement with a small margin past the borders
        u = rng.uniform(-0.04, 1.04, size=m).astype(np.float32)
        v = rng.uniform(-0.04, 1.04, size=m).astype(np.float32)
        x0 = (u - 0.5) * 2.0
        y0 = (v - 0.5) * 2.0
        z = (
            z_base + _height(x0, y0, phase)
            + rng.normal(0.0, 0.08, size=m)
        ).astype(np.float32)
        # unproject pixel centres at the surface depth (camera at the
        # origin looking down +z with up = -y: make_camera's view)
        x = (u * width - width / 2.0) * z / fx
        y = (v * height - height / 2.0) * z / fx
        means_l.append(np.stack([x, y, z], axis=1).astype(np.float32))

        # surface normal via analytic-free central differences of the
        # heightfield, chained through the x0 -> world-x scale (half
        # frustum width at the layer depth)
        eps = 1e-3
        half_w = math.tan(math.radians(fov_deg) / 2) * z_base
        dzdx = (_height(x0 + eps, y0, phase)
                - _height(x0 - eps, y0, phase)) / (2 * eps) / half_w
        dzdy = (_height(x0, y0 + eps, phase)
                - _height(x0, y0 - eps, phase)) / (2 * eps) / half_w
        nrm = np.stack([-dzdx, -dzdy, np.ones_like(dzdx)], axis=1)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        # quaternion (wxyz) rotating local +z onto the normal: axis =
        # z x n = (-ny, nx, 0), angle = arccos(nz) (nz > 0 always here)
        nz = np.clip(nrm[:, 2], -1.0, 1.0)
        half = 0.5 * np.arccos(nz)
        ax = np.stack([-nrm[:, 1], nrm[:, 0]], axis=1)
        axn = np.linalg.norm(ax, axis=1, keepdims=True)
        ax = ax / np.maximum(axn, 1e-12)
        s_half = np.sin(half)
        quats_l.append(
            np.stack(
                [np.cos(half), s_half * ax[:, 0], s_half * ax[:, 1],
                 np.zeros(m)],
                axis=1,
            ).astype(np.float32)
        )

        # footprint sigma_px pixels at each splat's own depth, modest
        # log-normal spread, normal-axis thinned (surface pancakes)
        s_world = (sigma_px * z / fx) * np.exp(
            rng.normal(0.0, 0.25, size=m))
        scales_l.append(
            np.stack(
                [s_world, s_world * np.exp(rng.normal(0.0, 0.2, size=m)),
                 0.15 * s_world],
                axis=1,
            ).astype(np.float32)
        )

    means = np.concatenate(means_l, axis=0)
    quats = np.concatenate(quats_l, axis=0)
    scales = np.concatenate(scales_l, axis=0)

    opaque = rng.random(n) < opaque_frac
    lo = rng.uniform(0.01, 0.30, size=n)
    hi = rng.beta(30.0, 1.0, size=n)  # sigmoid-saturated trained mass
    opacities = np.where(opaque, hi, lo).astype(np.float32)

    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-1.5, 1.5, size=(n, 3))
    sh[:, 1:, :] = 0.1 * rng.normal(size=(n, 15, 3))
    features = rng.normal(size=(n, feature_dim)).astype(np.float32) * 0.3
    return dict(
        means=means,
        quats=quats,
        scales=scales,
        opacities=opacities,
        sh=sh.astype(np.float32),
        features=features,
    )
