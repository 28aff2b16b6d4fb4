"""Scenes for the projection tests, on the CPU (against the JAX package)
and on the card (J2 against the plain chain). No JAX here: the card's
tests import this module."""

import numpy as np

from gags_torch.utils.synthetic import make_camera, make_scene

W, H, F = 64, 32, 40.0


def box_scene(n, seed):
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(-1, 9, n)], 1
    ).astype(np.float32)  # some behind the near plane
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-1.8, 0.6, size=(n, 3))).astype(np.float32)
    op = rng.uniform(0.01, 0.95, n).astype(np.float32)
    vm = np.eye(4, dtype=np.float32)
    vm[:3, 3] = rng.normal(scale=0.2, size=3)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
    return means, quats, scales, op, vm, K, W, H


def synthetic_scene(n, seed):
    raw = make_scene(n, seed=seed, extent=3.0)
    cam = make_camera(128, 72)
    return (raw["means"], raw["quats"], raw["scales"], raw["opacities"],
            cam.viewmat.numpy(), cam.K.numpy(), 128, 72)


CASES = [("box", 300, 0), ("box", 500, 1), ("synthetic", 2000, 0), ("synthetic", 1000, 5)]


def case_scene(kind, n, seed):
    return (box_scene if kind == "box" else synthetic_scene)(n, seed)


# the rows of `special_scene`, by kind, in this order
SPECIAL_KINDS = ("ordinary", "unnormalised", "behind", "parked", "needle")


def special_scene(n=400_000, seed=0):
    """n Gaussians before a 1280x720 camera, a fifth of each kind of
    SPECIAL_KINDS: ordinary splats; the same with quaternions scaled by
    1e-3 to 1e3 (one of them zero); splats behind the near plane; parked
    rows (0, 0, -1e9), as RGB training parks dead slots; and needles
    (one axis 1e1-1e4, two 1e-9-1e-6) close in front of the camera,
    whose screen covariance is rank one in float32, so that most of them
    have det <= 0 and are culled although their centre is on screen.
    Returns (means, quats, scales, opacities, viewmat, K, width, height,
    kind index (n,))."""
    w, h, f = 1280, 720, 1100.0
    rng = np.random.default_rng(seed)
    kind = np.arange(n) * len(SPECIAL_KINDS) // n
    z = rng.uniform(0.5, 12.0, n)
    z = np.where(kind == 2, rng.uniform(-5.0, -0.05, n), z)
    z = np.where(kind == 4, rng.uniform(0.05, 2.0, n), z)
    xy = rng.uniform(-0.6, 0.6, (n, 2)) * np.abs(z)[:, None] * np.array([1.0, 0.6])
    means = np.concatenate([xy, z[:, None]], 1)
    means[kind == 3] = (0.0, 0.0, -1e9)
    quats = rng.normal(size=(n, 4))
    quats[kind == 1] *= 10.0 ** rng.uniform(-3, 3, (int((kind == 1).sum()), 1))
    quats[np.argmax(kind == 1)] = 0.0
    scales = np.exp(rng.normal(-3.5, 0.8, (n, 3)))
    needle = kind == 4
    scales[needle, 0] = 10.0 ** rng.uniform(1, 4, int(needle.sum()))
    scales[needle, 1:] = 10.0 ** rng.uniform(-9, -6, (int(needle.sum()), 2))
    op = rng.uniform(0.005, 0.99, n)
    vm = np.eye(4)
    vm[:3, 3] = (0.01, -0.02, 0.03)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    f32 = [a.astype(np.float32) for a in (means, quats, scales, op, vm, K)]
    return (*f32, w, h, kind)


# the rows of `threshold_scene`, by kind, in this order
THRESHOLD_KINDS = ("near plane", "FoV clip")


def _rotation(axis, angle):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    cross = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(angle) * cross + (1 - np.cos(angle)) * cross @ cross


def threshold_scene(n=64, seed=0, candidates=4000):
    """Rows at a branch of the projection where its float32 chain and the
    same chain in float64 (from the same float32 inputs) decide apart:
    `n` whose camera depth lies on either side of the near plane 0.01,
    and `n` whose x / z lies on either side of the FoV clip's limit
    1.3 * (W / 2) / fx, before a rotated 1280x720 camera. The float32
    decisions are made in the plain chain's order of operations. Returns
    (means, quats, scales, opacities, viewmat, K, width, height, kind
    index (2n,) into THRESHOLD_KINDS)."""
    w, h, f = 1280, 720, 1100.0
    rng = np.random.default_rng(seed)
    vm = np.eye(4)
    vm[:3, :3] = _rotation((1, 2, 3), 0.3)
    vm[:3, 3] = (0.01, -0.02, 0.03)
    vm = vm.astype(np.float32)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    R64, t64 = vm[:3, :3].astype(np.float64), vm[:3, 3].astype(np.float64)
    f32 = np.float32
    lim32 = f32(1) / K[0, 0] * f32(0.5 * w) * f32(1.3)
    lim64 = 1.3 * (0.5 * w / np.float64(K[0, 0]))
    jitter = rng.uniform(-3e-7, 3e-7, (2, candidates))
    rows = []
    for kind in range(len(THRESHOLD_KINDS)):
        if kind == 0:
            cam = np.stack([rng.uniform(-5e-3, 5e-3, candidates),
                            rng.uniform(-3e-3, 3e-3, candidates), 0.01 * (1 + jitter[0])], 1)
        else:
            z = rng.uniform(1.0, 5.0, candidates)
            side = rng.choice([-1.0, 1.0], candidates)
            cam = np.stack([side * lim64 * z * (1 + jitter[1]),
                            rng.uniform(-0.3, 0.3, candidates) * z, z], 1)
        means = ((cam - t64) @ R64).astype(np.float32)
        x32, _, z32 = (((vm[r, 0] * means[:, 0] + vm[r, 1] * means[:, 1]) + vm[r, 2] * means[:, 2])
                       + vm[r, 3] for r in range(3))
        c64 = means.astype(np.float64) @ R64.T + t64
        if kind == 0:
            apart = (z32 > f32(0.01)) != (c64[:, 2] > 0.01)
        else:
            ux32 = x32 / np.where(z32 > f32(0.01), z32, f32(1))
            apart = (np.abs(ux32) < lim32) != (np.abs(c64[:, 0] / c64[:, 2]) < lim64)
        assert apart.sum() >= n, (THRESHOLD_KINDS[kind], int(apart.sum()))
        rows.append(means[apart][:n])
    means = np.concatenate(rows)
    quats = (np.array([1, 0, 0, 0]) + rng.normal(scale=0.1, size=(2 * n, 4))).astype(np.float32)
    # splats of a few pixels at either threshold (about 1e-5 wide at the near
    # plane), so that float32 autograd, the reference there, keeps its digits
    scales = np.exp(rng.normal(np.repeat([[-12.0], [-3.0]], n, 0), 0.2, (2 * n, 3)))
    scales = scales.astype(np.float32)
    op = rng.uniform(0.1, 0.9, 2 * n).astype(np.float32)
    return means, quats, scales, op, vm, K, w, h, np.repeat(np.arange(2), n)
