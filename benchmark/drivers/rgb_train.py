"""RGB 3DGS pretraining through the port's `gags_torch.rgb.train` API:
`create_rgb_state`, `make_rgb_step`, `densify_step`,
`reset_opacity_step` and `expon_lr`, in the loop body of
`cli/train_rgb.run` (the camera order, the schedule, density control,
the loss read every 10 iterations), with the images loaded in set-up by
`gags_torch.utils.image.load_rgb`.

Set-up renders the ground truths with the plain reference rasterizer
from a seeded scene, writes them as PNGs beside a COLMAP text
reconstruction, seeds the Gaussians from a subset of that scene's means
(3DGS's initialisation: SH DC from the colour, opacity 0.1, scale the
root mean 3-NN squared distance), and runs the loop from
`start_iteration`, so the window trains at the configuration's SH
degree. The first `checked_steps` steps are followed by the reference
from the same inputs; the first densification inside the warm-up is
checked from the program's own statistics. The loop-level code of
`cli/train_rgb.py` (its progress printing, metrics file and PLY saves)
is outside this cell.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from benchmark.counts import ops, pairs
from benchmark.drivers.gad_train import training_checks
from benchmark.lib import fixtures, harness
from benchmark import reference
from benchmark.lib.trace import Profiled
from benchmark.reference import raster
from benchmark.reference import rgb as ref_rgb

SH_C0 = 0.28209479177387814


def arc_poses(n: int, dist: float, arc_deg: float, center=(0.0, 0.0, 6.0)):
    out = []
    for i in range(n):
        th = math.radians(arc_deg) * (i / max(n - 1, 1) - 0.5)
        eye = (center[0] + dist * math.sin(th), 0.3 * dist * math.sin(2 * th),
               center[2] - dist * math.cos(th))
        out.append(fixtures.look_at(eye, center))
    return out


def camera(qvec, tvec, focal, w, h):
    vm = np.eye(4)
    vm[:3, :3] = fixtures.qvec_to_rotmat(qvec)
    vm[:3, 3] = tvec
    fovx = 2.0 * math.atan(w / (2.0 * focal))
    fovy = 2.0 * math.atan(h / (2.0 * focal))
    fx = w / (2.0 * math.tan(fovx / 2.0))
    fy = h / (2.0 * math.tan(fovy / 2.0))
    K = np.array([[fx, 0.0, w / 2.0], [0.0, fy, h / 2.0], [0.0, 0.0, 1.0]], np.float32)
    return vm.astype(np.float32), K


def scene_radius(written) -> float:
    """1.1 x the largest camera-centre distance from their mean (3DGS's
    getNerfppNorm)."""
    c = np.stack([fixtures.qvec_to_rotmat(q).T @ (-t) for _, q, t in written])
    return float(np.linalg.norm(c - c.mean(0), axis=1).max() * 1.1)


@torch.no_grad()
def mean_knn_sq_dist(xyz: torch.Tensor, k: int = 3, block: int = 2048) -> torch.Tensor:
    """Mean squared distance to the k nearest other points, exact, blocked."""
    sq = (xyz * xyz).sum(1)
    out = []
    for i in range(0, xyz.shape[0], block):
        q = xyz[i:i + block]
        d = (sq[i:i + block, None] + sq[None, :] - 2.0 * q @ xyz.T).clamp_min(0.0)
        d[torch.arange(q.shape[0]), torch.arange(i, i + q.shape[0])] = math.inf
        out.append(torch.topk(d, k, dim=1, largest=False).values.mean(1))
    return torch.cat(out)


def make_inputs(cfg: dict, seed: int, dev) -> dict:
    """Ground-truth images, cameras and the seed cloud, from `seed`."""
    w, h = cfg["width"], cfg["height"]
    focal = w / (2 * math.tan(math.radians(cfg["fov_deg"]) / 2))
    gt = fixtures.make_scene(cfg["gt_gaussians"], seed, extent=cfg["gt_extent"])
    poses = arc_poses(cfg["cameras"], cfg["camera_distance"], cfg["arc_deg"])
    t = {k: torch.as_tensor(v, device=dev) for k, v in gt.items()}
    images = []
    for vm in poses:
        vmt = torch.as_tensor(vm.astype(np.float32), device=dev)
        _, K = camera(fixtures.rotmat_to_qvec(vm[:3, :3]), vm[:3, 3], focal, w, h)
        Kt = torch.as_tensor(K, device=dev)
        campos = -vmt[:3, :3].T @ vmt[:3, 3]
        cols = ref_rgb.sh_colors(3, t["sh"], t["means"], campos)
        proj = raster.project(t["means"], t["quats"], t["scales"], t["opacities"], vmt, Kt, w, h)
        wk = raster.walk(proj, t["opacities"], raster.tile_lists(proj, w, h), w, h)
        img = raster.render_colors(wk, cols, w, h)
        images.append((img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).cpu().numpy())
    rng = np.random.default_rng([seed, 2])
    pick = rng.choice(cfg["gt_gaussians"], size=cfg["seed_points"], replace=False)
    xyz = gt["means"][pick]
    rgb = np.clip(gt["sh"][pick, 0, :] * SH_C0 + 0.5, 0.0, 1.0)
    rgb = (rgb * 255).astype(np.uint8).astype(np.float32) / 255.0
    xyz_t = torch.as_tensor(xyz, device=dev)
    dist2 = torch.clamp_min(mean_knn_sq_dist(xyz_t), 1e-7)
    n = xyz.shape[0]
    sh = torch.zeros((n, 16, 3), dtype=torch.float32, device=dev)
    sh[:, 0, :] = (torch.as_tensor(rgb, device=dev) - 0.5) / SH_C0
    seed_cloud = dict(
        means=xyz_t, sh=sh,
        opacities_raw=torch.full((n,), math.log(0.1 / 0.9), dtype=torch.float32, device=dev),
        scales_raw=torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3),
        quats=torch.cat([torch.ones((n, 1), device=dev), torch.zeros((n, 3), device=dev)], 1))
    return dict(images=images, poses=poses, focal=focal, seed=seed_cloud)


def _control():
    """The lower-precision control: the colour rows rounded to bfloat16
    before the blend (the port's own inference option `fast_color_rows`
    does this). TF32 is no control here: the step has no matrix product,
    and cuDNN's depthwise SSIM filter reads the same with it on."""
    import gags_torch.rgb.train as rt

    real = rt.sh_colors

    def bf16_rows(*a, **k):
        return real(*a, **k).to(torch.bfloat16).to(torch.float32)

    rt.sh_colors = bf16_rows


def run(ctx) -> dict:
    import gags_torch.rgb.train as rt
    from gags_torch.scene.dataset import camera_from_info, detect_and_load
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.utils.image import load_rgb

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    if ctx.inject == "bf16_colors":
        _control()
    t0 = time.perf_counter()
    inp = make_inputs(cfg, ctx.seed, dev)
    root = os.path.join(ctx.tmp, "scene")
    names = [f"cam{i:03d}.png" for i in range(cfg["cameras"])]
    written = fixtures.write_colmap_text(os.path.join(root, "sparse", "0"), cfg["width"],
                                         cfg["height"], inp["focal"], list(zip(names, inp["poses"])))
    os.makedirs(os.path.join(root, "images"))
    for name, img in zip(names, inp["images"]):
        with open(os.path.join(root, "images", name), "wb") as f:
            f.write(fixtures.encode_png(img))
    harness.detail(f"fixture: {cfg['cameras']} ground truths of {cfg['gt_gaussians']} Gaussians "
                   f"at {cfg['width']}x{cfg['height']}, {cfg['seed_points']} seed points, "
                   f"made in {time.perf_counter() - t0:.3f} s")

    rcfg = rt.RgbConfig(capacity_factor=cfg["capacity_factor"], sh_degree=cfg["sh_degree"])
    info = detect_and_load(root, foundation_model="none")
    s = inp["seed"]
    scene = GaussianScene(means=s["means"], sh=s["sh"], opacities_raw=s["opacities_raw"],
                          scales_raw=s["scales_raw"], quats=s["quats"], semantic_features=None,
                          max_sh_degree=cfg["sh_degree"])
    state = rt.create_rgb_state(scene, rcfg, seed=ctx.seed, device=dev)
    cams, images = [], []
    for ci in info.train_cameras:
        cam = camera_from_info(ci, cfg["resolution"]).to(dev)
        cams.append(cam)
        images.append(load_rgb(ci.image_path, cam.width, cam.height, dev))
    w, h = cams[0].width, cams[0].height
    step = rt.make_rgb_step(rcfg, w, h, spatial_scale=info.radius)
    if ctx.inject in ("half_batch", "unchanged"):
        step = _fault(step, ctx.inject, h)

    start, warm, checked = tr["start_iteration"], tr["warmup_steps"], tr["checked_steps"]
    rng = np.random.default_rng(ctx.seed)
    order: list = []
    rec = dict(loss=[], grad_norm=None, change_norm=None)
    init = {k: v.clone() for k, v in state.params.items()}
    used_cams, densify_check, prof = [], None, (Profiled(dev) if ctx.trace else None)
    steps, t_win, window_s, snap, plain_s = 0, None, None, None, None

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    it = start
    while True:
        k = it - start + 1
        if k == warm + 1:
            sync()
            t_win = time.perf_counter()
            setup_s = t_win - ctx.t_start
            host0 = harness.host_sample()
        if prof is not None and k == warm + tr["profiled_steps"] + 1:
            # a traced run times `profiled_steps` steps without the
            # profiler, then profiles as many more from this state
            sync()
            plain_s = time.perf_counter() - t_win
            snap = {g: v.clone() for g, v in state.params.items()}
            prof.start()
        if not order:
            order = list(rng.permutation(len(cams)))
        idx = order.pop()
        used_cams.append(idx)
        batch = dict(viewmat=cams[idx].viewmat, K=cams[idx].K,
                     image=images[idx].to(torch.float32) / 255.0)
        lr = rt.expon_lr(float(it), rcfg.position_lr_init * info.radius,
                         rcfg.position_lr_final * info.radius, rcfg.position_lr_delay_mult,
                         rcfg.position_lr_max_steps)
        state, m = step(state, batch, lr, min(it // 1000, rcfg.sh_degree))
        if k <= checked:
            rec["loss"].append(float(m["loss"]))
            if k == 1:
                rec["grad_norm"] = {g: float(torch.linalg.vector_norm(state.opt[g]["mu"].double()))
                                    / 0.1 for g in rt.GROUPS}
            if k == checked:
                rec["change_norm"] = {g: float(torch.linalg.vector_norm(
                    (state.params[g] - init[g]).double())) for g in rt.GROUPS}
                rec["stats"] = dict(grad_accum=state.grad_accum.clone(), denom=state.denom.clone(),
                                    max_radii=state.max_radii.clone())
                del init
        if rcfg.densify_from_iter < it < rcfg.densify_until_iter:
            if it % rcfg.densification_interval == 0:
                if densify_check is None and k <= warm:
                    densify_check = dict(before={g: v.clone() for g, v in state.params.items()},
                                         alive=state.alive.clone(),
                                         grad_accum=state.grad_accum.clone(),
                                         denom=state.denom.clone())
                state = rt.densify_step(state, rcfg.densify_grad_threshold, rcfg.percent_dense,
                                        info.radius, rcfg.min_opacity)
                if densify_check is not None and "after" not in densify_check:
                    densify_check["after"] = {g: v.clone() for g, v in state.params.items()}
                    densify_check["alive_after"] = state.alive.clone()
            if it % rcfg.opacity_reset_interval == 0:
                state = rt.reset_opacity_step(state)
        if it % 10 == 0:
            loss = float(m["loss"])  # the CLI's one host sync every 10 iterations
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at iteration {it}")
        if k > warm:
            steps += 1
            if prof is not None:
                if steps == 2 * tr["profiled_steps"]:
                    window_s = prof.stop()
                    break
            elif time.perf_counter() - t_win >= ctx.seconds:
                sync()
                window_s = time.perf_counter() - t_win
                harness.host_detail(host0, harness.host_sample())
                break
        it += 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    harness.detail(f"window: {steps} steps (iterations {start + warm}-{it}) in {window_s:.6f} s; "
                   f"set-up {setup_s:.3f} s; alive {int(state.alive.sum())} of {state.capacity}; "
                   f"memory peak {peak} B")
    del state, step, m, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    trace = None
    if ctx.trace:
        p = tr["profiled_steps"]
        trace = _trace(ctx, prof, snap, written, inp, used_cams[warm + p:warm + 2 * p], p,
                       window_s, plain_s / p, w, h)
        del snap
    with reference.float32():
        checks = _check(ctx, inp, written, used_cams[:checked], rec, densify_check, rcfg,
                        scene_radius(written), w, h, start)
    return dict(e2e={"setup_s": setup_s, "rgb_step_ms": window_s / steps * 1e3}, attempted=steps,
                failed=0, checks=checks, trace=trace, memory_peak_bytes=peak)


def _fault(step, kind, h):
    """The faults the output check must catch, planted under the API:
    a step that leaves the parameters as they were, or one whose loss
    leaves the lower half of the pixels out (the render and the target
    both cut to the upper half, so L1 and SSIM are means over the rest)."""
    import gags_torch.rgb.train as rt

    if kind == "unchanged":
        def unchanged(state, batch, lr, deg):
            keep = {g: v.clone() for g, v in state.params.items()}
            state, m = step(state, batch, lr, deg)
            for g, v in keep.items():
                state.params[g].copy_(v)
            return state, m
        return unchanged
    real = rt.rasterize

    def upper_half(*a, **k):
        res = real(*a, **k)
        return res._replace(image=res.image[:h // 2])

    rt.rasterize = upper_half

    def half(state, batch, lr, deg):
        return step(state, dict(batch, image=batch["image"][:h // 2]), lr, deg)
    return half


def _trace(ctx, prof, snap, written, inp, cams, steps, window_s, step_s, w, h) -> dict:
    summary = prof.summary()
    dev = ctx.device
    p = snap
    opac = torch.sigmoid(p["opacities_raw"])
    scales = torch.exp(p["scales_raw"])
    k1, k8, flops = [], [], 0
    for i in cams:
        _, q, t = written[i]
        vm, K = camera(q, t, inp["focal"], w, h)
        pc = pairs.count(p["means"], p["quats"], scales, opac, torch.as_tensor(vm, device=dev),
                         torch.as_tensor(K, device=dev), w, h)
        o1 = ops.forward_blend_ops(pc["near"], pc["blended"], 3)
        o8 = ops.full_backward_ops(pc["near"], pc["blended"], 3)
        k1.append(ops.bound_s(o1, ops.forward_blend_bytes(pc["visible"], pc["instances"],
                                                          pc["tiles"], pc["pixels"], 3)))
        k8.append(ops.bound_s(o8, ops.full_backward_bytes(pc["visible"], pc["instances"],
                                                          pc["tiles"], pc["pixels"], 3)))
        flops += o1 + o8 + ops.ssim_flops(pc["pixels"], 3)
    harness.detail(f"profiled {steps} steps in {window_s:.6f} s: {summary['records_kept']} kernel "
                   f"records kept of {summary['launch_calls']} launches; busy "
                   f"{summary['busy_s']:.6f} s (union {summary['union_s']:.6f} s); "
                   f"lost launches by host op {summary['lost_by_op']}; last camera's "
                   f"pairs {pc}")
    return dict(summary=summary, units=steps, window_s=window_s, step_s=step_s,
                flops_per_unit=flops / steps,
                bounds_s={"blend_forward_kernel": sum(k1) / len(k1),
                          "blend_backward_full_kernel": sum(k8) / len(k8)})


def _check(ctx, inp, written, cams, rec, densify_check, rcfg, radius, w, h, start) -> list:
    lim = ctx.cell.traffic["limits"]
    dev = ctx.device
    t0 = time.perf_counter()
    n = inp["seed"]["means"].shape[0]
    s = inp["seed"]
    params0 = dict(means=s["means"], sh_dc=s["sh"][:, :1].contiguous(),
                   sh_rest=s["sh"][:, 1:].contiguous(), opacities_raw=s["opacities_raw"],
                   scales_raw=s["scales_raw"], quats=s["quats"])
    steps = []
    for j, i in enumerate(cams):
        _, q, t = written[i]
        vm, K = camera(q, t, inp["focal"], w, h)
        img = torch.as_tensor(inp["images"][i], device=dev).to(torch.float32) / 255.0
        steps.append((start + j, torch.as_tensor(vm, device=dev), torch.as_tensor(K, device=dev),
                      img))
    rc = dict(sh_degree=rcfg.sh_degree, lambda_dssim=rcfg.lambda_dssim,
              position_lr_init=rcfg.position_lr_init, position_lr_final=rcfg.position_lr_final,
              position_lr_delay_mult=rcfg.position_lr_delay_mult,
              position_lr_max_steps=rcfg.position_lr_max_steps, feature_lr=rcfg.feature_lr,
              opacity_lr=rcfg.opacity_lr, scaling_lr=rcfg.scaling_lr,
              rotation_lr=rcfg.rotation_lr)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    ref = ref_rgb.run_steps(params0, alive, steps, w, h, rc, radius)
    harness.detail(f"reference: {len(cams)} steps (cameras {cams}) in "
                   f"{time.perf_counter() - t0:.3f} s; losses {ref['loss']}; program {rec['loss']}")
    checks = training_checks(rec, ref, lim)
    # densification statistics after the checked steps, slots 0..n-1 hold
    # the seed Gaussians in both
    gaps = []
    for key in ("grad_accum", "denom", "max_radii"):
        a = rec["stats"][key][:n].double()
        b = ref["stats"][key].double()
        gaps.append(float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30)))
        tail = rec["stats"][key][n:]
        if bool((tail != 0).any()):
            gaps.append(math.inf)
    checks.append(("stats_gap", max(gaps), lim["stats_gap"]))
    if densify_check is None:
        checks.append(("densify_gap", math.inf, lim["densify_gap"]))
        return checks
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    cap = densify_check["alive"].shape[0]
    noise = [torch.randn((cap, 3), generator=gen, device=dev) for _ in range(2)]
    new, new_alive, _ = ref_rgb.densify(
        densify_check["before"], densify_check["alive"], densify_check["grad_accum"],
        densify_check["denom"], noise,
        dict(densify_grad_threshold=rcfg.densify_grad_threshold,
             percent_dense=rcfg.percent_dense, min_opacity=rcfg.min_opacity), radius)
    gaps = [float((new_alive != densify_check["alive_after"]).sum())]
    for g, v in new.items():
        got = densify_check["after"][g].double()
        want = v.double()
        gaps.append(float(torch.linalg.vector_norm(got - want)
                          / torch.linalg.vector_norm(want).clamp_min(1e-30)))
    harness.detail(f"densify: alive {int(densify_check['alive'].sum())} -> program "
                   f"{int(densify_check['alive_after'].sum())}, reference {int(new_alive.sum())}")
    checks.append(("densify_gap", max(gaps), lim["densify_gap"]))
    return checks
