"""GAD distillation training through the port's CLI entry point
(`gags_torch.cli.train_gad.run`), driven by its `on_step` hook.

Set-up writes the scene from the seed (a COLMAP text reconstruction, the
GAS stage's language features and the pretrained PLY), starts `run`,
puts the benchmark's own decoder weights into the state before the
first step, and records what the output check needs from the first
steps: each loss, the first gradient as Adam holds it, each leaf's
change after the checked steps, and the segment ids the program picked
in them (a wrapper around `gad.train.mixed_seg_map`, removed once those
steps are done). The window opens after the warm-up
steps, on a synchronize, and closes on one after `--seconds`; the hook
then stops the loop. A traced run times `profiled_steps` steps after the
warm-up and profiles as many more instead. After the window the plain reference follows the
checked steps from the same inputs.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from benchmark.counts import ops, pairs
from benchmark.lib import fixtures, harness
from benchmark import reference
from benchmark.lib.trace import Profiled
from benchmark.reference import gad as ref_gad


class _Stop(Exception):
    pass


def _poses(n: int):
    return [fixtures.look_at(fixtures.orbit_eye(i / n), (0.0, 0.0, 6.0)) for i in range(n)]


def make_inputs(cfg: dict, seed: int, supervision: bool = True) -> dict:
    """Scene, cameras and (with `supervision`) the GAS stage's language
    features, all from `seed`."""
    n, f = cfg["num_gaussians"], cfg["feature_dim"]
    scene = fixtures.make_scene(n, seed, extent=cfg["scene_extent"], feature_dim=f)
    rng = np.random.default_rng([seed, 1])
    w, h, m = cfg["source_width"], cfg["source_height"], cfg["masks_per_camera"]
    sup = []
    for _ in range(cfg["cameras"] if supervision else 0):
        emb = rng.normal(size=(m, cfg["clip_dim"]))
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        seg = np.zeros((4, h, w), np.float32)
        for level, block in zip((1, 2, 3), cfg["region_blocks_px"]):
            coarse = rng.integers(-1, m, size=(-(-h // block), -(-w // block)))
            seg[level] = np.repeat(np.repeat(coarse, block, 0), block, 1)[:h, :w]
        sup.append((emb.astype(np.float16), seg))
    raw = dict(means=scene["means"], quats=scene["quats"],
               scales_raw=np.log(scene["scales"]).astype(np.float32),
               opacities_raw=np.log(scene["opacities"] / (1.0 - scene["opacities"])).astype(np.float32),
               sh=scene["sh"], features=scene["features"])
    focal = w / (2 * math.tan(math.radians(cfg["fov_deg"]) / 2))
    return dict(raw=raw, sup=sup, poses=_poses(cfg["cameras"]), focal=focal)


def write_scene(root: str, inp: dict, cfg: dict) -> str:
    names = [f"cam{i:03d}.png" for i in range(cfg["cameras"])]
    written = fixtures.write_colmap_text(os.path.join(root, "sparse", "0"), cfg["source_width"],
                                         cfg["source_height"], inp["focal"],
                                         list(zip(names, inp["poses"])))
    fdir = os.path.join(root, "language_features")
    os.makedirs(fdir)
    for name, (emb, seg) in zip(names, inp["sup"]):
        stem = name[:-4]
        np.save(os.path.join(fdir, f"{stem}_f.npy"), emb)
        np.save(os.path.join(fdir, f"{stem}_s.npy"), seg)
    r = inp["raw"]
    ply = os.path.join(root, "pretrained.ply")
    fixtures.write_gaussian_ply(ply, r["means"], r["sh"], r["opacities_raw"], r["scales_raw"],
                                r["quats"], r["features"])
    inp["written"] = written
    return ply


def render_camera(qvec, tvec, focal, src_w, src_h, resolution):
    """viewmat and K as a COLMAP reader of the written files derives them
    at render resolution `-r resolution`."""
    vm = np.eye(4)
    vm[:3, :3] = fixtures.qvec_to_rotmat(qvec)
    vm[:3, 3] = tvec
    w, h = int(round(src_w / resolution)), int(round(src_h / resolution))
    fovx = 2.0 * math.atan(src_w / (2.0 * focal))
    fovy = 2.0 * math.atan(src_h / (2.0 * focal))
    fx = w / (2.0 * math.tan(fovx / 2.0))
    fy = h / (2.0 * math.tan(fovy / 2.0))
    K = np.array([[fx, 0.0, w / 2.0], [0.0, fy, h / 2.0], [0.0, 0.0, 1.0]], np.float32)
    return vm.astype(np.float32), K, w, h


def camera_sequence(seed: int, n_cams: int, length: int) -> list:
    """The cameras the CLI's loader feeds, in order: a permutation an
    epoch from numpy's generator seeded with the run's seed."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < length:
        out += [int(i) for i in rng.permutation(n_cams)]
    return out[:length]


def decoder_weights(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    dec = ref_gad.init_linear_stack([tuple(x) for x in cfg["feature_decoder_widths"]], gen, device)
    scl = ref_gad.init_linear_stack([tuple(x) for x in cfg["scale_decoder_widths"]], gen, device)
    return dec, scl


def _inject(kind: str):
    """Faults and TF32, planted under the entry point (used by the
    control and fault readings, never by a run of the benchmark's own)."""
    if kind == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return
    import gags_torch.cli.train_gad as cli

    real = cli.make_train_step_binned

    def faulty(width, height, gcfg):
        step = real(width, height, gcfg)

        def half(state, geom, batch, ew, rw):
            b = dict(batch)
            seg = b["seg_map"].clone()
            seg[seg.shape[0] // 2:] = -1  # the lower half of the pixels left out
            b["seg_map"] = seg
            return step(state, geom, b, ew, rw)

        def unchanged(state, geom, batch, ew, rw):
            keep = [p.detach().clone() for p in _params(state)]
            state, m = step(state, geom, batch, ew, rw)
            with torch.no_grad():
                for p, k in zip(_params(state), keep):
                    p.copy_(k)
            return state, m

        return {"half_batch": half, "unchanged": unchanged}[kind]

    cli.make_train_step_binned = faulty


def _params(state):
    return [state.features] + list(state.decoder.parameters()) + list(state.scale_decoder.parameters())


def _leaf_names(state):
    return (["features"] + [f"decoder.{k}" for k, _ in state.decoder.named_parameters()]
            + [f"scale_decoder.{k}" for k, _ in state.scale_decoder.named_parameters()])


def _record_segments(box: dict, n: int):
    """Keep the segment ids of the program's first `n` steps once
    `box["seg"]` is a list; the program's own function is put back after."""
    import gags_torch.gad.train as gt

    real = gt.mixed_seg_map

    def recording(seg_map, scale_map):
        out = real(seg_map, scale_map)
        if "seg" in box:
            box["seg"].append(out.detach().reshape(-1).to(torch.int64).clone())
            if len(box["seg"]) == n:
                gt.mixed_seg_map = real
        return out

    gt.mixed_seg_map = recording


def run(ctx) -> dict:
    from gags_torch.cli.train_gad import RunConfig, run as train_run
    from gags_torch.gad.train import GadConfig

    cfg, tr, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    if ctx.inject:
        _inject(ctx.inject)
    t0 = time.perf_counter()
    inp = make_inputs(cfg, ctx.seed)
    root, model = os.path.join(ctx.tmp, "scene"), os.path.join(ctx.tmp, "model")
    ply = write_scene(root, inp, cfg)
    harness.detail(f"fixture: {cfg['num_gaussians']} Gaussians, {cfg['cameras']} cameras written "
                   f"in {time.perf_counter() - t0:.3f} s")
    dec_w, scl_w = decoder_weights(cfg, ctx.seed, dev)
    gcfg = GadConfig(feature_dim=cfg["feature_dim"], clip_dim=cfg["clip_dim"],
                     max_segments=cfg["max_segments"])
    rc = RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=cfg["resolution"],
                   iterations=tr["iterations"], save_iterations=str(tr["iterations"]),
                   test_iterations="", seed=ctx.seed, device=str(dev))
    warm, checked = tr["warmup_steps"], tr["checked_steps"]
    rec = dict(loss=[], grad_norm=None, change_norm=None, steps=0)
    box = {}
    seg_box: dict = {}
    _record_segments(seg_box, checked)
    prof = Profiled(dev) if ctx.trace else None

    def on_step(it, state, m):
        if m is None:
            box["first"] = it
            box["state"] = state
            with torch.no_grad():
                for mod, w in ((state.decoder, dec_w), (state.scale_decoder, scl_w)):
                    for k, p in mod.named_parameters():
                        p.copy_(w[k])
            box["init"] = [p.detach().clone() for p in _params(state)]
            seg_box["seg"] = []
            return
        k = it - box["first"]
        if k <= checked:
            rec["loss"].append(float(m["loss"]))
            if k == 1:
                opts = (state.opt_feat, state.opt_dec, state.opt_scale)
                norms = []
                for opt in opts:
                    for p in opt.param_groups[0]["params"]:
                        ea = opt.state[p]["exp_avg"]
                        norms.append(float(torch.linalg.vector_norm(ea.double())) / 0.1)
                rec["grad_norm"] = dict(zip(_leaf_names(state), norms))
            if k == checked:
                rec["change_norm"] = {
                    n: float(torch.linalg.vector_norm((p.detach() - p0).double()))
                    for n, p, p0 in zip(_leaf_names(state), _params(state), box["init"])}
                box.pop("init")
        if k == warm:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            box["t0"] = time.perf_counter()
            box["setup_s"] = box["t0"] - ctx.t_start
            box["host"] = harness.host_sample()
            return
        if k > warm:
            rec["steps"] += 1
            if prof is not None:
                # a traced run times `profiled_steps` steps without the
                # profiler, then profiles as many more
                if rec["steps"] == tr["profiled_steps"]:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    box["plain_s"] = time.perf_counter() - box["t0"]
                    prof.start()
                elif rec["steps"] == 2 * tr["profiled_steps"]:
                    box["window_s"] = prof.stop()
                    raise _Stop
            elif time.perf_counter() - box["t0"] >= ctx.seconds:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                box["window_s"] = time.perf_counter() - box["t0"]
                harness.host_detail(box["host"], harness.host_sample())
                raise _Stop

    try:
        train_run(rc, gcfg, on_step=on_step)
        raise harness.BenchError("the training loop ended before the window closed")
    except _Stop:
        pass
    steps, window_s = rec["steps"], box["window_s"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    harness.detail(f"window: {steps} steps (iterations {box['first'] + warm + 1}-"
                   f"{box['first'] + warm + steps}) in {window_s:.6f} s; set-up "
                   f"{box['setup_s']:.3f} s; memory peak {peak} B")
    setup_s, plain_s = box["setup_s"], box.get("plain_s")
    box.clear()  # the program's state goes before the reference runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    geo = _geometry(inp["raw"], dev)
    seq = camera_sequence(ctx.seed, cfg["cameras"], warm + steps)
    trace = None
    if ctx.trace:
        p = tr["profiled_steps"]
        trace = _trace(ctx, prof, inp, geo, seq[warm + p:warm + 2 * p], p, window_s, plain_s / p)
    with reference.float32():
        checks = _check(ctx, inp, geo, dec_w, scl_w, seq[:checked], rec, gcfg,
                        seg_box.get("seg", []))
    e2e = {"setup_s": setup_s, "gad_step_ms": window_s / steps * 1e3}
    return dict(e2e=e2e, attempted=steps, failed=0, checks=checks, trace=trace,
                memory_peak_bytes=peak)


def _geometry(raw: dict, dev) -> dict:
    t = {k: torch.as_tensor(raw[k], device=dev) for k in ("means", "quats", "scales_raw",
                                                          "opacities_raw", "features")}
    return dict(means=t["means"], quats=t["quats"], scales=torch.exp(t["scales_raw"]),
                opacities=torch.sigmoid(t["opacities_raw"]), features=t["features"])


def _camera(inp, cfg, i, dev):
    _, q, t = inp["written"][i]
    vm, K, w, h = render_camera(q, t, inp["focal"], cfg["source_width"], cfg["source_height"],
                                cfg["resolution"])
    return torch.as_tensor(vm, device=dev), torch.as_tensor(K, device=dev), w, h


def _trace(ctx, prof, inp, geo, cams, steps, window_s, step_s) -> dict:
    cfg = ctx.cell.config
    summary = prof.summary()
    k1, k2, pixels = [], [], 0
    c = cfg["feature_dim"]
    for i in sorted(set(cams)):
        vm, K, w, h = _camera(inp, cfg, i, ctx.device)
        pc = pairs.count(geo["means"], geo["quats"], geo["scales"], geo["opacities"], vm, K, w, h)
        n = cams.count(i)
        k1 += [ops.bound_s(ops.forward_blend_ops(pc["near"], pc["blended"], c),
                           ops.forward_blend_bytes(pc["visible"], pc["instances"], pc["tiles"],
                                                   pc["pixels"], c))] * n
        k2 += [ops.bound_s(ops.colour_backward_ops(pc["near"], pc["blended"], c),
                           ops.colour_backward_bytes(pc["visible"], pc["instances"], pc["tiles"],
                                                     pc["pixels"], c))] * n
        pixels = w * h
        harness.detail(f"pairs camera {i}: {pc}")
    flops = ops.decoder_train_flops(pixels, cfg["feature_decoder_widths"],
                                    cfg["scale_decoder_widths"])
    harness.detail(f"profiled {steps} steps in {window_s:.6f} s: {summary['records_kept']} kernel "
                   f"records kept of {summary['launch_calls']} launches; busy "
                   f"{summary['busy_s']:.6f} s (union {summary['union_s']:.6f} s); "
                   f"lost launches by host op {summary['lost_by_op']}")
    return dict(summary=summary, units=steps, window_s=window_s, step_s=step_s,
                flops_per_unit=flops,
                bounds_s={"blend_forward_kernel": sum(k1) / len(k1),
                          "blend_backward_kernel": sum(k2) / len(k2)})


def _check(ctx, inp, geo, dec_w, scl_w, cams, rec, gcfg, seg_prog) -> list:
    """The reference follows the checked steps from the same inputs and
    the program's segment picks, which it judges (`seg_gap`); the
    program's numbers are held to it (see PERF.md for the limits)."""
    cfg, lim = ctx.cell.config, ctx.cell.traffic["limits"]
    dev = ctx.device
    t0 = time.perf_counter()
    cameras, batches = [], []
    for j, i in enumerate(cams):
        vm, K, w, h = _camera(inp, cfg, i, dev)
        cameras.append((vm, K))
        emb, seg = inp["sup"][i]
        ri = np.clip(np.floor(np.arange(h) * (seg.shape[1] / h)).astype(np.int64), 0, seg.shape[1] - 1)
        ci = np.clip(np.floor(np.arange(w) * (seg.shape[2] / w)).astype(np.int64), 0, seg.shape[2] - 1)
        seg_r = np.moveaxis(seg[:, ri[:, None], ci[None, :]], 0, -1).astype(np.int32)
        batches.append(dict(img_embed=torch.as_tensor(emb, device=dev),
                            seg_map=torch.as_tensor(seg_r, device=dev),
                            seg_prog=seg_prog[j] if j < len(seg_prog) else None))
    weights = dict(features=geo["features"], decoder=dec_w, scale_decoder=scl_w)
    ref = ref_gad.run_steps(cameras, weights, geo, batches, w, h, dict(
        feature_lr=gcfg.feature_lr, decoder_lr=gcfg.decoder_lr,
        adam_eps_features=gcfg.adam_eps_features, max_segments=gcfg.max_segments,
        entropy_w=gcfg.entropy_w_early, regionvar_w=0.0))
    harness.detail(f"reference: {len(cams)} steps (cameras {cams}) in "
                   f"{time.perf_counter() - t0:.3f} s; losses {ref['loss']}; program {rec['loss']}")
    seg_gap = ref["seg_gap"] if len(seg_prog) == len(cams) else math.inf
    return training_checks(rec, ref, lim) + [("seg_gap", seg_gap, lim["seg_gap"])]


def training_checks(rec: dict, ref: dict, lim: dict) -> list:
    """loss: the largest relative gap of a checked step's loss; grad and
    change: by the worst leaf, the gap between the program's norm and the
    reference's, over the larger of the leaf's reference norm and the
    median leaf's. Leaves whose reference gradient is under a thousandth
    of the median leaf's are left out of both."""
    loss = max((abs(a - b) / max(abs(b), 1e-30) for a, b in zip(rec["loss"], ref["loss"])),
               default=math.inf) if len(rec["loss"]) == len(ref["loss"]) else math.inf
    g_ref = ref["grad_norm"]
    med_g = float(np.median(list(g_ref.values())))
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * med_g]

    def gaps(prog, refd):
        if prog is None or any(k not in prog for k in keep):
            return {k: math.inf for k in keep}
        med = float(np.median([refd[k] for k in keep]))
        return {k: abs(prog[k] - refd[k]) / max(refd[k], med, 1e-30) for k in keep}

    out = {}
    for name, prog, refd in (("grad", rec["grad_norm"], g_ref),
                             ("change", rec["change_norm"], ref["change_norm"])):
        g = gaps(prog, refd)
        out[name] = max(g.values())
        top = sorted(g.items(), key=lambda kv: -kv[1])[:3]
        harness.detail(f"{name} gaps: worst {max(g.values()):.6g}, median "
                       f"{float(np.median(list(g.values()))):.6g}; largest {top}")
    harness.detail(f"leaves compared: {len(keep)} of {len(g_ref)}")
    return [("loss_gap", loss, lim["loss_gap"]), ("grad_gap", out["grad"], lim["grad_gap"]),
            ("change_gap", out["change"], lim["change_gap"])]
