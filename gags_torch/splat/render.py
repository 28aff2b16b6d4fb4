"""Scene-level render entry point (port of gags_tpu.splat.render).

Chooses the colour source (SH RGB, override colours, or the F-dim
semantic features), an optional expected-depth channel ("RGB+ED"), and
background blending, then rasterizes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gags_torch import resolve_device
from gags_torch.core.camera import Camera
from gags_torch.core.sh import sh_colors
from gags_torch.splat.rasterizer import RasterizeConfig, rasterize


class RenderOutput(NamedTuple):
    render: torch.Tensor  # (H, W, C) channel-last (3 RGB, F features, +1 with ED)
    alpha: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (N,) int32; 0 = culled
    means2d: torch.Tensor  # (N, 2)


@torch.no_grad()
def render(
    camera: Camera,
    *,
    means: torch.Tensor,
    quats: torch.Tensor,
    scales: torch.Tensor,
    opacities: torch.Tensor,
    sh: Optional[torch.Tensor] = None,  # (N, K, 3), dc first
    sh_degree: int = 3,
    semantic_features: Optional[torch.Tensor] = None,  # (N, F)
    override_color: Optional[torch.Tensor] = None,  # (N, 3)
    feature_mode: bool = False,
    render_mode: str = "RGB",  # "RGB" | "RGB+ED"
    bg_color: Optional[torch.Tensor] = None,  # (3,)
    config: Optional[RasterizeConfig] = None,
    device="cuda",
) -> RenderOutput:
    """Render one camera view on `device` (default "cuda"; raises when CUDA
    is absent). feature_mode renders the semantic features with the
    background's first component broadcast across all channels."""
    dev = resolve_device(device)
    config = config or RasterizeConfig()
    cam = camera.to(dev)
    means = means.to(dev)
    if feature_mode:
        if semantic_features is None:
            raise ValueError("feature_mode needs semantic_features")
        colors = semantic_features.to(dev)
        bg = None if bg_color is None else bg_color.to(dev)[0].expand(colors.shape[-1])
    elif override_color is not None:
        colors = override_color.to(dev)
        bg = None if bg_color is None else bg_color.to(dev)
    else:
        if sh is None:
            raise ValueError("RGB mode needs sh or override_color")
        colors = sh_colors(sh_degree, sh.to(dev), means, cam.campos)
        bg = None if bg_color is None else bg_color.to(dev)
    scales = scales.to(dev)

    ed = render_mode == "RGB+ED"
    if ed:
        # expected depth rides along as an extra channel, normalised by alpha
        depth_cam = (means @ cam.viewmat[:3, :3].T + cam.viewmat[:3, 3])[:, 2]
        colors = torch.cat([colors, depth_cam[:, None]], dim=-1)
        if bg is not None:
            bg = torch.cat([bg, torch.zeros((1,), dtype=bg.dtype, device=dev)])
    elif render_mode != "RGB":
        raise ValueError(f"unknown render_mode {render_mode!r}")

    res = rasterize(
        means, quats, scales, opacities, colors, cam.viewmat, cam.K,
        cam.width, cam.height, background=bg, config=config, device=dev,
    )
    img = res.image
    if ed:
        depth = img[..., -1:] / torch.clamp_min(res.alpha[..., None], 1e-10)
        img = torch.cat([img[..., :-1], depth], dim=-1)
    return RenderOutput(render=img, alpha=res.alpha, radii=res.radii, means2d=res.means2d)
