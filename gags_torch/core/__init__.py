from gags_torch.core.camera import (
    Camera,
    focal_to_fov,
    fov_to_focal,
    intrinsics_from_fov,
    look_at,
    world_to_view,
)
from gags_torch.core.sh import SH_C0, eval_sh, rgb_to_sh, sh_colors, sh_to_rgb
from gags_torch.core.transforms import inverse_sigmoid, quat_to_rotmat

__all__ = [
    "Camera",
    "focal_to_fov",
    "fov_to_focal",
    "intrinsics_from_fov",
    "look_at",
    "world_to_view",
    "SH_C0",
    "eval_sh",
    "rgb_to_sh",
    "sh_colors",
    "sh_to_rgb",
    "inverse_sigmoid",
    "quat_to_rotmat",
]
