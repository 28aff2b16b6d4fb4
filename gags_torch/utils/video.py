"""mp4 encoding of rendered frame sequences (port of gags_tpu.utils.video),
for the relevancy CLI's --video: OpenCV's mp4v encoder where cv2 is
installed; without it the call says so and returns False, and the PNGs
written beside it stand."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def write_video(path: str, frames: Sequence[np.ndarray], fps: int = 30) -> bool:
    """Encode float [0, 1] or uint8 RGB frames to mp4; False (with a
    message) where no encoder is available."""
    frames = list(frames)
    if not frames:
        return False
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    h, w = frames[0].shape[:2]
    try:
        import cv2
    except ImportError:
        print(f"[video] cv2 unavailable — skipping {path} (pngs still saved)")
        return False
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        print(f"[video] encoder failed to open — skipping {path}")
        return False
    for f in frames:
        if f.dtype != np.uint8:
            f = (np.clip(f, 0.0, 1.0) * 255).astype(np.uint8)
        writer.write(f[..., ::-1])  # RGB -> BGR
    writer.release()
    return True
