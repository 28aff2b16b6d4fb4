"""GAD supervision loader (port of gags_tpu.gad.data): language features →
static-shape batches, streamed to the device one step ahead.

Each camera's supervision is padded once to a (max_masks, D) embedding
table and a render-resolution int32 seg map; `prefetch_to_device` copies
the next batches from pinned host memory on a side stream while the
current step runs.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gags_torch.scene.dataset import CameraInfo, camera_from_info


def _nearest_resize_np(seg: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(L, H, W) nearest resize, torch floor-index convention."""
    h_out, w_out = out_hw
    h_in, w_in = seg.shape[-2:]
    if (h_in, w_in) == (h_out, w_out):
        return seg
    ri = np.clip(np.floor(np.arange(h_out) * (h_in / h_out)).astype(np.int64), 0, h_in - 1)
    ci = np.clip(np.floor(np.arange(w_out) * (w_in / w_out)).astype(np.int64), 0, w_in - 1)
    return seg[..., ri[:, None], ci[None, :]]


@dataclasses.dataclass
class GadExample:
    name: str
    viewmat: np.ndarray  # (4, 4)
    K: np.ndarray  # (3, 3)
    img_embed: np.ndarray  # (max_masks, D)
    seg_map: np.ndarray  # (H, W, 4) int32, -1 invalid


class GadDataset:
    """Loads and pads per-camera supervision; all cameras share one render
    size. Seg maps are nearest-resized to the render resolution at load
    time, as the reference's camera loader does."""

    def __init__(self, cam_infos: Sequence[CameraInfo], resolution: int = 2,
                 max_masks: Optional[int] = None, clip_dim: int = 512):
        self.examples: List[GadExample] = []
        embeds, metas = [], []
        for info in cam_infos:
            if not info.f_path:
                raise ValueError(f"camera {info.name} has no language features")
            emb = np.load(info.f_path)  # (M, D), typically float16 on disk
            if emb.dtype not in (np.float16, np.float32):
                emb = emb.astype(np.float32)
            seg = np.load(info.s_path)  # (4, h, w) float with -1
            cam = camera_from_info(info, resolution)
            seg = _nearest_resize_np(seg, (cam.height, cam.width))
            seg = np.moveaxis(seg, 0, -1).astype(np.int32)  # (H, W, 4)
            embeds.append(emb)
            metas.append((info.name, cam, seg))
        self.max_masks = max_masks or max(e.shape[0] for e in embeds)
        self.clip_dim = embeds[0].shape[1] if embeds else clip_dim
        for emb, (name, cam, seg) in zip(embeds, metas):
            if emb.shape[0] > self.max_masks:
                raise ValueError(f"{name}: {emb.shape[0]} masks > max_masks={self.max_masks}")
            pad = np.zeros((self.max_masks, emb.shape[1]), emb.dtype)
            pad[: emb.shape[0]] = emb
            self.examples.append(GadExample(
                name=name, viewmat=cam.viewmat.numpy(), K=cam.K.numpy(),
                img_embed=pad, seg_map=seg,
            ))
        self.height = self.examples[0].seg_map.shape[0]
        self.width = self.examples[0].seg_map.shape[1]

    def __len__(self) -> int:
        return len(self.examples)

    def epoch_order(self, rng: np.random.Generator) -> np.ndarray:
        """Random no-replacement order over the cameras."""
        return rng.permutation(len(self.examples))

    def batch(self, idx: int) -> Dict[str, np.ndarray]:
        ex = self.examples[idx]
        return dict(viewmat=ex.viewmat, K=ex.K, img_embed=ex.img_embed, seg_map=ex.seg_map)


def _to_device(batch, device: torch.device, stream):
    """numpy arrays → tensors on `device` (pinned, non-blocking copies on
    `stream` for CUDA); tensors already on the device pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.device.type == device.type:
            out[k] = v
            continue
        t = torch.as_tensor(v)
        if device.type == "cuda":
            with torch.cuda.stream(stream):
                out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


def prefetch_to_device(batches: Iterator[Dict], device, size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Host→device pipeline: a thread keeps `size` batches in flight, each
    copied from pinned memory on a side stream, so the copies overlap the
    running step. The consumer's stream waits on each batch's copies."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def producer():
        try:
            for b in batches:
                if stop.is_set():
                    return
                item = _to_device(b, device, stream)
                event = None
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
                q.put((item, event))
            q.put(sentinel)
        except BaseException as exc:  # surface in the consumer
            q.put(exc)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for v in batch.values():
                    v.record_stream(current)  # the allocator must not reuse it early
            yield batch
    finally:
        stop.set()
        while t.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(timeout=0.05)
