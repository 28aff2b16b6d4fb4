"""Remote-viewer socket bridge, SIBR protocol (the port's own copy of
gags_tpu.utils.viewer: standard library and numpy only).

Wire-compatible with the reference's `gaussian_renderer/network_gui.py` so
the SIBR remote Gaussian viewer can attach to a training/serving process:

  client → server: 4-byte little-endian length + JSON camera message
    {resolution_x/y, train, fov_x/y, z_near/far, shs_python,
     rot_scale_python, keep_alive, scaling_modifier, view_matrix (16),
     view_projection_matrix (16)}
  server → client: raw H*W*3 uint8 bytes, then 4-byte length + ascii
    verify string (the dataset path).

The view matrix arrives in the transposed (row-vector) convention with the
y/z columns flipped; `ViewerRequest.viewmat` converts to our standard
world→camera matrix.
"""

from __future__ import annotations

import dataclasses
import json
import socket
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ViewerRequest:
    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    do_training: bool
    keep_alive: bool
    scaling_modifier: float
    viewmat: np.ndarray  # (4, 4) standard world→camera


class ViewerServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self) -> Optional[ViewerRequest]:
        """Read one camera request; None when resolution is 0 (idle ping)."""
        length = int.from_bytes(self._recv_exact(4), "little")
        msg = json.loads(self._recv_exact(length).decode("utf-8"))
        w, h = msg["resolution_x"], msg["resolution_y"]
        if w == 0 or h == 0:
            return None
        wvt = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wvt[:, 1] = -wvt[:, 1]
        wvt[:, 2] = -wvt[:, 2]
        return ViewerRequest(
            width=w,
            height=h,
            fovx=msg["fov_x"],
            fovy=msg["fov_y"],
            znear=msg["z_near"],
            zfar=msg["z_far"],
            do_training=bool(msg["train"]),
            keep_alive=bool(msg["keep_alive"]),
            scaling_modifier=msg["scaling_modifier"],
            viewmat=wvt.T,  # stored transposed on the wire
        )

    def send(self, image: Optional[np.ndarray], verify: str) -> None:
        """image: (H, W, 3) float in [0,1] or uint8, or None."""
        if image is not None:
            if image.dtype != np.uint8:
                image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
            self.conn.sendall(image.tobytes())
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def drop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.drop()
        self.listener.close()


class TrainingViewer:
    """Per-iteration viewer polling for a training loop.

    Reference semantics (the reference's train.py:109-123): each training
    iteration serves pending SIBR requests; a paused client
    (do_training=False) holds training until it resumes; a client rendering
    while training (do_training=True) gets one frame per iteration.
    Deviation: an idle connected client (no pending message) does NOT stall
    the step — we only block on the socket while the client is paused.
    """

    def __init__(self, server: ViewerServer, render_rgb, verify: str):
        self.server = server
        self.render_rgb = render_rgb  # (ViewerRequest) -> (H, W, 3) float/uint8
        self.verify = verify
        self.paused = False

    def _pending(self) -> bool:
        import select

        r, _, _ = select.select([self.server.conn], [], [], 0)
        return bool(r)

    def poll(self, iteration: int, total_iterations: int) -> None:
        if self.server.conn is None and not self.server.try_connect():
            return
        while self.server.conn is not None:
            try:
                if not self.paused and not self._pending():
                    return
                req = self.server.receive()
                img = self.render_rgb(req) if req is not None else None
                self.server.send(img, self.verify)
                if req is None:
                    continue
                self.paused = not req.do_training
                if req.do_training and (
                    iteration < total_iterations or not req.keep_alive
                ):
                    return
            except (ConnectionError, OSError, json.JSONDecodeError, KeyError):
                # client went away / sent garbage: drop quietly (the
                # reference swallows viewer socket errors too, train.py:122)
                self.server.drop()
                self.paused = False
            except Exception as exc:  # a real render failure must be visible
                print(f"[viewer] render error, dropping connection: {exc!r}")
                self.server.drop()
                self.paused = False

    def close(self) -> None:
        self.server.close()
