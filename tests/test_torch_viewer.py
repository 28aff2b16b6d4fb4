"""gags_torch.utils.viewer (the SIBR remote-viewer protocol) after
tests/test_viewer_and_campath.py: the socket round trip (the request the
port decodes equals the JAX package's, field for field), TrainingViewer.poll,
and train_gad's --viewer_port on the CPU, whose frame must equal a direct
rasterize of the frozen geometry byte for byte."""

import json
import math
import socket
import threading
import time

import numpy as np
import torch

from gags_torch.utils.viewer import TrainingViewer, ViewerServer

from test_torch_train_cli import build_fixture, _cfg


def _message(w, h, viewmat=None, fovx=1.0, fovy=0.8, train=True):
    """A SIBR camera message for `viewmat` (world→camera): the wire carries
    it transposed with the y / z columns flipped."""
    vm = np.eye(4, dtype=np.float32) if viewmat is None else np.asarray(viewmat, np.float32)
    wire = vm.T.copy()
    wire[:, 1] *= -1
    wire[:, 2] *= -1
    msg = dict(resolution_x=w, resolution_y=h, train=train, fov_x=fovx, fov_y=fovy,
               z_near=0.01, z_far=100.0, shs_python=False, rot_scale_python=False,
               keep_alive=True, scaling_modifier=1.0, view_matrix=wire.flatten().tolist(),
               view_projection_matrix=wire.flatten().tolist())
    raw = json.dumps(msg).encode()
    return len(raw).to_bytes(4, "little") + raw


def _read_reply(c, n):
    img = b""
    while len(img) < n:
        chunk = c.recv(n - len(img))
        assert chunk
        img += chunk
    m = int.from_bytes(c.recv(4), "little")
    return img, c.recv(m)


def test_viewer_roundtrip_matches_jax():
    from gags_tpu.utils.viewer import ViewerServer as JServer

    vm = np.array([[0.6, -0.8, 0, 0.1], [0.8, 0.6, 0, -0.2], [0, 0, 1, 3.0], [0, 0, 0, 1]],
                  np.float32)
    reqs = []
    for cls in (ViewerServer, JServer):
        srv = cls(port=0)
        port = srv.listener.getsockname()[1]
        result = {}

        def client():
            c = socket.create_connection(("127.0.0.1", port))
            c.sendall(_message(8, 4, vm))
            result["img"], result["verify"] = _read_reply(c, 8 * 4 * 3)
            c.close()

        t = threading.Thread(target=client)
        t.start()
        while not srv.try_connect():
            pass
        req = srv.receive()
        srv.send(np.full((4, 8, 3), 0.5, np.float32), "ok")
        t.join(timeout=5)
        srv.close()
        assert result["verify"] == b"ok" and result["img"] == bytes([127]) * 96
        reqs.append(req)
    got, want = reqs
    np.testing.assert_array_equal(got.viewmat, want.viewmat)
    np.testing.assert_array_equal(got.viewmat, vm)  # the wire convention undone
    for f in ("width", "height", "fovx", "fovy", "znear", "zfar", "do_training", "keep_alive",
              "scaling_modifier"):
        assert getattr(got, f) == getattr(want, f), f


def test_training_viewer_poll():
    """Pending requests are served; an idle or absent client never stalls
    the step."""
    srv = ViewerServer(port=0)
    port = srv.listener.getsockname()[1]
    tv = TrainingViewer(srv, lambda req: np.full((req.height, req.width, 3), 0.5, np.float32),
                        "src")
    tv.poll(1, 10)  # no client connected: immediate no-op
    out = {}

    def client():
        c = socket.create_connection(("127.0.0.1", port))
        c.sendall(_message(8, 4))
        out["img"], out["verify"] = _read_reply(c, 96)
        c.close()

    t = threading.Thread(target=client)
    t.start()
    deadline = time.time() + 10
    while "verify" not in out and time.time() < deadline:
        tv.poll(2, 10)
        time.sleep(0.01)
    t.join(timeout=5)
    assert out["verify"] == b"src" and out["img"][0] == 127
    tv.poll(3, 10)  # the closed connection is dropped quietly
    assert srv.conn is None
    tv.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_gad_viewer_frame_equals_direct_rasterize(tmp_path):
    from gags_torch.cli.train_gad import RunConfig, run
    from gags_torch.core.camera import intrinsics_from_fov, look_at
    from gags_torch.core.sh import sh_colors
    from gags_torch.scene.gaussian_data import GaussianScene
    from gags_torch.splat.rasterizer import RasterizeConfig, rasterize

    root, model = str(tmp_path / "scene"), str(tmp_path / "model")
    ply = build_fixture(root)
    w, h, fovx = 40, 24, math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * h / w)
    vm = look_at(np.array([0.3, -0.2, -0.4]), np.array([0.0, 0.0, 6.0]),
                 np.array([0.0, -1.0, 0.0])).astype(np.float32)
    port, got, clients = _free_port(), {}, []

    def on_step(it, state, m):
        if m is None:  # the listener is up: a client connects and sends one camera
            c = socket.create_connection(("127.0.0.1", port))
            c.sendall(_message(w, h, vm, fovx, fovy))

            def read():
                got["img"], got["verify"] = _read_reply(c, w * h * 3)
                c.close()
            t = threading.Thread(target=read)
            t.start()
            clients.append(t)

    rc = RunConfig(source_path=root, model_path=model, ply_path=ply, resolution=1,
                   iterations=3, save_iterations="", test_iterations="", viewer_port=port,
                   device="cpu")
    run(rc, _cfg(), on_step=on_step)
    clients[0].join(timeout=30)
    assert got["verify"] == root.encode()
    g = GaussianScene.from_ply(ply)
    viewmat = torch.as_tensor(vm)
    K = torch.as_tensor(intrinsics_from_fov(fovx, fovy, w, h))
    colors = sh_colors(3, g.sh, g.means, -viewmat[:3, :3].T @ viewmat[:3, 3])
    res = rasterize(g.means, g.quats, g.scales, g.opacities, colors, viewmat, K, w, h,
                    background=torch.zeros(3), config=RasterizeConfig(aligned=False),
                    device="cpu")
    want = (np.clip(res.image.numpy(), 0, 1) * 255).astype(np.uint8)
    assert want.max() > 0
    assert got["img"] == want.tobytes()
