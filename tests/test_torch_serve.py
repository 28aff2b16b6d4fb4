"""The port's serving slice vs gags_tpu on a tiny scene with identical
weights, and the port's HTTP endpoints on the CPU."""

import base64
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gags_tpu.core.camera import Camera as JCamera
from gags_tpu.models.decoders import FeatureDecoder as JFeat
from gags_tpu.query.grounding import decode_map_rows as jdecode
from gags_tpu.query.relevancy import max_across_levels as jmax_levels
from gags_tpu.splat.rasterizer import RasterizeConfig as JConfig
from gags_tpu.splat.render import render as jrender
from gags_torch.cli.serve import SceneServer, encode_png, load_server, make_handler
from gags_torch.models.decoders import FeatureDecoder
from gags_torch.models.weights import decoder_state_from_flax, save_decoders, scene_from_arrays
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.utils.synthetic import make_camera, make_scene

W, H, N, FD = 32, 16, 60, 16
TILE = dict(tile_h=8, tile_w=16, chunk=8)


def _setup():
    raw = make_scene(N, seed=0)
    raw["features"] = np.random.default_rng(3).normal(size=(N, FD)).astype(np.float32)
    jdec = JFeat()
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.PRNGKey(0), jnp.zeros((1, FD)))
    )
    dec = FeatureDecoder(in_dim=FD)
    dec.load_state_dict(decoder_state_from_flax(params))
    scene = scene_from_arrays(
        raw["means"], raw["quats"], np.log(raw["scales"]),
        np.log(raw["opacities"] / (1 - raw["opacities"])), raw["sh"],
        semantic_features=raw["features"],
    )
    rng = np.random.default_rng(7)
    pos = rng.normal(size=(2, 512)).astype(np.float32)
    neg = rng.normal(size=(3, 512)).astype(np.float32)
    text = (["thing", "other"], pos, neg)
    srv = SceneServer(scene, dec, text_embeds=text, raster=RasterizeConfig(**TILE, aligned=False),
                      device="cpu")
    return raw, jdec, params, scene, srv, pos, neg


def _jax_geometry(scene):
    return dict(
        means=jnp.asarray(scene.means.numpy()), quats=jnp.asarray(scene.quats.numpy()),
        scales=jnp.asarray(scene.scales.numpy()), opacities=jnp.asarray(scene.opacities.numpy()),
    )


def test_slice_relevancy_and_rgb_match_jax():
    raw, jdec, params, scene, srv, pos, neg = _setup()
    cam = make_camera(W, H)
    jcam = JCamera(viewmat=jnp.asarray(cam.viewmat.numpy()), K=jnp.asarray(cam.K.numpy()),
                   width=W, height=H)
    jcfg = JConfig(**TILE, interpret=True, aligned=False)
    geo = _jax_geometry(scene)
    fmap = jrender(jcam, **geo, semantic_features=jnp.asarray(raw["features"]),
                   feature_mode=True, bg_color=jnp.zeros((3,)), config=jcfg).render
    decoded = jdecode(jdec.apply, params, fmap)
    want = np.asarray(jmax_levels(jnp.asarray(decoded)[None], jnp.asarray(pos), jnp.asarray(neg)))[0]
    got = srv.relevancy_map(cam, torch.as_tensor(pos), torch.as_tensor(neg)).numpy()
    assert got.shape == (2, H, W)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.ptp(want) > 1e-3  # the map is not constant

    rgb_j = jrender(jcam, **geo, sh=jnp.asarray(scene.sh.numpy()), sh_degree=3,
                    feature_mode=False, bg_color=jnp.zeros((3,)), config=jcfg).render
    np.testing.assert_allclose(srv.render_rgb(cam).numpy(), np.asarray(rgb_j), atol=2e-5, rtol=1e-4)


def _decode_png(b):
    assert b[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", b[16:24])
    data = b[33 + 8 : 33 + 8 + struct.unpack(">I", b[33:37])[0]]
    rows = np.frombuffer(zlib.decompress(data), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_encode_png_roundtrip():
    img = np.random.default_rng(0).uniform(size=(5, 7, 3))
    np.testing.assert_array_equal(_decode_png(encode_png(img)), (img * 255).astype(np.uint8))


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def http_server():
    raw, jdec, params, scene, srv, pos, neg = _setup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"http://127.0.0.1:{httpd.server_address[1]}", pos, neg
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def test_http_endpoints(http_server):
    srv, base, pos, neg = http_server
    cam = make_camera(W, H)
    req = dict(viewmat=cam.viewmat.reshape(-1).tolist(), K=cam.K.reshape(-1).tolist(),
               width=W, height=H)
    with urllib.request.urlopen(base + "/health", timeout=60) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["n_gaussians"] == N
    assert health["feature_dim"] == FD and health["labels"] == ["thing", "other"]

    for mode in ("rgb", "feature_pca"):
        code, out = _post(base + "/render", dict(req, mode=mode))
        assert code == 200 and out["mode"] == mode and out["render_ms"] >= 0
        assert _decode_png(base64.b64decode(out["image_png"])).shape == (H, W, 3)

    code, out = _post(base + "/relevancy", dict(req, label="other"))
    assert code == 200 and set(out) == {"heatmap_png", "mask_png", "relevancy_max", "selected_px"}
    direct = srv.relevancy_map(cam, torch.as_tensor(pos[1:2]), torch.as_tensor(neg))[0]
    assert out["relevancy_max"] == pytest.approx(float(direct.max()), abs=1e-7)
    mask = _decode_png(base64.b64decode(out["mask_png"]))
    assert int((mask[..., 0] == 255).sum()) == out["selected_px"]

    code, out2 = _post(base + "/relevancy", dict(req, pos=pos[0].tolist(), neg=neg.tolist(), thresh=0.4))
    assert code == 200 and np.isfinite(out2["relevancy_max"])
    assert health["compiled"] == [] and srv.health()["compiled"] == [[W, H]]

    code, err = _post(base + "/relevancy", dict(req, label="nope"))
    assert code == 400 and "unknown label" in err["error"]
    code, err = _post(base + "/render", dict(req, mode="depth"))
    assert code == 400 and "unknown mode" in err["error"]


def test_load_server_from_model_dir(tmp_path):
    raw, jdec, params, scene, srv, pos, neg = _setup()
    it = tmp_path / "point_cloud" / "iteration_7"
    it.mkdir(parents=True)
    scene.save_ply(str(it / "point_cloud.ply"))
    save_decoders(str(tmp_path / "decoders.pt"), srv.decoder)
    np.savez(tmp_path / "text.npz", labels=np.array(["thing", "other"]), pos=pos, neg=neg)
    loaded = load_server(str(tmp_path), 7, text_embeds=str(tmp_path / "text.npz"), device="cpu")
    assert loaded.health()["labels"] == ["thing", "other"]
    cam = make_camera(W, H)
    a = loaded.relevancy_map(cam, torch.as_tensor(pos), torch.as_tensor(neg))
    b = srv.relevancy_map(cam, torch.as_tensor(pos), torch.as_tensor(neg))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
