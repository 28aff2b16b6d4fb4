"""HTTP serving endpoint for trained GAGS scenes: render + open-vocabulary
query (port of gags_tpu.cli.serve).

Endpoints (JSON in, JSON out; images as base64 PNG):
  GET  /health
  POST /render     {viewmat: 16 floats (row-major 4x4), K: 9 floats,
                    width, height, mode: "rgb" | "feature_pca"}
  POST /relevancy  {viewmat, K, width, height, thresh?,
                    label: <name from --text_embeds>  OR
                    pos: [D floats], neg: [[D floats], ...]}

Requests are serialised through one device lock. The scene, its
activations and the decoder live on the device for the life of the
server. PNGs are encoded with zlib and struct from the standard library
(utils/image.encode_png).

Run: python -m gags_torch.cli.serve -m <model_path> [--iteration N]
     [--autotune] [--autotune_res 1280x720]
The model directory holds point_cloud/iteration_N/point_cloud.ply (with
semantic_* features) and decoders.pt (see models/weights.save_decoders).
The rasterizer config is the persisted autotune winner of the
--autotune_res shape where one exists (bf16 variants allowed: feature and
relevancy serving tolerate their contract), or with --autotune the fastest
variant timed on the card at start-up (splat/autotune.py).
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from gags_torch import resolve_device
from gags_torch.core.camera import Camera
from gags_torch.models.decoders import FeatureDecoder, feature_decoder_from_state
from gags_torch.models.weights import load_decoder_state
from gags_torch.query.grounding import decode_map_rows
from gags_torch.query.relevancy import heatmap_to_mask, majority_smooth, max_across_levels
from gags_torch.scene.gaussian_data import GaussianScene
from gags_torch.splat.autotune import autotune_config, load_persisted
from gags_torch.splat.rasterizer import RasterizeConfig
from gags_torch.splat.render import render
from gags_torch.utils.colormaps import apply_pca_colormap, turbo
from gags_torch.utils.image import encode_png


def _png_b64(img01: np.ndarray) -> str:
    return base64.b64encode(encode_png(img01)).decode("ascii")


class SceneServer:
    """Holds the scene, its features and the feature decoder on the device."""

    def __init__(self, scene: GaussianScene, decoder: FeatureDecoder,
                 text_embeds=None, raster: RasterizeConfig | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        # decode and relevancy products in full float32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        if scene.semantic_features is None:
            raise ValueError("SceneServer: the scene has no semantic_features")
        self.scene = scene.to(self.device)
        self.decoder = decoder.to(self.device).eval()
        self.text = text_embeds  # (labels, pos (L, D), neg (Ln, D)) or None
        self.raster = raster or RasterizeConfig(aligned=False)
        self.lock = threading.Lock()
        self._resolutions: list[tuple[int, int]] = []
        self._geo = dict(
            means=self.scene.means, quats=self.scene.quats,
            scales=self.scene.scales, opacities=self.scene.opacities,
        )

    def _camera(self, req) -> Camera:
        w, h = int(req["width"]), int(req["height"])

        def mat(key, shape):
            a = np.asarray(req[key], np.float32).reshape(shape)
            return torch.as_tensor(a, device=self.device)

        return Camera(viewmat=mat("viewmat", (4, 4)), K=mat("K", (3, 3)),
                      width=w, height=h, name="req")

    def render_features(self, cam: Camera) -> torch.Tensor:
        """(H, W, F) feature map, background zero."""
        return render(
            cam, **self._geo, semantic_features=self.scene.semantic_features,
            feature_mode=True, bg_color=torch.zeros(3, device=self.device),
            config=self.raster, device=self.device,
        ).render

    def render_rgb(self, cam: Camera) -> torch.Tensor:
        """(H, W, 3) SH colour image, background black."""
        return render(
            cam, **self._geo, sh=self.scene.sh,
            sh_degree=self.scene.max_sh_degree, feature_mode=False,
            bg_color=torch.zeros(3, device=self.device),
            config=self.raster, device=self.device,
        ).render

    def relevancy_map(self, cam: Camera, pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
        """(P, H, W) relevancy of the decoded feature map."""
        fmap = self.render_features(cam)
        decoded = decode_map_rows(self.decoder, fmap)
        return max_across_levels(decoded[None], pos, neg)[0]

    def _note_resolution(self, cam: Camera) -> None:
        """Record a served resolution (call with the lock held)."""
        if (cam.width, cam.height) not in self._resolutions:
            self._resolutions.append((cam.width, cam.height))

    # -- request handlers --------------------------------------------------
    def health(self):
        return {
            "status": "ok",
            "n_gaussians": int(self.scene.means.shape[0]),
            "feature_dim": int(self.scene.semantic_features.shape[1]),
            "labels": list(self.text[0]) if self.text else [],
            "compiled": [list(k) for k in self._resolutions],
        }

    def render(self, req):
        cam = self._camera(req)
        mode = req.get("mode", "rgb")
        with self.lock:
            self._note_resolution(cam)
            t0 = time.perf_counter()
            if mode == "feature_pca":
                fmap = self.render_features(cam).cpu().numpy()
                img, _ = apply_pca_colormap(fmap, None)
            elif mode == "rgb":
                img = self.render_rgb(cam).cpu().numpy()
            else:
                raise ValueError(f"unknown mode {mode!r}")
            ms = (time.perf_counter() - t0) * 1e3
        return {"image_png": _png_b64(img), "mode": mode, "render_ms": round(ms, 2)}

    def relevancy(self, req):
        cam = self._camera(req)
        if "label" in req:
            if not self.text:
                raise ValueError("server started without --text_embeds")
            labels, pos, neg = self.text
            if req["label"] not in labels:
                raise ValueError(f"unknown label {req['label']!r}")
            k = labels.index(req["label"])
            pos = np.asarray(pos[k : k + 1], np.float32)
        else:
            pos = np.asarray(req["pos"], np.float32).reshape(1, -1)
            neg = req["neg"]
        pos_t = torch.as_tensor(pos, device=self.device)
        neg_t = torch.as_tensor(np.asarray(neg, np.float32), device=self.device)
        thresh = float(req.get("thresh", 0.5))
        with self.lock:
            self._note_resolution(cam)
            rel = self.relevancy_map(cam, pos_t, neg_t)[0]
            mask, vmap = heatmap_to_mask(rel, thresh)
            mask = majority_smooth(mask).cpu().numpy()
            vmap = vmap.cpu().numpy()
            rel_max = float(rel.max())
        heat = turbo(vmap)
        return {
            "heatmap_png": _png_b64(heat),
            "mask_png": _png_b64(mask.astype(np.float32)[..., None].repeat(3, -1)),
            "relevancy_max": rel_max,
            "selected_px": int(mask.sum()),
        }


def make_handler(server: SceneServer):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, server.health())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            ln = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(ln) or b"{}")
                if self.path == "/render":
                    self._reply(200, server.render(req))
                elif self.path == "/relevancy":
                    self._reply(200, server.relevancy(req))
                else:
                    self._reply(404, {"error": "unknown path"})
            except Exception as exc:  # surface the failure to the client
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})

        def log_message(self, fmt, *a):  # quiet; errors go to the client
            pass

    return Handler


def serve_config(scene: GaussianScene, autotune: bool, autotune_res, device) -> RasterizeConfig:
    """The serving rasterizer config at `autotune_res` (w, h): timed now
    (autotune), else the persisted winner (bf16 allowed, as in JAX), else
    the default unaligned config."""
    raster = RasterizeConfig(aligned=False)
    if not autotune_res:
        return raster
    w, h = autotune_res
    if autotune:
        from gags_torch.utils.synthetic import make_camera

        c0 = make_camera(w, h, device=device)
        return autotune_config(
            scene.means, scene.quats, scene.scales, scene.opacities, scene.semantic_features,
            c0.viewmat, c0.K, w, h, base=RasterizeConfig(aligned=False, fast_color_rows=True),
            allow_bf16=True, verbose=True, device=device)
    tuned = load_persisted(w, h, scene.num_gaussians, int(scene.semantic_features.shape[1]),
                           allow_bf16=True)
    if tuned is not None:
        print("# serve: persisted tuned config reused", flush=True)
        return tuned
    return raster


def load_server(model_path, iteration, text_embeds=None, device="cuda", autotune=False,
                autotune_res=None) -> SceneServer:
    """SceneServer from point_cloud/iteration_N/point_cloud.ply (features from
    the semantic_* fields) and decoders.pt in `model_path`, with the
    rasterizer config of `serve_config`."""
    dev = resolve_device(device)
    ply = os.path.join(model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply")
    scene = GaussianScene.from_ply(ply, device=dev)
    if scene.semantic_features is None:
        raise ValueError(f"{ply}: no semantic_* fields")
    decoder = feature_decoder_from_state(
        load_decoder_state(os.path.join(model_path, "decoders.pt"))["feature_decoder"], dev)
    text = None
    if text_embeds:
        data = np.load(text_embeds)
        text = ([str(l) for l in data["labels"]], data["pos"], data["neg"])
    return SceneServer(scene, decoder, text_embeds=text, device=dev,
                       raster=serve_config(scene, autotune, autotune_res, dev))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model_path", required=True)
    p.add_argument("--iteration", type=int, default=30000)
    p.add_argument("--text_embeds", default="")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--device", default="cuda")
    p.add_argument("--autotune", action="store_true",
                   help="time the rasterizer variants at start-up and serve with the fastest")
    p.add_argument("--autotune_res", default="1280x720",
                   help="WxH of the start-up autotune and of the persisted-winner lookup")
    args = p.parse_args(argv)
    w, h = (int(x) for x in args.autotune_res.split("x"))
    srv = load_server(args.model_path, args.iteration,
                      text_embeds=args.text_embeds or None, device=args.device,
                      autotune=args.autotune, autotune_res=(w, h))
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(srv))
    print(f"serving {args.model_path} on http://{args.host}:{args.port} "
          f"(/health /render /relevancy)", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
