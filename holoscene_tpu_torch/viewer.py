"""Interactive web viewer for trained artifacts (port of
holoscene_tpu/viewer.py): a tiny HTTP server whose browser page drags an
orbit camera while the port's own renderers produce each frame server-side,

  * gaussian artifacts (.ply / .usdz / .ingp) through the tile splat
    renderer (ops/splat.py; K3 on the card);
  * meshes (.obj / .ply, e.g. Stage-2 surfaces or Stage-3 bakes) through
    the fragment-scatter rasterizer (ops/rasterizer.py) with Lambert
    shading (vertex colours when present).

No GL, no extra dependencies (http.server + PIL). Frames render on the card
unless `--device cpu`.

Usage:
  python -m holoscene_tpu_torch.viewer exps/.../gauss_scene.ply [--port 8090]
  python -m holoscene_tpu_torch.viewer plots/surface_0.obj --res 400
      [--device cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from holoscene_tpu_torch import as_tensor, resolve_device


def _orbit_pose(center: np.ndarray, az: float, el: float, radius: float):
    """c2w pose (OpenCV convention: +z forward into the scene) orbiting
    `center` at (azimuth, elevation) degrees."""
    a, e = np.radians(az), np.radians(el)
    eye = center + radius * np.array(
        [np.cos(e) * np.sin(a), np.sin(e), np.cos(e) * np.cos(a)]
    )
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])  # OpenCV y-down
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def _intrinsics(res: int, fov_deg: float = 50.0) -> np.ndarray:
    f = 0.5 * res / np.tan(np.radians(fov_deg) / 2)
    return np.array(
        [[f, 0, res / 2], [0, f, res / 2], [0, 0, 1]], np.float32
    )


class GaussianOrbitRenderer:
    """Splat-renders a gaussian artifact from an orbit camera."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if path.endswith(".usdz"):
            from holoscene_tpu_torch.export.gs_usdz import read_gaussians_usdz

            raw = read_gaussians_usdz(path)
            nsp = raw["features_specular"].shape[1] // 3
            g = {
                "means": raw["positions"],
                "quats": raw["rotations"],
                "log_scales": raw["scales"],          # preactivation
                "opacity_logits": raw["densities"].reshape(-1),
                "features_dc": raw["features_albedo"],
                "features_rest": raw["features_specular"]
                .reshape(-1, 3, nsp).transpose(0, 2, 1),
            }
        elif path.endswith(".ingp"):
            from holoscene_tpu_torch.export.gs_ingp import read_gaussians_ingp

            g = read_gaussians_ingp(path)
        else:
            from holoscene_tpu_torch.models.gom import read_gaussian_ply

            g = read_gaussian_ply(path)
        self.g = {k: np.asarray(v, np.float32) for k, v in g.items()}
        self.center = self.g["means"].mean(axis=0)
        spread = np.linalg.norm(self.g["means"] - self.center, axis=-1)
        self.radius0 = float(np.quantile(spread, 0.9) * 2.5 + 1e-3)
        from holoscene_tpu_torch.export.gs_ingp import _sh_degree

        self.sh_degree = _sh_degree(self.g["features_rest"].shape[1])
        from holoscene_tpu_torch.training.gs_render import gaussian_tensors

        self.tensors = gaussian_tensors(self.g, self.device)

    @torch.no_grad()
    def render(self, az: float, el: float, zoom: float,
               res: int) -> np.ndarray:
        from holoscene_tpu_torch.ops.splat import render_gaussians

        dev = self.device
        c2w = _orbit_pose(self.center, az, el, self.radius0 * zoom)
        viewmat = as_tensor(np.linalg.inv(c2w), dev)
        out = render_gaussians(
            *self.tensors, viewmat, as_tensor(_intrinsics(res), dev),
            width=res, height=res, sh_degree=self.sh_degree,
            background=torch.full((3,), 0.12, device=dev))
        return np.clip(out["rgb"].cpu().numpy(), 0, 1)


class MeshOrbitRenderer:
    """Rasterizes a mesh with Lambert shading (+ vertex colours if
    present)."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        from holoscene_tpu_torch.utils.mesh import read_obj, read_ply

        self.device = resolve_device(device)
        self.mesh = read_obj(path) if path.endswith(".obj") \
            else read_ply(path)
        b = self.mesh.bounds
        self.center = b.mean(axis=0)
        self.radius0 = float(np.linalg.norm(b[1] - b[0]) * 1.2 + 1e-3)

    @torch.no_grad()
    def render(self, az: float, el: float, zoom: float,
               res: int) -> np.ndarray:
        from holoscene_tpu_torch.ops.rasterizer import rasterize_mesh

        c2w = _orbit_pose(self.center, az, el, self.radius0 * zoom)
        out = rasterize_mesh(
            self.mesh.vertices.astype(np.float32),
            self.mesh.faces.astype(np.int32), c2w, _intrinsics(res),
            (res, res), device=self.device)
        mask = out["mask"].cpu().numpy()
        fid = out["face_id"].cpu().numpy()
        fn = self.mesh.face_normals[np.maximum(fid, 0)]
        light = c2w[:3, 2]  # headlight
        lam = np.abs(fn @ light)[..., None]
        if self.mesh.vertex_colors is not None:
            bary = out["bary"].cpu().numpy()
            vc = self.mesh.vertex_colors[
                self.mesh.faces[np.maximum(fid, 0)]
            ]  # [H,W,3,3]
            albedo = (bary[..., None] * vc).sum(axis=2)
        else:
            albedo = np.full(lam.shape[:2] + (3,), 0.75)
        img = albedo * (0.25 + 0.75 * lam)
        img = np.where(mask[..., None], img, 0.12)
        return np.clip(img, 0, 1)


_PAGE = """<!doctype html>
<html><head><title>holoscene_tpu_torch viewer</title><style>
 body{margin:0;background:#111;color:#ccc;font:13px monospace}
 #v{display:block;margin:12px auto;border:1px solid #333;cursor:grab}
 #hud{text-align:center;padding:6px}
</style></head><body>
<div id="hud">drag = orbit &nbsp; wheel = zoom &nbsp; <span id="s"></span></div>
<img id="v" width=512 height=512>
<script>
let az=35, el=20, zoom=1.0, busy=false, dirty=true;
const img=document.getElementById('v'), hud=document.getElementById('s');
function tick(){
  if(dirty && !busy){
    busy=true; dirty=false;
    const u=`/render?az=${az.toFixed(1)}&el=${el.toFixed(1)}&zoom=${zoom.toFixed(2)}`;
    const t0=performance.now();
    fetch(u).then(r=>r.blob()).then(b=>{
      img.src=URL.createObjectURL(b);
      hud.textContent=`az ${az.toFixed(0)} el ${el.toFixed(0)} zoom ${zoom.toFixed(2)} — ${(performance.now()-t0).toFixed(0)} ms`;
      busy=false;
    }).catch(()=>{busy=false;});
  }
  requestAnimationFrame(tick);
}
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault();};
window.onmouseup=()=>{drag=null;};
window.onmousemove=e=>{
  if(!drag) return;
  az-=(e.clientX-drag[0])*0.4; el+=(e.clientY-drag[1])*0.4;
  el=Math.max(-89,Math.min(89,el)); drag=[e.clientX,e.clientY]; dirty=true;
};
window.onwheel=e=>{zoom*=Math.exp(e.deltaY*0.001); zoom=Math.max(0.05,Math.min(20,zoom)); dirty=true;};
tick();
</script></body></html>"""


def serve(renderer, port: int = 8090, res: int = 512):
    """Build the orbit-viewer HTTP server and return it WITHOUT starting
    it — the caller runs `srv.serve_forever()` (as main() does), or a
    thread + `srv.shutdown()` in tests."""
    from PIL import Image

    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path == "/":
                body = _PAGE.replace("width=512 height=512",
                                     f"width={res} height={res}").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(body)
                return
            if parsed.path == "/render":
                q = urllib.parse.parse_qs(parsed.query)

                def f(name, default, lo, hi):
                    try:
                        v = float(q.get(name, [default])[0])
                    except ValueError:
                        v = default
                    return min(max(v, lo), hi)

                with lock:  # one device render at a time
                    img = renderer.render(
                        f("az", 35.0, -1e6, 1e6), f("el", 20.0, -89, 89),
                        f("zoom", 1.0, 0.05, 20.0),
                        int(f("res", res, 16, 1024)),
                    )
                buf = io.BytesIO()
                Image.fromarray(
                    (np.asarray(img) * 255).astype(np.uint8)
                ).save(buf, "PNG")
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.end_headers()
                self.wfile.write(buf.getvalue())
                return
            self.send_response(404)
            self.end_headers()

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    return srv


def make_renderer(path: str, device: str | torch.device = "cuda"):
    if path.endswith((".obj",)) or _is_mesh_ply(path):
        return MeshOrbitRenderer(path, device)
    return GaussianOrbitRenderer(path, device)


def _is_mesh_ply(path: str) -> bool:
    """A .ply is a mesh if it carries a face element (3DGS gaussian PLYs
    are point-only)."""
    if not path.endswith(".ply"):
        return False
    with open(path, "rb") as f:
        header = f.read(4096)
    return b"element face" in header


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("artifact", help=".ply/.usdz/.ingp gaussians or .obj/.ply mesh")
    p.add_argument("--port", type=int, default=8090)
    p.add_argument("--res", type=int, default=512)
    p.add_argument(
        "--device", type=str, default="cuda",
        help="torch device; 'cuda' launches the hand-written kernels and "
             "fails without a card, 'cpu' runs their plain versions")
    args = p.parse_args(argv)

    renderer = make_renderer(args.artifact, args.device)
    srv = serve(renderer, args.port, args.res)
    print(json.dumps({"viewer": f"http://127.0.0.1:{args.port}/",
                      "kind": type(renderer).__name__}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


if __name__ == "__main__":
    main()
