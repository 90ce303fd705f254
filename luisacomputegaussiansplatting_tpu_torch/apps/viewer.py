"""Interactive scene viewer: the PyTorch counterpart of the JAX package's
``apps/viewer.py`` and of the reference's ImGui display window
(app/display.{h,cpp}).

GPU hosts are often headless, so the viewer is a tiny zero-dependency HTTP
server: the browser page implements the reference's controls
(display.cpp:61-147): WASD/QE movement, left-drag orbit, right-drag roll,
wheel FOV zoom, background colour picker, move-speed slider, FPS and camera
readout. Each ``/frame`` request carries the full pose and gets a JPEG
rendered by ``render_view`` on the server's device (by default the card).

    python -m luisacomputegaussiansplatting_tpu_torch.apps.viewer \
        --ply scene.ply --res 1280x720 --port 8777

Camera state lives in the browser, so the server is stateless and several
tabs can view one scene. Same flags as the JAX viewer, except ``--device``
(default ``cuda``; CPU runs pass ``--device cpu``) in place of
``--platform``.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..config import RenderConfig
from ..io.ply import load_ply
from ..io.synthetic import random_scene
from ..ops.render import render_view
from ..utils.camera import look_at_camera
from ..utils.device import resolve_device
from ..utils.profiling import span

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>lcgs-tpu viewer</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px monospace; overflow:hidden; }
 #img { position:absolute; top:0; left:0; width:100vw; height:100vh;
        object-fit:contain; image-rendering:auto; }
 #panel { position:absolute; top:8px; left:8px; background:rgba(0,0,0,.65);
          padding:10px 12px; border-radius:6px; line-height:1.7; user-select:none; }
 #panel input[type=range] { vertical-align:middle; width:110px; }
 #panel input[type=color] { vertical-align:middle; }
 .dim { color:#888 }
</style></head>
<body>
<img id="img" draggable="false">
<div id="panel">
 <div><b>lcgs-tpu viewer</b> <span class="dim">(%NAME%)</span></div>
 <div>fps: <span id="fps">-</span> <span class="dim">render <span id="ms">-</span> ms</span></div>
 <div>pos: <span id="pos">-</span></div>
 <div>front: <span id="front">-</span></div>
 <div>fov <input id="fov" type="range" min="20" max="120" step="1" value="60">
      <span id="fovv">60</span>&deg;</div>
 <div>speed <input id="speed" type="range" min="-2" max="1" step="0.1" value="-0.5"></div>
 <div>bg <input id="bg" type="color" value="#000000"></div>
 <div class="dim">WASD/QE move &middot; L-drag orbit &middot; R-drag roll &middot; wheel zoom</div>
</div>
<script>
"use strict";
// camera state (mirrors the reference Camera: position/front/up, display.cpp:61-133)
let pos = %POS%, front = %FRONT%, up = %UP%;
let fov = %FOV%, speed = Math.pow(10, -0.5);
const keys = {};
function v_add(a,b,s){ return [a[0]+b[0]*s, a[1]+b[1]*s, a[2]+b[2]*s]; }
function v_cross(a,b){ return [a[1]*b[2]-a[2]*b[1], a[2]*b[0]-a[0]*b[2], a[0]*b[1]-a[1]*b[0]]; }
function v_norm(a){ const l=Math.hypot(a[0],a[1],a[2])||1; return [a[0]/l,a[1]/l,a[2]/l]; }
function rot(v, axis, ang){  // Rodrigues
  const c=Math.cos(ang), s=Math.sin(ang), k=v_norm(axis);
  const d=(k[0]*v[0]+k[1]*v[1]+k[2]*v[2])*(1-c), x=v_cross(k,v);
  return [v[0]*c+x[0]*s+k[0]*d, v[1]*c+x[1]*s+k[1]*d, v[2]*c+x[2]*s+k[2]*d];
}
window.addEventListener('keydown', e => keys[e.key.toLowerCase()] = true);
window.addEventListener('keyup',   e => keys[e.key.toLowerCase()] = false);
const img = document.getElementById('img');
let drag = null;
img.addEventListener('contextmenu', e => e.preventDefault());
img.addEventListener('mousedown', e => { drag = {b: e.button, x: e.clientX, y: e.clientY}; });
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  const right = v_norm(v_cross(front, up));
  if (drag.b === 0) {            // orbit: yaw about up, pitch about right
    front = v_norm(rot(front, up, -dx * 0.003));
    front = v_norm(rot(front, right, -dy * 0.003));
    up = v_norm(v_cross(right, front));
  } else if (drag.b === 2) {     // roll about front (display.cpp:104-111)
    up = v_norm(rot(up, front, dx * 0.003));
  }
});
window.addEventListener('wheel', e => {   // FOV zoom (display.cpp:113-117)
  fov = Math.min(120, Math.max(20, fov + (e.deltaY > 0 ? 2 : -2)));
  document.getElementById('fov').value = fov;
  document.getElementById('fovv').textContent = fov;
});
document.getElementById('fov').oninput = e => {
  fov = +e.target.value; document.getElementById('fovv').textContent = fov; };
document.getElementById('speed').oninput = e => speed = Math.pow(10, +e.target.value);
let lastT = performance.now();
function stepKeys() {
  const now = performance.now(), dt = Math.min(0.1, (now - lastT) / 1000); lastT = now;
  const right = v_norm(v_cross(front, up)), d = speed * dt * 60 * 0.02;
  if (keys['w']) pos = v_add(pos, front,  d);
  if (keys['s']) pos = v_add(pos, front, -d);
  if (keys['a']) pos = v_add(pos, right, -d);
  if (keys['d']) pos = v_add(pos, right,  d);
  if (keys['q']) pos = v_add(pos, up,    -d);
  if (keys['e']) pos = v_add(pos, up,     d);
}
let inflight = false, frames = 0, fpsT = performance.now();
async function loop() {
  stepKeys();
  if (!inflight) {
    inflight = true;
    const bg = document.getElementById('bg').value;
    const q = new URLSearchParams({
      pos: pos.join(','), front: front.join(','), up: up.join(','),
      fov: fov, bg: bg }).toString();
    const t0 = performance.now();
    try {
      const r = await fetch('/frame?' + q);
      const blob = await r.blob();
      const url = URL.createObjectURL(blob);
      img.onload = () => URL.revokeObjectURL(url);
      img.src = url;
      document.getElementById('ms').textContent = (performance.now() - t0).toFixed(0);
      frames++;
      if (performance.now() - fpsT > 1000) {
        document.getElementById('fps').textContent =
          (frames * 1000 / (performance.now() - fpsT)).toFixed(1);
        frames = 0; fpsT = performance.now();
      }
    } catch (e) { /* server gone */ }
    document.getElementById('pos').textContent = pos.map(v => v.toFixed(2)).join(', ');
    document.getElementById('front').textContent = front.map(v => v.toFixed(2)).join(', ');
    inflight = false;
  }
  requestAnimationFrame(loop);
}
loop();
</script></body></html>
"""


class ViewerServer:
    """Stateless render server: pose in, JPEG out."""

    def __init__(self, scene, width: int, height: int, cfg, name: str = "scene",
                 init_pos=(-3.0, -0.5, 3.3), init_target=(0.0, 3.0, 0.5),
                 world_up=(0.0, -1.0, -1.0), fov: float = 60.0,
                 sh_degree: int = 3, quality: int = 90, device="cuda"):
        self.device = resolve_device(device)
        self.width, self.height = width, height
        self.cfg = cfg
        self.sh_degree = sh_degree
        self.name = name
        self.quality = quality
        self.scene_args = [t.to(self.device) for t in scene.render_args()]
        # the camera position as the float32 view holds it
        self.init_pos = [float(x) for x in np.asarray(init_pos, np.float32)]
        f = np.asarray(init_target, np.float64) - np.asarray(init_pos, np.float64)
        self.init_front = [float(x) for x in f / np.linalg.norm(f)]
        # re-orthonormalised up, like get_lookat_cam (camera.h:74-82)
        r = np.cross(self.init_front, np.asarray(world_up, np.float64))
        r /= np.linalg.norm(r)
        u = np.cross(r, self.init_front)
        self.init_up = [float(x) for x in u / np.linalg.norm(u)]
        self.init_fov = fov
        self._lock = threading.Lock()

    def _build_view(self, pos, front, up, fov):
        target = tuple(np.asarray(pos) + np.asarray(front))
        cam = look_at_camera(tuple(pos), target, tuple(up),
                             fov=fov, width=self.width, height=self.height)
        return cam.to_view(self.device)

    def render_frame(self, pos, front, up, fov, bg) -> torch.Tensor:
        """The (3, H, W) frame clipped to [0, 1], on the server's device
        (rows bottom-up, the renderer's order)."""
        with torch.no_grad():
            img, _ = render_view(
                *self.scene_args, self._build_view(pos, front, up, fov),
                self.width, self.height,
                bg_color=torch.as_tensor(bg, dtype=torch.float32,
                                         device=self.device),
                cfg=self.cfg, sh_degree=self.sh_degree)
            return torch.clamp(img, 0.0, 1.0)

    @staticmethod
    def frame_to_hwc(img: torch.Tensor) -> np.ndarray:
        """(3, H, W) frame -> (H, W, 3) uint8 on the host: rows flipped
        upright for the browser (render_cli's PNG convention) and truncated,
        on the device before the copy (the range ``viewer.frame_to_hwc``
        while a profiler records)."""
        with span("viewer.frame_to_hwc"), torch.no_grad():
            hwc = (img.permute(1, 2, 0).flip(0) * 255.0).to(torch.uint8)
        return hwc.cpu().numpy()

    def encode_jpeg(self, hwc: np.ndarray) -> bytes:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(hwc).save(buf, "JPEG", quality=self.quality)
        return buf.getvalue()

    def warmup(self):
        """One frame at the initial pose: builds the kernels."""
        self.frame_to_hwc(self.render_frame(
            self.init_pos, self.init_front, self.init_up, self.init_fov,
            (0.0, 0.0, 0.0)))

    def render_jpeg(self, pos, front, up, fov, bg) -> bytes:
        with self._lock:  # one frame on the device at a time
            hwc = self.frame_to_hwc(self.render_frame(pos, front, up, fov, bg))
        return self.encode_jpeg(hwc)

    def page(self) -> bytes:
        html = (_PAGE
                .replace("%NAME%", self.name)
                .replace("%POS%", json.dumps(self.init_pos))
                .replace("%FRONT%", json.dumps(self.init_front))
                .replace("%UP%", json.dumps(self.init_up))
                .replace("%FOV%", json.dumps(self.init_fov)))
        return html.encode()


def _parse_vec(s: str, n: int = 3):
    v = [float(x) for x in s.split(",")]
    if len(v) != n:
        raise ValueError(f"expected {n} floats, got {s!r}")
    return v


def _parse_hex_color(s: str):
    s = s.lstrip("#")
    return [int(s[i:i + 2], 16) / 255.0 for i in (0, 2, 4)]


def make_handler(server: ViewerServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet (reference silences hot-loop logs too)
            pass

        def do_GET(self):
            u = urlparse(self.path)
            try:
                if u.path == "/":
                    body = server.page()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                elif u.path == "/frame":
                    q = parse_qs(u.query)
                    body = server.render_jpeg(
                        _parse_vec(q["pos"][0]),
                        _parse_vec(q["front"][0]),
                        _parse_vec(q["up"][0]),
                        float(q.get("fov", ["60"])[0]),
                        _parse_hex_color(q.get("bg", ["#000000"])[0]),
                    )
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                else:
                    self.send_response(404)
                    body = b"not found"
            except Exception as e:  # bad query -> 400, keep serving
                self.send_response(400)
                body = str(e).encode()
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(description="interactive 3DGS web viewer")
    p.add_argument("--ply", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=None)
    p.add_argument("--res", type=str, default="1280x720")
    p.add_argument("--port", type=int, default=8777)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--world", choices=["colmap", "blender"], default="colmap")
    p.add_argument("--cam-pos", type=str, default="-3,-0.5,3.3")
    p.add_argument("--cam-target", type=str, default="0,3,0.5")
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--max-pairs", type=int, default=4_000_000)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--quality", type=int, default=90, help="jpeg quality")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:1, cpu)")
    p.add_argument("--tile", type=int, default=16, choices=[16, 32])
    p.add_argument("--pack", choices=["chunk", "none"], default="none",
                   help="'none' is the fast path (identical up to float "
                        "reduction order)")
    p.add_argument("--sort", choices=["2key", "fused"], default="fused",
                   help="entry-sort key layout (see render_cli --sort); "
                        "interactive viewing defaults to the fast fused "
                        "keys")
    p.add_argument("--payload", choices=["f32", "bf16"], default="bf16",
                   help="payload-gather precision (see render_cli "
                        "--payload); viewer default bf16 (rounding below "
                        "jpeg quantisation)")
    p.add_argument("--tight-radius", action="store_true", default=True,
                   help="exact alpha_min splat radii (see render_cli); "
                        "on by default for interactive FPS")
    p.add_argument("--no-tight-radius", dest="tight_radius",
                   action="store_false")
    p.add_argument("--tile-cull", action="store_true", default=True,
                   help="in-kernel ellipse-tile cull (see render_cli); "
                        "on by default for interactive FPS")
    p.add_argument("--no-tile-cull", dest="tile_cull", action="store_false")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    if args.ply:
        scene, name = load_ply(args.ply, device=dev), args.ply
    elif args.synthetic:
        scene = random_scene(args.synthetic, seed=0, device=dev)
        name = f"synthetic {args.synthetic}"
    else:
        print("error: --ply or --synthetic required", file=sys.stderr)
        return 2

    w, h = (int(x) for x in args.res.split("x"))
    world_up = (0.0, -1.0, -1.0) if args.world == "colmap" else (0.0, 0.0, 1.0)
    server = ViewerServer(
        scene, w, h,
        RenderConfig(max_pairs=args.max_pairs, tile=args.tile,
                     pack_mode=args.pack, sort_mode=args.sort,
                     payload_dtype=args.payload,
                     tight_radius=args.tight_radius,
                     tile_cull=args.tile_cull),
        name=name,
        init_pos=tuple(_parse_vec(args.cam_pos)),
        init_target=tuple(_parse_vec(args.cam_target)),
        world_up=world_up, fov=args.fov, sh_degree=args.sh_degree,
        quality=args.quality, device=dev,
    )
    print("building the render kernels...", flush=True)
    t0 = time.time()
    server.warmup()
    print(f"first frame in {time.time() - t0:.1f}s")

    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    print(f"viewing {name} at http://{args.host}:{args.port}/", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
