"""Standalone interactive viewer — the SIBR real-time viewer app analogue.

The counterpart of ``street_sparse_3dgs_tpu/viewer/app.py``.  The reference
fork views trained scenes in ``SIBR_gaussianHierarchyViewer_app`` (the
optional ``SIBR_viewers`` C++/OpenGL submodule, SURVEY.md L8); the
equivalent here is a self-contained web app: a stdlib HTTP server renders
frames server-side on the card (through the port's render path, whose
``method="pallas"`` launches the CUDA kernels K5 and K1) and serves an
HTML5 canvas UI with fly controls, a τ level-of-detail slider and a
scaling-modifier slider.

Two frame sources:

  - **scene mode** — load a trained artifact directly: a ``point_cloud.ply``
    (leaf render via ``ops.rasterize``) or a ``.hier.npz`` hierarchy
    (τ-cut LOD render via ``select_cut`` + ``render_cut_compact``, the same
    path as ``eval/render_hier.py``), on ``device`` (the card by default);
  - **live mode** — connect as a *client* of the SIBR wire protocol to a
    running training loop's ``NetworkGUI`` server (``viewer/network_gui.py``)
    and relay its frames, exactly like the reference's remote viewer attaches
    to ``train_single.py``.

Zero external dependencies: stdlib http.server + sockets; frames are
encoded by the port's JPEG encoder (``data/jpeg.py``).
"""

from __future__ import annotations

import json
import math
import socket
import struct
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from ..data.jpeg import encode_jpeg
from ..device import DEFAULT_DEVICE, resolve_device


# ---------------------------------------------------------------------------
# Fly camera


@dataclass
class FlyState:
    """Free-fly camera: position + yaw/pitch (world up = +z), pinhole fov."""

    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    yaw: float = 0.0
    pitch: float = 0.0
    fovx_deg: float = 60.0

    @staticmethod
    def basis(yaw: float, pitch: float):
        """(forward, right, down) world-space unit vectors of the 3DGS camera
        frame (+z forward, +y down) for the given yaw/pitch."""
        cp, sp = math.cos(pitch), math.sin(pitch)
        fwd = np.array([cp * math.cos(yaw), cp * math.sin(yaw), sp])
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        n = np.linalg.norm(right)
        if n < 1e-6:
            right = np.array([math.sin(yaw), -math.cos(yaw), 0.0])
            n = 1.0
        right = right / n
        down = np.cross(fwd, right)
        return fwd, right, down

    def camera(self, width: int, height: int, znear=0.01, zfar=1000.0,
               device=DEFAULT_DEVICE):
        from ..core.camera import make_camera

        fwd, right, down = self.basis(self.yaw, self.pitch)
        r_wc = np.stack([right, down, fwd])        # world→camera rows
        t = -r_wc @ self.pos
        fovx = math.radians(self.fovx_deg)
        fovy = 2.0 * math.atan(math.tan(fovx / 2.0) * height / width)
        return make_camera(r_wc.T, t, fovx, fovy, width, height,
                           znear=znear, zfar=zfar, device=device)


# ---------------------------------------------------------------------------
# Frame sources


class SceneSource:
    """Renders frames from a trained artifact on ``device`` (the card by
    default; raises without one), with the JAX viewer's ``RasterConfig()``
    knobs and ``method="pallas"`` (the CUDA kernels K5 and K1 on the card,
    their plain versions on CPU tensors).

    ``path``: a ``point_cloud.ply`` / directory containing one, or a
    ``*.hier.npz`` / ``*.hier_opt.npz`` hierarchy file."""

    def __init__(self, path: str | Path, sh_degree: int = 3,
                 point_budget: int = 0, device=DEFAULT_DEVICE):
        from ..ops.rasterize import RasterConfig

        self.device = resolve_device(device)
        self.sh_degree = sh_degree
        # >0: auto-regulate the hierarchy cut to this many rendered nodes
        # instead of the UI's tau slider (SIBR --budget analog).
        self.point_budget = int(point_budget)
        self.cfg = RasterConfig(method="pallas")
        self.bg = torch.zeros(3, device=self.device)
        self.hierarchy = None
        path = Path(path)
        if path.is_dir():
            if (path / "point_cloud.ply").exists():
                path = path / "point_cloud.ply"
            elif (path / "point_cloud.bin").exists():
                path = path / "point_cloud.bin"
        if path.name.endswith((".hier.npz", ".hier_opt.npz")):
            from ..hierarchy.io import load_hierarchy

            self.hierarchy = load_hierarchy(path, device=self.device)
            xyz = self.hierarchy.params.xyz.cpu().numpy()
        elif path.suffix in (".ply", ".bin"):
            if path.suffix == ".bin":
                from ..models.serialize import load_packed_bin

                p = load_packed_bin(path, device=self.device)
            else:
                from ..data.ply import load_gaussian_ply

                p = load_gaussian_ply(path, device=self.device)
            self.arrays = (
                p.xyz, torch.exp(p.log_scales), p.quats,
                torch.sigmoid(p.opacity_raw[:, 0]),
                torch.cat([p.features_dc, p.features_rest], dim=1))
            xyz = p.xyz.cpu().numpy()
        else:
            raise ValueError(f"unrecognized scene source: {path}")
        self.center = xyz.mean(axis=0)
        self.radius = float(np.linalg.norm(xyz - self.center, axis=1).mean())
        self.n_points = int(xyz.shape[0])
        self._lock = threading.Lock()

    def initial_state(self) -> FlyState:
        pos = self.center + np.array([-2.0, 0.0, 0.5]) * max(
            self.radius, 1e-3)
        d = self.center - pos
        yaw = math.atan2(d[1], d[0])
        pitch = math.asin(d[2] / np.linalg.norm(d))
        return FlyState(pos=pos, yaw=yaw, pitch=pitch)

    def render(self, state: FlyState, width: int, height: int,
               tau: float = 6.0, scaling: float = 1.0) -> np.ndarray:
        """[H, W, 3] uint8 frame.  Binning overflow (tile seams when flying
        inside dense clouds at static capacity) is surfaced on
        ``self.last_overflow`` — never silently dropped."""
        cam = state.camera(width, height, device=self.device)
        with self._lock, torch.no_grad():
            if self.hierarchy is not None:
                from ..hierarchy.render import render_cut_compact
                from ..hierarchy.structure import (budget_limit, pixel_limit,
                                                   select_cut)

                h = self.hierarchy
                if self.point_budget:
                    # SIBR viewer --budget analog: auto-regulate the cut.
                    limit = budget_limit(h, cam.campos, self.point_budget)
                else:
                    limit = pixel_limit(tau, float(cam.tan_fovx), width)
                cut = select_cut(h, cam.campos, limit)
                out = render_cut_compact(h.params, cut, h.n_nodes,
                                         h.skybox_count, cam,
                                         self.sh_degree, self.bg, self.cfg,
                                         scale_modifier=scaling)
                self.last_overflow = int(out["tile_overflow"])
            else:
                from ..ops.rasterize import rasterize

                out = rasterize(*self.arrays, cam, self.sh_degree, self.bg,
                                self.cfg, scale_modifier=scaling)
                self.last_overflow = int(out["tile_overflow"]
                                         + out["dup_overflow"])
            img = torch.clamp(out["render"], 0.0, 1.0).cpu().numpy()
        return (img.transpose(1, 2, 0) * 255).astype(np.uint8)


class LiveSource:
    """SIBR wire-protocol *client*: attaches to a training loop's
    ``NetworkGUI`` server and requests frames (``network_gui.py:26-57``
    message schema; the training side applies the y/z column sign flip and
    transpose, so this client emits matrices in the torch row-vector
    convention)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009,
                 keep_alive: bool = True):
        self.sock = socket.create_connection((host, port))
        self.keep_alive = keep_alive
        # ThreadingHTTPServer serves frames concurrently; the wire protocol
        # is one request/response at a time — serialize transactions.
        self._lock = threading.Lock()
        self.center = np.zeros(3)
        self.radius = 5.0
        self.n_points = -1
        self.hierarchy = None

    def initial_state(self) -> FlyState:
        return FlyState(pos=np.array([0.0, 0.0, 0.0]))

    @staticmethod
    def wire_matrices(cam) -> tuple[list, list]:
        """CameraParams → (view, view_projection) row-vector wire matrices
        (inverse of ``ViewerRequest.camera``'s flip+transpose)."""
        def enc(m_cols) -> list:
            m = np.asarray(torch.as_tensor(m_cols).cpu(), np.float32).T.copy()
            m[:, 1] = -m[:, 1]
            m[:, 2] = -m[:, 2]
            return [float(v) for v in m.reshape(-1)]

        return enc(cam.viewmatrix), enc(cam.projmatrix)

    def render(self, state: FlyState, width: int, height: int,
               tau: float = 6.0, scaling: float = 1.0) -> np.ndarray:
        # Only the wire matrices are needed: no device work on this side.
        cam = state.camera(width, height, device="cpu")
        view, viewproj = self.wire_matrices(cam)
        msg = {
            "resolution_x": width, "resolution_y": height,
            "fov_x": math.radians(state.fovx_deg),
            "fov_y": 2.0 * math.atan(math.tan(
                math.radians(state.fovx_deg) / 2.0) * height / width),
            "z_near": 0.01, "z_far": 1000.0,
            "train": True, "keep_alive": self.keep_alive,
            "scaling_modifier": scaling,
            "view_matrix": view, "view_projection_matrix": viewproj,
        }
        blob = json.dumps(msg).encode("utf-8")
        with self._lock:
            self.sock.sendall(struct.pack("<I", len(blob)) + blob)
            img = self._recv_exact(width * height * 3)
            n = struct.unpack("<I", self._recv_exact(4))[0]
            self._recv_exact(n)                 # verify string (source path)
        return np.frombuffer(img, np.uint8).reshape(height, width, 3)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("training side disconnected")
            buf += part
        return buf

    def close(self):
        self.sock.close()


# ---------------------------------------------------------------------------
# HTTP app

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>street_sparse_3dgs_tpu viewer</title>
<style>
 body { margin:0; background:#101014; color:#ddd; font:13px monospace;
        overflow:hidden }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px
        12px; border-radius:6px; line-height:1.7 }
 #img { width:100vw; height:100vh; object-fit:contain; display:block;
        cursor:grab }
 input[type=range] { vertical-align:middle }
</style></head><body>
<img id="img"><div id="hud">
 <b>street_sparse_3dgs_tpu</b> — drag to look, WASD+QE to fly,
 shift = fast<br>
 &tau; <input id="tau" type="range" min="0" max="15" step="0.5" value="6">
 <span id="tauv">6</span>
 &nbsp;scale <input id="sc" type="range" min="0" max="2" step="0.05"
  value="1"><span id="scv">1</span><br>
 <span id="stat">connecting…</span>
</div>
<script>
const S = {pos:[0,0,0], yaw:0, pitch:0, fov:60, keys:{}, drag:null};
const img = document.getElementById('img');
const tau = document.getElementById('tau'), sc = document.getElementById('sc');
fetch('info').then(r=>r.json()).then(d=>{
  S.pos = d.pos; S.yaw = d.yaw; S.pitch = d.pitch;
  document.getElementById('stat').textContent =
    d.n_points >= 0 ? d.n_points + ' gaussians' : 'live training bridge';
});
img.onpointerdown = e => { S.drag=[e.clientX,e.clientY]; img.setPointerCapture(e.pointerId); };
img.onpointerup = () => S.drag=null;
img.onpointermove = e => { if(!S.drag) return;
  S.yaw  -= (e.clientX-S.drag[0])*0.004;
  S.pitch = Math.max(-1.5,Math.min(1.5,S.pitch-(e.clientY-S.drag[1])*0.004));
  S.drag=[e.clientX,e.clientY]; };
onkeydown = e => S.keys[e.key.toLowerCase()]=true;
onkeyup = e => S.keys[e.key.toLowerCase()]=false;
function basis(){
  const cp=Math.cos(S.pitch), sp=Math.sin(S.pitch);
  const f=[cp*Math.cos(S.yaw), cp*Math.sin(S.yaw), sp];
  const upw=[0,0,1];
  let r=[f[1]*upw[2]-f[2]*upw[1], f[2]*upw[0]-f[0]*upw[2],
         f[0]*upw[1]-f[1]*upw[0]];
  const n=Math.hypot(...r)||1; r=r.map(v=>v/n);
  return [f,r];
}
let step=0.1, busy=false, last=performance.now();
async function tick(){
  const [f,r]=basis(); const k=S.keys;
  const sp=step*(k['shift']?5:1);
  const mv=(v,s)=>{for(let i=0;i<3;i++)S.pos[i]+=v[i]*s;};
  if(k['w'])mv(f,sp); if(k['s'])mv(f,-sp);
  if(k['d'])mv(r,sp); if(k['a'])mv(r,-sp);
  if(k['q'])S.pos[2]+=sp; if(k['e'])S.pos[2]-=sp;
  if(!busy){ busy=true;
    try{
      const res=await fetch('frame',{method:'POST',body:JSON.stringify({
        pos:S.pos, yaw:S.yaw, pitch:S.pitch, fov:S.fov,
        width:960, height:540, tau:+tau.value, scaling:+sc.value})});
      const blob=await res.blob();
      const url=URL.createObjectURL(blob);
      img.onload=()=>URL.revokeObjectURL(url);
      img.src=url;
      const now=performance.now();
      document.getElementById('tauv').textContent=tau.value;
      document.getElementById('scv').textContent=sc.value;
      step = 0.02*(+res.headers.get('x-scene-radius')||5);
      const fps=(1000/(now-last)).toFixed(1); last=now;
      document.getElementById('stat').textContent=
        res.headers.get('x-status')+' | '+fps+' fps';
    }catch(e){}
    busy=false; }
  requestAnimationFrame(tick);
}
tick();
</script></body></html>
"""


class ViewerApp:
    """HTTP viewer server around a frame source (Scene or Live).  Frames
    are JPEG at ``jpeg_quality`` with full-resolution chroma by default: a
    splat render's sharp colour edges lose about 3.5 dB of PSNR to 4:2:0
    at quality 85 (27.2 against 30.9 dB on a 480x272 street frame), the
    JAX viewer's PIL default."""

    def __init__(self, source, host: str = "127.0.0.1", port: int = 8000,
                 jpeg_quality: int = 85):
        self.source = source
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):        # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    self._reply(200, "text/html", body)
                elif self.path == "/info":
                    st = app.source.initial_state()
                    body = json.dumps({
                        "pos": [float(v) for v in st.pos],
                        "yaw": st.yaw, "pitch": st.pitch,
                        "n_points": app.source.n_points,
                        "radius": getattr(app.source, "radius", 5.0),
                    }).encode()
                    self._reply(200, "application/json", body)
                else:
                    self._reply(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path != "/frame":
                    self._reply(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                state = FlyState(pos=np.asarray(req["pos"], np.float64),
                                 yaw=float(req["yaw"]),
                                 pitch=float(req["pitch"]),
                                 fovx_deg=float(req.get("fov", 60.0)))
                frame = app.source.render(
                    state, int(req.get("width", 960)),
                    int(req.get("height", 540)),
                    tau=float(req.get("tau", 6.0)),
                    scaling=float(req.get("scaling", 1.0)))
                body = encode_jpeg(frame, jpeg_quality, "4:4:4")
                overflow = getattr(app.source, "last_overflow", 0)
                status = f"{frame.shape[1]}x{frame.shape[0]}"
                if overflow:
                    status += f" overflow:{overflow}"
                self._reply(200, "image/jpeg", body, extra={
                    "x-status": status,
                    "x-scene-radius":
                        f"{getattr(app.source, 'radius', 5.0):.3f}"})

            def _reply(self, code, ctype, body, extra=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        print(f"viewer on http://{self.httpd.server_address[0]}:{self.port}/")
        self.httpd.serve_forever()

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def make_parser():
    import argparse

    p = argparse.ArgumentParser(prog="viewer")
    p.add_argument("--source", default=None,
                   help="point_cloud.ply, its directory, or a .hier.npz")
    p.add_argument("--live", default=None, metavar="HOST:PORT",
                   help="attach to a running training loop's NetworkGUI "
                        "instead of loading a scene")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--budget", type=int, default=0,
                   help="auto-regulate the hierarchy cut to at most this "
                        "many rendered nodes (overrides the tau slider; "
                        "SIBR viewer --budget analog)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="device the scene renders on (default: the card)")
    return p


def main(argv=None):
    p = make_parser()
    args = p.parse_args(argv)
    if (args.source is None) == (args.live is None):
        p.error("exactly one of --source / --live is required")
    if args.live:
        host, _, port = args.live.rpartition(":")
        source = LiveSource(host or "127.0.0.1", int(port))
    else:
        source = SceneSource(args.source, sh_degree=args.sh_degree,
                             point_budget=args.budget, device=args.device)
    ViewerApp(source, port=args.port).serve_forever()


if __name__ == "__main__":
    main()
