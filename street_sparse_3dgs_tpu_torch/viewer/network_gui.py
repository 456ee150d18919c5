"""Live training viewer socket server — the SIBR remote-GUI protocol, byte
for byte that of ``street_sparse_3dgs_tpu/viewer/network_gui.py``.

Wire-compatible with the reference's ``gaussian_renderer/network_gui.py``
(and therefore with the SIBR remote viewer): a non-blocking TCP listener;
each message is a little-endian uint32 length + JSON blob carrying the
requested resolution, FOVs, view/view-projection matrices (with the y/z
column sign flip), and control flags; the reply is the raw RGB byte buffer
of the render followed by a length-prefixed 'verify' string
(``network_gui.py:26-57``).  The training loop polls
:meth:`NetworkGUI.poll` once per iteration (``train_single.py:81-98``).
"""

from __future__ import annotations

import json
import math
import socket
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from ..core.camera import CameraParams
from ..device import DEFAULT_DEVICE, resolve_device


@dataclass
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
    view_matrix: np.ndarray        # [4,4] world→view (row-vector convention)
    view_projection: np.ndarray    # [4,4]

    def camera(self, device: str | torch.device = DEFAULT_DEVICE):
        """The port's renderer ``CameraParams`` on ``device`` from the
        viewer matrices (the MiniCam path: matrices arrive ready-made, only
        the y/z sign flip is applied — ``network_gui.py:72-75``)."""
        dev = resolve_device(device)
        w2v = self.view_matrix.copy()
        w2v[:, 1] = -w2v[:, 1]
        w2v[:, 2] = -w2v[:, 2]
        vp = self.view_projection.copy()
        vp[:, 1] = -vp[:, 1]
        vp[:, 2] = -vp[:, 2]
        # The wire matrices act on row vectors; the renderer's on columns.
        w2v_c = w2v.T
        vp_c = vp.T
        campos = np.linalg.inv(w2v_c)[:3, 3]

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        return CameraParams(
            viewmatrix=f32(w2v_c), projmatrix=f32(vp_c), campos=f32(campos),
            tan_fovx=f32(math.tan(self.fovx / 2)),
            tan_fovy=f32(math.tan(self.fovy / 2)),
            focal_x=f32(self.width / (2 * math.tan(self.fovx / 2))),
            focal_y=f32(self.height / (2 * math.tan(self.fovy / 2))),
            height=int(self.height), width=int(self.width))


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: socket.socket | None = None

    def try_connect(self) -> None:
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _read(self) -> dict:
        assert self.conn is not None
        raw_len = self._recv_exact(4)
        n = int.from_bytes(raw_len, "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes:
        assert self.conn is not None
        buf = b""
        while len(buf) < n:
            part = self.conn.recv(n - len(buf))
            if not part:
                raise ConnectionError("viewer disconnected")
            buf += part
        return buf

    def receive(self) -> ViewerRequest | None:
        msg = self._read()
        width = msg["resolution_x"]
        height = msg["resolution_y"]
        if width == 0 or height == 0:
            return None
        return ViewerRequest(
            width=width, height=height, fovx=msg["fov_x"], fovy=msg["fov_y"],
            znear=msg["z_near"], zfar=msg["z_far"],
            do_training=bool(msg["train"]),
            keep_alive=bool(msg["keep_alive"]),
            scaling_modifier=msg["scaling_modifier"],
            view_matrix=np.array(msg["view_matrix"],
                                 np.float32).reshape(4, 4),
            view_projection=np.array(msg["view_projection_matrix"],
                                     np.float32).reshape(4, 4))

    def send(self, image: np.ndarray | None, verify: str) -> None:
        """``image``: [3,H,W] float in [0,1] (converted to the byte buffer
        the viewer expects) or None."""
        assert self.conn is not None
        if image is not None:
            buf = (np.clip(np.asarray(image), 0, 1)
                   .transpose(1, 2, 0) * 255).astype(np.uint8).tobytes()
            self.conn.sendall(buf)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def poll(self, render_fn, source_path: str,
             training_done: bool = False) -> bool:
        """One training-loop iteration of the viewer protocol
        (``train_single.py:80-97``): accept a connection if pending, then
        serve requests until the viewer releases the loop.  The reference's
        break rule: return to training when ``do_training`` and (training is
        not finished, or the viewer did not ask to be kept alive) — so a
        paused viewer (``do_training=False``) is served continuously, and
        after the final iteration a keep-alive viewer keeps getting frames.
        ``render_fn(req)`` renders one frame ([3,H,W] float in [0,1]);
        ``req.keep_alive`` selects RGB vs depth on the reference
        (``train_single.py:88-92``) — the callback decides.  Returns the
        last do_training flag."""
        if self.conn is None:
            self.try_connect()
        do_training = True
        while self.conn is not None:
            try:
                req = self.receive()
                image = None
                if req is not None:
                    image = render_fn(req)
                    do_training = req.do_training
                self.send(image, source_path)
                if req is None or (do_training and
                                   (not training_done or not req.keep_alive)):
                    break
            except Exception:
                traceback.print_exc()
                try:
                    self.conn.close()
                except OSError:
                    pass
                self.conn = None
        return do_training

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
