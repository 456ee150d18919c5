"""PyTorch port, the live-viewer hook (``viewer/network_gui.py``,
``viewer/hook.py``, ``LoopHooks.viewer_poll``) against the JAX package:

- the wire round trip of tests/test_viewer.py::test_network_gui_roundtrip
  with the port's server;
- the same request bytes parsed by both packages' servers give equal
  cameras (matrices to 1e-6);
- the port's ``ViewerHook`` frame against JAX's on the same state (tiled,
  CPU) in RGB and inverse-depth mode, within 2e-5 (the image bar of
  tests/test_torch_raster.py);
- a client connected while the port's ``train_loop`` runs receives a live
  frame (tests/test_viewer.py::test_viewer_receives_frame_mid_training)."""

import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu import config as jcfg
from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.models import gaussians as jg
from street_sparse_3dgs_tpu.train import step as jstep
from street_sparse_3dgs_tpu.viewer import hook as jhook
from street_sparse_3dgs_tpu.viewer import network_gui as jgui
from street_sparse_3dgs_tpu_torch import config as tcfg
from street_sparse_3dgs_tpu_torch import convert
from street_sparse_3dgs_tpu_torch.models import gaussians as tg
from street_sparse_3dgs_tpu_torch.viewer import hook as thook
from street_sparse_3dgs_tpu_torch.viewer import network_gui as tgui

from test_viewer import _recv_exact, _viewer_msg

torch.set_num_threads(1)
W, H = 48, 32
IMG_ATOL = 2e-5


def lookat_rows(w, h):
    """A row-vector world->view matrix looking at the origin from
    (0, -3, 1) and its view-projection, as a SIBR client sends them."""
    from street_sparse_3dgs_tpu.data.toy import lookat_camera

    cam = lookat_camera(np.array([0.0, -3.0, 1.0]), np.zeros(3), w, h)
    view = np.asarray(cam.viewmatrix, np.float64).copy()
    proj = np.asarray(cam.projmatrix, np.float64).copy()
    # Undo the protocol's y/z column flip, then row-vector convention.
    for m in (view, proj):
        m[1, :] = -m[1, :]
        m[2, :] = -m[2, :]
    return view.T.astype(np.float32), proj.T.astype(np.float32), cam


def message(w, h, view, proj, keep_alive=False, train=True) -> bytes:
    import json

    body = json.loads(_viewer_msg(w, h, view, keep_alive=keep_alive,
                                  train=train))
    body["view_projection_matrix"] = np.asarray(proj).flatten().tolist()
    blob = json.dumps(body).encode()
    return len(blob).to_bytes(4, "little") + blob


def test_network_gui_roundtrip():
    """The port's server: a client's request is rendered and answered with
    the RGB bytes and the verify string; the camera built on the CPU."""
    gui = tgui.NetworkGUI(port=0)
    port = gui.listener.getsockname()[1]
    rendered = {}

    def render_fn(req):
        cam = req.camera(device="cpu")
        rendered["size"] = (cam.width, cam.height)
        rendered["campos"] = cam.campos.numpy()
        img = np.zeros((3, req.height, req.width), np.float32)
        img[0] = 0.5
        return img

    def server():
        deadline = time.monotonic() + 10.0
        while not rendered and time.monotonic() < deadline:
            gui.poll(render_fn, "srcpath")
            time.sleep(0.005)

    t = threading.Thread(target=server)
    t.start()
    try:
        client = socket.create_connection(("127.0.0.1", port), timeout=10)
        client.settimeout(10)
        view = np.eye(4, dtype=np.float32)
        view[3, :3] = [1.0, 2.0, 3.0]
        msg = _viewer_msg(W, H, view)
        client.sendall(len(msg).to_bytes(4, "little") + msg)
        img = np.frombuffer(_recv_exact(client, H * W * 3),
                            np.uint8).reshape(H, W, 3)
        assert (img[..., 0] == 127).all() or (img[..., 0] == 128).all()
        assert (img[..., 1] == 0).all()
        vlen = int.from_bytes(_recv_exact(client, 4), "little")
        assert _recv_exact(client, vlen).decode() == "srcpath"
        client.close()
    finally:
        t.join(timeout=15)
        gui.close()
    assert not t.is_alive()
    assert rendered["size"] == (W, H)
    np.testing.assert_allclose(rendered["campos"], [-1.0, -2.0, -3.0],
                               atol=1e-5)


class FakeConn:
    """A socket stand-in that serves one request's bytes and keeps what
    the server sends back."""

    def __init__(self, data: bytes):
        self.data, self.sent = data, b""

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out

    def sendall(self, b):
        self.sent += b

    def close(self):
        pass


def test_request_parses_to_equal_cameras():
    """The same request bytes through both packages' receive(): equal
    request fields and cameras (every matrix and scalar to 1e-6)."""
    view, proj, _ = lookat_rows(W, H)
    data = message(W, H, view, proj, keep_alive=True, train=False)
    reqs = []
    for mod in (jgui, tgui):
        gui = mod.NetworkGUI.__new__(mod.NetworkGUI)
        gui.conn = FakeConn(data)
        reqs.append(gui.receive())
    rj, rt = reqs
    assert (rt.width, rt.height, rt.do_training, rt.keep_alive) == \
        (rj.width, rj.height, False, True)
    cj, ct = rj.camera(), rt.camera(device="cpu")
    assert (ct.width, ct.height) == (cj.width, cj.height)
    for name in ("viewmatrix", "projmatrix", "campos", "tan_fovx",
                 "tan_fovy", "focal_x", "focal_y"):
        np.testing.assert_allclose(getattr(ct, name).numpy(),
                                   np.asarray(getattr(cj, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def fields(x):
    """A JAX NamedTuple as nested numpy mappings."""
    return {k: (fields(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in x._asdict().items()}


@pytest.fixture(scope="module")
def state():
    """A JAX model state (toy scene points, 3 SH degrees) and its port
    copy."""
    scene = make_toy_scene(seed=5, n=200, n_cameras=1, width=W, height=H)
    pts = np.asarray(scene.means3d)
    cols = np.clip(np.asarray(scene.sh_coeffs[:, 0, :]) * 0.28 + 0.5, 0, 1)
    params, active, meta = jg.create_from_pcd(
        jax.random.PRNGKey(0), pts, cols, sh_degree=3, capacity=256)
    params = params._replace(opacity_raw=params.opacity_raw + 3.0)
    j_state = jstep.init_state(params, active, n_images=2)
    t_state = convert.train_state_from_numpy(fields(j_state), "cpu")
    t_meta = convert.config_from(meta, tg.GaussianMeta)
    return j_state, meta, t_state, t_meta


class OneShotGUI:
    """Stands in for NetworkGUI: poll renders the given request once."""

    def __init__(self, req):
        self.req, self.frame = req, None

    def poll(self, render_fn, source_path, training_done=False):
        self.frame = np.asarray(render_fn(self.req))
        return True


@pytest.mark.parametrize("keep_alive", [True, False],
                         ids=["rgb", "inverse_depth"])
def test_hook_frame_matches_jax(state, keep_alive):
    """The port's ViewerHook frame of a state against JAX's on the same
    request and background (tiled): [3, H, W] in [0, 1], within 2e-5."""
    j_state, j_meta, t_state, t_meta = state
    view, proj, _ = lookat_rows(W, H)
    data = message(W, H, view, proj, keep_alive=keep_alive)
    frames = []
    for gui_mod, hook_mod, cfg_mod, st, meta, bg in (
            (jgui, jhook, jcfg, j_state, j_meta,
             jnp.array([0.1, 0.2, 0.3])),
            (tgui, thook, tcfg, t_state, t_meta,
             torch.tensor([0.1, 0.2, 0.3]))):
        server = gui_mod.NetworkGUI.__new__(gui_mod.NetworkGUI)
        server.conn = FakeConn(data)
        fake = OneShotGUI(server.receive())
        hook = hook_mod.ViewerHook(fake, "src",
                                   cfg_mod.PipelineConfig(tile_capacity=256))
        assert hook(st, meta, False, bg) is True
        frames.append(fake.frame)
    want, got = frames
    assert got.shape == want.shape == (3, H, W)
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.std() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=IMG_ATOL)


def test_viewer_receives_frame_mid_training(state):
    """A client connected while the port's train_loop runs gets a live
    frame of the current state and the verify string."""
    from street_sparse_3dgs_tpu_torch.data.toy import make_toy_scene as tts
    from street_sparse_3dgs_tpu_torch.train.loop import LoopHooks, train_loop
    from street_sparse_3dgs_tpu_torch.train.step import CameraBatch

    _, _, t_state, t_meta = state
    scene = tts(seed=5, n=64, n_cameras=2, width=W, height=H, device="cpu")
    shape = (1, H, W)
    batches = [CameraBatch(
        camera=cam, gt_image=torch.zeros(3, H, W),
        alpha_mask=torch.ones(shape), mono_invdepth=torch.zeros(shape),
        depth_mask=torch.zeros(shape), depth_reliable=torch.tensor(False),
        image_index=torch.tensor(i)) for i, cam in enumerate(scene.cameras)]

    gui = tgui.NetworkGUI(port=0)
    port = gui.listener.getsockname()[1]
    pipe = tcfg.PipelineConfig(tile_capacity=256)
    hook = thook.ViewerHook(gui, "livesrc", pipe)
    result = {}
    view, proj, _ = lookat_rows(W, H)

    def client():
        sock = socket.create_connection(("127.0.0.1", port), timeout=15)
        sock.settimeout(15)
        sock.sendall(message(W, H, view, proj))
        buf = _recv_exact(sock, H * W * 3)
        result["frame"] = np.frombuffer(buf, np.uint8).reshape(H, W, 3)
        vlen = int.from_bytes(_recv_exact(sock, 4), "little")
        result["verify"] = _recv_exact(sock, vlen).decode()
        sock.close()

    t = threading.Thread(target=client)
    t.start()
    polls = []
    real_call = hook.__call__

    def counting(*a):
        polls.append(a[2])
        return real_call(*a)

    try:
        _, _, stats = train_loop(
            t_state, t_meta, batches, tcfg.OptimizationConfig(iterations=40),
            pipe, tcfg.ModelConfig(), cameras_extent=1.0,
            spatial_lr_scale=1.0, iterations=40, densify_enabled=False,
            hooks=LoopHooks(viewer_poll=counting))
    finally:
        t.join(timeout=30)
        gui.close()
    assert not t.is_alive()
    assert len(polls) == 40 and polls[-1] is True and not any(polls[:-1])
    assert result.get("verify") == "livesrc"
    assert result["frame"].shape == (H, W, 3)
    assert result["frame"].std() > 0
