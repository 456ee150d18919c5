"""PyTorch port, the web viewer (``viewer/app.py``) and the CLI's
``mask-images`` and ``viewer`` commands against the JAX package:

- ``SceneSource`` frames on a toy PLY and a toy hierarchy (tau and
  ``--budget`` cuts) against JAX's: within one level of 255 at all but
  1e-4 of the pixels (JAX renders with its tiled method, the port with
  ``method="pallas"``, the kernels' plain versions on the CPU), the same
  ``last_overflow``;
- the HTTP round trip (page, ``/info``, ``/frame`` as ``image/jpeg``
  whose decode is the frame, ``x-status``);
- ``LiveSource`` against the port's ``NetworkGUI``;
- the two commands' parsing, each run against JAX's with the work
  stubbed, and the viewer needing the card by default."""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu import cli as jcli
from street_sparse_3dgs_tpu.hierarchy.build import build_hierarchy
from street_sparse_3dgs_tpu.hierarchy.io import save_hierarchy
from street_sparse_3dgs_tpu.viewer import app as japp
from street_sparse_3dgs_tpu_torch import cli as tcli
from street_sparse_3dgs_tpu_torch.data import jpeg
from street_sparse_3dgs_tpu_torch.preprocess import mask_images as tmi
from street_sparse_3dgs_tpu_torch.viewer import app as tapp
from street_sparse_3dgs_tpu_torch.viewer.network_gui import NetworkGUI

from test_viewer import _toy_scene_dir

torch.set_num_threads(1)
W, H = 96, 64
FLIP_SHARE = 1e-4


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """The JAX viewer tests' toy PLY and a hierarchy built over it."""
    from street_sparse_3dgs_tpu.data.ply import load_gaussian_ply

    d = _toy_scene_dir(tmp_path_factory.mktemp("viewer"))
    h = build_hierarchy(load_gaussian_ply(d / "point_cloud.ply"))
    save_hierarchy(d / "toy.hier.npz", h)
    return d


def assert_frames_close(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=2)
    assert int((diff > 1).sum()) <= FLIP_SHARE * diff.size
    assert want.std() > 2.0


def poses(src):
    st = src.initial_state()
    return [st, tapp.FlyState(pos=st.pos + np.array([0.3, -0.2, 0.1]),
                              yaw=st.yaw + 0.2, pitch=st.pitch - 0.1,
                              fovx_deg=50.0)]


def test_leaf_frames_match_jax(scene_dir):
    """The PLY source at two poses and two scaling modifiers."""
    js = japp.SceneSource(scene_dir)
    ts = tapp.SceneSource(scene_dir, device="cpu")
    assert ts.n_points == js.n_points == 256
    np.testing.assert_allclose(ts.center, js.center, rtol=1e-6)
    assert ts.radius == pytest.approx(js.radius, rel=1e-6)
    for st in poses(ts):
        for scaling in (1.0, 0.6):
            jst = japp.FlyState(pos=st.pos, yaw=st.yaw, pitch=st.pitch,
                                fovx_deg=st.fovx_deg)
            want = js.render(jst, W, H, scaling=scaling)
            got = ts.render(st, W, H, scaling=scaling)
            assert_frames_close(got, want)
            assert ts.last_overflow == js.last_overflow


@pytest.mark.parametrize("tau,budget", [(0.0, 0), (6.0, 0), (15.0, 0),
                                        (6.0, 120)])
def test_hierarchy_frames_match_jax(scene_dir, tau, budget):
    """The ``.hier.npz`` source through select_cut (pixel limit at tau, or
    the ``--budget`` bisection) and render_cut_compact."""
    js = japp.SceneSource(scene_dir / "toy.hier.npz", point_budget=budget)
    ts = tapp.SceneSource(scene_dir / "toy.hier.npz", point_budget=budget,
                          device="cpu")
    assert ts.n_points == js.n_points
    st = ts.initial_state()
    want = js.render(japp.FlyState(pos=st.pos, yaw=st.yaw, pitch=st.pitch),
                     W, H, tau=tau)
    got = ts.render(st, W, H, tau=tau)
    assert_frames_close(got, want)
    assert ts.last_overflow == js.last_overflow


def test_scene_source_needs_the_card_by_default(scene_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.SceneSource(scene_dir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["viewer", "--source", str(scene_dir)])


def test_http_roundtrip(scene_dir):
    """The page, ``/info`` (JAX's), and ``/frame``: ``image/jpeg`` bytes
    the port's decoder and PIL read alike, at PSNR >= 30 dB against the
    frame the source rendered, ``x-status`` naming the size and the
    overflow."""
    from PIL import Image
    import io

    src = tapp.SceneSource(scene_dir, device="cpu")
    app = tapp.ViewerApp(src, port=0)
    app.serve_background()
    frames = []
    render = src.render
    src.render = lambda *a, **kw: frames.append(render(*a, **kw)) or \
        frames[-1]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", app.port, timeout=60)
        conn.request("GET", "/")
        page = conn.getresponse().read()
        assert b"street_sparse_3dgs_tpu" in page and b"tick()" in page
        conn.request("GET", "/info")
        info = json.loads(conn.getresponse().read())
        jinfo = japp.SceneSource(scene_dir).initial_state()
        assert info["n_points"] == 256
        np.testing.assert_allclose(info["pos"], jinfo.pos, rtol=1e-6)
        assert info["yaw"] == pytest.approx(jinfo.yaw, rel=1e-6)
        body = json.dumps({"pos": info["pos"], "yaw": info["yaw"],
                           "pitch": info["pitch"], "width": W,
                           "height": H, "tau": 6.0})
        conn.request("POST", "/frame", body=body)
        resp = conn.getresponse()
        blob = resp.read()
        assert resp.status == 200 and blob[:2] == b"\xff\xd8"
        assert resp.getheader("Content-Type") == "image/jpeg"
        want = f"{W}x{H}" + (f" overflow:{src.last_overflow}"
                             if src.last_overflow else "")
        assert resp.getheader("x-status") == want
        got = jpeg.decode_jpeg(blob)
        np.testing.assert_array_equal(got, np.asarray(Image.open(
            io.BytesIO(blob))))
        mse = np.mean((got.astype(float) - frames[-1].astype(float)) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) >= 30.0
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
    finally:
        app.close()


def test_live_source_speaks_sibr_protocol():
    """``LiveSource`` against the port's ``NetworkGUI``: the camera it puts
    on the wire reconstructs to its own render camera, and the frame comes
    back."""
    gui = NetworkGUI(port=0)
    port = gui.listener.getsockname()[1]
    state = tapp.FlyState(pos=np.array([1.0, -2.0, 0.5]), yaw=0.7,
                          pitch=-0.2)
    got = {}

    def server():
        deadline = time.time() + 30
        while "cam" not in got and time.time() < deadline:
            def render_fn(req):
                got["cam"] = req.camera(device="cpu")
                return torch.full((3, req.height, req.width), 0.5)
            gui.poll(render_fn, "src")
            time.sleep(0.01)

    th = threading.Thread(target=server, daemon=True)
    th.start()
    client = tapp.LiveSource(port=port)
    frame = client.render(state, 48, 32)
    th.join(timeout=30)
    client.close()
    gui.close()
    assert frame.shape == (32, 48, 3) and int(frame[0, 0, 0]) in (127, 128)
    want = state.camera(48, 32, device="cpu")
    np.testing.assert_allclose(got["cam"].viewmatrix.numpy(),
                               want.viewmatrix.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["cam"].campos.numpy(),
                               want.campos.numpy(), atol=1e-4)
    jwant = japp.FlyState(pos=state.pos, yaw=0.7, pitch=-0.2).camera(48, 32)
    np.testing.assert_allclose(want.viewmatrix.numpy(),
                               np.asarray(jwant.viewmatrix), atol=1e-6)


MASK_ARGVS = [["--project_dir", "P", "--batch", "confirm-all",
               "--detections_dir", "D"],
              ["--project_dir", "P", "--batch", "reject-all",
               "--detections_dir", "D", "--process_6_images"]]


@pytest.mark.parametrize("argv", MASK_ARGVS)
def test_mask_images_command_matches_jax(argv, monkeypatch, capsys):
    """Both packages' ``mask-images`` call ``process_images`` alike (its
    decide callback's answer included); the port's parser adds only
    ``--device``."""
    from street_sparse_3dgs_tpu.preprocess import mask_images as jmi

    seen = {}
    for mod, d in ((jmi, "j"), (tmi, "t")):
        def fake(project_dir, detector, decide=None, d=d, **kw):
            seen[d] = (project_dir, decide("x", "car", None), kw,
                       getattr(detector, "named", False))
            return 3
        monkeypatch.setattr(mod, "process_images", fake)
    jcli.main(["mask-images"] + argv)
    assert tcli.main(["mask-images"] + argv) == 0
    assert seen["t"] == seen["j"]
    assert capsys.readouterr().out.count("wrote 3 masks") == 2
    p = tcli.mask_images_parser()
    args = p.parse_args(argv)
    assert args.device == "cuda" and args.port == 5001
    assert {a.dest for a in p._actions} - {"help"} == {
        "project_dir", "process_6_images", "detections_dir", "batch",
        "port", "device"}


def test_mask_images_command_end_to_end(tmp_path):
    """``mask-images --batch confirm-all`` on a project with precomputed
    detections writes JAX's masks."""
    from PIL import Image

    from street_sparse_3dgs_tpu_torch.data import png

    for d in ("j", "t"):
        imgs = tmp_path / d / "inputs" / "images" / "cam0"
        imgs.mkdir(parents=True)
        for i in range(2):
            Image.fromarray(np.full((10, 12, 3), 60 * i, np.uint8)).save(
                imgs / f"v{i}_f1.jpg")
        (tmp_path / d / "det" / "cam0").mkdir(parents=True)
        car = np.zeros((1, 10, 12), np.float32)
        car[0, 2:6, 3:9] = 1
        np.savez(tmp_path / d / "det" / "cam0" / "v1_f1.jpg.npz",
                 labels=np.array([3]), scores=np.array([0.9]), masks=car)
    for cli, d in ((jcli, "j"), (tcli, "t")):
        cli.main(["mask-images", "--project_dir", str(tmp_path / d),
                  "--detections_dir", str(tmp_path / d / "det"),
                  "--batch", "confirm-all"])
    for i in range(2):
        rel = f"inputs/masks/cam0/v{i}_f1.png"
        np.testing.assert_array_equal(
            png.read_image(tmp_path / "t" / rel),
            np.asarray(Image.open(tmp_path / "j" / rel)))


VIEWER_ARGVS = [["--source", "S"], ["--source", "S", "--budget", "5000",
                                    "--sh_degree", "1", "--port", "8123"],
                ["--live", "host:6010"]]


@pytest.mark.parametrize("argv", VIEWER_ARGVS)
def test_viewer_command_matches_jax(argv, monkeypatch):
    """Both packages' ``viewer`` build the same source and app from the
    same flags (the port's scene source on ``--device``, the card by
    default)."""
    seen = {}
    for mod, d in ((japp, "j"), (tapp, "t")):
        def scene(path, sh_degree=3, point_budget=0, device=None, d=d):
            seen.setdefault(d, {})["scene"] = (path, sh_degree, point_budget)
            if device is not None:
                seen["device"] = device
            return "source"

        def live(host="127.0.0.1", port=6009, keep_alive=True, d=d):
            seen.setdefault(d, {})["live"] = (host, port)
            return "source"

        class App:
            def __init__(self, source, host="127.0.0.1", port=8000,
                         jpeg_quality=85, d=d):
                seen.setdefault(d, {})["app"] = (source, port, jpeg_quality)

            def serve_forever(self):
                pass

        monkeypatch.setattr(mod, "SceneSource", scene)
        monkeypatch.setattr(mod, "LiveSource", live)
        monkeypatch.setattr(mod, "ViewerApp", App)
    jcli.main(["viewer"] + argv)
    assert tcli.main(["viewer"] + argv) == 0
    assert seen["t"] == seen["j"]
    if "--source" in argv:
        assert seen["device"] == "cuda"
    with pytest.raises(SystemExit):
        tapp.make_parser().parse_args(["--port", "x"])
