"""PyTorch port, moving-object masks (``preprocess/mask_images.py``): the
JAX tests' cases (tests/test_mask_images.py) held against the JAX
package: the class policy, the mask algebra and its PNG, the precomputed
detector over a project (resumable), ``process_6_images``, the HTTP
confirmation round trip with the overlay PNG, and the torchvision
backend's refusal where torchvision is absent."""

import io
import sys
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import pytest
from PIL import Image

from street_sparse_3dgs_tpu.preprocess import mask_images as jmi
from street_sparse_3dgs_tpu_torch.data import png
from street_sparse_3dgs_tpu_torch.preprocess import mask_images as tmi


def det(mod, *items, hw=(12, 12)):
    """items: (label, score, mask_box=(y0, y1, x0, x1))."""
    labels, scores, masks = [], [], []
    for lab, sc, (y0, y1, x0, x1) in items:
        m = np.zeros(hw, np.float32)
        m[y0:y1, x0:x1] = 1.0
        labels.append(lab)
        scores.append(sc)
        masks.append(m)
    return mod.Detections(np.array(labels, np.int64), np.array(scores),
                          np.stack(masks) if masks else np.zeros((0, *hw)))


POLICY_CASES = {
    "person, contact bicycle, parked bicycle, car, weak truck": (
        (1, 0.9, (0, 4, 0, 4)), (2, 0.9, (2, 6, 2, 6)),
        (2, 0.9, (8, 12, 8, 12)), (3, 0.9, (6, 9, 0, 3)),
        (8, 0.3, (0, 12, 0, 12))),
    "animals only": ((16, 0.8, (1, 3, 1, 3)), (18, 0.6, (5, 9, 5, 9))),
    "vehicles only": ((6, 0.7, (0, 5, 0, 12)), (7, 0.9, (6, 8, 0, 3)),
                      (4, 0.9, (9, 12, 9, 12))),
    "nothing": (),
}


@pytest.mark.parametrize("case", list(POLICY_CASES))
def test_policy_matches_jax(case):
    a = jmi.combine_detections(det(jmi, *POLICY_CASES[case]))
    b = tmi.combine_detections(det(tmi, *POLICY_CASES[case]))
    assert (a.auto_mask is None) == (b.auto_mask is None)
    if a.auto_mask is not None:
        np.testing.assert_array_equal(b.auto_mask, a.auto_mask)
    assert b.to_confirm_names == a.to_confirm_names
    for x, y in zip(a.to_confirm, b.to_confirm):
        np.testing.assert_array_equal(y, x)


def test_names_and_faces_match_jax():
    for name in ("cam1/0001_f1.jpg", "x_u2.png", "a_d2.jpg", "b.jpg"):
        assert tmi.face_of(name) == jmi.face_of(name)
        for six in (True, False):
            assert tmi.needs_confirmation(name, six) == \
                jmi.needs_confirmation(name, six)


@pytest.mark.parametrize("manual", [None, "png", "jpg"])
def test_save_mask_matches_jax(tmp_path, manual):
    """The keep mask (inverted, unioned with an inverted hand-drawn face
    mask read from PNG or JPEG) and its PNG equal JAX's."""
    mask = np.zeros((6, 8), np.uint8)
    mask[0:2, 0:2] = 1
    hand = None
    if manual:
        drawn = np.full((6, 8), 255, np.uint8)
        drawn[4:6, 5:8] = 0
        (tmp_path / "manual").mkdir()
        Image.fromarray(drawn).save(tmp_path / "manual" /
                                    f"manual_mask_f1.{manual}")
    outs = {}
    for mod, d in ((jmi, "j"), (tmi, "t")):
        hand = mod.load_manual_mask(tmp_path / "manual" if manual else None,
                                    "cam1/0003_f1.jpg")
        outs[d] = (hand, mod.save_mask(mask, tmp_path / d / "m.jpg", (6, 8),
                                       hand))
    if manual:
        np.testing.assert_array_equal(outs["t"][0], outs["j"][0])
    else:
        assert outs["t"][0] is None and outs["j"][0] is None
    np.testing.assert_array_equal(outs["t"][1], outs["j"][1])
    np.testing.assert_array_equal(png.read_image(tmp_path / "t" / "m.png"),
                                  np.asarray(Image.open(tmp_path / "j" /
                                                        "m.png")))


def make_project(root, n=3, hw=(12, 12)):
    imgs = root / "inputs" / "images" / "cam0"
    imgs.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(np.full((*hw, 3), 50 * i, np.uint8)).save(
            imgs / f"v{i}_f1.jpg")
    Image.fromarray(np.full((*hw, 3), 9, np.uint8)).save(imgs / "w_d2.png")
    return root


def detections(root, hw=(12, 12)):
    ddir = root / "det"
    (ddir / "cam0").mkdir(parents=True)
    person = np.zeros((1, *hw), np.float32)
    person[0, 0:3, 0:3] = 1
    np.savez(ddir / "cam0" / "v0_f1.jpg.npz", labels=np.array([1]),
             scores=np.array([0.95]), masks=person)
    both = np.zeros((2, *hw), np.float32)
    both[0, 4:8, 4:8] = 1
    both[1, 9:12, 0:5] = 1
    np.savez(ddir / "cam0" / "v2_f1.jpg.npz", labels=np.array([3, 8]),
             scores=np.array([0.9, 0.8]), masks=both)
    return ddir


@pytest.mark.parametrize("decision", [True, False])
@pytest.mark.parametrize("six", [False, True])
def test_process_images_matches_jax(tmp_path, decision, six):
    """A project of JPEG and PNG views with precomputed detections: the
    written masks equal JAX's, and a second run writes nothing."""
    calls = {}
    for mod, d in ((jmi, "j"), (tmi, "t")):
        root = make_project(tmp_path / d)
        ddir = detections(root)
        seen = calls.setdefault(d, [])

        def decide(name, cls, mask, seen=seen):
            seen.append((name, cls, int(mask.sum())))
            return decision

        n = mod.process_images(root, mod.precomputed_detector(ddir),
                               decide=decide, process_6_images=six)
        assert n == 4
        assert mod.process_images(root, mod.precomputed_detector(ddir)) == 0
    assert calls["t"] == calls["j"]
    masks = sorted((tmp_path / "j" / "inputs" / "masks").rglob("*.png"))
    assert len(masks) == 4
    for p in masks:
        rel = p.relative_to(tmp_path / "j")
        np.testing.assert_array_equal(png.read_image(tmp_path / "t" / rel),
                                      np.asarray(Image.open(p)))


def test_overlay_png_matches_jax():
    """The red-tinted overlay, PNG bytes that decode to JAX's array."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (10, 14, 3)).astype(np.uint8)
    mask = (rng.random((10, 14)) > 0.5).astype(np.float32)
    want = np.asarray(Image.open(io.BytesIO(jmi.overlay_png(img, mask))))
    data = tmi.overlay_png(img, mask)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  want)


def test_confirmation_server_roundtrip(tmp_path):
    """A user confirms the car and skips the rest of that image over HTTP;
    the written masks equal those of JAX's batch run with the same
    answers."""
    make_project(tmp_path / "t", n=3)
    ddir = detections(tmp_path / "t")
    srv = tmi.ConfirmationServer(tmp_path / "t", tmi.precomputed_detector(
        ddir), port=0)
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    deadline = time.time() + 30
    page = ""
    while time.time() < deadline:
        try:
            page = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/", timeout=2).read().decode()
            if "car" in page:
                break
        except OSError:
            pass
        time.sleep(0.1)
    assert "car" in page and "v2_f1.jpg" in page
    overlay = urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/overlay.png", timeout=5).read()
    assert overlay[:8] == b"\x89PNG\r\n\x1a\n"
    for choice in ("confirm", "skip"):
        urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/decide",
            data=urllib.parse.urlencode({"choice": choice}).encode(),
            timeout=5)
        time.sleep(0.3)
    t.join(timeout=30)
    assert not t.is_alive() and srv.written == 4
    root_j = make_project(tmp_path / "j", n=3)
    answers = iter([True, False])
    jmi.process_images(root_j, jmi.precomputed_detector(detections(root_j)),
                       decide=lambda *_: next(answers))
    for p in sorted((root_j / "inputs" / "masks").rglob("*.png")):
        rel = p.relative_to(root_j)
        np.testing.assert_array_equal(png.read_image(tmp_path / "t" / rel),
                                      np.asarray(Image.open(p)))


def test_torchvision_detector_refuses_without_torchvision(monkeypatch):
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(RuntimeError, match="precomputed_detector"):
        tmi.torchvision_detector(device="cpu")
