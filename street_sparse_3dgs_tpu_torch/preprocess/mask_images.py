"""Moving-object mask generation — ``ss_utils/mask_images.py`` equivalent.

The reference runs a pretrained Mask R-CNN over every input image and builds
per-image *keep* masks (white = keep) that the training loss consumes:
people/animals are masked automatically, vehicles are queued for
human-in-the-loop confirmation in a small web UI, bicycles/motorbikes are
only ever masked when they touch a person (a parked bike is static scene),
and hand-drawn per-cube-face masks are unioned in
(``ss_utils/mask_images.py:128-185,214-258``).

The counterpart of ``street_sparse_3dgs_tpu/preprocess/mask_images.py``:
the class policy and mask algebra are pure numpy (`combine_detections`,
`save_mask`) so they are unit-testable without any detector; detection
itself is a pluggable callable; images and masks go through the port's own
codecs (``data/png.py``, ``data/jpeg.py``: no PIL).  Two backends ship:

- ``torchvision_detector()`` — the reference's Mask R-CNN, gated on
  torchvision being installed (same external-prior stance as
  ``mono_depth``);
- ``precomputed_detector(dir)`` — per-image ``<name>.npz`` files with
  ``labels``/``scores``/``masks`` arrays produced by any instance
  segmenter offline.

The human-in-the-loop confirmation UI is a dependency-free
``http.server`` app (the reference needs Flask): it serves the overlay,
takes confirm/skip clicks, and writes masks incrementally.  A
non-interactive ``decide`` callback covers batch runs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

from ..data import png
from ..device import resolve_device

# COCO category ids, as used by the reference (ss_utils/mask_images.py:137-138)
AUTO_IDS = (1, 16, 18)            # person, bird, dog — masked automatically
CONFIRM_IDS = (2, 3, 4, 6, 7, 8)  # bicycle, car, motorcycle, bus, train, truck
CONTACT_IDS = (2, 4)              # masked only when touching a person
_NAMES = {2: "bicycle/motorbike", 3: "car", 4: "bicycle/motorbike",
          6: "bus", 7: "train", 8: "truck"}

VALID_FACE_SUFFIXES = ("_f1", "_b1", "_l1", "_r1", "_u1", "_u2")

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


@dataclass
class Detections:
    """Instance-segmentation output for one image."""
    labels: np.ndarray          # [M] int COCO category ids
    scores: np.ndarray          # [M] float
    masks: np.ndarray           # [M, H, W] float in [0, 1] (or bool)


@dataclass
class MaskProposal:
    """Policy output: the automatic union + instances needing a human."""
    auto_mask: np.ndarray | None                  # [H, W] uint8 or None
    to_confirm: list[np.ndarray] = field(default_factory=list)
    to_confirm_names: list[str] = field(default_factory=list)


def combine_detections(det: Detections,
                       confidence_threshold: float = 0.5) -> MaskProposal:
    """Apply the moving-object class policy (ref ``detect_and_process``).

    People/animals union into ``auto_mask``; cars/buses/trains/trucks are
    queued for confirmation; bicycles/motorcycles are queued only when their
    mask intersects a person mask (otherwise discarded as parked)."""
    keep = det.scores > confidence_threshold
    labels = det.labels[keep]
    masks = det.masks[keep]
    binary = masks > 0.5

    person = [b for lab, b in zip(labels, binary) if lab == 1]
    prop = MaskProposal(auto_mask=None)
    for lab, b in zip(labels, binary):
        lab = int(lab)
        if lab in AUTO_IDS:
            m = b.astype(np.uint8)
            prop.auto_mask = m if prop.auto_mask is None else \
                np.maximum(prop.auto_mask, m)
        elif lab in CONTACT_IDS:
            if any((b & p).sum() > 0 for p in person):
                prop.to_confirm.append(b.astype(np.uint8))
                prop.to_confirm_names.append(_NAMES[lab])
        elif lab in CONFIRM_IDS:
            prop.to_confirm.append(b.astype(np.uint8))
            prop.to_confirm_names.append(_NAMES[lab])
    return prop


def face_of(image_name: str) -> str:
    """Cube-face token from an image filename (``..._f1.jpg`` → ``f1``)."""
    return Path(image_name).stem.split("_")[-1]


def needs_confirmation(image_name: str, process_6_images: bool) -> bool:
    """With ``process_6_images``, only the six canonical cube faces go
    through detection+confirmation (ref ``should_confirm_image``)."""
    if not process_6_images:
        return True
    stem = Path(image_name).stem
    return any(s in stem for s in VALID_FACE_SUFFIXES)


def save_mask(mask: np.ndarray | None, out_path: str | Path,
              image_hw: tuple[int, int],
              manual_mask: np.ndarray | None = None) -> np.ndarray:
    """Write the final *keep* mask PNG: moving-object mask (optionally
    unioned with an inverted hand-drawn face mask) is inverted so white
    pixels survive the loss (ref ``save_mask``)."""
    if mask is None:
        mask = np.zeros(image_hw, np.uint8)
    if manual_mask is not None:
        manual = 1 - (manual_mask > 0).astype(np.uint8)
        mask = np.bitwise_or(mask, manual)
    keep = ((1 - mask) * 255).astype(np.uint8)
    out_path = Path(out_path).with_suffix(".png")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    png.write_png(out_path, keep)
    return keep


def load_manual_mask(manual_dir: str | Path | None,
                     image_name: str) -> np.ndarray | None:
    """Hand-drawn per-face mask ``manual_mask_<face>.jpg`` if present."""
    if manual_dir is None:
        return None
    p = Path(manual_dir) / f"manual_mask_{face_of(image_name)}.jpg"
    if not p.exists():
        p = p.with_suffix(".png")
        if not p.exists():
            return None
    return png.to_grey(png.read_image(p))


# ---------------------------------------------------------------------------
# Detector backends
# ---------------------------------------------------------------------------

def torchvision_detector(confidence_threshold: float = 0.5,
                         device="cuda") -> Callable:
    """The reference's pretrained Mask R-CNN, gated on torchvision.

    Raises a clear error where torchvision or its downloaded weights are
    missing (the card's machine has neither) — use
    ``precomputed_detector``."""
    try:
        import torch
        import torchvision
    except ImportError as e:  # pragma: no cover - env-dependent
        raise RuntimeError(
            "torchvision is not installed; run the detector offline and "
            "feed the results through precomputed_detector(dir)") from e

    dev = resolve_device(device)
    model = torchvision.models.detection.maskrcnn_resnet50_fpn(
        weights="DEFAULT").eval().to(dev)

    def detect(image: np.ndarray) -> Detections:  # pragma: no cover
        tensor = torch.from_numpy(np.ascontiguousarray(
            image.transpose(2, 0, 1))).to(dev).float() / 255.0
        with torch.no_grad():
            pred = model([tensor])[0]
        return Detections(labels=pred["labels"].cpu().numpy(),
                          scores=pred["scores"].cpu().numpy(),
                          masks=pred["masks"][:, 0].cpu().numpy())

    return detect


def precomputed_detector(detections_dir: str | Path) -> Callable:
    """Detections from per-image ``<relpath>.npz`` files (any offline
    instance segmenter).  Missing file → no detections (empty mask)."""
    detections_dir = Path(detections_dir)

    def detect_named(image: np.ndarray, name: str) -> Detections:
        p = detections_dir / (name + ".npz")
        if not p.exists():
            h, w = image.shape[:2]
            return Detections(np.zeros(0, np.int64), np.zeros(0),
                              np.zeros((0, h, w)))
        z = np.load(p)
        return Detections(z["labels"], z["scores"], z["masks"])

    detect_named.named = True  # type: ignore[attr-defined]
    return detect_named


def _detect(detector: Callable, image: np.ndarray, name: str) -> Detections:
    if getattr(detector, "named", False):
        return detector(image, name)
    return detector(image)


# ---------------------------------------------------------------------------
# Batch driver
# ---------------------------------------------------------------------------

def list_images(input_dir: str | Path) -> list[str]:
    input_dir = Path(input_dir)
    return sorted(p.relative_to(input_dir).as_posix()
                  for p in input_dir.rglob("*")
                  if p.suffix.lower() in IMAGE_EXTS)


def process_images(project_dir: str | Path,
                   detector: Callable,
                   decide: Callable[[str, str, np.ndarray], bool]
                   | None = None,
                   process_6_images: bool = False,
                   confidence_threshold: float = 0.5,
                   input_dir: str | Path | None = None,
                   output_dir: str | Path | None = None,
                   manual_dir: str | Path | None = None) -> int:
    """Generate keep-masks for every image under ``inputs/images``.

    ``decide(image_name, class_name, mask) -> bool`` resolves each
    confirmation-class instance (the web UI binds this to a click; batch
    runs pass e.g. ``lambda *_: True``).  Existing masks are skipped so the
    run is resumable, like the reference.  Returns #masks written."""
    project_dir = Path(project_dir)
    input_dir = Path(input_dir or project_dir / "inputs" / "images")
    output_dir = Path(output_dir or project_dir / "inputs" / "masks")
    if manual_dir is None:
        cand = project_dir / "manual_masks"
        manual_dir = cand if cand.exists() else None
    if decide is None:
        decide = lambda name, cls, mask: True  # noqa: E731

    written = 0
    for name in list_images(input_dir):
        out_path = (output_dir / name).with_suffix(".png")
        if out_path.exists():
            continue
        img = png.to_rgb(png.read_image(input_dir / name))
        hw = img.shape[:2]
        manual = load_manual_mask(manual_dir, name)
        if not needs_confirmation(name, process_6_images):
            save_mask(None, out_path, hw, manual)
            written += 1
            continue
        prop = combine_detections(
            _detect(detector, img, name), confidence_threshold)
        mask = prop.auto_mask
        for m, cls in zip(prop.to_confirm, prop.to_confirm_names):
            if decide(name, cls, m):
                mask = m if mask is None else np.maximum(mask, m)
        save_mask(mask, out_path, hw, manual)
        written += 1
    return written


# ---------------------------------------------------------------------------
# Human-in-the-loop web UI (stdlib http.server; the reference needs Flask)
# ---------------------------------------------------------------------------

_PAGE = """<!doctype html><html><head><title>mask confirmation</title>
<style>body{{font-family:sans-serif;margin:2em}}img{{max-width:90vw}}
button{{font-size:1.2em;margin:.5em;padding:.4em 1.4em}}</style></head>
<body><h3>{title}</h3><p>{progress}</p>{body}</body></html>"""


def overlay_png(image: np.ndarray, mask: np.ndarray,
                opacity: float = 0.7) -> bytes:
    """Red-tinted mask overlay PNG bytes (ref superimpose_mask_on_image)."""
    out = image.astype(np.float32).copy()
    m = (mask > 0.5)[..., None]
    red = np.array([255.0, 0.0, 0.0])
    out = np.where(m, (1 - opacity) * out + opacity * red, out)
    return png.encode_png(out.astype(np.uint8))


class ConfirmationServer:
    """Serve confirm/skip decisions over HTTP while a worker thread runs
    ``process_images``.  GET / shows the pending overlay; POST /decide with
    ``choice=confirm|reject|skip`` resolves it.  ``skip`` rejects every
    remaining instance of the current image (ref 'skip' branch)."""

    def __init__(self, project_dir, detector, host="127.0.0.1", port=5001,
                 **kwargs):
        self.project_dir = project_dir
        self.detector = detector
        self.kwargs = kwargs
        self.host, self.port = host, port
        self._pending: tuple[str, str, bytes] | None = None
        self._answer: bool | None = None
        self._skip_image: str | None = None
        self._cv = threading.Condition()
        self._done = threading.Event()
        self.written = 0

    # -- decide callback run on the worker thread --
    def _decide(self, name: str, cls: str, mask: np.ndarray) -> bool:
        if self._skip_image == name:
            return False
        input_dir = Path(self.kwargs.get("input_dir") or
                         Path(self.project_dir) / "inputs" / "images")
        img = png.to_rgb(png.read_image(input_dir / name))
        overlay = overlay_png(img, mask)
        with self._cv:
            self._pending = (name, cls, overlay)
            self._answer = None
            self._cv.notify_all()
            while self._answer is None:
                self._cv.wait(timeout=0.1)
            ans = self._answer
            self._pending = None
        return bool(ans)

    def _worker(self):
        self.written = process_images(
            self.project_dir, self.detector, decide=self._decide,
            **self.kwargs)
        self._done.set()
        with self._cv:
            self._cv.notify_all()

    def serve(self, max_requests: int | None = None):
        """Run until every image is masked (or ``max_requests`` handled)."""
        import http.server
        import urllib.parse

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype="text/html", code=200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/overlay.png" and outer._pending:
                    self._send(outer._pending[2], "image/png")
                    return
                if outer._done.is_set():
                    self._send(_PAGE.format(
                        title="All images processed",
                        progress=f"{outer.written} masks written",
                        body="").encode())
                    return
                if outer._pending is None:
                    self._send(_PAGE.format(
                        title="Working…", progress="detection running",
                        body="<meta http-equiv='refresh' content='1'>"
                        ).encode())
                    return
                name, cls, _ = outer._pending
                form = ("<img src='/overlay.png'><form method='post' "
                        "action='/decide'>"
                        "<button name='choice' value='confirm'>Mask it"
                        "</button><button name='choice' value='reject'>"
                        "Keep it</button><button name='choice' "
                        "value='skip'>Skip image</button></form>")
                self._send(_PAGE.format(
                    title=f"Is this {cls} a moving object? ({name})",
                    progress="", body=form).encode())

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                data = urllib.parse.parse_qs(
                    self.rfile.read(length).decode())
                choice = data.get("choice", ["reject"])[0]
                with outer._cv:
                    if outer._pending is not None:
                        if choice == "skip":
                            outer._skip_image = outer._pending[0]
                            outer._answer = False
                        else:
                            outer._answer = choice == "confirm"
                        outer._cv.notify_all()
                self._send(b"<meta http-equiv='refresh' content='0;url=/'>")

        threading.Thread(target=self._worker, daemon=True).start()
        server = http.server.HTTPServer((self.host, self.port), Handler)
        self.port = server.server_address[1]
        served = 0
        try:
            while not self._done.is_set():
                server.timeout = 0.2
                server.handle_request()
                served += 1
                if max_requests is not None and served >= max_requests:
                    break
        finally:
            server.server_close()
        return self.written
