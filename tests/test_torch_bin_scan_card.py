"""``bin_scan``'s CUDA kernel (``csrc/bin_scan.cu``) against its plain
version on the card, bit for bit: ``kept``, ``coverage`` and the compacted
``tile_id`` table, and every ``TileBins`` field of ``bin_gaussians`` (the
kernel's path against the plain path on the same card tensors, ``seg_pos``
included).  Skips without a card.  Run it on the card's machine with:

    python -m pytest tests/test_torch_bin_scan_card.py -o addopts=""
"""

import functools

import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu_torch.ops import binning
from street_sparse_3dgs_tpu_torch.ops.preprocess import Projected

W, H = 1920, 1088
STREET_TAILS = ((262144, 6), (16384, 24), (4096, 224))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def synthetic_rows(seed: int, n: int, dev) -> Projected:
    """Projected rows as ``project_gaussians`` leaves them, with what the
    scan has to get right: culled rows (radius and opacity 0, depth inf),
    rows with NaN centres or conics and infinite radii that stay valid,
    rects clamped at every edge and rows covering far more tiles than any
    scan, centres on tile and grid edges, opacity 0, tiny and 1."""
    rng = np.random.default_rng(seed)
    mean2d = np.stack([rng.uniform(-300, W + 300, n),
                       rng.uniform(-300, H + 300, n)], 1)
    k = n // 20
    mean2d[:k, 0] = rng.integers(0, W // 16 + 1, k) * 16.0
    mean2d[k:2 * k, 1] = rng.integers(0, H // 16 + 1, k) * 16.0
    mean2d[2 * k:2 * k + 8] = [[0, 0], [W, H], [0, H], [W, 0],
                               [W - 0.5, H - 0.5], [15.999, 16.0],
                               [-1e-3, 0], [W + 1e-3, H]]
    sx, sy = np.exp(rng.uniform(-0.5, 4.5, n)), np.exp(rng.uniform(-0.5, 4.5,
                                                                   n))
    rho = rng.uniform(-0.95, 0.95, n)
    cxx, cyy, cxy = sx * sx, sy * sy, rho * sx * sy
    det = cxx * cyy - cxy * cxy
    conic = np.stack([cyy / det, -cxy / det, cxx / det], 1)
    radius = np.ceil(3.0 * np.sqrt(np.maximum(cxx, cyy)))
    opacity = rng.uniform(0, 1, n)
    opacity[rng.random(n) < 0.05] = 0.0
    opacity[rng.random(n) < 0.02] = 1.0
    opacity[rng.random(n) < 0.02] = 1e-4
    depth = rng.uniform(1, 100, n)
    valid = rng.random(n) < 0.9
    mean2d[3 * k:3 * k + 20] = np.nan
    conic[3 * k + 20:3 * k + 40] = np.nan
    radius[3 * k + 40:3 * k + 60] = np.inf
    radius[~valid], opacity[~valid], depth[~valid] = 0.0, 0.0, np.inf

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return Projected(mean2d=f32(mean2d), depth=f32(depth),
                     inv_depth=f32(np.where(valid, 1.0 / depth, 0.0)),
                     conic=f32(conic), radius=f32(radius),
                     color=f32(rng.uniform(0, 1, (n, 3))),
                     opacity=f32(opacity),
                     valid=torch.tensor(valid, device=dev))


@functools.lru_cache(maxsize=1)
def street_rows(dev) -> Projected:
    """200k rows of the street scene's profile, projected by view 0."""
    from street_sparse_3dgs_tpu_torch.data.toy import make_street_scene
    from street_sparse_3dgs_tpu_torch.ops.preprocess import project_gaussians

    s = make_street_scene(seed=5, n=200_000, n_cameras=1, width=W, height=H,
                          device=dev)
    return project_gaussians(s.means3d, s.scales, s.quats, s.opacities,
                             s.sh_coeffs, s.cameras[0], 3)


def assert_bins_equal(got, want, label):
    for name in binning.TileBins._fields:
        x, y = getattr(got, name), getattr(want, name)
        if isinstance(y, torch.Tensor):
            assert isinstance(x, torch.Tensor) and x.dtype == y.dtype and \
                torch.equal(x, y), f"{label}: {name}"
        else:
            assert x == y, f"{label}: {name}"


# (max_dup, dup_overscan) giving scans 4 (four-lane groups), 8 (the
# defaults), 12 (not a power of two), 64 (the street flags), 100 and 256
# (autosize's widest).
SCANS = {4: (1, 4), 8: (2, 0), 12: (3, 0), 64: (2, 32), 100: (25, 4),
         256: (8, 32)}


@pytest.mark.card
@pytest.mark.parametrize("rows", ["synthetic", "street"])
@pytest.mark.parametrize("vis", [False, True])
@pytest.mark.parametrize("scan", sorted(SCANS))
def test_bin_scan_equals_plain_on_the_card(cuda_device, monkeypatch, scan,
                                           vis, rows):
    dev = cuda_device
    proj = synthetic_rows(scan, 50_003, dev) if rows == "synthetic" \
        else street_rows(dev)
    n = proj.depth.shape[0]
    tx, ty = binning.num_tiles(H, W)
    # The scan alone, on every row and on short row counts (partial warps
    # and blocks).
    for m in (n, 1, 3, 37, 257):
        args = (proj.mean2d[:m].contiguous(), proj.conic[:m].contiguous(),
                proj.radius[:m].contiguous(), proj.opacity[:m].contiguous(),
                proj.valid[:m].contiguous(), tx, ty, scan)
        got = binning.bin_scan(*args)
        want = binning.bin_scan_plain(*args)
        for name, x, y in zip(("kept", "coverage", "tile_id"), got, want):
            assert x.dtype == y.dtype and torch.equal(x, y), \
                f"scan {scan}, {m} rows: {name}"
        if m == n:
            want_scan = want
    max_dup, overscan = SCANS[scan]
    kw = dict(max_dup=max_dup, tile_capacity=128, dup_overscan=overscan,
              exact_extra=4096,
              dup_tails=STREET_TAILS if scan == 64 else binning.DUP_TAILS)
    if vis:
        kw["vis_capacity"] = int(proj.valid.sum()) * 3 // 5
    else:
        kw["with_seg_pos"] = True
    before = binning.native.LAUNCHES["bin_scan"]
    got = binning.bin_gaussians(proj, H, W, **kw)
    assert binning.native.LAUNCHES["bin_scan"] == before + 1
    monkeypatch.setattr(binning, "bin_scan", binning.bin_scan_plain)
    want = binning.bin_gaussians(proj, H, W, **kw)
    assert_bins_equal(got, want, f"scan {scan}, vis {vis}, {rows}")
    # The draw reaches rows kept, rows covering more than the scan (the
    # synthetic rows' infinite radii) and rows left out by the visible
    # compaction.
    assert int(got.counts.sum()) > 0
    if rows == "synthetic":
        assert int((want_scan[1] > scan).sum()) > 0
    if vis:
        assert int(got.vis_overflow) > 0
