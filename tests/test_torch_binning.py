"""PyTorch port, projection and binning: ``project_gaussians`` against the
JAX function field by field, ``bin_gaussians`` against the JAX tables
element by element (every ``TileBins`` field, exactly equal, for every JAX
``key_mode``), and K5's plain version against the JAX Pallas slab gather in
interpret mode.

Binning is compared on the SAME projected rows (the JAX ``Projected``
carried across as numpy), so the tables must be equal bit for bit."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.ops import binning as jbin
from street_sparse_3dgs_tpu.ops.preprocess import (
    project_gaussians as j_project)
from street_sparse_3dgs_tpu_torch.convert import camera_from_numpy
from street_sparse_3dgs_tpu_torch.ops import binning as tbin
from street_sparse_3dgs_tpu_torch.ops.preprocess import (
    Projected, project_gaussians as t_project)

torch.set_num_threads(1)

STREET_TAILS = ((262144, 6), (16384, 24), (4096, 224))


def t(x):
    return torch.tensor(np.asarray(x))


def scene_inputs(seed, n, width, height):
    s = make_toy_scene(seed=seed, n=n, n_cameras=1, width=width,
                       height=height)
    cam = s.cameras[0]
    cam_t = camera_from_numpy(
        {k: np.asarray(v) for k, v in cam._asdict().items()}, device="cpu")
    rows = (s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs)
    return s, cam, cam_t, rows


@functools.lru_cache(maxsize=None)
def scene_data(seed, n, width, height):
    s, cam, cam_t, rows = scene_inputs(seed, n, width, height)
    return dict(cam=cam, cam_t=cam_t, rows=rows,
                proj=j_project(*rows, cam, 3))


@pytest.fixture(scope="module", params=[0, 1])
def small(request):
    return scene_data(request.param, 300, 64, 48)


def test_projected_fields_match_jax(small):
    a = t_project(*(t(x) for x in small["rows"]), small["cam_t"], 3)
    b = small["proj"]
    for name in Projected._fields:
        x, y = getattr(a, name).numpy(), np.asarray(getattr(b, name))
        if name == "valid":
            np.testing.assert_array_equal(x, y)
            continue
        finite = np.isfinite(y)
        np.testing.assert_array_equal(np.isfinite(x), finite, err_msg=name)
        scale = float(np.abs(y[finite]).max()) if finite.any() else 1.0
        np.testing.assert_allclose(x[finite], y[finite], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
        np.testing.assert_array_equal(x[~finite], y[~finite], err_msg=name)


def threshold_pairs(proj_t, height, width, max_dup, dup_overscan):
    """(row, tile) pairs whose _tile_qmin sits within 1e-5 (relative) of
    the cull cap — where a last-ulp difference could flip a table entry."""
    tx, ty = tbin.num_tiles(height, width)
    x0, y0, x1, y1 = tbin.tile_rect(proj_t.mean2d, proj_t.radius, tx, ty)
    nx = torch.clamp(x1 - x0, min=1)
    scan = max_dup * (dup_overscan or tbin.DUP_OVERSCAN)
    slots = torch.arange(scan)
    tile_x = x0[:, None] + slots[None, :] % nx[:, None]
    tile_y = y0[:, None] + torch.div(slots[None, :], nx[:, None],
                                     rounding_mode="floor")
    q = tbin._tile_qmin(proj_t.mean2d, proj_t.conic, tile_x, tile_y)
    cap = 2.0 * (torch.log(torch.clamp(proj_t.opacity, min=1e-30))
                 - np.log(np.float32(tbin.ALPHA_MIN * (1.0 - 1e-3))))
    near = (torch.abs(q - cap[:, None]) <= 1e-5 * torch.abs(cap[:, None])) \
        & proj_t.valid[:, None]
    return torch.nonzero(near).tolist()


def assert_bins_equal(a, b, label):
    for name in jbin.TileBins._fields:
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            assert x is None, f"{label}: {name}"
            continue
        x = x if isinstance(x, int) else x.numpy()
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{label}: {name}")


SMALL, DENSE = (300, 64, 48), (2048, 128, 96)
BIN_CASES = {
    "padded_seed0": (0, SMALL, dict(max_dup=32, tile_capacity=256)),
    "padded_seed1": (1, SMALL, dict(max_dup=32, tile_capacity=256)),
    "padded_vis_capacity": (0, SMALL, dict(max_dup=32, tile_capacity=256,
                                           vis_capacity=150)),
    "exact": (0, DENSE, dict(max_dup=16, tile_capacity=128,
                             exact_extra=64)),
    "exact_overflow": (0, DENSE, dict(max_dup=16, tile_capacity=128,
                                      exact_extra=2)),
    "street_tail_ladder": (0, DENSE, dict(max_dup=2, tile_capacity=128,
                                          exact_extra=64, dup_overscan=32,
                                          dup_tails=STREET_TAILS)),
    "street_tail_ladder_padded": (0, DENSE, dict(max_dup=2,
                                                 tile_capacity=256,
                                                 dup_overscan=32,
                                                 dup_tails=STREET_TAILS)),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_tile_bins_equal_jax_for_every_key_mode(case):
    seed, shape, kw = BIN_CASES[case]
    data = scene_data(seed, *shape)
    proj_j = data["proj"]
    proj_t = Projected(*(t(x) for x in proj_j))
    h, w = data["cam"].height, data["cam"].width
    near = threshold_pairs(proj_t, h, w, kw["max_dup"],
                           kw.get("dup_overscan", 0))
    if near:
        print(f"{case}: (row, scan slot) pairs on the cull threshold: {near}")
    got = tbin.bin_gaussians(proj_t, h, w, **kw)
    for key_mode in (None, "packed31", "packed32", "lex"):
        want = jbin.bin_gaussians(proj_j, h, w, key_mode=key_mode, **kw)
        assert_bins_equal(got, want, f"{case} key_mode={key_mode}")
    if case == "exact_overflow":
        assert int(got.tile_overflow) > 0
    if case == "exact":
        assert int(torch.max(got.counts)) > 128     # multi-window tiles
    if case == "padded_vis_capacity":
        assert int(got.vis_overflow) > 0
    if case.startswith("street"):
        # The tail ladder really emitted pairs past max_dup.
        no_tails = tbin.bin_gaussians(proj_t, h, w, **{**kw, "dup_tails": ()})
        assert int(got.dup_overflow) < int(no_tails.dup_overflow)
        assert int(got.counts.sum()) > int(no_tails.counts.sum())


def test_bin_gaussians_rejects_seg_pos(small):
    """``with_seg_pos`` gives JAX's ``seg_pos``; both packages reject it
    with visible compaction."""
    proj_t = Projected(*(t(x) for x in small["proj"]))
    got = tbin.bin_gaussians(proj_t, 48, 64, 32, 256, exact_extra=8,
                             with_seg_pos=True)
    want = jbin.bin_gaussians(small["proj"], 48, 64, 32, 256, exact_extra=8,
                              with_seg_pos=True)
    np.testing.assert_array_equal(got.seg_pos.numpy(),
                                  np.asarray(want.seg_pos))
    for binner, proj in ((tbin, proj_t), (jbin, small["proj"])):
        with pytest.raises(NotImplementedError, match="vis_capacity"):
            binner.bin_gaussians(proj, 48, 64, 32, 256, exact_extra=8,
                                 with_seg_pos=True, vis_capacity=100)


@pytest.mark.parametrize("k_cap", [128, 256, 384])
def test_k5_plain_matches_jax_slab_gather(k_cap):
    """K5's plain version against the JAX Pallas slab gather (interpret
    mode) plus the binning epilogue it fuses: rank extraction and the
    sentinel past min(count, K).  Edge rows: one of count 0, one over K,
    and a last segment that ends at the last key of ``vals``."""
    rng = np.random.default_rng(7)
    n, tiles, rank_bits = 5000, 13, 9
    vals = np.sort(rng.integers(0, 1 << 30, (n,), dtype=np.int32))
    starts = np.sort(rng.integers(0, n, (tiles,), dtype=np.int32))
    counts = np.minimum(rng.integers(0, 2 * k_cap, (tiles,)),
                        n - starts).astype(np.int32)
    counts[0] = 0
    starts[1], counts[1] = 17, 2 * k_cap + 1
    starts[-1], counts[-1] = n - k_cap // 2 - 3, k_cap // 2 + 3
    raw = np.asarray(jbin._slab_gather(jnp.asarray(vals),
                                       jnp.asarray(starts), k_cap, True))
    live = np.arange(k_cap)[None, :] < np.minimum(counts, k_cap)[:, None]
    want = np.where(live, raw & ((1 << rank_bits) - 1), n)
    got = tbin.slab_gather(torch.tensor(vals.astype(np.int64)),
                           torch.tensor(starts), torch.tensor(counts), k_cap,
                           rank_bits, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_slab_gather_checks_inputs():
    vals = torch.arange(10, dtype=torch.int64)
    starts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="counts"):
        tbin.slab_gather(vals, starts, torch.zeros(2, dtype=torch.int64),
                         128, 4, 10)
