"""PyTorch port, kernel-floor probes D1-D3: the plain versions of the stub
kernel (``tools/kernel_floor.py``) against the TPU stub bodies of
``tools/kernel_floor_tpu.py`` (``_make_stub_kernel``, ``_make_stub_kernel_t``)
run in interpret mode, on a small JAX exact binning padded to the tile
batch as that tool pads it.  Levels 0, -1 and -2 must be equal; levels 2 and
1 (f32 sums in another order) within rtol 1e-5.  The plain twin of the
stubs' window split (``blend_exact_stub_split_plain``, on K3's block
tables) against the closed form and against the TPU stubs in interpret
mode, within ``stub_error``'s bars."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.ops import pallas_blend as pb
from street_sparse_3dgs_tpu.ops.binning import bin_gaussians
from street_sparse_3dgs_tpu.ops.preprocess import project_gaussians
from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
from street_sparse_3dgs_tpu_torch.tools import kernel_floor as kf
from tools import kernel_floor_tpu as kft

torch.set_num_threads(1)
W, H = 256, 64
EXTRA = 64
BG = np.array([[0.25, 0.5, 0.75]], np.float32)


@functools.lru_cache(maxsize=None)
def binning():
    """A JAX exact binning with multi-window tiles, partly filled and empty
    windows and unused budget windows; its meta padded to a multiple of the
    tile batch as ``kernel_floor_tpu.py:201-215`` does."""
    scene = make_toy_scene(seed=1, n=2000, n_cameras=1, width=W, height=H,
                           radius=7.0)
    proj = project_gaussians(scene.means3d, scene.scales, scene.quats,
                             scene.opacities, scene.sh_coeffs,
                             scene.cameras[0], 3)
    bins = bin_gaussians(proj, H, W, 32, kf.KCAP, exact_extra=EXTRA)
    attrs = pb.pack_gather_attrs(
        bins.gather, proj.mean2d, proj.conic, proj.color, proj.opacity,
        proj.inv_depth, order=bins.order, rank=bins.rank, pair_major=True)
    t_total = bins.tiles_x * bins.tiles_y
    nv = bins.t_of_v.shape[0]
    tb = 8
    pad = -nv % tb
    t_safe = jnp.minimum(bins.t_of_v, t_total - 1)
    is_last = ((bins.t_of_v >= t_total)
               | (jnp.arange(nv, dtype=jnp.int32)
                  == bins.last_v[t_safe])).astype(jnp.int32)
    meta = jnp.stack([t_safe, bins.wt, bins.vcounts, is_last])
    if pad:
        meta = jnp.concatenate(
            [meta, jnp.zeros((4, pad), jnp.int32).at[pb.MT_LAST].set(1)],
            axis=1)
        attrs = jnp.concatenate(
            [attrs, jnp.zeros((pad,) + attrs.shape[1:], attrs.dtype)])
    return (np.asarray(meta), np.asarray(attrs), np.asarray(bins.vcounts),
            np.asarray(bins.wt), np.asarray(bins.last_v), bins.tiles_x)


def run_jax_stub(level: int, transposed: bool, tb: int,
                 channels: int = pb.N_CH) -> np.ndarray:
    """The TPU stub of ``level`` (``_make_stub_kernel_t`` when
    ``transposed``) in a ``pallas_call`` built as ``run_stub`` /
    ``run_stub_t`` / ``run_stub_tb`` build it, interpreted; returns the
    output at each real tile's last window [T, 8, 256].

    The transposed stub takes its window width from the channel axis
    (``k_cap = attrs_ref.shape[2]``, ``kernel_floor_tpu.py:120``): with the
    tool's pair-major [tb, K, 10] block that is 10, so it walks no block.
    ``channels = K`` zero-pads the channel axis to K, and the body then
    walks each window as its docstring says."""
    meta, attrs, _, _, last_v, tiles_x = binning()
    nvp = attrs.shape[0]
    if transposed:
        attrs = np.concatenate([attrs, np.zeros(
            attrs.shape[:2] + (channels - pb.N_CH,), attrs.dtype)], axis=2)
        make, block, scratch = kft._make_stub_kernel_t, (tb, kf.KCAP,
                                                         channels), \
            pltpu.VMEM((8, pb.P), jnp.float32)
    else:
        attrs = np.ascontiguousarray(np.swapaxes(attrs, 1, 2))
        make, block, scratch = kft._make_stub_kernel, (tb, pb.N_CH, kf.KCAP), \
            pltpu.VMEM((pb.P, 8), jnp.float32)
    out = pl.pallas_call(
        make(tiles_x, tb, level), grid=(nvp // tb,),
        in_specs=[pl.BlockSpec((4, nvp), lambda i: (0, 0),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec(block, lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 3), lambda i: (0, 0),
                               memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((tb, pb.N_OUT, pb.P), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nvp, pb.N_OUT, pb.P), jnp.float32),
        scratch_shapes=[scratch], interpret=True,
    )(jnp.asarray(meta), jnp.asarray(attrs), jnp.asarray(BG))
    return np.asarray(out)[last_v]


def port_plain(level: int, pair_major: bool):
    _, attrs, vcounts, wt, last_v, tiles_x = binning()
    a = torch.tensor(attrs[:vcounts.shape[0]])
    if not pair_major:
        a = a.transpose(1, 2).contiguous()
    out, terms = kf.blend_exact_stub_plain(
        a, torch.tensor(vcounts), torch.tensor(wt), torch.tensor(last_v),
        torch.tensor(BG), tiles_x, level, pair_major)
    return out.numpy(), terms.numpy()


def test_fixture_has_every_window_kind():
    """Tiles over several windows, partly filled and empty windows, and
    budget windows no tile uses."""
    _, _, vcounts, wt, last_v, _ = binning()
    assert (wt[last_v] >= 2).any()
    assert ((vcounts > 0) & (vcounts < kf.KCAP)).any()
    used = int((wt[last_v] + 1).sum())
    assert (vcounts[:used] == 0).any()
    assert used < vcounts.shape[0]


@pytest.mark.parametrize("level", kf.LEVELS_D1)
def test_d1_plain_matches_jax_stub(level):
    want = run_jax_stub(level, transposed=False, tb=8)
    got, _ = port_plain(level, pair_major=False)
    if level >= 1:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", kf.LEVELS_D2)
def test_d2_plain_matches_jax_transposed_stub(level):
    want = run_jax_stub(level, transposed=True, tb=8, channels=kf.KCAP)
    got, _ = port_plain(level, pair_major=True)
    if level >= 1:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", kf.LEVELS_D2)
def test_d2_tpu_layout_walks_no_block(level):
    """In the TPU tool's own layout the transposed stub reads K = 10 and
    walks no 128-lane block: every output is bg alone, so its timings there
    measured the carry and the writes only."""
    np.testing.assert_array_equal(run_jax_stub(level, transposed=True, tb=8),
                                  np.full((binning()[4].shape[0], pb.N_OUT,
                                           pb.P), BG[0, 0], np.float32))


@pytest.mark.parametrize("tb", [16, 32])
def test_d3_plain_matches_jax_tile_batch_sweep(tb):
    """The level-0 stub at the TPU's tile batches 16 and 32 (``run_stub_tb``)
    against the plain D3 at every ``tiles_per_block`` of the card's sweep:
    the value depends on neither."""
    assert binning()[1].shape[0] % tb == 0
    want = run_jax_stub(0, transposed=False, tb=tb)
    _, attrs, vcounts, wt, last_v, tiles_x = binning()
    a = torch.tensor(np.ascontiguousarray(np.swapaxes(attrs, 1, 2)))
    for tpb in kf.TILES_PER_BLOCK_D3:
        got = kf.blend_exact_stub(
            a, torch.tensor(vcounts), torch.tensor(wt), torch.tensor(last_v),
            torch.tensor(BG), tiles_x, 0, False, tpb)
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_and_bound():
    """The CPU wrapper returns the plain output, refuses a wrong layout or
    level, and the bound counts the walked slots."""
    _, attrs, vcounts, wt, last_v, tiles_x = binning()
    a = torch.tensor(attrs)
    args = (torch.tensor(vcounts), torch.tensor(wt), torch.tensor(last_v),
            torch.tensor(BG), tiles_x)
    got = kf.blend_exact_stub(a, *args, 2, True)
    np.testing.assert_array_equal(got.numpy(), port_plain(2, True)[0])
    with pytest.raises(ValueError):
        kf.blend_exact_stub(a, *args, 2, False)
    with pytest.raises(ValueError):
        kf.blend_exact_stub(a, *args, 3, True)
    blocks = -(-np.minimum(vcounts, kf.KCAP) // 128)
    used = int((wt[last_v] + 1).sum())
    _, by, walked = kf.stub_bound(*args[:3], kf.KCAP, 2)
    assert walked == int(blocks[:used].sum()) * 128 and by == "operations"
    assert kf.stub_bound(*args[:3], kf.KCAP, -2)[2] == used * kf.KCAP


def test_stub_error_bars():
    """Levels 2 and 1 hold SUM_RTOL x sum|terms|; lower levels must be
    equal."""
    _, terms = port_plain(2, True)
    want = torch.zeros((terms.shape[0], 8, 256))
    t = torch.tensor(terms)
    assert kf.stub_error(want + 0.5 * kf.SUM_RTOL * t[:, None, :], want, t,
                         2) > 0
    with pytest.raises(AssertionError):
        kf.stub_error(want + 3 * kf.SUM_RTOL * t[:, None, :] + 1e-30, want,
                      t, 1)
    with pytest.raises(AssertionError):
        kf.stub_error(want + 1e-7, want, t, 0)


def layout_tensors(pair_major: bool):
    _, attrs, vcounts, wt, last_v, tiles_x = binning()
    a = torch.tensor(attrs[:vcounts.shape[0]])
    if not pair_major:
        a = a.transpose(1, 2).contiguous()
    return (a, torch.tensor(vcounts), torch.tensor(wt), torch.tensor(last_v),
            torch.tensor(BG), tiles_x)


SPLIT_CASES = [(group, probe, level) for group in (1, 2, 3)
               for probe, levels in (("D1", kf.LEVELS_D1),
                                     ("D2", kf.LEVELS_D2))
               for level in levels]


@pytest.mark.parametrize("group,probe,level", SPLIT_CASES)
def test_split_plain_matches_closed_form(group, probe, level):
    """At groups of 1, 2 and 3 windows (the fixture's tiles have up to 4,
    so every group splits some), the split's plain twin equals the closed
    form: levels 0, -1, -2 exactly, 2 and 1 within SUM_RTOL of each pixel's
    sum of |terms|."""
    args = layout_tensors(probe == "D2") + (level, probe == "D2")
    table = cb.exact_split_plan(*args[1:4], group)[0]
    assert (table[:, 3] >= 0).any()
    want, terms = kf.blend_exact_stub_plain(*args)
    got = kf.blend_exact_stub_split_plain(*args, group=group)
    assert got.shape == want.shape
    kf.stub_error(got, want, terms, level)


@functools.lru_cache(maxsize=None)
def jax_stub_out(level: int, pair_major: bool) -> np.ndarray:
    """The TPU stub's output of ``level`` on the fixture: D2's transposed
    stub with its channel axis padded to K, D1's as the tool runs it."""
    return run_jax_stub(level, transposed=pair_major, tb=8,
                        channels=kf.KCAP if pair_major else pb.N_CH)


@pytest.mark.parametrize("group,probe,level", SPLIT_CASES)
def test_split_plain_matches_jax_stub(group, probe, level):
    """The split's plain twin at groups of 1, 2 and 3 windows against the
    TPU stub bodies run in interpret mode (``run_jax_stub``): levels 0, -1,
    -2 exactly, 2 and 1 within ``stub_error``'s bars (SUM_RTOL of each
    pixel's sum of |terms|)."""
    pm = probe == "D2"
    args = layout_tensors(pm) + (level, pm)
    got = kf.blend_exact_stub_split_plain(*args, group=group)
    want = torch.tensor(jax_stub_out(level, pm))
    assert got.shape == want.shape
    kf.stub_error(got, want, torch.tensor(port_plain(level, pm)[1]), level)


@pytest.mark.parametrize("group", [1, 2, 3])
def test_bound_counts_phase_a(group):
    """The bound's walked slots are the split's walk: each tile's live
    blocks once, and the windows of its middle groups (neither the first
    nor the last) once more, for phase A."""
    _, _, vcounts, wt, last_v, _ = binning()
    blocks = -(-np.minimum(vcounts, kf.KCAP) // 128)
    want = 0
    for vl in last_v:
        nw = int(wt[vl]) + 1
        first = int(vl) - nw + 1
        want += int(blocks[first:first + nw].sum())
        if nw > group:
            for g in range(1, -(-nw // group) - 1):
                v0 = first + g * group
                want += int(blocks[v0:v0 + group].sum())
    args = [torch.tensor(x) for x in (vcounts, wt, last_v)]
    assert kf.stub_bound(*args, kf.KCAP, 2, group)[2] == want * 128
    assert kf.stub_bound(*args, kf.KCAP, 2, 0)[2] == \
        int(blocks[:int((wt[last_v] + 1).sum())].sum()) * 128
