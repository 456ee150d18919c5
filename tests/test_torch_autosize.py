"""PyTorch port, self-sizing exact mode (``ops/autosize.py`` and the
loop's ``exact_extra=-1``): the ladder, the kept probe and the knobs equal
the JAX package's on the same inputs (the toy scene of
tests/test_autosize.py), and the port's twins of that file's knob and loop
tests, plus a re-autosize after a capacity growth."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.models import gaussians as jg
from street_sparse_3dgs_tpu.ops import autosize as jauto
from street_sparse_3dgs_tpu.ops.binning import num_tiles
from street_sparse_3dgs_tpu.ops.preprocess import project_gaussians as jproj
from street_sparse_3dgs_tpu.ops.rasterize import (RasterConfig as JRaster,
                                                  rasterize as j_rasterize)
from street_sparse_3dgs_tpu.train import step as jstep
from street_sparse_3dgs_tpu_torch import config as tcfg
from street_sparse_3dgs_tpu_torch import convert
from street_sparse_3dgs_tpu_torch.models import gaussians as tg
from street_sparse_3dgs_tpu_torch.ops import autosize as tauto
from street_sparse_3dgs_tpu_torch.ops.binning import bin_gaussians
from street_sparse_3dgs_tpu_torch.ops.preprocess import (Projected,
                                                         project_gaussians)
from street_sparse_3dgs_tpu_torch.train import loop as tloop

torch.set_num_threads(1)
W, H = 64, 48


def fields(x):
    return {k: (fields(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in x._asdict().items()}


@functools.lru_cache(maxsize=None)
def jscene():
    return make_toy_scene(seed=0, n=384, n_cameras=3, width=W, height=H)


@functools.lru_cache(maxsize=None)
def tscene():
    """The JAX toy scene's rows and cameras as CPU tensors."""
    s = jscene()
    rows = tuple(torch.tensor(np.asarray(x)) for x in
                 (s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs))
    cams = [convert.camera_from_numpy(fields(c), "cpu") for c in s.cameras]
    return rows, cams


def knobs_kw(**kw):
    return {"max_dup": 0, "probe_rows": 256, "probe_scan": 256, **kw}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_derive_ladder_matches_jax(seed):
    """Host numpy in both: the same (overscan, tails) on the same
    arrays."""
    rng = np.random.default_rng(seed)
    cov = np.sort(rng.geometric(0.02 * (seed + 1), 5000))[::-1]
    kept = np.minimum(cov[:300], rng.integers(1, 400, 300))
    for max_dup, scan_cap in ((2, 64), (4, 256), (8, 1024)):
        args = (kept, cov, max_dup, scan_cap, 1.25)
        assert tauto.derive_ladder(*args) == jauto.derive_ladder(*args)


def test_kept_probe_matches_jax():
    """The exact surviving-tile counts of the 256 rows of largest coverage,
    element by element, on JAX's projection of view 0 (scan 256)."""
    s = jscene()
    proj = jproj(s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs,
                 s.cameras[0], 3)
    tx, ty = num_tiles(H, W)
    cov = jauto._coverage_pass(proj, tx, ty)
    _, rows = jax.lax.top_k(cov, 256)
    want = np.asarray(jauto._kept_probe(proj, rows, 256, tx, ty))
    tproj = Projected(*(torch.tensor(np.asarray(x)) for x in proj))
    tcov = tauto._coverage_pass(tproj, tx, ty)
    np.testing.assert_array_equal(tcov.numpy(), np.asarray(cov))
    trows = torch.sort(tcov, descending=True, stable=True).indices[:256]
    np.testing.assert_array_equal(trows.numpy(), np.asarray(rows))
    got = tauto._kept_probe(tproj, trows, 256, tx, ty)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) >= 3


@pytest.mark.parametrize("kw", [knobs_kw(), knobs_kw(max_dup=2, margin=1.5),
                                knobs_kw(scan_cap=8, scan_cap_max=64,
                                         shards=2)])
def test_autosize_raster_matches_jax(kw):
    """Equal ExactKnobs on the 64x48, 384-row toy scene (self-sized base
    width, a fixed one, and an escalating scan window with two shards)."""
    s = jscene()
    want = jauto.autosize_raster(
        s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs,
        list(s.cameras), 3, H, W, 128, **kw)
    rows, cams = tscene()
    got = tauto.autosize_raster(*rows, cams, 3, H, W, 128, **kw)
    assert got == want
    assert got.exact_extra % (128 * kw.get("shards", 1)) == 0


def test_knobs_bind_every_view_clean():
    """Twin of tests/test_autosize.py: the knobs bind every view with no
    window overflow and at most the expected emission overflow."""
    rows, cams = tscene()
    knobs = tauto.autosize_raster(*rows, cams, 3, H, W, 128, **knobs_kw())
    assert knobs.exact_extra > 0 and knobs.exact_extra % 128 == 0
    assert knobs.max_dup in (2, 4, 8, 16)
    for cam in cams:
        proj = project_gaussians(*rows, cam, 3)
        bins = bin_gaussians(proj, H, W, knobs.max_dup, 128,
                             dup_tails=knobs.dup_tails,
                             dup_overscan=knobs.dup_overscan,
                             exact_extra=knobs.exact_extra)
        assert int(bins.tile_overflow) == 0
        assert int(bins.dup_overflow) <= knobs.expected_dup_overflow


@functools.lru_cache(maxsize=None)
def model_and_batches(capacity=512):
    """tests/test_autosize.py's model (JAX init from the scene points) and
    batches (tiled GT), converted to the port on the CPU."""
    s = jscene()
    key = jax.random.PRNGKey(0)
    pts = np.asarray(s.means3d)
    cols = np.clip(np.asarray(s.sh_coeffs[:, 0, :]) * 0.28 + 0.5, 0, 1)
    params, active, meta = jg.create_from_pcd(key, pts, cols, sh_degree=3,
                                              capacity=capacity)
    batches = []
    for i, cam in enumerate(s.cameras):
        gt = jnp.clip(j_rasterize(
            s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs, cam, 3,
            jnp.zeros(3), JRaster(method="tiled",
                                  tile_capacity=600))["render"], 0.0, 1.0)
        batches.append(jstep.CameraBatch(
            camera=cam, gt_image=gt, alpha_mask=jnp.ones((1, H, W)),
            mono_invdepth=jnp.zeros((1, H, W)),
            depth_mask=jnp.zeros((1, H, W)),
            depth_reliable=jnp.array(False), image_index=jnp.int32(i)))
    state = jstep.init_state(params, active, n_images=len(batches))
    return (convert.train_state_from_numpy(fields(state), "cpu"),
            convert.config_from(meta, tg.GaussianMeta),
            [convert.camera_batch_from_numpy(fields(b), "cpu")
             for b in batches])


OPT = dict(position_lr_init=2e-4, position_lr_final=2e-6)


def test_loop_grows_budget_until_clean():
    """Twin of tests/test_autosize.py: a starved budget grows, skipped
    updates are counted, and updates apply again."""
    state, meta, batches = model_and_batches()
    pipe = tcfg.PipelineConfig(raster_method="pallas", tile_capacity=128,
                               max_dup=32, exact_extra=1,
                               grad_reduce="counts")
    x0 = state.params.features_dc.clone()
    state, meta, stats = tloop.train_loop(
        state, meta, batches, tcfg.OptimizationConfig(iterations=8, **OPT),
        pipe, tcfg.ModelConfig(), cameras_extent=2.0, spatial_lr_scale=1.0,
        iterations=8, densify_enabled=False)
    assert stats["exact_growths"] >= 1
    assert stats["skipped_updates"] >= 1
    assert stats["final_pipe"].exact_extra > 1
    assert float((state.params.features_dc - x0).abs().max()) > 0


def test_loop_autosizes_from_sentinel():
    """Twin of tests/test_autosize.py: exact_extra == -1 resolves to the
    knobs JAX's loop measures on the same state before the first step, and
    the run binds clean."""
    state, meta, batches = model_and_batches()
    pipe = tcfg.PipelineConfig(raster_method="pallas", tile_capacity=128,
                               exact_extra=-1, grad_reduce="counts")
    want = jauto.autosize_raster(
        *(jnp.asarray(x.numpy()) for x in (
            state.params.xyz, tg.activate_scales(state.params),
            state.params.quats, tg.activate_opacity(state.params, meta),
            tg.sh_coeffs(state.params))),
        list(jscene().cameras), 3, H, W, 128, max_dup=0,
        active_mask=jnp.asarray(state.active.numpy()),
        scan_cap_max=int(min(256, max(32, (1 << 28) // meta.capacity))))
    _, _, stats = tloop.train_loop(
        state, meta, batches, tcfg.OptimizationConfig(iterations=4, **OPT),
        pipe, tcfg.ModelConfig(), cameras_extent=2.0, spatial_lr_scale=1.0,
        iterations=4, densify_enabled=False)
    final = stats["final_pipe"]
    assert (final.max_dup, final.dup_overscan, tuple(final.dup_tails),
            final.exact_extra) == (want.max_dup, want.dup_overscan,
                                   want.dup_tails, want.exact_extra)
    assert stats["tile_overflow"] == 0
    assert stats["skipped_updates"] == 0


def test_loop_reautosizes_after_capacity_growth(monkeypatch):
    """Densification in auto mode overflows the capacity: the loop grows
    it and measures the knobs again on the grown model (a second
    autosize), and the exact budget check runs on the resolved config."""
    s = jscene()
    n = 384
    rows, _ = tscene()
    _, meta, batches = model_and_batches()
    params = tg.GaussianParams(
        xyz=rows[0].clone(), features_dc=rows[4][:, :1].clone(),
        features_rest=rows[4][:, 1:].clone(), log_scales=torch.log(rows[1]),
        quats=rows[2].clone(),
        opacity_raw=tg.inverse_sigmoid(rows[3])[:, None])
    params, active = tg.pad_to_capacity(params, n, 400)
    from street_sparse_3dgs_tpu_torch.train.step import init_state
    state = init_state(params, active, n_images=len(s.cameras))
    meta = dataclasses.replace(meta, capacity=400)
    calls = []
    real = tloop.autosize_pipeline

    def counted(pipe, state_, meta_, batches_, **kw):
        calls.append(meta_.capacity)
        return real(pipe, state_, meta_, batches_, **kw)

    monkeypatch.setattr(tloop, "autosize_pipeline", counted)
    opt = tcfg.OptimizationConfig(
        iterations=4, densification_interval=2, densify_from_iter=1,
        densify_until_iter=10, opacity_reset_interval=1000,
        densify_grad_threshold=1e-9, **OPT)
    pipe = tcfg.PipelineConfig(raster_method="pallas", tile_capacity=128,
                               exact_extra=-1, grad_reduce="counts")
    state, meta, stats = tloop.train_loop(
        state, meta, batches, opt, pipe, tcfg.ModelConfig(),
        cameras_extent=2.0, spatial_lr_scale=1.0, clamp_fraction=1.0)
    assert stats["overflows"] >= 1 and meta.capacity > 400
    assert calls[0] == 400 and len(calls) == 1 + stats["overflows"]
    assert calls[1] == meta.capacity or stats["overflows"] > 1
    assert stats["final_pipe"].exact_extra > 0
    assert len(stats["losses"]) == 4
    assert int(state.active.sum()) > n


def test_autosize_refuses_a_one_shot_stream():
    """Sampling views from an iterator would drop them from training."""
    state, meta, batches = model_and_batches()
    pipe = tcfg.PipelineConfig(raster_method="pallas", tile_capacity=128,
                               exact_extra=-1)
    with pytest.raises(TypeError, match="re-iterable"):
        tloop.autosize_pipeline(pipe, state, meta, iter(batches))
