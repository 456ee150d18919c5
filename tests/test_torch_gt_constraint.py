"""PyTorch port, the GT point-cloud constraint (``models/gt_constraint``):
the host-built index and the prune mask equal the JAX package's on the same
numpy inputs (a crowded cell over ``max_per_cell``, a chunk that does not
divide N, rows outside the x/y bounds), the twin of
tests/test_train.py::test_gt_constraint_prunes_far_points, and the loop's
densify rounds pruning through ``gt_index``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.models import gt_constraint as jgt
from street_sparse_3dgs_tpu_torch import config as tcfg
from street_sparse_3dgs_tpu_torch.core.knn import cell_key
from street_sparse_3dgs_tpu_torch.data.toy import make_toy_scene
from street_sparse_3dgs_tpu_torch.models import adam, densify
from street_sparse_3dgs_tpu_torch.models import gt_constraint as tgt
from street_sparse_3dgs_tpu_torch.models.gaussians import (GaussianMeta,
                                                           GaussianParams,
                                                           create_from_pcd)
from street_sparse_3dgs_tpu_torch.train import loop as tloop
from street_sparse_3dgs_tpu_torch.train.step import CameraBatch, init_state

torch.set_num_threads(1)


def gt_cloud(seed: int, n: int = 3000) -> np.ndarray:
    """A uniform cloud plus a crowd of 150 points in one cell."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    pts[:150] = 0.51 + rng.uniform(0, 0.05, (150, 3))
    return pts


def queries(seed: int, gt: np.ndarray, n: int = 1333) -> np.ndarray:
    """Near, far, out-of-bounds and random rows."""
    rng = np.random.default_rng(seed + 100)
    near = gt[rng.integers(0, len(gt), n // 3)] + rng.normal(0, 0.05,
                                                             (n // 3, 3))
    rand = rng.uniform(-2.5, 2.5, (n - 2 * (n // 3), 3))
    out = rng.uniform(3, 5, (n // 3, 3)) * rng.choice([-1, 1], (n // 3, 3))
    return np.concatenate([near, rand, out]).astype(np.float32)


@pytest.mark.parametrize("seed,threshold,cap", [(0, 0.3, 64), (1, 0.2, 16),
                                                (2, 0.45, 8)])
def test_build_index_matches_jax(seed, threshold, cap):
    gt = gt_cloud(seed)
    want = jgt.build_index(gt, threshold, max_per_cell=cap)
    got = tgt.build_index(gt, threshold, max_per_cell=cap, device="cpu")
    for name in ("points", "cell_keys", "cell_start", "cell_count",
                 "bounds"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert got.cap_overflow == want.cap_overflow > 0
    assert (got.cell_size, got.max_per_cell) == (want.cell_size,
                                                 want.max_per_cell)


@pytest.mark.parametrize("seed,threshold,cap,chunk", [
    (0, 0.3, 64, 500), (1, 0.2, 16, 333), (2, 0.45, 8, 4096)])
def test_too_far_mask_matches_jax(seed, threshold, cap, chunk):
    """Equal masks, every cell capped at ``cap`` (the crowd overflows it),
    ``chunk`` not dividing N, a third of the rows outside the bounds."""
    gt = gt_cloud(seed)
    xyz = queries(seed, gt)
    active = np.random.default_rng(seed).uniform(0, 1, len(xyz)) > 0.1
    want = np.asarray(jgt.too_far_mask(
        jgt.build_index(gt, threshold, max_per_cell=cap), jnp.asarray(xyz),
        jnp.asarray(active), chunk=chunk))
    got = tgt.too_far_mask(
        tgt.build_index(gt, threshold, max_per_cell=cap, device="cpu"),
        torch.tensor(xyz), torch.tensor(active), chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < active.sum()


def test_cell_hash_wraps_like_jax():
    """The device hash's int32 wrap-around equals the host build's 64->32
    truncation, on cells whose products overflow 32 bits."""
    cells = np.array([[1000, -2000, 3000], [-7, 9, 123456], [0, 0, 0],
                      [40000, 40000, -40000]], np.int64)
    np.testing.assert_array_equal(
        cell_key(torch.tensor(cells)).numpy(), jgt._cell_key(cells))


def test_gt_constraint_prunes_far_points():
    """Twin of tests/test_train.py:213: active rows inside the GT x/y
    bounds with no GT point within the threshold are pruned; near rows and
    rows outside the bounds survive; in densify, far rows deactivate and
    are not cloned."""
    rng = np.random.default_rng(0)
    gt = rng.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    index = tgt.build_index(gt, threshold=0.3, device="cpu")
    near = gt[:10] + 0.01
    far = np.full((5, 3), 0.0, np.float32)
    far[:, 2] = 50.0
    outside = np.full((5, 3), 10.0, np.float32)
    xyz = torch.tensor(np.concatenate([near, far, outside]))
    mask = tgt.too_far_mask(index, xyz, torch.ones(20, dtype=torch.bool),
                            chunk=8)
    m = mask.numpy()
    assert not m[:10].any() and m[10:15].all() and not m[15:].any()

    cap = 32
    xyz_full = torch.zeros((cap, 3))
    xyz_full[:20] = xyz
    quats = torch.zeros((cap, 4))
    quats[:, 0] = 1.0
    params = GaussianParams(
        xyz=xyz_full, features_dc=torch.zeros((cap, 1, 3)),
        features_rest=torch.zeros((cap, 15, 3)),
        log_scales=torch.full((cap, 3), -3.0), quats=quats,
        opacity_raw=torch.full((cap, 1), 2.0))
    active = torch.arange(cap) < 20
    extra = torch.zeros(cap, dtype=torch.bool)
    extra[:20] = mask
    res = densify.densify_and_prune(
        torch.zeros((2, cap, 3)), params, active, adam.init(params),
        densify.DensifyState(torch.ones(cap), torch.ones(cap),
                             torch.full((cap,), 10.0)),
        GaussianMeta(sh_degree=3, capacity=cap), grad_threshold=0.01,
        min_opacity=0.005, extent=100.0, percent_dense=0.01,
        extra_prune=extra)
    assert int(res.n_active) == 30
    live = res.params.xyz[res.active].numpy()
    for f in far:
        assert not np.any(np.all(np.abs(live - f) < 1e-5, axis=-1))


def test_loop_densify_prunes_through_gt_index():
    """train_loop with a ``gt_index``: the rows lifted far above the GT
    cloud (inside its x/y bounds) are gone after the densify round, and
    no other row is lost to the constraint."""
    scene = make_toy_scene(seed=4, n=200, n_cameras=2, width=48, height=48,
                           device="cpu")
    gt = scene.means3d.numpy()
    pts = scene.means3d.clone()
    pts[:20, 2] += 5.0
    params, active, meta = create_from_pcd(pts, torch.full((200, 3), 0.5),
                                           capacity=256)
    state = init_state(params, active, n_images=2)
    batches = [CameraBatch(
        camera=c, gt_image=torch.full((3, 48, 48), 0.3),
        alpha_mask=torch.ones((1, 48, 48)),
        mono_invdepth=torch.zeros((1, 48, 48)),
        depth_mask=torch.zeros((1, 48, 48)),
        depth_reliable=torch.tensor(False), image_index=torch.tensor(i))
        for i, c in enumerate(scene.cameras)]
    opt = tcfg.OptimizationConfig(
        iterations=3, densification_interval=2, densify_from_iter=1,
        densify_until_iter=10, opacity_reset_interval=1000,
        densify_grad_threshold=1e9)
    index = tgt.build_index(gt, threshold=0.2, device="cpu")
    state, meta, stats = tloop.train_loop(
        state, meta, batches, opt, tcfg.PipelineConfig(tile_capacity=256),
        tcfg.ModelConfig(), cameras_extent=3.0, spatial_lr_scale=1.0,
        clamp_fraction=1.0, gt_index=index)
    assert len(stats["n_active"]) == 1
    assert not state.active[:20].any()
    # The opacity prune (min 0.005) keeps the 0.01-opacity init rows.
    assert bool(state.active[20:200].all())
