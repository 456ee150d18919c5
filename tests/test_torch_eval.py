"""PyTorch port, evaluation: the metrics, LPIPS (random-feature weights,
masked and unmasked, batched, and a weights file on disk), the τ-sweep
``render_hierarchy_eval`` and the ``render_position`` probe on a tiny
COLMAP project, and ``group_cameras_by_center``, each against the JAX
package on the same inputs.  Tolerances are stated per test."""

import functools
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.config import ModelConfig as JModelConfig
from street_sparse_3dgs_tpu.config import PipelineConfig as JPipelineConfig
from street_sparse_3dgs_tpu.data import colmap as jcolmap
from street_sparse_3dgs_tpu.data.scene import load_scene_info as j_load
from street_sparse_3dgs_tpu.data.toy import lookat_camera, make_toy_scene
from street_sparse_3dgs_tpu.eval import lpips_jax as jlpips
from street_sparse_3dgs_tpu.eval import metrics as jm
from street_sparse_3dgs_tpu.eval import render_hier as jrh
from street_sparse_3dgs_tpu.eval import render_position as jrp
from street_sparse_3dgs_tpu.hierarchy import render as jrender
from street_sparse_3dgs_tpu.hierarchy import structure as jst
from street_sparse_3dgs_tpu.hierarchy.build import build_hierarchy
from street_sparse_3dgs_tpu.models.gaussians import GaussianParams
from street_sparse_3dgs_tpu.ops.rasterize import RasterConfig as JRaster
from street_sparse_3dgs_tpu_torch import convert
from street_sparse_3dgs_tpu_torch.config import ModelConfig, PipelineConfig
from street_sparse_3dgs_tpu_torch.data import png
from street_sparse_3dgs_tpu_torch.data.scene import load_scene_info
from street_sparse_3dgs_tpu_torch.eval import lpips as tlpips
from street_sparse_3dgs_tpu_torch.eval import metrics as tm
from street_sparse_3dgs_tpu_torch.eval import render_hier as trh
from street_sparse_3dgs_tpu_torch.eval import render_position as trp

torch.set_num_threads(1)
W, H = 64, 48


def images(seed=0, shape=(3, H, W)):
    rng = np.random.default_rng(seed)
    img = rng.random(shape).astype(np.float32)
    gt = np.clip(img + 0.08 * rng.normal(size=shape), 0, 1).astype(
        np.float32)
    mask = (rng.random((1,) + shape[1:]) > 0.3).astype(np.float32)
    return img, gt, mask


@pytest.mark.parametrize("name", ["psnr", "ssim", "psnr_masked",
                                  "ssim_masked"])
def test_image_metrics_match_jax(name):
    """PSNR and SSIM, plain and masked, on numpy inputs and on tensors:
    within rtol 1e-6 (float32 sums in another order)."""
    img, gt, mask = images()
    args = (img, gt, mask) if name.endswith("masked") else (img, gt)
    want = getattr(jm, name)(*args)
    for a in (args, tuple(torch.tensor(x) for x in args)):
        got = getattr(tm, name)(*a)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_depth_metrics_and_masks_match_jax():
    """iMAE / iRMSE within rtol 1e-6; the depth-band and category masks and
    the pixel-weighted aggregate equal to JAX's exactly."""
    rng = np.random.default_rng(3)
    pred = rng.uniform(0.0, 0.5, (1, H, W)).astype(np.float32)
    gt = rng.uniform(0.0, 0.5, (1, H, W)).astype(np.float32)
    gt[0, :5] = 0.0
    valid = rng.random((1, H, W)) > 0.2
    np.testing.assert_allclose(tm.inverse_depth_errors(pred, gt, valid),
                               jm.inverse_depth_errors(pred, gt, valid),
                               rtol=1e-6)
    alpha = (rng.random((1, H, W)) > 0.1).astype(np.float32)
    for a in (None, alpha):
        want = jm.depth_band_masks(gt, a)
        got = tm.depth_band_masks(torch.tensor(gt),
                                  None if a is None else torch.tensor(a))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    colors = list(tm.CATEGORY_GROUPS.values())
    seg = np.zeros((3, H, W), np.float32)
    for i, c in enumerate(colors):
        rgb = [int(c[j:j + 2], 16) / 255.0 for j in (1, 3, 5)]
        seg[:, :, 10 * i:10 * i + 10] = np.array(rgb, np.float32)[:, None,
                                                                 None]
    seg += rng.normal(0, 0.02, seg.shape).astype(np.float32)
    want = jm.category_masks(seg, jm.CATEGORY_GROUPS)
    got = tm.category_masks(torch.tensor(seg), tm.CATEGORY_GROUPS)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    rows = [{"psnr": 20.0, "ssim": 0.5}, {"psnr": float("nan"), "ssim": 0.7},
            {"psnr": 30.0, "ssim": 0.9}]
    for weights in ([1.0, 2.0, 3.0], [0.0, 0.0, 0.0]):
        a = tm.aggregate_pixel_weighted(rows, weights)
        b = jm.aggregate_pixel_weighted(rows, weights)
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(list(a.values()), list(b.values()))
    assert tm.aggregate_pixel_weighted([], []) == {}


@pytest.mark.parametrize("with_depth", [False, True])
def test_full_metrics_matches_jax(with_depth):
    """The per-view metric row (random-feature LPIPS included): rtol 1e-4
    for LPIPS (JAX convolves at Precision.HIGH, f32 on the CPU), 1e-6 for
    the rest."""
    img, gt, mask = images(5)
    kw = {}
    if with_depth:
        rng = np.random.default_rng(6)
        kw = dict(pred_invdepth=rng.random((1, H, W)).astype(np.float32),
                  gt_invdepth=rng.random((1, H, W)).astype(np.float32))
    want = jm.full_metrics(img, gt, mask, **kw)
    got = tm.full_metrics(torch.tensor(img), torch.tensor(gt),
                          torch.tensor(mask),
                          **{k: torch.tensor(v) for k, v in kw.items()})
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k],
                                   rtol=1e-4 if k == "lpips" else 1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("shape", [(48, 64), (50, 70)])
def test_lpips_matches_jax(shape):
    """LPIPS with the random-feature weights (numpy seed 0 in both
    packages), unmasked and masked (the mask downsampled with an
    antialiased bilinear filter, as jax.image.resize does), and
    lpips_batch (one identical pair: 0 in both, within atol 1e-12): within
    rtol 1e-4 of lpips_jax; the weights equal."""
    assert tlpips.weights_kind() == jlpips.weights_kind() == "random"
    wj, wt = jlpips._random_weights(), tlpips._random_weights()
    assert wj.keys() == wt.keys()
    for k in wj:
        np.testing.assert_array_equal(wt[k], wj[k])
    img, gt, mask = images(1, (3,) + shape)
    np.testing.assert_allclose(
        tlpips.lpips(torch.tensor(img), torch.tensor(gt)),
        jlpips.lpips(img, gt), rtol=1e-4)
    np.testing.assert_allclose(
        tlpips.lpips(img, gt, mask=mask),
        jlpips.lpips(img, gt, mask=mask), rtol=1e-4)
    imgs = np.stack([img, gt, img[:, ::-1].copy()])
    gts = np.stack([gt, gt, img])
    np.testing.assert_allclose(tlpips.lpips_batch(torch.tensor(imgs),
                                                  torch.tensor(gts)),
                               jlpips.lpips_batch(imgs, gts), rtol=1e-4,
                               atol=1e-12)


def test_lpips_weights_file_on_disk(tmp_path):
    """A weights bundle already on disk (here: random values tagged
    calibrated, in the JAX package's format) is used by both packages
    alike: the same kind and distances within rtol 1e-4."""
    w = jlpips._random_weights(seed=4)
    w["kind"] = np.array("calibrated")
    path = str(tmp_path / "lpips_vgg.npz")
    np.savez(path, **w)
    assert tlpips.weights_kind(path) == jlpips.weights_kind(path) == \
        "calibrated"
    img, gt, _ = images(2)
    np.testing.assert_allclose(
        tlpips.lpips(img, gt, weights_path=path),
        jlpips.lpips(img, gt, weights_path=path), rtol=1e-4)


# ---- the eval drivers on a tiny project ---------------------------------

CENTERS = [np.array([3.0, 0.2, 1.0]), np.array([0.3, 3.0, 1.2]),
           np.array([-3.0, -0.4, 0.8]), np.array([3.0, 0.2, 1.0])]
TARGETS = [np.zeros(3), np.zeros(3), np.zeros(3), np.array([0.0, 1.0, 0.0])]
DEPTH_SCALE, DEPTH_OFFSET = 0.6, 0.02


@functools.lru_cache(maxsize=None)
def hierarchy():
    s = make_toy_scene(seed=4, n=100, n_cameras=1, width=W, height=H)
    params = GaussianParams(
        xyz=s.means3d, features_dc=s.sh_coeffs[:, :1, :],
        features_rest=s.sh_coeffs[:, 1:, :], log_scales=jnp.log(s.scales),
        quats=s.quats, opacity_raw=s.opacities[:, None])
    h_j = build_hierarchy(params, opacity_activation="abs")
    f = {k: np.asarray(getattr(h_j, k)) for k in h_j._fields[1:-1]}
    f["params"] = {k: np.asarray(v) for k, v in h_j.params._asdict().items()}
    f["skybox_count"] = h_j.skybox_count
    return h_j, convert.hierarchy_from_numpy(f, "cpu")


def make_project(root):
    """Four PINHOLE views of the toy hierarchy (two of them from one
    centre), GT its τ = 0 render, 16-bit inverse depth with depth params,
    color-coded segmentation masks, test.txt naming views 1 and 3."""
    h_j, _ = hierarchy()
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    (root / "depths").mkdir()
    (root / "seg").mkdir()
    cams = {1: jcolmap.ColmapCamera(1, "PINHOLE", W, H, np.array(
        [W / (2 * math.tan(math.radians(30))),
         H / (2 * math.tan(math.radians(30)) * H / W), W / 2, H / 2]))}
    imgs, dp = {}, {}
    cfg = JRaster(method="tiled", tile_capacity=256)
    rng = np.random.default_rng(0)
    for i, (c, t) in enumerate(zip(CENTERS, TARGETS)):
        cam = lookat_camera(c, t, W, H)
        vm = np.asarray(cam.viewmatrix, np.float64)
        name = f"view{i}.png"
        imgs[i + 1] = jcolmap.ColmapImage(
            i + 1, jcolmap.rotmat2qvec(vm[:3, :3]), vm[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros(0, np.int64))
        cut = jst.select_cut(h_j, cam.campos, 0.0)
        out = jrender.render_cut_compact(h_j.params, cut, h_j.n_nodes,
                                         h_j.skybox_count, cam, 3,
                                         jnp.zeros(3), cfg)
        img = np.clip(np.asarray(out["render"]), 0, 1)
        png.write_png(root / "images" / name,
                      (img.transpose(1, 2, 0) * 255).astype(np.uint8))
        inv = np.asarray(out["depth"])[0]
        raw = np.clip((inv - DEPTH_OFFSET) / DEPTH_SCALE, 0, 1) * 65535
        png.write_png(root / "depths" / f"view{i}.png",
                      np.round(raw).astype(np.uint16))
        dp[f"view{i}"] = {"scale": DEPTH_SCALE, "offset": DEPTH_OFFSET}
        seg = np.zeros((H, W, 3), np.uint8)
        for j, color in enumerate(tm.CATEGORY_GROUPS.values()):
            seg[:, 10 * j:10 * j + 10] = [int(color[k:k + 2], 16)
                                          for k in (1, 3, 5)]
        seg[rng.random((H, W)) < 0.2] = 0
        png.write_png(root / "seg" / f"view{i}.png", seg)
    jcolmap.write_model(cams, imgs, None, sparse)
    pts = rng.normal(size=(30, 3))
    from street_sparse_3dgs_tpu.data.ply import store_point_cloud
    store_point_cloud(sparse / "points3D.ply", pts,
                      rng.integers(0, 255, (30, 3)).astype(np.uint8))
    (sparse / "depth_params.json").write_text(json.dumps(dp))
    (sparse / "test.txt").write_text("view1.png\nview3.png\n")
    return root


def assert_results_close(got, want):
    """Per-τ metrics: PSNR and SSIM within rtol 1e-4 (the renders agree to
    2e-5 and the GT is 8-bit), LPIPS 1e-3, iMAE / iRMSE 1e-3; the LPIPS
    provenance and the breakdown keys equal."""
    assert list(got) == list(want)
    for tau in want:
        a, b = got[tau], want[tau]
        assert a.keys() == b.keys(), tau
        for k, v in b.items():
            if isinstance(v, dict):
                assert a[k].keys() == v.keys(), (tau, k)
                for name, row in v.items():
                    for m, x in row.items():
                        np.testing.assert_allclose(a[k][name][m], x,
                                                   rtol=1e-4,
                                                   err_msg=(tau, k, name, m))
            elif isinstance(v, str):
                assert a[k] == v
            else:
                rtol = 1e-4 if k in ("psnr", "ssim") else 1e-3
                np.testing.assert_allclose(a[k], v, rtol=rtol,
                                           err_msg=(tau, k))


@pytest.mark.parametrize("compact", [True, False])
def test_render_hierarchy_eval_matches_jax(tmp_path, compact):
    """The τ sweep (0, 3, 15) on the test views, against alpha-masked GT
    and 16-bit LiDAR inverse depth, with depth-band and category
    breakdowns and random-feature LPIPS: every per-τ metric against JAX's
    (tolerances in assert_results_close); the written renders within one
    8-bit level of JAX's."""
    h_j, h_t = hierarchy()
    src = make_project(tmp_path / "project")
    kw = dict(taus=(0.0, 3.0, 15.0), with_lpips=True, with_breakdowns=True,
              compact=compact, seg_dir=src / "seg")
    want = jrh.render_hierarchy_eval(
        h_j, src, JModelConfig(eval=True, depths="depths"),
        JPipelineConfig(tile_capacity=256), out_dir=tmp_path / "j", **kw)
    got = trh.render_hierarchy_eval(
        h_t, src, ModelConfig(eval=True, depths="depths"),
        PipelineConfig(tile_capacity=256), out_dir=tmp_path / "t", **kw)
    assert_results_close(got, want)
    assert got[0.0]["psnr"] > got[15.0]["psnr"]
    assert got[0.0]["lpips_weights"] == "random"
    for tau in ("0", "3", "15"):
        for name in ("view1.png", "view3.png"):
            a = png.read_png(tmp_path / "t" / f"renders_tau{tau}" / name)
            b = png.read_png(tmp_path / "j" / f"renders_tau{tau}" / name)
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_render_position_matches_jax(tmp_path):
    """The first test-camera group (views 1 and 3 share no centre: view 1's
    group) shifted to (0.5, 2.5) at the mean height: the same files, each
    within one 8-bit level of JAX's render."""
    h_j, h_t = hierarchy()
    src = make_project(tmp_path / "project")
    kw = dict(tau=0.0)
    want = jrp.render_position(
        h_j, src, 0.5, 2.5, out_dir=tmp_path / "j",
        model_cfg=JModelConfig(eval=True),
        pipe=JPipelineConfig(tile_capacity=256), **kw)
    got = trp.render_position(
        h_t, src, 0.5, 2.5, out_dir=tmp_path / "t",
        model_cfg=ModelConfig(eval=True),
        pipe=PipelineConfig(tile_capacity=256), **kw)
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        x, y = png.read_png(a).astype(int), png.read_png(b).astype(int)
        assert np.abs(x - y).max() <= 1
        assert x.std() > 0


def test_group_cameras_by_center_matches_jax(tmp_path):
    src = make_project(tmp_path / "project")
    cfg = dict(eval=True)
    ij = j_load(src, JModelConfig(**cfg))
    it = load_scene_info(src, ModelConfig(**cfg))
    for cj, ct in ((ij.train_cameras, it.train_cameras),
                   (ij.train_cameras + ij.test_cameras,
                    it.train_cameras + it.test_cameras)):
        gj = jrp.group_cameras_by_center(cj)
        gt = trp.group_cameras_by_center(ct)
        assert list(gt) == list(gj)
        for k in gj:
            assert [i.image_name for i, _ in gt[k]] == \
                [i.image_name for i, _ in gj[k]]
            for (_, a), (_, b) in zip(gt[k], gj[k]):
                np.testing.assert_array_equal(a, b)
    assert len(trp.group_cameras_by_center(it.train_cameras
                                           + it.test_cameras)) == 3


def test_eval_turns_tf32_off(tmp_path):
    """``render_hierarchy_eval`` switches TF32 off for its convolutions."""
    _, h_t = hierarchy()
    src = make_project(tmp_path / "project")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    trh.render_hierarchy_eval(h_t, src, ModelConfig(eval=True),
                              PipelineConfig(tile_capacity=256), taus=(0.0,),
                              with_lpips=False)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
