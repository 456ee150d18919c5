"""PyTorch port, LOD hierarchy: the builder gives the JAX tree, a
``.hier.npz`` written by either package loads in the other, ``select_cut``
and ``budget_limit`` select the same cut, and ``render_cut_compact`` /
``render_cut`` render it like the JAX package (image, depth and alpha to
2e-5; the JAX Pallas kernels run in interpret mode)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.hierarchy import io as jio
from street_sparse_3dgs_tpu.hierarchy import render as jrender
from street_sparse_3dgs_tpu.hierarchy import structure as jst
from street_sparse_3dgs_tpu.hierarchy.build import (
    build_hierarchy as j_build)
from street_sparse_3dgs_tpu.models.gaussians import (GaussianParams,
                                                     inverse_sigmoid)
from street_sparse_3dgs_tpu.ops.rasterize import RasterConfig as JConfig
from street_sparse_3dgs_tpu_torch import convert
from street_sparse_3dgs_tpu_torch.hierarchy import io as tio
from street_sparse_3dgs_tpu_torch.hierarchy import render as trender
from street_sparse_3dgs_tpu_torch.hierarchy import structure as tst
from street_sparse_3dgs_tpu_torch.hierarchy.build import (
    build_hierarchy as t_build)
from street_sparse_3dgs_tpu_torch.ops.rasterize import RasterConfig

torch.set_num_threads(1)
ATOL = 2e-5
PALLAS = dict(method="pallas", tile_capacity=256, max_dup=32)


@functools.lru_cache(maxsize=None)
def chunk(n, activation):
    s = make_toy_scene(seed=0, n=n, n_cameras=2, width=64, height=64)
    op = (inverse_sigmoid(s.opacities) if activation == "sigmoid"
          else s.opacities)
    params = GaussianParams(
        xyz=s.means3d, features_dc=s.sh_coeffs[:, :1, :],
        features_rest=s.sh_coeffs[:, 1:, :], log_scales=jnp.log(s.scales),
        quats=s.quats, opacity_raw=op[:, None])
    return params, s


@functools.lru_cache(maxsize=None)
def built(activation, scaffold_rows=0, skybox_rows=0, masked=False):
    params, s = chunk(300, activation)
    active = (np.arange(300) % 7 != 3) if masked else None
    kw = dict(scaffold_rows=scaffold_rows, skybox_rows=skybox_rows,
              opacity_activation=activation)
    h_j = j_build(params, active=active, **kw)
    h_t = t_build(params, active=None if active is None
                  else torch.tensor(active), device="cpu", **kw)
    return h_j, h_t, s


def fields(h):
    """Hierarchy -> {name: numpy} (params flattened in)."""
    out = {k: np.asarray(getattr(h.params, k)) if not
           isinstance(getattr(h.params, k), torch.Tensor)
           else getattr(h.params, k).numpy()
           for k in GaussianParams._fields}
    for k in ("parent", "child_start", "child_count", "box_center",
              "box_half", "size", "anchors"):
        v = getattr(h, k)
        out[k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    out["skybox_count"] = h.skybox_count
    return out


def assert_same_hierarchy(a, b):
    fa, fb = fields(a), fields(b)
    for k in fb:
        if k in ("parent", "child_start", "child_count", "anchors",
                 "skybox_count"):
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            np.testing.assert_allclose(fa[k], fb[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(activation="sigmoid"),
    dict(activation="abs"),
    dict(activation="sigmoid", scaffold_rows=20, skybox_rows=6,
         masked=True)], ids=["sigmoid", "abs", "scaffold_skybox_masked"])
def test_build_hierarchy_matches_jax(kw):
    h_j, h_t, _ = built(**kw)
    assert h_t.n_nodes == h_j.n_nodes and h_t.n_rows == h_j.n_rows
    assert_same_hierarchy(h_t, h_j)


def test_hier_npz_loads_across_packages(tmp_path):
    h_j, h_t, _ = built("abs")
    jio.save_hierarchy(tmp_path / "jax.hier.npz", h_j)
    tio.save_hierarchy(tmp_path / "torch.hier.npz", h_t)
    assert_same_hierarchy(
        tio.load_hierarchy(tmp_path / "jax.hier.npz", device="cpu"), h_j)
    assert_same_hierarchy(jio.load_hierarchy(tmp_path / "torch.hier.npz"),
                          h_t)
    with np.load(tmp_path / "jax.hier.npz") as a, \
            np.load(tmp_path / "torch.hier.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_select_cut_and_budget_match_jax():
    h_j, h_t, s = built("abs")
    for cam in s.cameras:
        campos = np.asarray(cam.campos)
        for tau in (0.0, 3.0, 15.0):
            lim = jst.pixel_limit(tau, float(cam.tan_fovx), cam.width)
            assert lim == tst.pixel_limit(tau, float(cam.tan_fovx),
                                          cam.width)
            a = tst.select_cut(h_t, torch.tensor(campos), lim)
            b = jst.select_cut(h_j, jnp.asarray(campos), lim)
            for k in ("selected", "parent", "num_siblings"):
                np.testing.assert_array_equal(getattr(a, k).numpy(),
                                              np.asarray(getattr(b, k)))
            # (m_p - limit) / (m_p - m) amplifies last-ulp differences of
            # the distance norms: the core-function tolerance.
            np.testing.assert_allclose(a.weights.numpy(),
                                       np.asarray(b.weights), rtol=1e-5,
                                       atol=1e-6)
        for budget in (50, 200):
            np.testing.assert_allclose(
                float(tst.budget_limit(h_t, torch.tensor(campos), budget)),
                float(jst.budget_limit(h_j, jnp.asarray(campos), budget)),
                rtol=1e-6)


def compare_outputs(got, want):
    for name in ("render", "depth", "alpha"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=ATOL, err_msg=name)
    for name in ("visibility", "dup_overflow", "tile_overflow"):
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("tau", [0.0, 3.0, 15.0])
def test_render_cut_compact_matches_jax(tau):
    h_j, h_t, s = built("abs")
    cam = s.cameras[0]
    cam_t = convert.camera_from_numpy(
        {k: np.asarray(v) for k, v in cam._asdict().items()}, device="cpu")
    lim = jst.pixel_limit(tau, float(cam.tan_fovx), cam.width)
    cut_j = jst.select_cut(h_j, cam.campos, lim)
    cut_t = tst.select_cut(h_t, cam_t.campos, lim)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = jrender.render_cut_compact(h_j.params, cut_j, h_j.n_nodes,
                                      h_j.skybox_count, cam, 3,
                                      jnp.asarray(bg), JConfig(**PALLAS))
    got = trender.render_cut_compact(h_t.params, cut_t, h_t.n_nodes,
                                     h_t.skybox_count, cam_t, 3,
                                     torch.tensor(bg), RasterConfig(**PALLAS))
    compare_outputs(got, want)
    assert int(cut_t.selected.sum()) > 0


def test_render_cut_mask_form_matches_jax():
    h_j, h_t, s = built("sigmoid", scaffold_rows=20, skybox_rows=6,
                        masked=True)
    cam = s.cameras[1]
    cam_t = convert.camera_from_numpy(
        {k: np.asarray(v) for k, v in cam._asdict().items()}, device="cpu")
    lim = jst.pixel_limit(3.0, float(cam.tan_fovx), cam.width)
    cut_j = jst.select_cut(h_j, cam.campos, lim)
    cut_t = tst.select_cut(h_t, cam_t.campos, lim)
    bg = np.zeros(3, np.float32)
    cfg = dict(method="tiled", tile_capacity=256, max_dup=32)
    want = jrender.render_cut(h_j.params, cut_j, h_j.n_nodes,
                              h_j.skybox_count, cam, 3, jnp.asarray(bg),
                              JConfig(**cfg))
    got = trender.render_cut(h_t.params, cut_t, h_t.n_nodes,
                             h_t.skybox_count, cam_t, 3, torch.tensor(bg),
                             RasterConfig(**cfg))
    compare_outputs(got, want)
    xyz_t = trender.compact_cut_params(h_t.params, cut_t, h_t.n_nodes,
                                       h_t.skybox_count)
    xyz_j = jrender.compact_cut_params(h_j.params, cut_j, h_j.n_nodes,
                                       h_j.skybox_count)
    for a, b in zip(xyz_t, xyz_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
