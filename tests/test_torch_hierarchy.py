"""PyTorch port, LOD hierarchy: the builder gives the JAX tree, a
``.hier.npz`` written by either package loads in the other, ``select_cut``
and ``budget_limit`` select the same cut, and ``render_cut_compact`` /
``render_cut`` render it like the JAX package (image, depth and alpha to
2e-5; the JAX Pallas kernels run in interpret mode), and
``merge_hierarchies`` gives JAX's merged tree exactly (both run the same
numpy)."""

import contextlib
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
from street_sparse_3dgs_tpu.hierarchy.merge import (
    merge_hierarchies as j_merge)
from street_sparse_3dgs_tpu.models.gaussians import (GaussianParams,
                                                     inverse_sigmoid)
from street_sparse_3dgs_tpu.ops.rasterize import RasterConfig as JConfig
from street_sparse_3dgs_tpu_torch import convert
from street_sparse_3dgs_tpu_torch.hierarchy import io as tio
from street_sparse_3dgs_tpu_torch.hierarchy import render as trender
from street_sparse_3dgs_tpu_torch.hierarchy import structure as tst
from street_sparse_3dgs_tpu_torch.hierarchy.build import (
    build_hierarchy as t_build)
from street_sparse_3dgs_tpu_torch.hierarchy.merge import (
    merge_hierarchies as t_merge)
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


def check_partition(h, cut):
    """Every leaf has exactly one selected node on its root path (a copy of
    tests/test_hierarchy.py::_check_partition)."""
    parent = np.asarray(h.parent)
    sel = np.asarray(cut.selected)
    leaves = np.nonzero(np.asarray(h.child_count) == 0)[0]
    for leaf in leaves:
        count = 0
        node = leaf
        while node >= 0:
            count += int(sel[node])
            node = parent[node]
        assert count == 1, (leaf, count)


@functools.lru_cache(maxsize=None)
def merge_chunks(n_chunks):
    """JAX hierarchies of ``n_chunks`` shifted toy chunks (the first with a
    scaffold block and a skybox tail, whose tail the merge keeps) and their
    port copies."""
    hs_j, hs_t = [], []
    for i in range(n_chunks):
        s = make_toy_scene(seed=1 + i, n=60 - 5 * i, n_cameras=1, width=64,
                           height=64)
        params = GaussianParams(
            xyz=s.means3d + 5.0 * i, features_dc=s.sh_coeffs[:, :1, :],
            features_rest=s.sh_coeffs[:, 1:, :],
            log_scales=jnp.log(s.scales), quats=s.quats,
            opacity_raw=inverse_sigmoid(s.opacities)[:, None])
        kw = dict(scaffold_rows=12, skybox_rows=4) if i == 0 else {}
        h_j = j_build(params, **kw)
        hs_j.append(h_j)
        hs_t.append(convert.hierarchy_from_numpy(
            {**{k: np.asarray(getattr(h_j, k)) for k in h_j._fields[1:-1]},
             "params": {k: np.asarray(v)
                        for k, v in h_j.params._asdict().items()},
             "skybox_count": h_j.skybox_count}, device="cpu"))
    return hs_j, hs_t


@pytest.mark.parametrize("n_chunks", [2, 3])
def test_merge_hierarchies_matches_jax(n_chunks):
    """Two and three chunks (an odd count carries a root up the chain):
    every field equal to JAX's merge, exactly; one more node per merge,
    exactly one root, the first chunk's skybox tail, and the cut a
    partition at limits 0, 0.05 and 1e9 (as test_merge_two_chunks)."""
    hs_j, hs_t = merge_chunks(n_chunks)
    m_j = j_merge(hs_j)
    m_t = t_merge(hs_t, device="cpu")
    fa, fb = fields(m_t), fields(m_j)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        if k != "skybox_count":
            assert fa[k].dtype == fb[k].dtype, k
    assert m_t.n_nodes == sum(h.n_nodes for h in hs_t) + n_chunks - 1
    assert int((m_t.parent < 0).sum()) == 1
    assert m_t.skybox_count == hs_t[0].skybox_count > 0
    campos = torch.tensor([0.0, 0.0, 3.0])
    for lim in (0.0, 0.05, 1e9):
        check_partition(m_t, tst.select_cut(m_t, campos, lim))
    assert int(tst.select_cut(m_t, campos, 1e9).selected.sum()) == 1


def test_merge_of_one_chunk_moves_it():
    _, hs_t = merge_chunks(2)
    m = t_merge(hs_t[:1], device="cpu")
    assert_same_hierarchy(m, hs_t[0])
    with pytest.raises(RuntimeError, match="device='cpu'") if not \
            torch.cuda.is_available() else contextlib.nullcontext():
        t_merge(hs_t)


def test_smoke_partition_check_agrees():
    """chip_smoke's all-leaves-at-once partition check says what
    ``check_partition`` says: no leaf off the partition on merged cuts, and
    a cut with a node dropped or a parent added caught; the merged cut is
    the chunks' own, node for node, and not once the merge is broken."""
    import chip_smoke

    _, hs_t = merge_chunks(3)
    m = t_merge(hs_t, device="cpu")
    campos = torch.tensor([0.0, 0.0, 3.0])
    for lim in (0.0, 0.05, 1e9):
        cut = tst.select_cut(m, campos, lim)
        check_partition(m, cut)
        rep = chip_smoke.partition_report(m, cut, campos)
        assert rep["off_partition"] == 0 and rep["leaves"] == int(
            (m.child_count == 0).sum())
        assert chip_smoke.merged_cut_matches_chunks(m, hs_t, campos, lim)
    cut = tst.select_cut(m, campos, 0.05)
    sel = cut.selected.clone()
    first = int(torch.nonzero(sel)[0])
    sel[first] = False
    rep = chip_smoke.partition_report(m, cut._replace(selected=sel), campos)
    assert rep["off_partition"] > 0
    sel = cut.selected.clone()
    sel[int(m.parent[first])] = True
    rep = chip_smoke.partition_report(m, cut._replace(selected=sel), campos)
    assert rep["off_partition_on_monotone_paths"] > 0
    with pytest.raises(AssertionError):
        check_partition(m, cut._replace(selected=sel))
    broken = m._replace(size=m.size * torch.linspace(0.5, 1.5, m.n_nodes))
    assert not chip_smoke.merged_cut_matches_chunks(broken, hs_t, campos,
                                                    0.05)


def test_cut_not_a_partition_where_the_metric_rises():
    """A fault of the JAX package's closed-form cut, which the port
    reproduces: the metric is size over the distance to the box's
    circumscribed sphere, which can shrink from a node to its parent (the
    parent's box is as wide but its sphere is farther).  Then a leaf and
    its grandparent are both selected (the reference's top-down expansion
    would stop at the grandparent).  Root 4 over node 2 (leaves 0, 1) and
    leaf 3; at limit 0.95 from (0, -3, 0) node 2's metric is 1.020 and the
    root's 0.924: JAX and the port select leaves 0, 1 and the root."""
    import chip_smoke

    centre = np.array([[-0.5, 0, 0], [0.5, 0, 0], [0, 0, 0], [0, 0.7, 0],
                       [0, 0.3, 0]], np.float32)
    half = np.array([[0.5, 0.2, 0.2], [0.5, 0.2, 0.2], [1, 0.2, 0.2],
                     [0.1, 0.1, 0.1], [1, 0.5, 0.2]], np.float32)
    topo = dict(parent=np.array([2, 2, 4, 4, -1], np.int32),
                child_start=np.array([0, 0, 0, 0, 2], np.int32),
                child_count=np.array([0, 0, 2, 0, 2], np.int32),
                box_center=centre, box_half=half,
                size=(2 * half.max(axis=1)).astype(np.float32),
                anchors=np.zeros(5, bool))
    h_j = jst.Hierarchy(params=None, skybox_count=0,
                        **{k: jnp.asarray(v) for k, v in topo.items()})
    h_t = tst.Hierarchy(params=None, skybox_count=0,
                        **{k: torch.tensor(v) for k, v in topo.items()})
    campos = np.array([0.0, -3.0, 0.0], np.float32)
    cut_j = jst.select_cut(h_j, jnp.asarray(campos), 0.95)
    cut_t = tst.select_cut(h_t, torch.tensor(campos), 0.95)
    np.testing.assert_array_equal(cut_t.selected.numpy(),
                                  np.asarray(cut_j.selected))
    np.testing.assert_array_equal(cut_t.selected.numpy(),
                                  [True, True, False, False, True])
    with pytest.raises(AssertionError):
        check_partition(h_t, cut_t)
    rep = chip_smoke.partition_report(h_t, cut_t, torch.tensor(campos))
    assert rep["off_partition"] == 2
    assert rep["off_partition_on_monotone_paths"] == 0
