"""PyTorch port, ``tools/synth_project.make_project`` against the JAX
fixture ``tests/test_pipeline.py::make_project`` at n=120, 6 views, 64x48
with every fork knob on (depth maps, 3 depth-only cameras, masks, LiDAR,
the GT cloud, a degraded SfM), the port given JAX's five Gaussian arrays
(``random_gaussians(PRNGKey(7))``) as ``rows=``:

- the COLMAP binaries (``cameras.bin``, ``images.bin``, ``points3D.bin``)
  and ``images_depths.bin`` byte-identical;
- ``test.txt``, ``center.txt`` and ``extent.txt`` equal;
- ``depth_params.json`` to rtol 1e-6 (the oracle's inverse depths are
  summed in another order);
- ``chunk.ply``'s points equal;
- the decoded images, masks and 16-bit depths within 1 level at all but
  1e-3 of the pixels (the oracle's floats are truncated to integers).
"""

import json

import jax
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.data.toy import random_gaussians
from street_sparse_3dgs_tpu_torch.data import png
from street_sparse_3dgs_tpu_torch.data.ply import read_ply
from street_sparse_3dgs_tpu_torch.tools import synth_project

from test_pipeline import make_project as jax_make_project

torch.set_num_threads(1)
KNOBS = dict(n=120, n_views=6, width=64, height=48, with_depths=True,
             depth_cams=3, with_masks=True, lidar=True, with_gt_cloud=True,
             sfm_keep=0.3, sfm_noise=0.05)
PIXEL_SHARE = 1e-3


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    jax_make_project(root / "jax", **KNOBS)
    rows = [np.asarray(x) for x in random_gaussians(
        jax.random.PRNGKey(7), KNOBS["n"], sh_degree=3, extent=2.0)]
    synth_project.make_project(root / "port", rows=rows, device="cpu",
                               **KNOBS)
    return root / "jax", root / "port"


def files(root, pattern):
    return sorted(p.relative_to(root) for p in root.rglob(pattern))


def test_same_files(projects):
    jroot, troot = projects
    assert files(jroot, "*") == files(troot, "*")
    assert len(files(troot, "*.png")) == 6 + 5 + 9   # images, masks, depths


@pytest.mark.parametrize("pattern", ["cameras.bin", "images.bin",
                                     "points3D.bin", "images_depths.bin"])
def test_colmap_binaries_byte_identical(projects, pattern):
    jroot, troot = projects
    found = files(jroot, pattern)
    assert len(found) == 3          # aligned and both chunks
    for rel in found:
        assert (troot / rel).read_bytes() == (jroot / rel).read_bytes(), rel


@pytest.mark.parametrize("pattern", ["test.txt", "center.txt", "extent.txt"])
def test_text_files_equal(projects, pattern):
    jroot, troot = projects
    found = files(jroot, pattern)
    assert found
    for rel in found:
        assert (troot / rel).read_text() == (jroot / rel).read_text(), rel


def test_depth_params_close(projects):
    jroot, troot = projects
    found = files(jroot, "depth_params.json")
    assert len(found) == 3
    for rel in found:
        want = json.loads((jroot / rel).read_text())
        got = json.loads((troot / rel).read_text())
        assert sorted(got) == sorted(want)
        for stem, w in want.items():
            assert got[stem]["offset"] == w["offset"]
            np.testing.assert_allclose(got[stem]["scale"], w["scale"],
                                       rtol=1e-6, err_msg=f"{rel} {stem}")


def test_chunk_ply_points_equal(projects):
    jroot, troot = projects
    found = files(jroot, "chunk.ply")
    assert len(found) == 2
    for rel in found:
        want, got = read_ply(jroot / rel), read_ply(troot / rel)
        assert sorted(got) == sorted(want)
        for name, col in want.items():
            np.testing.assert_array_equal(got[name], col,
                                          err_msg=f"{rel} {name}")


@pytest.mark.parametrize("folder", ["images", "masks", "depths"])
def test_pngs_within_one_level(projects, folder):
    jroot, troot = projects
    found = files(jroot / "rectified" / folder, "*.png")
    assert found
    for rel in found:
        want = png.read_png(jroot / "rectified" / folder / rel)
        got = png.read_png(troot / "rectified" / folder / rel)
        assert got.dtype == want.dtype and got.shape == want.shape
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert (diff > 1).mean() <= PIXEL_SHARE, rel


def test_seeded_draw_is_deterministic(tmp_path):
    """Without ``rows`` the Gaussians come from a torch.Generator seeded 7:
    two builds are byte-identical and the GT is not blank."""
    kw = dict(n=60, n_views=3, width=32, height=24, device="cpu")
    synth_project.make_project(tmp_path / "a", **kw)
    synth_project.make_project(tmp_path / "b", **kw)
    for rel in files(tmp_path / "a", "*"):
        if (tmp_path / "a" / rel).is_file():
            assert (tmp_path / "a" / rel).read_bytes() == \
                (tmp_path / "b" / rel).read_bytes(), rel
    img = png.read_png(tmp_path / "a" / "rectified" / "images"
                       / "view000.png")
    assert img.std() > 5


def test_needs_the_card_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth_project.make_project(tmp_path / "p", n=10, n_views=1)
