"""PyTorch port, ``rasterize`` end to end against the JAX package on the
same scene: methods ``oracle``, ``tiled`` and ``pallas`` (padded, exact,
visible-compaction and bf16-attribute configs).  On CPU tensors the port's
``pallas`` method runs the plain versions of its kernels; the JAX one runs
its Pallas kernels in interpret mode.

Image, depth and alpha agree to 2e-5 (the forward bar of
tests/test_pallas_blend.py); radii, visibility and the three overflow
counters are equal."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.ops.rasterize import (RasterConfig as JConfig,
                                                  rasterize as j_rasterize)
from street_sparse_3dgs_tpu_torch.convert import camera_from_numpy
from street_sparse_3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                        rasterize)

torch.set_num_threads(1)
ATOL = 2e-5
BG = np.array([0.2, 0.1, 0.3], np.float32)


@functools.lru_cache(maxsize=None)
def scene(seed, n, width, height):
    return make_toy_scene(seed=seed, n=n, n_cameras=1, width=width,
                          height=height)


SMALL, DENSE = (300, 64, 48), (2048, 128, 96)
CASES = {
    "oracle_seed0": (0, SMALL, dict(method="oracle")),
    "oracle_seed1": (1, SMALL, dict(method="oracle")),
    "tiled_seed0": (0, SMALL, dict(method="tiled", tile_capacity=256,
                                   max_dup=32)),
    "tiled_seed1": (1, SMALL, dict(method="tiled", tile_capacity=256,
                                   max_dup=32)),
    "pallas_seed0": (0, SMALL, dict(method="pallas", tile_capacity=256,
                                    max_dup=32)),
    "pallas_seed1": (1, SMALL, dict(method="pallas", tile_capacity=256,
                                    max_dup=32)),
    "pallas_bf16_vis_capacity": (0, SMALL, dict(
        method="pallas", tile_capacity=256, max_dup=32, attr_dtype="bf16",
        vis_capacity=200)),
    "pallas_exact": (0, DENSE, dict(method="pallas", tile_capacity=128,
                                    max_dup=16, exact_extra=64)),
    "pallas_exact_overflow": (0, DENSE, dict(method="pallas",
                                             tile_capacity=128, max_dup=16,
                                             exact_extra=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rasterize_matches_jax(case):
    seed, shape, kw = CASES[case]
    s = scene(seed, *shape)
    cam = s.cameras[0]
    cam_t = camera_from_numpy(
        {k: np.asarray(v) for k, v in cam._asdict().items()}, device="cpu")
    rows = (s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs)
    want = j_rasterize(*rows, cam, 3, jnp.asarray(BG), JConfig(**kw))
    got = rasterize(*(torch.tensor(np.asarray(x)) for x in rows), cam_t, 3,
                    torch.tensor(BG), RasterConfig(**kw))
    for name in ("render", "depth", "alpha"):
        assert tuple(got[name].shape) == np.asarray(want[name]).shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=ATOL, err_msg=name)
    for name in ("radii", "visibility", "dup_overflow", "tile_overflow",
                 "vis_overflow"):
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)
    if case == "pallas_exact_overflow":
        assert int(got["tile_overflow"]) > 0
    if case == "pallas_bf16_vis_capacity":
        assert int(got["vis_overflow"]) > 0


def test_raster_config_matches_jax_fields():
    """Same fields, defaults and method names as the JAX config."""
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(RasterConfig)}
    assert jf == tf


def test_rasterize_rejects_unknown_method_and_counts_without_exact():
    s = scene(0, *SMALL)
    cam_t = camera_from_numpy(
        {k: np.asarray(v) for k, v in s.cameras[0]._asdict().items()},
        device="cpu")
    rows = [torch.tensor(np.asarray(x)) for x in
            (s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs)]
    with pytest.raises(ValueError, match="unknown raster method"):
        rasterize(*rows, cam_t, 3, torch.tensor(BG),
                  RasterConfig(method="nope"))
    with pytest.raises(ValueError, match="exact mode"):
        rasterize(*rows, cam_t, 3, torch.tensor(BG),
                  RasterConfig(method="pallas", grad_reduce="counts"))
