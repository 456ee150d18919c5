"""PyTorch port, ``rasterize`` gradients against ``jax.grad`` of the JAX
package on the same scene, for the ``tiled`` method, padded ``pallas`` (K1
and K2's plain versions here) and exact ``pallas`` (K3 and K4's), with the
sort and the counts slot reduction: grads of means3d, scales, quats,
opacities, SH, bg and ``mean2d_residual``.

Bars (tests/test_pallas_blend.py:41-92): 3e-4 * max|g| with rtol 2e-3 per
input; bg within 1e-5 with rtol 1e-3.  Also: counts against sort in exact
mode (:395-416), ``grad_sort="bf16"`` within the bounded deviation of
:204 and :429, and ``with_seg_pos`` equal to JAX's ``seg_pos`` element by
element."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.ops import binning as jbin
from street_sparse_3dgs_tpu.ops.preprocess import project_gaussians as jproj
from street_sparse_3dgs_tpu.ops.rasterize import (RasterConfig as JConfig,
                                                  rasterize as j_rasterize)
from street_sparse_3dgs_tpu_torch.convert import camera_from_numpy
from street_sparse_3dgs_tpu_torch.ops import binning as tbin
from street_sparse_3dgs_tpu_torch.ops.preprocess import Projected
from street_sparse_3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                        rasterize)

torch.set_num_threads(1)
BG = np.array([0.2, 0.1, 0.3], np.float32)
NAMES = ("means3d", "scales", "quats", "opacities", "sh", "bg", "mean2d_res")

SMALL, DENSE = (0, 300, 64, 48), (0, 1024, 96, 64)
CONFIGS = {
    "tiled": (SMALL, dict(method="tiled", tile_capacity=128, max_dup=32)),
    "pallas_padded": (SMALL, dict(method="pallas", tile_capacity=128,
                                  max_dup=32)),
    "pallas_exact_sort": (DENSE, dict(method="pallas", tile_capacity=128,
                                      max_dup=4, exact_extra=64)),
    "pallas_exact_counts": (DENSE, dict(method="pallas", tile_capacity=128,
                                        max_dup=4, exact_extra=64,
                                        grad_reduce="counts")),
}


@functools.lru_cache(maxsize=None)
def scene(seed, n, width, height):
    return make_toy_scene(seed=seed, n=n, n_cameras=1, width=width,
                          height=height)


def rows_np(s):
    return tuple(np.asarray(x) for x in (s.means3d, s.scales, s.quats,
                                         s.opacities, s.sh_coeffs))


def loss_terms(out, lib):
    return (lib.mean(out["render"] ** 2) + 0.3 * lib.mean(out["depth"])
            + 0.1 * lib.mean(out["alpha"] ** 2))


@functools.lru_cache(maxsize=None)
def jax_grads(case):
    shape, kw = CONFIGS[case]
    s = scene(*shape)
    n = s.means3d.shape[0]

    def loss(m, sc, q, o, sh, bg, res):
        out = j_rasterize(m, sc, q, o, sh, s.cameras[0], 3, bg, JConfig(**kw),
                          mean2d_residual=res)
        return loss_terms(out, jnp)

    args = tuple(jnp.asarray(x) for x in rows_np(s)) + (
        jnp.asarray(BG), jnp.zeros((n, 2), jnp.float32))
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(7)))(
        *args)]


def torch_grads(case, **over):
    shape, kw = CONFIGS[case]
    s = scene(*shape)
    n = s.means3d.shape[0]
    cam = camera_from_numpy({k: np.asarray(v)
                             for k, v in s.cameras[0]._asdict().items()},
                            device="cpu")
    args = [torch.tensor(x, requires_grad=True) for x in rows_np(s)]
    args += [torch.tensor(BG, requires_grad=True),
             torch.zeros((n, 2), requires_grad=True)]
    out = rasterize(*args[:5], cam, 3, args[5], RasterConfig(**kw, **over),
                    mean2d_residual=args[6])
    loss_terms(out, torch).backward()
    return [a.grad.numpy() for a in args], out


def assert_grads_close(got, want, what):
    for name, a, b in zip(NAMES, want, got):
        if name == "bg":
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-3,
                                       err_msg=f"{what} {name}")
            continue
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=3e-4 * scale, rtol=2e-3,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_rasterize_grads_match_jax(case):
    got, out = torch_grads(case)
    assert_grads_close(got, jax_grads(case), case)
    assert int(out["tile_overflow"]) == 0 or case in ("tiled",
                                                      "pallas_padded")
    assert np.abs(got[0]).max() > 0


def test_counts_matches_sort_in_exact_mode():
    """grad_reduce='counts' (segments from seg_pos) reproduces the sort
    scheme's grads; max_dup=4 forces tail-bucket grants into the count."""
    sort, _ = torch_grads("pallas_exact_sort")
    counts, _ = torch_grads("pallas_exact_counts")
    for name, a, b in zip(NAMES, sort, counts):
        np.testing.assert_allclose(b, a, atol=1e-4 * (np.abs(a).max() + 1e-9),
                                   err_msg=name)


@pytest.mark.parametrize("case", ["pallas_padded", "pallas_exact_counts"])
def test_bf16_grad_sort_bounded_deviation(case):
    """grad_sort='bf16' rounds each slot's grad to bf16 before the f32
    segment sum: forward bit-identical, grads within the per-pair rounding
    band of the f32 scheme."""
    g32, out32 = torch_grads(case)
    g16, out16 = torch_grads(case, grad_sort="bf16")
    assert torch.equal(out32["render"], out16["render"])
    for name, a, b in zip(NAMES[:5], g32[:5], g16[:5]):
        gn = np.linalg.norm(a.reshape(a.shape[0], -1), axis=1)
        mask = gn > 1e-6
        rel = np.abs(a - b).reshape(a.shape[0], -1).max(axis=1)[mask] / (
            gn[mask] + 1e-12)
        assert np.median(rel) < 0.02, name
        assert np.isfinite(b).all()
        assert (rel > 0).any(), name          # the rounding really happened


@pytest.mark.parametrize("shape,kw", [
    (SMALL, dict(max_dup=32, tile_capacity=256, exact_extra=0)),
    (DENSE, dict(max_dup=4, tile_capacity=128, exact_extra=64)),
    (DENSE, dict(max_dup=2, tile_capacity=128, exact_extra=64,
                 dup_overscan=12, dup_tails=((512, 6), (64, 8), (16, 8)))),
])
def test_seg_pos_equals_jax(shape, kw):
    s = scene(*shape)
    _, _, w, h = shape
    proj = jproj(*(jnp.asarray(x) for x in rows_np(s)), s.cameras[0], 3)
    want = jbin.bin_gaussians(proj, h, w, with_seg_pos=True, **kw)
    got = tbin.bin_gaussians(
        Projected(*(torch.tensor(np.asarray(x)) for x in proj)), h, w,
        with_seg_pos=True, **kw)
    assert got.seg_pos.dtype == torch.int32
    np.testing.assert_array_equal(got.seg_pos.numpy(),
                                  np.asarray(want.seg_pos))
    # At tile_overflow == 0 the last boundary is the live pair count.
    if int(got.tile_overflow) == 0:
        assert int(got.seg_pos[-1]) == int(got.mask.sum())
