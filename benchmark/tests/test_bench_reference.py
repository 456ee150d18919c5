"""The plain reference against the port's plain paths at a tiny size on the
CPU: projection, the blend (the port's dense oracle), the cut and its
interpolated rows, and the benchmark's hierarchy builder against the
port's numpy builder."""

import math

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.drivers.train_chunk import camera_params
from benchmark.reference import raster

CPU = torch.device("cpu")


def rows_and_camera(n=400, seed=3):
    g = scene.generator(seed, CPU)
    rows = scene.street_rows(g, n, 3, 20.0, 4.0, CPU)
    cam = scene.camera([2.0, 0.3, 1.8], 0.1, -0.05, 96, 64, 70.0)
    return rows, cam


def port_camera(cam):
    from street_sparse_3dgs_tpu_torch.core.camera import CameraParams

    return camera_params(CameraParams, cam, CPU)


def activated(rows):
    return (rows["means"], rows["scales"], rows["quats"], rows["opacities"],
            rows["sh"])


def test_projection_matches_port():
    from street_sparse_3dgs_tpu_torch.ops.preprocess import project_gaussians

    rows, cam = rows_and_camera()
    ref = raster.project(*activated(rows), cam, 3)
    port = project_gaussians(*activated(rows), port_camera(cam), 3)
    assert torch.equal(ref.valid, port.valid)
    v = ref.valid
    assert v.sum() > 50
    for a, b in ((ref.mean2d, port.mean2d), (ref.conic, port.conic),
                 (ref.color, port.color), (ref.inv_depth, port.inv_depth)):
        torch.testing.assert_close(a[v], b[v], rtol=2e-5, atol=1e-5)
    assert torch.equal(ref.radius[v], port.radius[v])


def test_blend_matches_port_oracle():
    from street_sparse_3dgs_tpu_torch.ops.oracle import render_oracle
    from street_sparse_3dgs_tpu_torch.ops.preprocess import project_gaussians

    rows, cam = rows_and_camera()
    bg = torch.tensor([0.1, 0.2, 0.3])
    p = raster.project(*activated(rows), cam, 3)
    img, invd, alpha, passes = raster.render(
        raster.plan_tiles(p, 64, 96, block_elems=1 << 12),
        raster.attrs_of(p), bg)
    q = project_gaussians(*activated(rows), port_camera(cam), 3)
    o_img, o_invd, o_alpha = render_oracle(q, 64, 96, bg, tile_grid=(6, 4))
    torch.testing.assert_close(img, o_img, rtol=0, atol=2e-5)
    torch.testing.assert_close(invd, o_invd, rtol=0, atol=2e-5)
    torch.testing.assert_close(alpha, o_alpha, rtol=0, atol=2e-5)
    assert passes > 0


def test_backward_matches_autograd_of_the_whole_image():
    rows, cam = rows_and_camera(n=200)
    p = raster.project(*activated(rows), cam, 3)
    plan = raster.plan_tiles(p, 64, 96, block_elems=1 << 11)
    attrs = tuple(a.detach().requires_grad_(True) for a in raster.attrs_of(p))
    bg = torch.zeros(3)
    d_img = torch.rand(3, 64, 96, generator=torch.Generator().manual_seed(1))
    d_inv = torch.rand(1, 64, 96, generator=torch.Generator().manual_seed(2))
    got = raster.backward(plan, attrs, bg, d_img, d_inv)
    # The same blend in one block, under autograd end to end.
    one = plan._replace(blocks=[(torch.arange(24), int(plan.count.max()))])
    img = torch.zeros(3, 64 * 96)
    inv = torch.zeros(64 * 96)
    col, iv, _, _, px, py = raster._blend_block(
        one, *one.blocks[0], raster._with_sentinel(attrs), bg, False)
    lin = (py * 96 + px).reshape(-1)
    img = img.index_copy(1, lin, col.reshape(-1, 3).T)
    inv = inv.index_copy(0, lin, iv.reshape(-1))
    want = torch.autograd.grad(
        (img.reshape(3, 64, 96) * d_img).sum() + (inv * d_inv.reshape(-1)).sum(),
        attrs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def tiny_hierarchy(n=600, seed=5):
    g = scene.generator(seed, CPU)
    return scene.street_rows(g, n, 3, 20.0, 4.0, CPU)


def test_hierarchy_builder_merges_as_the_port():
    from street_sparse_3dgs_tpu_torch.hierarchy.build import \
        build_hierarchy as port_build
    from street_sparse_3dgs_tpu_torch.models.gaussians import GaussianParams

    rows = tiny_hierarchy()
    h = scene.build_hierarchy(rows)
    op = rows["opacities"].clamp(1e-6, 1 - 1e-6)
    raw = GaussianParams(rows["means"], rows["sh"][:, :1], rows["sh"][:, 1:],
                         torch.log(rows["scales"]), rows["quats"],
                         torch.log(op / (1 - op))[:, None])
    ph = port_build(raw, device="cpu")
    assert torch.equal(h["parent"], ph.parent)
    assert torch.equal(h["child_count"], ph.child_count)
    torch.testing.assert_close(h["xyz"], ph.params.xyz, rtol=1e-4, atol=1e-4)
    # Mass-preserving opacity divides by the square root of a nearly flat
    # covariance's determinant, in float32 by two routes.
    torch.testing.assert_close(h["opacity_raw"], ph.params.opacity_raw,
                               rtol=5e-3, atol=1e-5)
    torch.testing.assert_close(h["size"], ph.size, rtol=1e-4, atol=1e-4)

    def cov(log_scales, quats):
        m = scene.rotation(quats) * torch.exp(log_scales)[:, None, :]
        return m @ m.transpose(1, 2)

    a = cov(h["log_scales"], h["quats"])
    b = cov(ph.params.log_scales, ph.params.quats)
    scale = b.abs().amax(dim=(1, 2), keepdim=True)
    assert ((a - b).abs() / scale).max() < 1e-3


@pytest.mark.parametrize("tau", [0.0, 6.0, 15.0])
def test_cut_rows_match_port(tau):
    from street_sparse_3dgs_tpu_torch.hierarchy.render import \
        compact_cut_params
    from street_sparse_3dgs_tpu_torch.hierarchy.structure import (
        Hierarchy, pixel_limit, select_cut)
    from street_sparse_3dgs_tpu_torch.models.gaussians import GaussianParams

    h = scene.build_hierarchy(tiny_hierarchy())
    keys = ("xyz", "features_dc", "features_rest", "log_scales", "quats",
            "opacity_raw")
    n = h["parent"].shape[0]
    ph = Hierarchy(GaussianParams(*(h[k] for k in keys)), h["parent"],
                   h["child_start"], h["child_count"], h["box_center"],
                   h["box_half"], h["size"], torch.zeros(n, dtype=torch.bool),
                   0)
    _, cam = rows_and_camera()
    lim = pixel_limit(tau, cam["tan_fovx"], cam["width"])
    assert math.isclose(lim, raster.pixel_limit(tau, cam["tan_fovx"],
                                                cam["width"]), rel_tol=1e-12)
    cut = select_cut(ph, torch.as_tensor(cam["campos"]), lim)
    port = compact_cut_params(ph.params, cut, n, 0, pad_to_pow2=False)
    ref = raster.cut_rows(h, cam["campos"], lim)
    assert port[0].shape[0] == ref[0].shape[0] > 0
    for a, b in zip(ref, port[:5]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_eigh3_decomposes():
    g = torch.Generator().manual_seed(0)
    m = torch.randn(300, 3, 3, generator=g)
    a = m @ m.transpose(1, 2)
    a[:3] = torch.diag_embed(torch.rand(3, 3, generator=g))
    w, v = scene.eigh3(a)
    torch.testing.assert_close(v @ torch.diag_embed(w) @ v.transpose(1, 2),
                               a, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(w.sort(1).values, torch.linalg.eigvalsh(a),
                               rtol=1e-4, atol=1e-4)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, -3.0],
                     dtype=torch.float32)
    r = raster.tf32_round(x)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
    bits = r.view(torch.int32) & 0x1FFF
    assert np.all(bits.numpy() == 0)
