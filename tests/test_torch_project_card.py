"""``project_gaussians``' CUDA kernels (``csrc/project.cu``: ``project_fwd``
and, under autograd, ``project_bwd``) against the plain path on the same
card tensors: the forward's outputs against ``project_gaussians_plain`` at
SH degrees 0-4 (and K = 16 at degrees 0-2), on edge rows and on the street
scene's 1M rows; the backward against ``torch.autograd.grad`` of the plain
path and against ``project_backward_plain``; bit-identical reruns, one
launch each way a call, no allocation by the kernels, and the wrapper's
raises.  Skips without a card.  Run it on the card's machine with:

    python -m pytest tests/test_torch_project_card.py -o addopts=""

The plain path's [N, 4] @ [4, 4] products and SH sum run through cuBLAS in
another summation order than the kernel's, so outputs agree to a few ulp;
where a row sits on a ``ceil`` or comparison boundary, ``radius`` and
``valid`` may differ (at most ``FLIP_SHARE`` of the rows, each within
``EDGE_RTOL`` of its boundary).
"""

import functools

import pytest
import torch

from project_rows import edge_rows, street_camera
from street_sparse_3dgs_tpu_torch import native
from street_sparse_3dgs_tpu_torch.core.covariance import (camera_cov3d,
                                                          conic_and_radius,
                                                          project_cov3d)
from street_sparse_3dgs_tpu_torch.ops import preprocess
from street_sparse_3dgs_tpu_torch.ops.preprocess import (
    project_backward_plain, project_gaussians, project_gaussians_plain)

W, H = 1920, 1088
RTOL, ATOL = 1e-5, 1e-6          # float outputs on rows valid on both paths
FP32_SLACK = 8.0                 # times the plain path's own float32 error
FLIP_SHARE, EDGE_RTOL = 1e-4, 1e-5
GRAD_NORM_RTOL = 1e-4            # per leaf, on the norm
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6   # per element, well-conditioned rows
F32_SOUND = 1e-6                 # a float32 reference's error, row-scaled
FLOATS = ("mean2d", "depth", "inv_depth", "conic", "color", "opacity")
COTANGENTS = ("mean2d", "depth", "inv_depth", "conic", "color", "opacity")
LEAVES = ("means3d", "scales", "quats", "opacities", "sh_coeffs")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def plain_terms(rows, cam, scale_modifier=1.0):
    """The plain path's camera-space centre [N, 3], packed 2D covariance
    [N, 3], ``det`` and radius before its ``ceil`` (3 sqrt(lambda_max))."""
    means, scales, quats = rows[:3]
    hom = torch.cat([means, torch.ones_like(means[:, :1])], 1)
    p_view = (hom @ cam.viewmatrix.T)[:, :3]
    cov = project_cov3d(camera_cov3d(scales, quats, cam.viewmatrix[:3, :3],
                                     scale_modifier), p_view,
                        cam.focal_x, cam.focal_y, cam.tan_fovx,
                        cam.tan_fovy)
    det = conic_and_radius(cov)[2]
    mid = 0.5 * (cov[:, 0] + cov[:, 2])
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    return p_view, cov, det, 3.0 * torch.sqrt(torch.clamp(lam, min=0.0))


def near_boundary(rows, cam, scale_modifier, mean2d):
    """Rows within EDGE_RTOL of a branch of the forward: the radius' ceil,
    the near plane, det = 0 or an in-image comparison."""
    p_view, cov, det, r_pre = plain_terms(rows, cam, scale_modifier)
    r = torch.ceil(r_pre)
    on_ceil = (r_pre - torch.round(r_pre)).abs() <= EDGE_RTOL * r_pre
    near = (p_view[:, 2] - 0.2).abs() <= EDGE_RTOL * 0.2
    flat = det.abs() <= EDGE_RTOL * (cov[:, 0] * cov[:, 2]).abs()
    scale = mean2d.abs().amax(1) + r + max(cam.width, cam.height)
    edges = torch.stack([mean2d[:, 0] + r, mean2d[:, 0] - r - cam.width,
                         mean2d[:, 1] + r, mean2d[:, 1] - r - cam.height], 1)
    on_edge = (edges.abs() <= EDGE_RTOL * scale[:, None]).any(1)
    return on_ceil | near | flat | on_edge


@functools.lru_cache(maxsize=1)
def street(dev):
    """The street scene's 1,048,576 rows at SH degree 3, and view 0."""
    from street_sparse_3dgs_tpu_torch.data.toy import make_street_scene
    s = make_street_scene(seed=5, n=1 << 20, n_cameras=1, width=W, height=H,
                          device=dev)
    return (s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs), \
        s.cameras[0]


def as64(rows, cam):
    """The rows (but the mask) and the camera in float64."""
    return [x.double() for x in rows[:5]], cam._replace(**{
        f: getattr(cam, f).double() for f in ("viewmatrix", "projmatrix",
                                              "campos", "tan_fovx",
                                              "tan_fovy", "focal_x",
                                              "focal_y")})


def compare_forward(got, want, rows, cam, degree, scale_modifier, mask,
                    label):
    """Every float output on rows valid on both paths within RTOL of the
    plain path (floor ATOL; pixel centres RTOL of half the image more, the
    conic RTOL of its det's cancellation more), beyond FP32_SLACK times
    the plain path's own float32 error against its float64 evaluation
    (where the chain cancels, as the EWA sums do off-axis, both paths'
    roundings grow alike); ``radius`` and ``valid`` equal but on at most
    FLIP_SHARE of the rows, each near a boundary.  Returns the worst
    relative error of each float output."""
    n = want.valid.shape[0]
    differ = (got.valid != want.valid) | (got.radius != want.radius)
    assert int(differ.sum()) <= max(1, int(FLIP_SHARE * n)), \
        f"{label}: {int(differ.sum())} rows differ in radius or valid"
    edge = near_boundary(rows, cam, scale_modifier, want.mean2d)
    assert bool(edge[differ].all()), \
        f"{label}: rows {differ.nonzero()[:8, 0].tolist()} differ off " \
        "any boundary"
    truth = project_gaussians_plain(*as64(rows, cam)[0], as64(rows, cam)[1],
                                    degree, scale_modifier, mask)
    both = got.valid & want.valid
    worst = {}
    for name in FLOATS:
        x, y = getattr(got, name)[both], getattr(want, name)[both]
        t = getattr(truth, name)[both]
        err = (x - y).abs()
        slack = FP32_SLACK * (y.double() - t).abs().float()
        # Pixel centres are NDC scaled by half the image, and NDC + 1
        # cancels at the image's left and top edges: RTOL of that scale
        # more (an NDC error of RTOL).
        tol = RTOL * y.abs() + ATOL + slack
        if name == "mean2d":
            tol = tol + RTOL * 0.5 * max(cam.width, cam.height)
        elif name == "conic":
            # The inverse divides by a det that cancels by cxx cyy / det
            # (= a c / (a c - b^2) of the conic): both paths' roundings
            # grow by it, on the scale of the row's largest entry.
            a, b, c = y.double().unbind(1)
            kappa = (a * c / (a * c - b * b)).abs().float()
            tol = tol + RTOL * kappa[:, None] * y.abs().amax(1, True)
        bad = err > tol
        worst[name] = float((err / (y.abs() + ATOL)).max()) \
            if x.numel() else 0.0
        if bool(bad.any()):
            i = int(bad.reshape(bad.shape[0], -1).any(1).nonzero()[0, 0])
            row = int(both.nonzero()[i, 0])
            raise AssertionError(
                f"{label}: {name} off on {int(bad.sum())} rows, worst "
                f"{worst[name]}; row {row}: {x[i].tolist()} against "
                f"{y[i].tolist()} (float64 {t[i].tolist()}), mean2d "
                f"{want.mean2d[row].tolist()}, depth {want.depth[row].item()}")
    return worst


DEGREE_K = [(d, (d + 1) ** 2) for d in range(5)] + [(d, 16) for d in (0, 1,
                                                                      2)]


@pytest.mark.card
@pytest.mark.parametrize("degree,k", DEGREE_K)
def test_project_forward_equals_plain_on_edge_rows(cuda_device, degree, k):
    dev = cuda_device
    cam = street_camera(dev, 640, 360)
    *rows, mask = edge_rows(degree * 7 + k, 20_011, k, cam, dev)
    assert bool((plain_terms(rows, cam)[2] <= 0).any()), "no det <= 0 row"
    for sm, msk in ((1.0, None), (1.7, mask)):
        before = dict(native.LAUNCHES)
        got = project_gaussians(*rows, cam, degree, sm, msk)
        assert native.LAUNCHES["project_fwd"] == before["project_fwd"] + 1
        want = project_gaussians_plain(*rows, cam, degree, sm, msk)
        for name in preprocess.Projected._fields:
            x, y = getattr(got, name), getattr(want, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
        compare_forward(got, want, rows, cam, degree, sm, msk,
                        f"degree {degree} K {k} scale {sm}")
        if msk is not None:
            assert not bool(got.valid[~msk].any())
        assert bool(got.valid.any()) and not bool(got.valid.all())
        # Culled rows as the plain path leaves them.
        off = ~got.valid
        assert bool((got.radius[off] == 0).all())
        assert bool(torch.isinf(got.depth[off]).all())
        assert bool((got.inv_depth[off] == 0).all())
        assert bool((got.opacity[off] == 0).all())
        # Colours clamped at 0 (the negative-DC rows).
        assert bool((got.color == 0).any())


@pytest.mark.card
def test_project_forward_equals_plain_on_street_rows(cuda_device):
    rows, cam = street(cuda_device)
    got = project_gaussians(*rows, cam, 3)
    want = project_gaussians_plain(*rows, cam, 3)
    compare_forward(got, want, rows, cam, 3, 1.0, None, "street")
    assert int(got.valid.sum()) > 100_000


def random_cotangents(out, seed):
    g = torch.Generator(device=out.mean2d.device).manual_seed(seed)
    cots = {}
    for name in COTANGENTS:
        x = getattr(out, name)
        cots[name] = torch.randn(x.shape, generator=g, device=x.device)
    return cots


def well_conditioned(rows, cam, degree, mask):
    """Rows whose every step is far from a branch point and whose conic is
    far from singular: valid, in front, inside the clamp, colour above
    zero, ``det`` not cancelling."""
    out = project_gaussians_plain(*rows, cam, degree, 1.0, mask)
    pv, cov, det, _ = plain_terms(rows, cam)
    inside = ((pv[:, 0] / pv[:, 2]).abs() < 1.2 * cam.tan_fovx) & \
        ((pv[:, 1] / pv[:, 2]).abs() < 1.2 * cam.tan_fovy)
    return out.valid & inside & (out.color > 1e-3).all(1) & \
        (det > 1e-2 * cov[:, 0] * cov[:, 2])


@pytest.mark.card
@pytest.mark.parametrize("degree,k", [(0, 1), (1, 16), (2, 9), (3, 16),
                                      (4, 25)])
def test_project_backward_equals_autograd_and_plain(cuda_device, degree, k):
    dev = cuda_device
    cam = street_camera(dev, 640, 360)
    *rows, mask = edge_rows(100 + degree, 20_011, k, cam, dev)
    leaves = [x.clone().requires_grad_(True) for x in rows]
    got = project_gaussians(*leaves, cam, degree, 1.0, mask)
    cots = random_cotangents(got, degree)
    # The inverse depth's and depth's cotangents on valid rows alone (the
    # culled rows' depth is inf).
    cots["depth"] = torch.where(got.valid, cots["depth"], 0.0)
    before = native.LAUNCHES["project_bwd"]
    g_kernel = torch.autograd.grad(
        [getattr(got, n) for n in COTANGENTS],
        leaves, [cots[n] for n in COTANGENTS])
    assert native.LAUNCHES["project_bwd"] == before + 1
    rerun = project_gaussians(*leaves, cam, degree, 1.0, mask)
    again = torch.autograd.grad([getattr(rerun, n) for n in COTANGENTS],
                                leaves, [cots[n] for n in COTANGENTS])
    for a, b in zip(g_kernel, again):     # bit for bit, NaN rows too
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            "reruns differ"

    plain = project_gaussians_plain(*leaves, cam, degree, 1.0, mask)
    g_auto = torch.autograd.grad(
        [torch.where(torch.isfinite(getattr(plain, n)), getattr(plain, n),
                     0.0) for n in COTANGENTS],
        leaves, [cots[n] for n in COTANGENTS])
    g_plain = project_backward_plain(
        *rows[:3], rows[4], cam, degree, 1.0, mask,
        **{f"g_{n}": cots[n] for n in COTANGENTS})
    rows64, cam64 = as64(rows, cam)
    leaves64 = [x.clone().requires_grad_(True) for x in rows64]
    plain64 = project_gaussians_plain(*leaves64, cam64, degree, 1.0, mask)
    g_truth = torch.autograd.grad(
        [torch.where(torch.isfinite(getattr(plain64, n)),
                     getattr(plain64, n), 0.0) for n in COTANGENTS],
        leaves64, [cots[n].double() for n in COTANGENTS])
    ok = well_conditioned(rows, cam, degree, mask)
    for name, x, y, z in zip(LEAVES, g_kernel, g_auto, g_plain):
        for label, ref in (("autograd", y), ("plain", z)):
            xs, rs = x[ok], ref[ok]
            rel = float((xs - rs).norm() / rs.norm().clamp(min=1e-30))
            assert rel <= GRAD_NORM_RTOL, f"{name} vs {label}: norm {rel}"
    # Per element on the rows where float32 itself is sound: both float32
    # references within F32_SOUND of float64, each entry against the
    # larger of it and its row's largest entry.
    sound = ok.clone()
    for y, z, t in zip(g_auto, g_plain, g_truth):
        for ref in (y, z):
            flat = t.reshape(t.shape[0], -1).abs()
            off = (ref.double() - t).reshape(flat.shape).abs().amax(1)
            sound &= off <= F32_SOUND * flat.amax(1).clamp(min=1e-30)
    assert int(sound.sum()) > 1000
    for name, x, y, z in zip(LEAVES, g_kernel, g_auto, g_plain):
        for label, ref in (("autograd", y), ("plain", z)):
            xs, rs = x[sound], ref[sound]
            flat = rs.reshape(rs.shape[0], -1).abs()
            scale = torch.maximum(flat, flat.amax(1, keepdim=True))
            tol = GRAD_RTOL * scale + GRAD_ATOL * flat.amax()
            err = (xs - rs).reshape(flat.shape).abs()
            bad = err > tol
            assert not bool(bad.any()), \
                f"{name} vs {label}: {int(bad.sum())} elements off, worst " \
                f"{float((err / scale.clamp(min=1e-30)).max())}"
    # SH coefficients past (degree + 1)^2 get zero.
    assert bool((g_kernel[4][:, (degree + 1) ** 2:] == 0).all())


@pytest.mark.card
def test_project_backward_on_street_rows(cuda_device):
    rows, cam = street(cuda_device)
    leaves = [x.clone().requires_grad_(True) for x in rows]
    got = project_gaussians(*leaves, cam, 3)
    cots = random_cotangents(got, 7)
    cots["depth"] = torch.where(got.valid, cots["depth"], 0.0)
    g_kernel = torch.autograd.grad([getattr(got, n) for n in COTANGENTS],
                                   leaves, [cots[n] for n in COTANGENTS])
    g_plain = project_backward_plain(*rows[:3], rows[4], cam, 3,
                                     **{f"g_{n}": cots[n]
                                        for n in COTANGENTS})
    ok = well_conditioned(rows, cam, 3, None)
    for name, x, z in zip(LEAVES, g_kernel, g_plain):
        rel = float((x[ok] - z[ok]).norm() / z[ok].norm())
        assert rel <= GRAD_NORM_RTOL, f"{name}: norm {rel}"


@pytest.mark.card
def test_project_kernels_allocate_nothing(cuda_device):
    dev = cuda_device
    cam = street_camera(dev, 640, 360)
    *rows, mask = edge_rows(3, 4099, 16, cam, dev)
    leaves = [x.clone().requires_grad_(True) for x in rows]
    out = project_gaussians(*leaves, cam, 3, 1.0, mask)
    cots = random_cotangents(out, 3)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats(dev)
    n_alloc = stats["allocation.all.allocated"]
    ptrs = [t.data_ptr() for t in preprocess._camera_tensors(
        cam, rows[0].device)]
    outs = [torch.empty_like(x) for x in (out.mean2d, out.depth,
                                          out.inv_depth, out.conic,
                                          out.radius, out.color,
                                          out.opacity, out.valid)]
    grads = [torch.empty_like(x) for x in rows[:5]]
    n_alloc = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
    means, scales, quats, opac, sh = rows[:5]
    native.launch("project_fwd", means.data_ptr(), scales.data_ptr(),
                  quats.data_ptr(), opac.data_ptr(), sh.data_ptr(),
                  mask.data_ptr(), *ptrs, means.shape[0], 16, 3, cam.width,
                  cam.height, 1.0, *(o.data_ptr() for o in outs))
    native.launch("project_bwd", means.data_ptr(), scales.data_ptr(),
                  quats.data_ptr(), sh.data_ptr(), mask.data_ptr(), *ptrs,
                  means.shape[0], 16, 3, cam.width, cam.height, 1.0,
                  *(cots[n].data_ptr() for n in COTANGENTS),
                  *(g.data_ptr() for g in grads))
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(dev)["allocation.all.allocated"] == \
        n_alloc
    for o, name in zip(outs, preprocess.Projected._fields):
        assert torch.equal(o, getattr(out, name)), name


@pytest.mark.card
def test_project_raises_on_what_the_kernel_does_not_take(cuda_device):
    dev = cuda_device
    cam = street_camera(dev, 640, 360)
    *rows, mask = edge_rows(4, 257, 16, cam, dev)
    with pytest.raises(ValueError, match="float32"):
        project_gaussians(rows[0].double(), *rows[1:], cam, 3)
    with pytest.raises(ValueError, match="float32"):
        project_gaussians(*rows[:4], rows[4].half(), cam, 3)
    with pytest.raises(ValueError, match="SH degree"):
        project_gaussians(*rows, cam, 5)
    with pytest.raises(ValueError, match="coefficients"):
        project_gaussians(*rows[:4], rows[4][:, :4].contiguous(), cam, 3)
    with pytest.raises(ValueError, match="requires grad"):
        moved = cam._replace(campos=cam.campos.clone().requires_grad_(True))
        project_gaussians(*rows, moved, 3)
    with pytest.raises(ValueError, match="active_mask"):
        project_gaussians(*rows, cam, 3, 1.0, mask.float())
