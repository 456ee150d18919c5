"""The projection's backward as the CUDA kernel computes it
(``ops/preprocess.project_backward_plain``, the line-for-line twin of
``csrc/project.cu``'s ``project_bwd``) against ``torch.autograd.grad`` of
the plain forward, in float64 on the CPU: SH degrees 0-4, K above
(degree + 1)^2, with and without ``active_mask``, ``scale_modifier`` 1 and
1.7, on rows with every edge the chain branches on (``tests/
project_rows.py``).  Also: the SH basis' derivatives, CPU tensors taking
the plain path (no launch, no ``project.rows``), the kernel wrapper's input
checks, and each kernel's ctypes signature against its C entry point."""

import re

import pytest
import torch

from project_rows import camera_as, edge_rows, street_camera
from street_sparse_3dgs_tpu_torch import native, profiling
from street_sparse_3dgs_tpu_torch.core import sh as shlib
from street_sparse_3dgs_tpu_torch.core.covariance import (camera_cov3d,
                                                          conic_and_radius,
                                                          project_cov3d)
from street_sparse_3dgs_tpu_torch.ops import preprocess
from street_sparse_3dgs_tpu_torch.ops.preprocess import (
    project_backward_plain, project_gaussians, project_gaussians_plain,
    sh_basis_grad)

torch.set_num_threads(1)
F64 = torch.float64
COTANGENTS = ("mean2d", "depth", "inv_depth", "conic", "color", "opacity")
LEAVES = ("means3d", "scales", "quats", "opacities", "sh_coeffs")
CPU = torch.device("cpu")
# float64 agreement of two orders of the same sums: relative per leaf norm,
# and per element against the leaf's largest magnitude.
NORM_RTOL, ELEM_RTOL = 1e-10, 1e-10


def rows_and_camera(seed, n, k):
    cam = camera_as(street_camera(CPU, 320, 180), F64)
    *rows, mask = edge_rows(seed, n, k, cam, CPU, F64)
    return rows, mask, cam


def plain_det(rows, cam):
    means, scales, quats = rows[:3]
    p_view = means @ cam.viewmatrix[:3, :3].T + cam.viewmatrix[:3, 3]
    cov = project_cov3d(camera_cov3d(scales, quats, cam.viewmatrix[:3, :3]),
                        p_view, cam.focal_x, cam.focal_y, cam.tan_fovx,
                        cam.tan_fovy)
    return conic_and_radius(cov)[2]


def autograd_and_plain(rows, mask, cam, degree, sm, seed):
    leaves = [x.clone().requires_grad_(True) for x in rows]
    out = project_gaussians_plain(*leaves, cam, degree, sm, mask)
    g = torch.Generator().manual_seed(seed)
    cots = {name: torch.randn(getattr(out, name).shape, generator=g,
                              dtype=F64) for name in COTANGENTS}
    # Culled rows' depth is +inf: their depth cotangent is zero.
    cots["depth"] = torch.where(out.valid, cots["depth"], 0.0)
    outs = [torch.where(torch.isfinite(getattr(out, n)), getattr(out, n),
                        0.0) for n in COTANGENTS]
    want = torch.autograd.grad(outs, leaves, [cots[n] for n in COTANGENTS])
    got = project_backward_plain(*rows[:3], rows[4], cam, degree, sm, mask,
                                 **{f"g_{n}": cots[n] for n in COTANGENTS})
    return got, want, out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("degree,k", [(0, 1), (0, 16), (1, 4), (1, 16),
                                      (2, 9), (2, 16), (3, 16), (3, 25),
                                      (4, 25)])
def test_project_backward_plain_equals_autograd(degree, k, masked):
    rows, mask, cam = rows_and_camera(10 * degree + k, 1601, k)
    sm = 1.7 if masked else 1.0
    got, want, out = autograd_and_plain(rows, mask if masked else None, cam,
                                        degree, sm, degree)
    # The rows reach every branch: culled and kept, a conic whose det
    # cancels to <= 0, colours clamped at 0.
    assert bool(out.valid.any()) and not bool(out.valid.all())
    assert bool((plain_det(rows, cam) <= 0).any())
    assert bool((out.color == 0).any())
    for name, x, y in zip(LEAVES, got, want):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        assert bool(torch.isfinite(y).all()), name
        rel = float((x - y).norm() / y.norm())
        assert rel <= NORM_RTOL, f"{name}: {rel}"
        worst = float((x - y).abs().max() / y.abs().max())
        assert worst <= ELEM_RTOL, f"{name}: {worst}"
    # Coefficients past (degree + 1)^2 get zero; opacity's gradient is the
    # cotangent on valid rows.
    assert bool((got[4][:, (degree + 1) ** 2:] == 0).all())
    assert bool((got[3][~out.valid] == 0).all())


@pytest.mark.parametrize("absent", COTANGENTS)
def test_project_backward_plain_takes_absent_cotangents(absent):
    rows, mask, cam = rows_and_camera(7, 401, 16)
    leaves = [x.clone().requires_grad_(True) for x in rows]
    out = project_gaussians_plain(*leaves, cam, 3, 1.0, mask)
    g = torch.Generator().manual_seed(3)
    names = [n for n in COTANGENTS if n != absent]
    cots = {n: torch.randn(getattr(out, n).shape, generator=g, dtype=F64)
            for n in names}
    if "depth" in cots:
        cots["depth"] = torch.where(out.valid, cots["depth"], 0.0)
    outs = [torch.where(torch.isfinite(getattr(out, n)), getattr(out, n),
                        0.0) for n in names]
    want = torch.autograd.grad(outs, leaves, [cots[n] for n in names],
                               allow_unused=True)
    got = project_backward_plain(*rows[:3], rows[4], cam, 3, 1.0, mask,
                                 **{f"g_{n}": cots[n] for n in names})
    for name, x, y in zip(LEAVES, got, want):
        y = torch.zeros_like(x) if y is None else y
        scale = float(y.abs().max()) or 1.0
        assert float((x - y).abs().max()) <= ELEM_RTOL * scale, name


@pytest.mark.parametrize("degree", range(5))
def test_sh_basis_grad_equals_autograd(degree):
    g = torch.Generator().manual_seed(degree)
    dirs = torch.randn(257, 3, generator=g, dtype=F64)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    gb = torch.randn(257, shlib.num_sh_coeffs(degree), generator=g,
                     dtype=F64)
    d = dirs.clone().requires_grad_(True)
    total = (shlib.sh_basis(degree, d) * gb).sum()
    # Degree 0's basis is a constant: no graph, a zero gradient.
    want = torch.autograd.grad(total, d)[0] if total.requires_grad \
        else torch.zeros_like(dirs)
    got = sh_basis_grad(degree, dirs, gb)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max() + 1.0)


def test_cpu_tensors_take_the_plain_path():
    cam = street_camera(CPU, 320, 180)
    *rows, mask = edge_rows(5, 301, 16, cam, CPU)
    before = dict(native.LAUNCHES)
    profiling.counters()
    with profiling.tracing():
        got = project_gaussians(*rows, cam, 3, 1.3, mask)
    counters = profiling.counters()
    want = project_gaussians_plain(*rows, cam, 3, 1.3, mask)
    assert native.LAUNCHES == before
    assert "project.rows" not in counters
    assert counters.get("sync.project_size") == 1
    for name, x, y in zip(preprocess.Projected._fields, got, want):
        assert torch.equal(x, y), name


def bad_inputs(rows, mask, cam):
    means, scales, quats, opac, sh = rows
    moved = cam._replace(campos=cam.campos.clone().requires_grad_(True))
    return {
        "float64": ((means.double(), scales, quats, opac, sh, cam, 3),
                    "float32"),
        "half sh": ((means, scales, quats, opac, sh.half(), cam, 3),
                    "float32"),
        "degree 5": ((means, scales, quats, opac, sh, cam, 5), "SH degree"),
        "short sh": ((means, scales, quats, opac, sh[:, :4].contiguous(),
                      cam, 3), "coefficients"),
        "float mask": ((means, scales, quats, opac, sh, cam, 3, 1.0,
                        mask.float()), "active_mask"),
        "camera grad": ((means, scales, quats, opac, sh, moved, 3),
                        "requires grad"),
        "camera float64": ((means, scales, quats, opac, sh,
                            camera_as(cam, F64), 3), "camera.viewmatrix"),
    }


CASES = ("float64", "half sh", "degree 5", "short sh", "float mask",
         "camera grad", "camera float64")


@pytest.mark.parametrize("case", CASES)
def test_kernel_wrapper_checks_its_inputs(case):
    """The CUDA path's checks run before any launch, so CPU tensors reach
    them through the wrapper's own entry."""
    cam = street_camera(CPU, 320, 180)
    *rows, mask = edge_rows(6, 129, 16, cam, CPU)
    args, match = bad_inputs(rows, mask, cam)[case]
    before = dict(native.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        preprocess._project_kernel(*args, *((1.0, None)[len(args) - 7:]))
    assert native.LAUNCHES == before


_CTYPE = {"int": native._I, "float": native._F, "long long": native._LL}


@pytest.mark.parametrize("name", native.KERNELS)
def test_kernel_argtypes_match_the_c_entry_point(name):
    """Each kernel's ctypes argument list is its C entry point's, type for
    type (a pointer passed as a 32-bit int would be cut)."""
    src = (native.CSRC / f"{native.SOURCES.get(name, name)}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"_launch\((.*?)\)\s*\{", src,
                  re.S)
    assert m, f"no entry point {name}_launch"
    want = []
    for param in m.group(1).split(","):
        decl = " ".join(param.split())
        if "*" in decl:
            want.append(native._P)
        else:
            want.append(_CTYPE[decl.rsplit(" ", 1)[0].replace("const ", "")])
    assert native._ARGTYPES[name] == want
    assert native.library_path(name).name.startswith(
        f"lib{native.SOURCES.get(name, name)}-")
