"""PyTorch port, core layer: quaternions, covariances, SH, cameras and
activations against the JAX package on the same numpy inputs; the weight
converters; the port's import isolation; device resolution.

Tolerance for float functions: rtol 1e-5 / atol 1e-6 (both run f32 on the
CPU; only the order of a few sums differs)."""

import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.core import camera as jcam
from street_sparse_3dgs_tpu.core import covariance as jcov
from street_sparse_3dgs_tpu.core import quaternion as jquat
from street_sparse_3dgs_tpu.core import sh as jsh
from street_sparse_3dgs_tpu.data import toy as jtoy
from street_sparse_3dgs_tpu.hierarchy.build import (
    build_hierarchy as j_build)
from street_sparse_3dgs_tpu.models import gaussians as jg
from street_sparse_3dgs_tpu_torch import convert
from street_sparse_3dgs_tpu_torch.core import camera as tcam
from street_sparse_3dgs_tpu_torch.core import covariance as tcov
from street_sparse_3dgs_tpu_torch.core import quaternion as tquat
from street_sparse_3dgs_tpu_torch.core import sh as tsh
from street_sparse_3dgs_tpu_torch.data import toy as ttoy
from street_sparse_3dgs_tpu_torch.models import gaussians as tg

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-6)


def close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(kw or TOL))


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(0)
    n = 257
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[0] = [0.0, 0.0, 0.0, 0.0]                      # degenerate quaternion
    return dict(
        q=q, ref=rng.normal(size=(n, 4)).astype(np.float32),
        scales=rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32),
        means=rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32),
        sh=(0.3 * rng.normal(size=(n, 16, 3))).astype(np.float32),
        dirs=rng.normal(size=(n, 3)).astype(np.float32),
        W=np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32),
        mean_cam=np.concatenate(
            [rng.uniform(-3, 3, (n, 2)), rng.uniform(0.3, 9, (n, 1))],
            axis=1).astype(np.float32),
        logit=rng.normal(size=(n, 1)).astype(np.float32))


def test_quaternion_functions(rows):
    q, ref = rows["q"], rows["ref"]
    close(tquat.normalize(torch.tensor(q)), jquat.normalize(q))
    close(tquat.to_rotation_matrix(torch.tensor(q)),
          jquat.to_rotation_matrix(q))
    close(tquat.align_sign(torch.tensor(q), torch.tensor(ref)),
          jquat.align_sign(q, ref))


@pytest.mark.parametrize("modifier", [1.0, 0.7])
def test_covariance_functions(rows, modifier):
    s, q, W = rows["scales"], rows["q"], rows["W"]
    close(tcov.build_covariance(torch.tensor(s), torch.tensor(q), modifier),
          jcov.build_covariance(s, q, modifier))
    cov_t = tcov.camera_cov3d(torch.tensor(s), torch.tensor(q),
                              torch.tensor(W), modifier)
    cov_j = jcov.camera_cov3d(s, q, W, modifier)
    close(cov_t, cov_j)
    args = (800.0, 700.0, 0.6, 0.5)
    c2_t = tcov.project_cov3d(cov_t, torch.tensor(rows["mean_cam"]), *args)
    c2_j = jcov.project_cov3d(cov_j, rows["mean_cam"], *args)
    close(c2_t, c2_j, rtol=1e-5, atol=1e-5 * float(np.abs(c2_j).max()))
    for a, b in zip(tcov.conic_and_radius(torch.tensor(np.asarray(c2_j))),
                    jcov.conic_and_radius(c2_j)):
        b = np.asarray(b)
        close(a, b, rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_functions(rows, degree):
    k = (degree + 1) ** 2
    sh, dirs, means = rows["sh"][:, :k], rows["dirs"], rows["means"]
    campos = np.array([0.3, -2.0, 1.1], np.float32)
    assert tsh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree)
    close(tsh.sh_basis(degree, torch.tensor(dirs)),
          jsh.sh_basis(degree, dirs))
    close(tsh.eval_sh(degree, torch.tensor(sh), torch.tensor(dirs)),
          jsh.eval_sh(degree, sh, dirs))
    close(tsh.sh_to_color(degree, torch.tensor(sh), torch.tensor(means),
                          torch.tensor(campos)),
          jsh.sh_to_color(degree, sh, means, campos))
    rgb = rows["scales"]
    close(tsh.rgb_to_sh(torch.tensor(rgb)), jsh.rgb_to_sh(rgb))
    close(tsh.sh_to_rgb(torch.tensor(sh)), jsh.sh_to_rgb(sh))


def test_cameras_bit_identical():
    rng = np.random.default_rng(3)
    for _ in range(3):
        pos = rng.uniform(-5, 5, 3)
        target = rng.uniform(-1, 1, 3)
        kw = dict(fovx=math.radians(rng.uniform(40, 90)))
        a = ttoy.lookat_camera(pos, target, 96, 64, device="cpu", **kw)
        b = jtoy.lookat_camera(pos, target, 96, 64, **kw)
        for name in tcam.CameraParams._fields:
            x, y = getattr(a, name), getattr(b, name)
            if name in ("height", "width"):
                assert x == y
            else:
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=name)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    t = rng.normal(size=3)
    np.testing.assert_array_equal(tcam.world_to_view(R, t, scale=1.3),
                                  jcam.world_to_view(R, t, scale=1.3))
    np.testing.assert_array_equal(
        tcam.projection_matrix(0.01, 100.0, 1.1, 0.8, 0.45, 0.55),
        jcam.projection_matrix(0.01, 100.0, 1.1, 0.8, 0.45, 0.55))
    ndc = rng.uniform(-1, 1, (50, 2)).astype(np.float32)
    size = np.array([96.0, 64.0], np.float32)
    close(tcam.ndc_to_pixel(torch.tensor(ndc), torch.tensor(size)),
          jcam.ndc_to_pixel(jnp.asarray(ndc), jnp.asarray(size)))


def test_street_scene_same_from_seed():
    a = ttoy.make_street_scene(seed=1, n=4000, n_cameras=2, width=128,
                               height=64, device="cpu")
    b = jtoy.make_street_scene(seed=1, n=4000, n_cameras=2, width=128,
                               height=64)
    for name in ("means3d", "scales", "quats", "opacities", "sh_coeffs"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      np.asarray(getattr(b, name)))
    for ca, cb in zip(a.cameras, b.cameras):
        np.testing.assert_array_equal(ca.projmatrix.numpy(),
                                      np.asarray(cb.projmatrix))


@pytest.mark.parametrize("activation", ["sigmoid", "abs"])
def test_gaussian_activations(rows, activation):
    n = rows["means"].shape[0]
    fields = dict(xyz=rows["means"], features_dc=rows["sh"][:, :1],
                  features_rest=rows["sh"][:, 1:],
                  log_scales=np.log(rows["scales"]), quats=rows["q"],
                  opacity_raw=rows["logit"])
    pt = convert.params_from_numpy(fields, device="cpu")
    pj = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    meta_t = tg.GaussianMeta(opacity_activation=activation)
    meta_j = jg.GaussianMeta(opacity_activation=activation)
    close(tg.activate_opacity(pt, meta_t), jg.activate_opacity(pj, meta_j))
    close(tg.activate_scales(pt), jg.activate_scales(pj))
    close(tg.sh_coeffs(pt), jg.sh_coeffs(pj))
    x = torch.tensor(rows["scales"][:, 0])
    close(tg.inverse_sigmoid(x), jg.inverse_sigmoid(rows["scales"][:, 0]))
    assert pt.xyz.shape == (n, 3)


def test_convert_round_trip():
    """JAX fields -> port objects -> numpy give back the same arrays."""
    s = jtoy.make_toy_scene(seed=0, n=64, n_cameras=1, width=32, height=32)
    params = jg.GaussianParams(
        xyz=s.means3d, features_dc=s.sh_coeffs[:, :1],
        features_rest=s.sh_coeffs[:, 1:], log_scales=jnp.log(s.scales),
        quats=s.quats, opacity_raw=jnp.abs(s.opacities)[:, None])
    hier = j_build(params, opacity_activation="abs")
    for jobj, conv in ((params, convert.params_from_numpy),
                       (s.cameras[0], convert.camera_from_numpy),
                       (hier, convert.hierarchy_from_numpy)):
        fields = {k: (v._asdict() if hasattr(v, "_asdict") else np.asarray(v)
                      if not isinstance(v, int) else v)
                  for k, v in jobj._asdict().items()}
        back = convert.to_numpy(conv(fields, device="cpu"))

        def same(a, b):
            if isinstance(b, dict):
                assert a.keys() == b.keys()
                for k in b:
                    same(a[k], b[k])
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        same(back, {k: (v._asdict() if hasattr(v, "_asdict") else v)
                    for k, v in jobj._asdict().items()})


def test_port_imports_no_jax():
    """Every port module and chip_smoke.py import without JAX or the JAX
    package."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT)!r})
import street_sparse_3dgs_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "street_sparse_3dgs_tpu"
       or m.startswith("street_sparse_3dgs_tpu.")]
assert not bad, bad
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_device_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from street_sparse_3dgs_tpu_torch.device import resolve_device
    from street_sparse_3dgs_tpu_torch.hierarchy.io import load_hierarchy

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttoy.make_street_scene(n=100, n_cameras=1, width=32, height=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy({k: np.zeros((1, 3), np.float32)
                                   for k in tg.GaussianParams._fields})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_hierarchy(ROOT / "no-such-file.hier.npz")
    assert resolve_device("cpu") == torch.device("cpu")
