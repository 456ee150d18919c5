"""PyTorch port, ``tools/parity`` and ``tools/convergence`` against the
JAX package's ``tools/tpu_parity.py`` and ``tools/convergence_tpu.py`` on
the CPU (JAX's Pallas in interpret mode):

- ``parity`` passes JAX's bar on the CPU, and its image and grad diffs
  match ``tools/tpu_parity.py``'s on the same converted scene to 1e-5;
- ``convergence``: the GT against JAX's ``oracle_gt_2x`` to 1e-5 at all
  but 1e-4 of the pixels (termination flips, 1e-4 at most), the init
  from JAX's jitter against JAX's ``create_from_pcd`` (the bars of
  ``test_torch_train.py::test_create_from_pcd_matches_jax``), and a
  6-iteration run of each method with finite PSNR and JAX's line.
"""

import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.data.toy import lookat_camera as j_lookat
from street_sparse_3dgs_tpu.data.toy import make_toy_scene as j_toy
from street_sparse_3dgs_tpu.models import gaussians as jg
from street_sparse_3dgs_tpu.ops.rasterize import RasterConfig as JConfig
from street_sparse_3dgs_tpu.ops.rasterize import rasterize as j_rasterize
from street_sparse_3dgs_tpu_torch.models import gaussians as tg
from street_sparse_3dgs_tpu_torch.tools import convergence, parity

from test_torch_tools import port_scene

torch.set_num_threads(1)
FLIP_SHARE = 1e-4


# ---- parity -------------------------------------------------------------------

def jax_parity(s, bg):
    """``tools/tpu_parity.py:26-57``: each config's image and grads."""
    def run(cfg):
        def loss(m, sc):
            out = j_rasterize(m, sc, s.quats, s.opacities, s.sh_coeffs,
                              s.cameras[0], 3, bg, cfg)
            return (jnp.mean(out["render"] ** 2)
                    + 0.05 * jnp.mean(out["depth"])), out["render"]
        (_, img), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(s.means3d, s.scales)
        return np.asarray(img), [np.asarray(x) for x in g]

    return {name: run(JConfig(**dataclasses.asdict(cfg)))
            for name, cfg in parity.CONFIGS.items()}


def test_parity_passes_and_matches_the_jax_tool():
    s = j_toy(seed=0, n=1024, n_cameras=1, width=128, height=96)
    bg = (0.3, 0.5, 0.7)
    res = parity.parity(port_scene(s), torch.tensor(bg))
    assert res["passed"], res["failures"]
    want = jax_parity(s, jnp.array(bg))
    for name in parity.CONFIGS:      # the forward bar of the blend tests
        np.testing.assert_allclose(res["images"][name].numpy(),
                                   want[name][0], atol=2e-5, err_msg=name)

    def mx(a, b):
        return float(np.abs(a - b).max())

    # The diffs JAX's tool prints ("exact-oracle" is the port's own).
    for key, got in res["diffs"].items():
        what, pair = key.split(" ")
        if pair == "exact-oracle":
            continue
        a, b = pair.split("-")
        if what == "img":
            expect = mx(want[a][0], want[b][0])
        else:
            i = ("dmeans", "dscales").index(what)
            expect = mx(want[a][1][i], want[b][1][i])
        assert abs(got - expect) <= 1e-5, (key, got, expect)


# ---- convergence --------------------------------------------------------------

@pytest.fixture(scope="module")
def conv_scene():
    return j_toy(seed=11, n=400, n_cameras=6, width=convergence.RES,
                 height=convergence.RES)


def test_convergence_gt_matches_jax(conv_scene):
    s = conv_scene
    res = convergence.RES
    got = convergence.gt_images(tuple(port_scene(s)[:5]), "cpu")
    for i in range(6):                    # tools/convergence_tpu.py:236-241
        ang = 2.0 * math.pi * i / 6
        pos = np.array([3.0 * math.cos(ang), 3.0 * math.sin(ang), 0.8])
        out = j_rasterize(s.means3d, s.scales, s.quats, s.opacities,
                          s.sh_coeffs, j_lookat(pos, np.zeros(3), res * 2,
                                                res * 2), 3, jnp.zeros(3),
                          JConfig(method="oracle"))
        img = jnp.clip(out["render"], 0.0, 1.0)
        want = img.reshape(3, res, 2, res, 2).mean(axis=(2, 4))
        diff = np.abs(got[i].numpy() - np.asarray(want)).max(axis=0)
        # 1e-5 but where the two oracles' T < 1e-4 termination falls on
        # either side of a 2x pixel (a flip moves its pooled pixel by up
        # to 1e-4): at most FLIP_SHARE of the oracle's own pixels.
        assert (diff > 1e-5).sum() <= FLIP_SHARE * (2 * res) ** 2, \
            f"view {i}"
        assert diff.max() <= 1e-4, f"view {i}"


def test_convergence_init_matches_jax(conv_scene):
    s = conv_scene
    key = jax.random.PRNGKey(0)                 # convergence_tpu.py:245-250
    jitter = np.asarray(jax.random.normal(key, s.means3d.shape))
    pts = np.asarray(s.means3d) + 0.03 * jitter
    cols = np.clip(np.asarray(s.sh_coeffs[:, 0, :]) * 0.28 + 0.5, 0, 1)
    params, active, meta = jg.create_from_pcd(key, pts, cols, sh_degree=3,
                                              capacity=2048)
    ps = port_scene(s)
    got_p, got_a, got_m = convergence.init_model(ps.means3d, ps.sh_coeffs,
                                                 torch.tensor(jitter))
    for name in tg.GaussianParams._fields:
        want = np.asarray(getattr(params, name))
        tol = {"log_scales": 1e-4}.get(name, 1e-6)
        np.testing.assert_allclose(getattr(got_p, name).numpy(), want,
                                   rtol=1e-6, atol=tol, err_msg=name)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(active))
    assert dataclasses.asdict(got_m) == dataclasses.asdict(meta)


def test_convergence_six_iterations_each_method(tmp_path, capsys):
    jitter = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (400, 3)))
    np.save(tmp_path / "jitter.npy", jitter)
    recs = convergence.main(["--methods", ",".join(convergence.METHODS),
                             "6", "3", "--jitter-from",
                             str(tmp_path / "jitter.npy"), "--device",
                             "cpu"])
    assert [r["method"] for r in recs] == list(convergence.METHODS)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("method=")]
    assert len(lines) == 3
    for rec, line in zip(recs, lines):
        assert math.isfinite(rec["psnr"]) and len(rec["per_view"]) == 6
        assert rec["iters"] == 6 and rec["seed"] == 3
        assert re.fullmatch(
            rf"method={rec['method']} iters=6 seed=3 wall=\d+s "
            r"PSNR=\d+\.\d\d \(per-view \['\d+\.\d'(, '\d+\.\d'){5}\]\) "
            r"n_active=\d+", line), line
