"""PyTorch port, the root drivers ``tools/bench``, ``tools/bench_street``
and ``tools/microbench`` against the JAX package's ``bench.py`` and
``tools/bench_street.py`` on the CPU (JAX's Pallas in interpret mode;
``tools/parity`` and ``tools/convergence`` are in
``test_torch_tools_parity.py``):

- ``bench``: the loss and its five grads against ``bench.py``'s
  ``loss_fn`` on a converted 1,024-row 64x64 toy scene in the bench config,
  3e-4 x max|g| per channel (``tests/test_pallas_blend.py``'s bar); the
  JSON record's keys start with JAX's four;
- ``bench_street``: the scene statistics against JAX's ``stats``
  (``tools/bench_street.py:88-115``) at 20,000 rows and 320x192 in the
  padded and the two-level exact configs, integers equal and the
  percentiles to 1e-6; the JSON line's keys are JAX's, in JAX's order;
- ``microbench`` at a tiny scale: each candidate computes its reference's
  result;
- every tool raises without a card unless given ``--device cpu``.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.data.toy import make_street_scene as j_street
from street_sparse_3dgs_tpu.data.toy import make_toy_scene as j_toy
from street_sparse_3dgs_tpu.ops.binning import bin_gaussians as j_bin
from street_sparse_3dgs_tpu.ops.preprocess import project_gaussians as j_proj
from street_sparse_3dgs_tpu.ops.rasterize import RasterConfig as JConfig
from street_sparse_3dgs_tpu.ops.rasterize import rasterize as j_rasterize
from street_sparse_3dgs_tpu_torch.convert import camera_from_numpy
from street_sparse_3dgs_tpu_torch.data.toy import ToyScene, make_street_scene
from street_sparse_3dgs_tpu_torch.tools import (bench, bench_street,
                                                convergence, microbench,
                                                parity)

torch.set_num_threads(1)
GRAD_BAR = 3e-4
JAX_BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
JAX_STREET_KEYS = ["metric", "value", "unit", "vs_baseline", "step_ms",
                   "config", "pairs", "visible"]
JAX_STREET_CONFIG_KEYS = ["n", "res", "cameras", "max_dup", "K", "vis_cap",
                          "method", "grad_sort", "exact_extra",
                          "grad_reduce", "two_level", "dup_overscan"]


def rows_np(s):
    return tuple(np.asarray(x) for x in (s.means3d, s.scales, s.quats,
                                         s.opacities, s.sh_coeffs))


def port_scene(s) -> ToyScene:
    """The JAX scene's rows and cameras as CPU tensors."""
    cams = [camera_from_numpy({k: np.asarray(v) for k, v in c._asdict()
                               .items()}, device="cpu") for c in s.cameras]
    return ToyScene(*(torch.tensor(x) for x in rows_np(s)), cams)


def assert_per_channel(got, want, what):
    """|got - want| <= GRAD_BAR x max|want| of each last-axis channel."""
    w = want.reshape(-1, want.shape[-1]) if want.ndim > 1 else want[:, None]
    g = got.reshape(w.shape)
    scale = np.abs(w).max(axis=0) + 1e-12
    err = (np.abs(g - w) / scale).max(axis=0)
    assert (err <= GRAD_BAR).all(), f"{what}: {err} x max|g| per channel"


# ---- bench ------------------------------------------------------------------

def test_bench_loss_and_grads_match_jax():
    s = j_toy(seed=0, n=1024, n_cameras=1, width=64, height=64)
    cfg = JConfig(method="pallas", max_dup=32, tile_capacity=384)
    bg, gt = jnp.zeros((3,)), jnp.zeros((3, 64, 64))

    def loss_fn(means3d, scales, quats, opacities, sh_coeffs):   # bench.py
        out = j_rasterize(means3d, scales, quats, opacities, sh_coeffs,
                          s.cameras[0], 3, bg, cfg)
        return jnp.mean(jnp.abs(out["render"] - gt)) + 0.1 * jnp.mean(
            out["depth"])

    args = tuple(jnp.asarray(x) for x in rows_np(s))
    j_loss, j_grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3, 4))(
        *args)
    ps = port_scene(s)
    leaves = [x.clone().requires_grad_() for x in ps[:5]]
    loss, out = bench_street.bench_loss(leaves, ps.cameras[0], bench.CONFIG,
                                        torch.zeros(3), torch.zeros(3, 64, 64))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss),
                               rtol=1e-5)
    for name, a, b in zip(("means", "scales", "quats", "opacities", "sh"),
                          grads, j_grads):
        assert_per_channel(a.numpy(), np.asarray(b), name)
    assert int(out["dup_overflow"]) == 0


def test_bench_record_on_the_cpu(capsys):
    rec = bench.bench(torch.device("cpu"), n=1024, res=64, iters=2,
                      warmup=1)
    assert list(rec)[:4] == JAX_BENCH_KEYS
    assert rec["metric"] == "rasterizer_fwd_bwd_rays_per_s"
    assert rec["unit"] == "rays/s/chip" and rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 15e6, 4)
    assert rec["grads_finite"] and len(rec["grads"]) == 5
    assert rec["pairs"] > 0
    err = capsys.readouterr().err
    assert (f"dup_overflow {rec['dup_overflow']} tile_overflow "
            f"{rec['tile_overflow']} pairs {rec['pairs']}") in err
    assert "truncates" in err


def test_bench_grads_accumulate_steps():
    """Two steps sum the grads of each step's own epsilon."""
    scene = j_toy(seed=0, n=256, n_cameras=1, width=32, height=32)
    ps = port_scene(scene)
    rows, cam = tuple(ps[:5]), ps.cameras[0]
    bg, gt = torch.zeros(3), torch.zeros(3, 32, 32)
    eps = bench_street.epsilons(2, "cpu")
    acc, _ = bench_street.grad_steps(rows, [cam], eps, bench.CONFIG, bg, gt)
    want = [torch.zeros_like(x) for x in rows]
    for e in eps:
        leaves = [x.clone().requires_grad_() for x in rows]
        loss, _ = bench_street.bench_loss((leaves[0] + e, *leaves[1:]), cam,
                                          bench.CONFIG, bg, gt)
        for w, g in zip(want, torch.autograd.grad(loss, leaves)):
            w += g
    for a, w in zip(acc, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    np.testing.assert_array_equal(
        eps.reshape(-1).numpy(),
        np.random.default_rng(0).uniform(1e-6, 2e-6, 2).astype(np.float32))


# ---- bench_street -------------------------------------------------------------

STREET_CONFIGS = {
    "padded": dict(max_dup=16, tile_capacity=384),
    "two_level_exact": dict(max_dup=2, tile_capacity=128, exact_extra=256,
                            dup_overscan=32,
                            dup_tails=bench_street.TWO_LEVEL_TAILS),
}


def jax_stats(scene, cfg, h, w):
    """``tools/bench_street.py:88-115``."""
    proj = j_proj(scene.means3d, scene.scales, scene.quats, scene.opacities,
                  scene.sh_coeffs, scene.cameras[0], 3)
    kw = dict(vis_capacity=cfg.vis_capacity, exact_extra=cfg.exact_extra,
              dup_overscan=cfg.dup_overscan)
    if cfg.dup_tails:
        kw["dup_tails"] = cfg.dup_tails
    bins = j_bin(proj, h, w, cfg.max_dup, cfg.tile_capacity, **kw)
    c = bins.counts
    return dict(n_visible=jnp.sum(proj.valid), pairs=jnp.sum(c),
                dup_overflow=bins.dup_overflow,
                tile_overflow=bins.tile_overflow,
                occ_mean=jnp.mean(c.astype(jnp.float32)),
                occ_p50=jnp.percentile(c.astype(jnp.float32), 50),
                occ_p90=jnp.percentile(c.astype(jnp.float32), 90),
                occ_max=jnp.max(c))


@pytest.mark.parametrize("case", sorted(STREET_CONFIGS))
def test_bench_street_stats_match_jax(case):
    h, w = 192, 320
    kw = STREET_CONFIGS[case]
    want = jax.device_get(jax.jit(lambda s: jax_stats(s, JConfig(
        method="pallas", **kw), h, w))(j_street(
            seed=0, n=20_000, n_cameras=1, width=w, height=h)))
    scene = make_street_scene(seed=0, n=20_000, n_cameras=1, width=w,
                              height=h, device="cpu")
    got = bench_street.stats((scene.means3d, scene.scales, scene.quats,
                              scene.opacities, scene.sh_coeffs),
                             scene.cameras[0],
                             bench_street.RasterConfig(method="pallas", **kw))
    assert sorted(got) == sorted(want)
    for k in ("n_visible", "pairs", "dup_overflow", "tile_overflow",
              "occ_max"):
        assert got[k] == int(want[k]), k
    for k in ("occ_mean", "occ_p50", "occ_p90"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-6,
                                   err_msg=k)
    assert got["pairs"] > 0


def test_bench_street_line_has_jax_keys(tmp_path, capsys):
    out = tmp_path / "street.jsonl"
    argv = ["--n", "3000", "--width", "128", "--height", "64", "--iters",
            "2", "--warmup", "0", "--cameras", "2", "--device", "cpu",
            "--json", str(out)]
    rec = bench_street.main(argv)
    line = json.loads(out.read_text().splitlines()[-1])
    assert list(line)[:len(JAX_STREET_KEYS)] == JAX_STREET_KEYS
    assert list(line["config"]) == JAX_STREET_CONFIG_KEYS
    assert line["config"]["cameras"] == 2 and line["config"]["res"] == \
        "128x64"
    assert line["pairs"] == rec["stats"]["pairs"] and line["grads_finite"]
    assert line["step_ms"] > 0 and line["device_ms"] is None
    printed = capsys.readouterr()
    assert json.loads(printed.out.splitlines()[-1]) == line
    assert re.search(r"tiles 8x4=32  visible \d+/3000  pairs \d+  occ "
                     r"mean/p50/p90/max \d+/\d+/\d+/\d+  dup_of \d+ "
                     r"tile_of \d+", printed.err)
    stats_only = bench_street.main(argv[:8] + ["--device", "cpu",
                                               "--stats-only"])
    assert stats_only == {"stats": rec["stats"]}


def test_bench_street_profile_prints_a_summary(capsys):
    rec = bench_street.main(["--n", "2000", "--width", "64", "--height",
                             "48", "--iters", "1", "--warmup", "0",
                             "--device", "cpu", "--profile"])
    assert rec["profile"]["top"]
    printed = capsys.readouterr().out
    assert "count  name" in printed
    # The program's counters of the one step, and the scan's yield.
    ctrs = rec["profile"]["counters"]
    assert ctrs["binning.rows"] == 2000
    assert ctrs["binning.pairs"] == rec["pairs"]
    assert 0 < ctrs["binning.kept"] <= ctrs["binning.covered"] \
        <= ctrs["binning.slots"]
    assert rec["profile"]["scan_yield"] == pytest.approx(
        100 * ctrs["binning.kept"] / ctrs["binning.slots"])
    assert "counters a step: binning.covered" in printed
    assert f"scan_yield {rec['profile']['scan_yield']:.4f}%" in printed


# ---- microbench ---------------------------------------------------------------

def test_microbench_candidates_agree_with_their_references():
    res = microbench.main(["--device", "cpu", "--scale", "0.0005"])
    assert sorted(res["ms"]) == sorted(res["checks"])
    assert all(v >= 0 for v in res["ms"].values())
    for name, err in res["checks"].items():
        bar = microbench.CUMSUM_RTOL if name.startswith("cumsum") else \
            microbench.REDUCE_RTOL
        assert err <= bar, name
    for stem in ("sort1op_", "sort2key_packed64_", "bwd_rowgather_",
                 "transpose_cm_to_rm_", "cumsum_rm_", "cumsum_cm_",
                 "posgather_", "scatteradd_index_add_",
                 "scatteradd_sort_segment_reduce_", "dim1sort_",
                 "bwd_sort6op_", "bwd_sort11op_", "attr_rowgather_",
                 "bin_depth_sort_stable_", "bin_packed_key_sort_",
                 "bin_searchsorted_", "bin_row_tile_sort_"):
        assert any(n.startswith(stem) for n in res["ms"]), stem


def test_microbench_refuses_a_wrong_candidate():
    b = microbench.Bench(torch.device("cpu"), 1.0)
    x = torch.arange(10)
    b.workload({"ref": lambda: x, "same": lambda: x.clone()},
               microbench.equal)
    with pytest.raises(AssertionError, match="wrong"):
        b.workload({"ref2": lambda: x, "wrong": lambda: x + 1},
                   microbench.equal)
    with pytest.raises(AssertionError, match="index_add_"):
        microbench.close_rows(torch.ones(3), torch.ones(3) + 1e-4, "red")


# ---- the card by default --------------------------------------------------------

@pytest.mark.parametrize("tool, argv", [
    (bench, []), (bench_street, ["--n", "100"]), (microbench, []),
    (parity, []), (convergence, ["tiled", "1"])])
def test_tools_need_the_card_by_default(tool, argv):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)
