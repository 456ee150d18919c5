"""PyTorch port, hierarchy post-optimization: the compacted cut indices, the
O(cut) differentiable render (images and gradients, in the tiled and the
pallas exact counts configs, at the bars of
tests/test_hierarchy.py::test_compact_cut_render_matches_mask), one post
step from a carried-over state, an 8-step loss trajectory, the frozen
anchor and skybox rows, the capacity-growing driver, the limit and capacity
helpers and the scaling tool's synthetic hierarchy, each against the JAX
package on the same inputs (JAX's Pallas kernels in interpret mode).
Tolerances are stated per test."""

import ast
import functools
import math
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu import config as jcfg
from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.hierarchy import render as jrender
from street_sparse_3dgs_tpu.hierarchy import structure as jst
from street_sparse_3dgs_tpu.hierarchy.build import build_hierarchy
from street_sparse_3dgs_tpu.models.gaussians import (GaussianParams,
                                                     inverse_sigmoid)
from street_sparse_3dgs_tpu.ops.rasterize import RasterConfig as JRaster
from street_sparse_3dgs_tpu.train import post as jpost
from street_sparse_3dgs_tpu.train import step as jstep
from street_sparse_3dgs_tpu_torch import config as tcfg
from street_sparse_3dgs_tpu_torch import convert
from street_sparse_3dgs_tpu_torch.hierarchy import render as trender
from street_sparse_3dgs_tpu_torch.hierarchy import structure as tst
from street_sparse_3dgs_tpu_torch.ops.rasterize import RasterConfig
from street_sparse_3dgs_tpu_torch.tools import post_scaling
from street_sparse_3dgs_tpu_torch.train import post as tpost

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
W = H = 64
TILED = dict(method="tiled", tile_capacity=256)
EXACT = dict(method="pallas", tile_capacity=128, max_dup=32, exact_extra=64,
             grad_reduce="counts")
PIPES = {"tiled": dict(tile_capacity=256),
         "pallas": dict(raster_method="pallas", tile_capacity=128,
                        max_dup=32, exact_extra=64, grad_reduce="counts")}
OPT = dict(position_lr_init=2e-4, position_lr_final=2e-6)


def fields(x):
    """A JAX NamedTuple as nested numpy mappings."""
    return {k: (fields(v) if hasattr(v, "_asdict") else
                (v if isinstance(v, int) else np.asarray(v)))
            for k, v in x._asdict().items() if v is not None}


@functools.lru_cache(maxsize=None)
def built(skybox: bool = False):
    """A JAX hierarchy over a 100-Gaussian toy scene (with 20 scaffold rows,
    8 of them a skybox tail, when ``skybox``), its port copy, and the
    scene."""
    s = make_toy_scene(seed=0, n=100, n_cameras=2, width=W, height=H)
    params = GaussianParams(
        xyz=s.means3d, features_dc=s.sh_coeffs[:, :1, :],
        features_rest=s.sh_coeffs[:, 1:, :], log_scales=jnp.log(s.scales),
        quats=s.quats, opacity_raw=inverse_sigmoid(s.opacities)[:, None])
    kw = dict(scaffold_rows=20, skybox_rows=8) if skybox else {}
    h_j = build_hierarchy(params, **kw)
    if not skybox:
        anchors = np.zeros(h_j.n_nodes, bool)
        anchors[:10] = True
        h_j = h_j._replace(anchors=jnp.asarray(anchors))
    h_t = convert.hierarchy_from_numpy(fields(h_j), "cpu")
    return h_j, h_t, s


@functools.lru_cache(maxsize=None)
def batches(skybox: bool = False):
    """JAX and port camera batches of both toy views; GT the fine tiled
    render of the hierarchy itself."""
    h_j, _, s = built(skybox)
    out_j = []
    for i, cam in enumerate(s.cameras):
        gt = jnp.clip(jrender.render_cut(
            h_j.params, jst.select_cut(h_j, cam.campos, 1e-6), h_j.n_nodes,
            h_j.skybox_count, cam, 3, jnp.zeros(3),
            JRaster(**TILED))["render"], 0, 1)
        out_j.append(jstep.CameraBatch(
            camera=cam, gt_image=gt, alpha_mask=jnp.ones((1, H, W)),
            mono_invdepth=jnp.zeros((1, H, W)),
            depth_mask=jnp.zeros((1, H, W)), depth_reliable=jnp.array(False),
            image_index=jnp.int32(i)))
    out_t = [convert.camera_batch_from_numpy(fields(b), "cpu")
             for b in out_j]
    return out_j, out_t


def cuts(limit):
    h_j, h_t, s = built()
    cam = s.cameras[0]
    cut_j = jst.select_cut(h_j, cam.campos, limit)
    cut_t = tst.select_cut(h_t, torch.tensor(np.asarray(cam.campos)), limit)
    return cut_j, cut_t


@pytest.mark.parametrize("capacity", [4, 16, 1 << 10])
def test_compact_cut_indices_match_jax(capacity):
    """Index, parent, weight and validity buffers equal to JAX's, the
    overflow count included (capacity 4 and 16 overflow, 1024 does not);
    weights at rtol 1e-5, as select_cut's (test_torch_hierarchy.py)."""
    cut_j, cut_t = cuts(0.01)
    want = jrender.compact_cut_indices(cut_j, capacity)
    got = trender.compact_cut_indices(cut_t, capacity)
    names = ("gi", "gp", "w", "valid", "overflow")
    for name, a, b in zip(names, want, got):
        if name == "w":
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
    n_sel = int(cut_t.selected.sum())
    assert int(got[4]) == max(n_sel - capacity, 0)


def render_loss(render, params):
    out = render(params)
    loss = out["render"].pow(2).mean() + 0.3 * out["depth"].pow(2).mean()
    return loss, out["render"]


@pytest.mark.parametrize("cfg", ["tiled", "pallas"])
def test_render_cut_compacted_matches_jax(cfg):
    """The compacted render against JAX's render_cut_compacted on the same
    hierarchy and cut: image within 2e-5, loss within rtol 1e-5, gradients
    to every parameter array within 5e-4 * max|g| and rtol 2e-3 (the bars
    of test_compact_cut_render_matches_mask); overflow 0 at the power of
    two above the cut."""
    h_j, h_t, s = built()
    cam = s.cameras[0]
    rc = TILED if cfg == "tiled" else EXACT
    cut_j, cut_t = cuts(0.05)
    cap = 1 << (int(cut_t.selected.sum()) - 1).bit_length()

    def loss_j(params):
        out = jrender.render_cut_compacted(params, cut_j, h_j.n_nodes,
                                           h_j.skybox_count, cap, cam, 3,
                                           jnp.zeros(3), JRaster(**rc))
        return (jnp.mean(out["render"] ** 2)
                + 0.3 * jnp.mean(out["depth"] ** 2), out["render"])

    (la, img_a), ga = jax.value_and_grad(loss_j, has_aux=True)(h_j.params)
    tcam = convert.camera_from_numpy(fields(cam), "cpu")
    params = type(h_t.params)(*(p.clone().requires_grad_(True)
                                for p in h_t.params))
    outs = {}

    def render(p):
        outs["o"] = trender.render_cut_compacted(
            p, cut_t, h_t.n_nodes, h_t.skybox_count, cap, tcam, 3,
            torch.zeros(3), RasterConfig(**rc))
        return outs["o"]

    lb, img_b = render_loss(render, params)
    gb = torch.autograd.grad(lb, params)
    assert int(outs["o"]["cut_overflow"]) == 0
    np.testing.assert_allclose(img_b.detach().numpy(), np.asarray(img_a),
                               atol=2e-5)
    np.testing.assert_allclose(float(lb.detach()), float(la), rtol=1e-5)
    for name, a, b in zip(ga._fields, ga, gb):
        scale = float(jnp.abs(a).max()) + 1e-8
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=5e-4 * scale, rtol=2e-3,
                                   err_msg=f"grad {name}")


def test_compacted_gather_backward_is_deterministic():
    """Two backwards of the compacted render give bit-identical gradients
    (the gather sums each row's slots in a fixed order), and the padding
    slots leak nothing into row 0: its gradient at capacity 2^k and at
    2^(k+2) is the same."""
    _, h_t, s = built()
    tcam = convert.camera_from_numpy(fields(s.cameras[0]), "cpu")
    _, cut_t = cuts(0.05)
    cap = 1 << (int(cut_t.selected.sum()) - 1).bit_length()

    def grads(capacity):
        params = type(h_t.params)(*(p.clone().requires_grad_(True)
                                    for p in h_t.params))
        out = trender.render_cut_compacted(
            params, cut_t, h_t.n_nodes, h_t.skybox_count, capacity, tcam, 3,
            torch.zeros(3), RasterConfig(**TILED))
        return torch.autograd.grad(out["render"].pow(2).mean(), params)

    a, b, c = grads(cap), grads(cap), grads(4 * cap)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert torch.equal(x, z)


@functools.lru_cache(maxsize=None)
def jax_trajectory(cfg: str, steps: int = 8, capacity: int = 256):
    """JAX post states and losses of ``steps`` compacted steps over the two
    toy views, limits from random_limit(random.Random(0)), an exposure row
    off identity."""
    h_j, _, _ = built()
    bj, _ = batches()
    step = jpost.make_post_step(h_j, jcfg.OptimizationConfig(**OPT),
                                jcfg.PipelineConfig(**PIPES[cfg]),
                                compact_capacity=capacity)
    rng = random.Random(0)
    state = jpost.init_post_state(h_j)
    states, losses, limits = [state], [], []
    for i in range(steps):
        limits.append(jpost.random_limit(rng))
        state, aux = step(state, bj[i % 2], jnp.float32(limits[-1]),
                          jnp.asarray(EXPOSURE))
        states.append(state)
        losses.append(float(aux["loss"]))
    return states, losses, limits


EXPOSURE = np.array([[1.05, 0.02, 0.0, 0.01], [0.0, 0.97, 0.03, -0.01],
                     [0.01, 0.0, 1.02, 0.0]], np.float32)


def port_post_step(cfg: str, capacity=256, **kw):
    _, h_t, _ = built()
    return tpost.make_post_step(h_t, tcfg.OptimizationConfig(**OPT),
                                tcfg.PipelineConfig(**PIPES[cfg]),
                                compact_capacity=capacity, **kw)


@pytest.mark.parametrize("cfg", ["tiled", "pallas"])
def test_post_step_matches_jax(cfg):
    """One compacted post step from JAX's initial state carried across with
    post_state_from_numpy: the loss within rtol 1e-5; the grads, read from
    the first Adam moment (mu = 0.1 g after one step), within 3e-4 * max|g|
    per parameter and rtol 2e-3; the params within the same bar relative to
    their lr-sized move; the step counters equal."""
    states, losses, limits = jax_trajectory(cfg, steps=1)
    _, bt = batches()
    state0 = convert.post_state_from_numpy(fields(states[0]), "cpu")
    assert convert.to_numpy(state0)["step"] == 0
    new, aux = port_post_step(cfg)(state0, bt[0], limits[0],
                                   torch.tensor(EXPOSURE))
    np.testing.assert_allclose(float(aux["loss"]), losses[0], rtol=1e-5)
    want = states[1]
    for name in GaussianParams._fields:
        a = np.asarray(getattr(want.adam_state.mu, name))
        b = getattr(new.adam_state.mu, name).numpy()
        np.testing.assert_allclose(b, a, atol=3e-4 * np.abs(a).max(),
                                   rtol=2e-3, err_msg=name)
    assert int(new.step) == int(want.step) == 1
    assert int(new.adam_state.step) == int(want.adam_state.step) == 1
    back = convert.to_numpy(new)
    assert set(back) == {"params", "adam_state", "step"}


@pytest.mark.parametrize("cfg", ["tiled", "pallas"])
def test_post_loss_trajectory_matches_jax(cfg):
    """Eight compacted post steps from the same state with the same limits
    and exposure: the losses within rtol 5e-3 (the bar of
    tests/test_train.py:393)."""
    states, losses, limits = jax_trajectory(cfg)
    _, bt = batches()
    step = port_post_step(cfg)
    state = convert.post_state_from_numpy(fields(states[0]), "cpu")
    got = []
    for i, lim in enumerate(limits):
        state, aux = step(state, bt[i % 2], lim, torch.tensor(EXPOSURE))
        got.append(float(aux["loss"]))
    np.testing.assert_allclose(got, losses, rtol=5e-3)


@pytest.mark.parametrize("compact", [False, True])
def test_post_freezes_anchors_and_skybox(compact):
    """Anchor rows and the locked skybox tail stay bit for bit where they
    started, in the mask and the compacted form; the other rows move and
    the loss falls (mean of the last 5 of 20 steps below the first 5), as
    tests/test_hierarchy.py::test_post_step_freezes_anchors_and_improves
    checks of JAX's step.  The frozen rows are JAX's."""
    h_j, h_t, _ = built(skybox=True)
    _, bt = batches(skybox=True)
    assert h_t.skybox_count > 0 and bool(h_t.anchors.any())
    step = tpost.make_post_step(
        h_t, tcfg.OptimizationConfig(**OPT),
        tcfg.PipelineConfig(**PIPES["tiled"]), use_trained_exp=False,
        compact_capacity=512 if compact else None)
    want_frozen = np.concatenate([np.asarray(h_j.anchors),
                                  np.ones(h_j.skybox_count, bool)])
    np.testing.assert_array_equal(step.frozen_rows.numpy(), want_frozen)
    state = tpost.init_post_state(h_t)
    rng = random.Random(0)
    seen = []
    for i in range(20):
        state, aux = step(state, bt[i % 2], tpost.random_limit(rng),
                          torch.eye(3, 4))
        seen.append(float(aux["loss"]))
        assert int(aux["cut_overflow"]) == 0
    frozen = torch.tensor(want_frozen)
    for a, b in zip(h_t.params, state.params):
        assert torch.equal(a[frozen], b[frozen])
    assert not torch.equal(h_t.params.xyz[~frozen], state.params.xyz[~frozen])
    assert np.mean(seen[-5:]) < np.mean(seen[:5])


def test_compact_post_driver_matches_jax():
    """The driver started at capacity 2 grows to the same power of two with
    the same number of redos as JAX's driver (8 steps, limits from
    random_limit(random.Random(0))), and its final state equals, bit for
    bit, a run started at that capacity (which redoes nothing)."""
    h_j, h_t, _ = built()
    bj, bt = batches()

    def run_j(capacity):
        d = jpost.CompactPostDriver(h_j, jcfg.OptimizationConfig(**OPT),
                                    jcfg.PipelineConfig(**PIPES["tiled"]),
                                    capacity=capacity,
                                    use_trained_exp=False)
        rng = random.Random(0)
        for i in range(8):
            d.step(bj[i % 2], jnp.float32(jpost.random_limit(rng)),
                   jnp.eye(3, 4))
        return d, d.finish()

    def run_t(capacity):
        d = tpost.CompactPostDriver(h_t, tcfg.OptimizationConfig(**OPT),
                                    tcfg.PipelineConfig(**PIPES["tiled"]),
                                    capacity=capacity,
                                    use_trained_exp=False)
        rng = random.Random(0)
        for i in range(8):
            d.step(bt[i % 2], tpost.random_limit(rng), torch.eye(3, 4))
        return d, d.finish()

    dj, _ = run_j(2)
    d_small, s_small = run_t(2)
    assert (d_small.capacity, d_small.redos) == (dj.capacity, dj.redos)
    assert d_small.redos > 0
    d_big, s_big = run_t(d_small.capacity)
    assert d_big.redos == 0 and d_big.capacity == d_small.capacity
    for a, b in zip(s_small.params, s_big.params):
        assert torch.equal(a, b)
    for a, b in zip(s_small.adam_state.mu + s_small.adam_state.nu,
                    s_big.adam_state.mu + s_big.adam_state.nu):
        assert torch.equal(a, b)


def test_compact_post_driver_redo_exact_counts():
    """In the pallas exact counts config (the production one), the driver
    started at capacity 2 grows and redoes, and ends bit for bit where a
    run started at its final capacity ends."""
    _, h_t, _ = built()
    _, bt = batches()

    def run(capacity):
        d = tpost.CompactPostDriver(h_t, tcfg.OptimizationConfig(**OPT),
                                    tcfg.PipelineConfig(**PIPES["pallas"]),
                                    capacity=capacity)
        rng = random.Random(1)
        for i in range(6):
            d.step(bt[i % 2], tpost.random_limit(rng), torch.eye(3, 4))
        return d, d.finish()

    d_small, s_small = run(2)
    d_big, s_big = run(d_small.capacity)
    assert d_small.redos > 0 and d_big.redos == 0
    for a, b in zip(s_small.params + s_small.adam_state.mu,
                    s_big.params + s_big.adam_state.mu):
        assert torch.equal(a, b)


def test_random_limit_and_default_capacity_match_jax():
    """The same limits from the same random.Random, and the same initial
    capacity from the same hierarchy and camera positions."""
    a, b = random.Random(7), random.Random(7)
    assert [jpost.random_limit(a) for _ in range(50)] == \
        [tpost.random_limit(b) for _ in range(50)]
    h_j, h_t, s = built()
    campos = [np.asarray(c.campos) for c in s.cameras]
    for limit in (jpost.LIMIT_MIN, 0.03):
        assert tpost.default_post_capacity(h_t, campos, limit) == \
            jpost.default_post_capacity(h_j, [jnp.asarray(c)
                                              for c in campos], limit)


def jax_synth_hierarchy():
    """``synth_hierarchy`` of tools/post_scaling_tpu.py, compiled alone: the
    tool's module sets a persistent JAX compilation cache when imported."""
    src = (ROOT / "tools" / "post_scaling_tpu.py").read_text()
    fn = next(n for n in ast.parse(src).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "synth_hierarchy")
    ns = dict(np=np, jnp=jnp, math=math, GaussianParams=GaussianParams,
              Hierarchy=jst.Hierarchy)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "synth", "exec"),
         ns)
    return ns["synth_hierarchy"]


@pytest.mark.parametrize("n_leaves", [64, 37])
def test_synth_hierarchy_matches_jax(n_leaves):
    """The scaling tool's synthetic tree equals the JAX tool's, every field
    exactly (37 leaves: levels of odd width, a parent of one child)."""
    want = jax_synth_hierarchy()(n_leaves, seed=3)
    got = post_scaling.synth_hierarchy(n_leaves, seed=3, device="cpu")
    for k in GaussianParams._fields:
        np.testing.assert_array_equal(getattr(got.params, k).numpy(),
                                      np.asarray(getattr(want.params, k)),
                                      err_msg=k)
    for k in jst.Hierarchy._fields[1:-1]:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.skybox_count == want.skybox_count


def test_post_scaling_measure_runs_on_cpu():
    """The tool's measurement end to end at a tiny size, in its production
    exact counts config: a cut at most the target, no overflow at the
    tool's capacity, finite times."""
    (rec,) = post_scaling.measure("cpu", sizes=(256,), res=32)
    assert rec["nodes"] == 511 and 0 < rec["cut"] <= post_scaling.CUT_TARGET
    assert rec["cut_overflow"] == 0
    assert math.isfinite(rec["mask_ms"]) and math.isfinite(rec["compact_ms"])
