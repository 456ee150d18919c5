"""PyTorch port, training slice: losses, schedules, KNN, model init, the
masked sparse and dense Adam, densify/prune, opacity reset, capacity
growth, one train step, an 8-step loss trajectory in exact mode, the
counts-mode revert and the loop, each against the JAX package on the same
inputs (random draws — skybox, split noise, backgrounds — are JAX's,
handed over as numpy).  Tolerances are stated per test."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu import config as jcfg
from street_sparse_3dgs_tpu import utils as jutils
from street_sparse_3dgs_tpu.core import knn as jknn
from street_sparse_3dgs_tpu.core.schedules import expon_lr as j_expon_lr
from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.models import adam as jadam
from street_sparse_3dgs_tpu.models import densify as jdens
from street_sparse_3dgs_tpu.models import gaussians as jg
from street_sparse_3dgs_tpu.ops.rasterize import (RasterConfig as JRaster,
                                                  rasterize as j_rasterize)
from street_sparse_3dgs_tpu.train import loop as jloop
from street_sparse_3dgs_tpu.train import losses as jlosses
from street_sparse_3dgs_tpu.train import step as jstep
from street_sparse_3dgs_tpu_torch import config as tcfg
from street_sparse_3dgs_tpu_torch import convert, utils as tutils
from street_sparse_3dgs_tpu_torch.core import knn as tknn
from street_sparse_3dgs_tpu_torch.core.schedules import expon_lr
from street_sparse_3dgs_tpu_torch.models import adam as tadam
from street_sparse_3dgs_tpu_torch.models import densify as tdens
from street_sparse_3dgs_tpu_torch.models import gaussians as tg
from street_sparse_3dgs_tpu_torch.train import loop as tloop
from street_sparse_3dgs_tpu_torch.train import losses as tlosses
from street_sparse_3dgs_tpu_torch.train import step as tstep

torch.set_num_threads(1)
W = H = 64


def t(x):
    return torch.tensor(np.asarray(x))


def fields(x):
    """A JAX NamedTuple as nested numpy mappings."""
    return {k: (fields(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in x._asdict().items()}


def assert_tree_close(got, want, rtol, atol, what=""):
    """Port NamedTuple against a JAX one, leaf by leaf."""
    for name, a in want._asdict().items():
        b = getattr(got, name)
        if hasattr(a, "_asdict"):
            assert_tree_close(b, a, rtol, atol, f"{what}.{name}")
        else:
            np.testing.assert_allclose(np.asarray(b.detach().cpu()),
                                       np.asarray(a), rtol=rtol, atol=atol,
                                       err_msg=f"{what}.{name}")


# ---- losses and schedules ---------------------------------------------------

LOSSES = ("l1", "l2", "ssim", "ssim_map", "masked_ssim", "photometric",
          "depth_l1", "depth_hinge", "psnr", "psnr_masked")


@pytest.mark.parametrize("name", LOSSES)
def test_losses_match_jax(name):
    """Each loss at 1e-6 (relative and absolute) on random [3, 40, 56]
    images; SSIM's window convolution in full f32 in both."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, 40, 56)) > 0.3).astype(np.float32)
    args = {"masked_ssim": (a, b, mask), "depth_l1": (a[:1], b[:1], mask),
            "depth_hinge": (a[:1], b[:1]), "psnr_masked": (a, b, mask)}.get(
        name, (a, b))
    want = np.asarray(getattr(jlosses, name)(*(jnp.asarray(x) for x in args)))
    got = getattr(tlosses, name)(*(torch.tensor(x) for x in args)).numpy()
    # The per-pixel SSIM map (not a loss) holds 1e-5: its 11-tap window
    # sums round apart in the two convolutions; the means hold 1e-6.
    tol = 1e-5 if name == "ssim_map" else 1e-6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_expon_lr_matches_jax():
    """Same float32 formula; the CPU exp of XLA is its own polynomial, so
    values agree to within 1 ulp (and mostly exactly)."""
    cases = [dict(lr_init=2e-5 * 3.7, lr_final=2e-7 * 3.7,
                  lr_delay_mult=0.01, max_steps=30000),
             dict(lr_init=1e-3, lr_final=1e-4, lr_delay_steps=5000,
                  lr_delay_mult=0.001, max_steps=30000),
             dict(lr_init=0.0, lr_final=0.0)]
    exact = total = 0
    for kw in cases:
        for s in [-1, 0, 1, 2, 7, 100, 999, 4999, 5000, 12345, 30000, 40000]:
            want = np.float32(j_expon_lr(s, **kw))
            got = expon_lr(s, **kw).numpy()
            assert got.dtype == np.float32
            assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1
            exact += int(got == want)
            total += 1
    assert exact >= total - 3


def test_ema_meter_matches_jax():
    a, b = jutils.EmaMeter(), tutils.EmaMeter()
    for x in (1.0, 0.5, 0.25, 2.0):
        assert a.update(x) == b.update(x)


def test_config_fields_match_jax():
    for name in ("ModelConfig", "PipelineConfig", "OptimizationConfig"):
        jf = {f.name: f.default for f in
              dataclasses.fields(getattr(jcfg, name))}
        tf = {f.name: f.default for f in
              dataclasses.fields(getattr(tcfg, name))}
        assert jf == tf, name
    assert tcfg.parse_tails("8:2,3:4") == jcfg.parse_tails("8:2,3:4")


# ---- knn and init -----------------------------------------------------------

def test_knn_exact_and_grid_match_jax():
    """Exact 3-NN (the |q|^2 - 2 q.p + |p|^2 form of both, rounded apart)
    to rtol 1e-4 of the distance; the voxel-hash version on the same grid
    to rtol 1e-5."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    want = np.asarray(jknn.mean_sq_dist_to_3nn(jnp.asarray(pts)))
    got = tknn.mean_sq_dist_to_3nn(torch.tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    want_g = np.asarray(jknn.grid_mean_sq_dist_to_3nn(pts, query_chunk=256))
    got_g = tknn.grid_mean_sq_dist_to_3nn(torch.tensor(pts),
                                          query_chunk=256).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5)
    # The grid search is exact where it finds three neighbours in range.
    assert np.mean(np.isclose(got_g, got, rtol=1e-4)) > 0.5


def test_create_from_pcd_matches_jax():
    """Init with a skybox dome from JAX's two uniform draws: every parameter
    within 1e-6 (log scales 1e-4: the 3-NN distances round apart; xyz
    1e-6 of the dome radius, where the two f32 sin/cos round apart), the
    active mask and the metadata equal."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    params, active, meta = jg.create_from_pcd(key, pts, cols, sh_degree=3,
                                              skybox_points=50, capacity=400)
    k1, k2 = jax.random.split(key)
    uni = np.stack([np.asarray(jax.random.uniform(k1, (50,))),
                    np.asarray(jax.random.uniform(k2, (50,)))])
    got_p, got_a, got_m = tg.create_from_pcd(
        torch.tensor(pts), torch.tensor(cols), sh_degree=3, skybox_points=50,
        capacity=400, skybox_uniform=torch.tensor(uni))
    for name in tg.GaussianParams._fields:
        want = np.asarray(getattr(params, name))
        tol = {"log_scales": 1e-4,
               "xyz": 1e-6 * np.abs(want).max()}.get(name, 1e-6)
        np.testing.assert_allclose(getattr(got_p, name).numpy(), want,
                                   rtol=1e-6 if name != "log_scales" else tol,
                                   atol=tol, err_msg=name)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(active))
    assert dataclasses.asdict(got_m) == dataclasses.asdict(meta)


@pytest.mark.parametrize("meta", [
    dict(scaffold_points=5), dict(skybox_points=7, skybox_locked=True),
    dict(skybox_points=7), dict(scaffold_points=5, skybox_points=7,
                                skybox_locked=True)])
def test_frozen_mask_matches_jax(meta):
    jm = jg.GaussianMeta(sh_degree=3, capacity=20, **meta)
    tm = convert.config_from(jm, tg.GaussianMeta)
    np.testing.assert_array_equal(
        tg.frozen_mask(tm, 20, device="cpu").numpy(),
        np.asarray(jg.frozen_mask(jm, 20)))


CREATORS = {
    "frozen_mask": lambda **kw: tg.frozen_mask(
        tg.GaussianMeta(sh_degree=3, capacity=20, scaffold_points=5), 20,
        **kw),
    "init_exposure": lambda **kw: tg.init_exposure(4, **kw),
    "densify_init": lambda **kw: tdens.init(20, **kw)}
JAX_TWINS = {
    "frozen_mask": lambda: jg.frozen_mask(
        jg.GaussianMeta(sh_degree=3, capacity=20, scaffold_points=5), 20),
    "init_exposure": lambda: jg.init_exposure(4),
    "densify_init": lambda: jdens.init(20)}


@pytest.mark.parametrize("name", sorted(CREATORS))
def test_creator_defaults_to_the_card(name):
    """These creators default to ``device.DEFAULT_DEVICE`` ("cuda") like
    every other: without a card the default raises, and on the CPU each
    equals its JAX twin."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CREATORS[name]()
    got, want = CREATORS[name](device="cpu"), JAX_TWINS[name]()
    for g, w in zip(*((got, want) if name == "densify_init"
                      else ((got,), (want,)))):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- Adam, densify ---------------------------------------------------------

def random_params(rng, c, k_rest=15):
    return jg.GaussianParams(
        xyz=rng.normal(0, 1, (c, 3)), features_dc=rng.normal(0, 1, (c, 1, 3)),
        features_rest=rng.normal(0, 0.1, (c, k_rest, 3)),
        log_scales=rng.normal(-3, 0.5, (c, 3)),
        quats=rng.normal(0, 1, (c, 4)), opacity_raw=rng.normal(0, 2, (c, 1)))


def as_f32(p):
    return type(p)(*(jnp.asarray(np.asarray(x, np.float32)) for x in p))


def test_sparse_adam_matches_jax_and_freezes_untouched_rows():
    """Three masked steps at 1e-6; rows never relevant keep their params
    and moments bit for bit."""
    rng = np.random.default_rng(3)
    c = 64
    p = as_f32(random_params(rng, c))
    st = jadam.init(p)
    lrs = jadam.ParamLrs.from_config(1.6e-4, 0.0025, 0.05, 0.005, 0.001)
    tp, tst = convert.params_from_numpy(fields(p), "cpu"), None
    tst = tadam.init(tp)
    tlrs = tadam.ParamLrs.from_config(float(lrs.xyz), 0.0025, 0.05, 0.005,
                                      0.001)
    frozen = np.arange(c) % 5 == 0
    for i in range(3):
        g = as_f32(random_params(rng, c))
        rel = (rng.uniform(0, 1, c) > 0.3) & ~frozen
        p, st = jadam.step(p, g, st, lrs, jnp.asarray(rel))
        tp, tst = tadam.step(tp, convert.params_from_numpy(fields(g), "cpu"),
                             tst, tlrs, torch.tensor(rel))
    assert_tree_close(tp, p, 1e-6, 1e-6, "params")
    assert_tree_close(tst.mu, st.mu, 1e-6, 1e-6, "mu")
    assert_tree_close(tst.nu, st.nu, 1e-6, 1e-6, "nu")
    assert int(tst.step) == int(st.step) == 3
    p0 = convert.params_from_numpy(fields(as_f32(random_params(
        np.random.default_rng(3), c))), "cpu")
    for a, b in zip(tp, p0):
        assert torch.equal(a[torch.tensor(frozen)], b[torch.tensor(frozen)])
    for m in tst.mu:
        assert not m[torch.tensor(frozen)].any()


def test_dense_adam_matches_jax():
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(0, 1, (3, 3, 4)).astype(np.float32))
    st = jadam.dense_init(x)
    tx, tst = t(x), tadam.dense_init(t(x))
    for _ in range(4):
        g = rng.normal(0, 1, x.shape).astype(np.float32)
        x, st = jadam.dense_step(x, jnp.asarray(g), st, 1e-3)
        tx, tst = tadam.dense_step(tx, torch.tensor(g), tst, 1e-3)
    np.testing.assert_allclose(tx.numpy(), np.asarray(x), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tst.nu.numpy(), np.asarray(st.nu), rtol=1e-6)


def densify_inputs(seed=5, c=96, n=70):
    rng = np.random.default_rng(seed)
    p = random_params(rng, c)
    p = p._replace(log_scales=np.where(rng.uniform(0, 1, (c, 1)) < 0.5,
                                       -4.5, -1.5) + 0 * p.log_scales)
    params, active = jg.pad_to_capacity(as_f32(jg.GaussianParams(
        *(np.asarray(x)[:n] for x in p))), n, c)
    dstate = jdens.DensifyState(
        grad_accum=jnp.asarray(rng.uniform(0, 0.02, c).astype(np.float32)),
        denom=jnp.ones(c), max_radii2d=jnp.full((c,), 5.0))
    meta = jg.GaussianMeta(sh_degree=3, capacity=c, skybox_points=4,
                           scaffold_points=6)
    return params, active, dstate, meta


@pytest.mark.parametrize("c", [96, 80])
def test_densify_and_prune_matches_jax(c):
    """Same clone/split/prune decisions and free-slot placement with JAX's
    split noise (k0, k1 of split(key)); params within 1e-6.  At capacity 80
    the new rows do not all fit and both count the same overflow."""
    params, active, dstate, meta = densify_inputs(c=c)
    meta = dataclasses.replace(meta, capacity=c)
    astate = jadam.init(params)
    astate = astate._replace(mu=jax.tree.map(lambda x: x + 1.0, astate.mu))
    key = jax.random.PRNGKey(7)
    res = jdens.densify_and_prune(key, params, active, astate, dstate, meta,
                                  grad_threshold=0.01, min_opacity=0.3,
                                  extent=1.0, percent_dense=0.05)
    k0, k1 = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k, (c, 3)))
                      for k in (k0, k1)])
    tres = tdens.densify_and_prune(
        torch.tensor(noise), convert.params_from_numpy(fields(params), "cpu"),
        t(active), tadam.AdamState(
            mu=convert.params_from_numpy(fields(astate.mu), "cpu"),
            nu=convert.params_from_numpy(fields(astate.nu), "cpu"),
            step=t(astate.step)),
        tdens.DensifyState(*(t(x) for x in dstate)),
        convert.config_from(meta, tg.GaussianMeta), 0.01, 0.3, 1.0, 0.05)
    np.testing.assert_array_equal(tres.active.numpy(), np.asarray(res.active))
    assert int(tres.n_active) == int(res.n_active)
    assert int(tres.overflow) == int(res.overflow)
    assert_tree_close(tres.params, res.params, 1e-6, 1e-6, "params")
    assert_tree_close(tres.adam_state.mu, res.adam_state.mu, 0, 0, "mu")
    assert int(res.n_active) != int(np.asarray(active).sum())
    if c == 80:
        assert int(res.overflow) > 0


def test_reset_opacity_and_grow_capacity_match_jax():
    params, active, _, meta = densify_inputs()
    tparams = convert.params_from_numpy(fields(params), "cpu")
    tmeta = convert.config_from(meta, tg.GaussianMeta)
    np.testing.assert_allclose(
        tdens.reset_opacity(tparams, tmeta).opacity_raw.numpy(),
        np.asarray(jdens.reset_opacity(params, meta).opacity_raw),
        rtol=1e-6, atol=1e-6)
    jstate = jstep.init_state(params, active, n_images=3)
    tstate = convert.train_state_from_numpy(fields(jstate), "cpu")
    js2, jm2 = jloop.grow_capacity(jstate, meta, 160)
    ts2, tm2 = tloop.grow_capacity(tstate, tmeta, 160)
    assert dataclasses.asdict(tm2) == dataclasses.asdict(jm2)
    assert_tree_close(ts2, js2, 0, 0, "state")


# ---- the train step and the loop -------------------------------------------

@functools.lru_cache(maxsize=None)
def toy():
    scene = make_toy_scene(seed=3, n=300, n_cameras=4, width=W, height=H)
    gts = [jnp.clip(j_rasterize(
        scene.means3d, scene.scales, scene.quats, scene.opacities,
        scene.sh_coeffs, c, 3, jnp.zeros(3),
        JRaster(method="tiled", tile_capacity=600))["render"], 0.0, 1.0)
        for c in scene.cameras]
    key = jax.random.PRNGKey(0)
    pts = np.asarray(scene.means3d) + 0.02 * np.asarray(
        jax.random.normal(key, scene.means3d.shape))
    cols = np.clip(np.asarray(scene.sh_coeffs[:, 0, :]) * 0.28 + 0.5, 0, 1)
    params, active, meta = jg.create_from_pcd(key, pts, cols, sh_degree=3,
                                              capacity=512)
    # Anisotropic, rotated splats, so every parameter has a real gradient.
    rng = np.random.default_rng(8)
    q = rng.normal(0, 1, (512, 4)).astype(np.float32)
    live = np.asarray(active)[:, None]
    params = params._replace(
        log_scales=params.log_scales + jnp.asarray(np.where(
            live, rng.normal(0, 0.3, (512, 3)), 0.0).astype(np.float32)),
        quats=jnp.where(live, jnp.asarray(
            q / np.linalg.norm(q, axis=1, keepdims=True)), params.quats))
    batches = [jstep.CameraBatch(
        camera=cam, gt_image=gt, alpha_mask=jnp.ones((1, H, W)),
        mono_invdepth=jnp.full((1, H, W), 0.2),
        depth_mask=jnp.ones((1, H, W)), depth_reliable=jnp.array(i % 2 == 0),
        image_index=jnp.int32(i))
        for i, (cam, gt) in enumerate(zip(scene.cameras, gts))]
    return params, active, meta, batches


EXACT = dict(raster_method="pallas", tile_capacity=128, max_dup=32,
             exact_extra=64, grad_reduce="counts")
OPT = dict(iterations=50, position_lr_init=2e-4, position_lr_final=2e-6)


@functools.lru_cache(maxsize=None)
def jax_trajectory(steps=8):
    """JAX states, aux (losses, backgrounds) of ``steps`` exact-mode steps
    round-robin over the toy views."""
    params, active, meta, batches = toy()
    step = jstep.make_train_step(meta, jcfg.OptimizationConfig(**OPT),
                                 jcfg.PipelineConfig(**EXACT), 1.0,
                                 sh_degree_schedule=False)
    state = jstep.init_state(params, active, n_images=len(batches))
    states, auxs = [state], []
    for i in range(steps):
        state, aux = step(state, batches[i % len(batches)])
        states.append(state)
        auxs.append({k: np.asarray(v) for k, v in aux.items()
                     if k != "image"})
    return states, auxs


def port_step(**kw):
    _, _, meta, batches = toy()
    step = tstep.make_train_step(
        convert.config_from(meta, tg.GaussianMeta),
        tcfg.OptimizationConfig(**OPT), tcfg.PipelineConfig(**EXACT), 1.0,
        sh_degree_schedule=False, **kw)
    return step, [convert.camera_batch_from_numpy(fields(b), "cpu")
                  for b in batches]


def test_train_step_matches_jax():
    """One exact-mode counts step from the same converted TrainState with
    JAX's background: the loss within 1e-5 relative; the grads, read from
    the first Adam moment (mu = 0.1 g after one step), within the JAX
    gradient bar (3e-4 * max|g| per parameter, rtol 2e-3); the screen-grad
    statistic and the exposure moment likewise."""
    states, auxs = jax_trajectory()
    step, tbatches = port_step()
    state0 = convert.train_state_from_numpy(fields(states[0]), "cpu")
    new, aux = step(state0, tbatches[0], bg=torch.tensor(auxs[0]["bg"]))
    np.testing.assert_allclose(float(aux["loss"]), float(auxs[0]["loss"]),
                               rtol=1e-5)
    want = states[1]
    for name in tg.GaussianParams._fields:
        a = np.asarray(getattr(want.adam_state.mu, name))
        b = getattr(new.adam_state.mu, name).numpy()
        np.testing.assert_allclose(b, a, atol=3e-4 * np.abs(a).max(),
                                   rtol=2e-3, err_msg=name)
    for a, b in ((want.grad_accum, new.grad_accum),
                 (want.exposure_adam.mu, new.exposure_adam.mu)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, atol=3e-4 * np.abs(a).max(),
                                   rtol=2e-3)
    np.testing.assert_array_equal(new.max_radii2d.numpy(),
                                  np.asarray(want.max_radii2d))
    assert int(new.step) == 1 and int(aux["update_skipped"]) == 0
    assert int(aux["tile_overflow"]) == 0


def test_loss_trajectory_exact_mode_matches_jax():
    """Eight exact-mode steps, JAX's backgrounds fed in: the losses within
    rtol 5e-3 (the bar of tests/test_train.py:393)."""
    states, auxs = jax_trajectory()
    step, tbatches = port_step()
    state = convert.train_state_from_numpy(fields(states[0]), "cpu")
    losses = []
    for i, a in enumerate(auxs):
        state, aux = step(state, tbatches[i % len(tbatches)],
                          bg=torch.tensor(a["bg"]))
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, [float(a["loss"]) for a in auxs],
                               rtol=5e-3)


def big_splats():
    params, active, meta, batches = toy()
    return (params._replace(log_scales=params.log_scales + np.log(4.0)),
            active, meta, batches)


def test_counts_revert_on_forced_overflow():
    """With splats 4x larger and a one-window budget the toy view
    overflows: both packages keep the old state, advance the step and
    report update_skipped."""
    params, active, meta, batches = big_splats()
    pipe = dict(EXACT, exact_extra=1, max_dup=64)
    jstate = jstep.init_state(params, active, n_images=len(batches))
    jnew, jaux = jstep.make_train_step(
        meta, jcfg.OptimizationConfig(**OPT), jcfg.PipelineConfig(**pipe),
        1.0)(jstate, batches[0])
    assert int(jaux["tile_overflow"]) > 0 and int(jaux["update_skipped"]) == 1
    step = tstep.make_train_step(
        convert.config_from(meta, tg.GaussianMeta),
        tcfg.OptimizationConfig(**OPT), tcfg.PipelineConfig(**pipe), 1.0)
    state = convert.train_state_from_numpy(fields(jstate), "cpu")
    new, aux = step(state, convert.camera_batch_from_numpy(
        fields(batches[0]), "cpu"), bg=torch.tensor(np.asarray(jaux["bg"])))
    assert int(aux["tile_overflow"]) == int(jaux["tile_overflow"])
    assert int(aux["update_skipped"]) == 1
    assert int(new.step) == int(jnew.step) == 1
    assert_tree_close(new._replace(step=state.step), state._replace(
        step=state.step), 0, 0, "reverted")


def test_train_loop_with_densify_matches_jax_cadence():
    """A 24-step loop with densification at 6, 12, 18 (tiled method):
    the same number of losses and densify rounds as JAX, all finite, and
    a mean loss within 20% of JAX's (the random backgrounds and split noise
    differ, so the values do not match step by step)."""
    params, active, meta, batches = toy()
    opt = dict(iterations=24, densification_interval=6, densify_from_iter=3,
               densify_until_iter=20, opacity_reset_interval=1000,
               position_lr_init=2e-4, position_lr_final=2e-6,
               densify_grad_threshold=1e-4)
    pipe = dict(tile_capacity=600)
    jstate = jstep.init_state(params, active, n_images=len(batches))
    _, jmeta, jstats = jloop.train_loop(
        jstate, meta, batches, jcfg.OptimizationConfig(**opt),
        jcfg.PipelineConfig(**pipe), jcfg.ModelConfig(), cameras_extent=3.0,
        spatial_lr_scale=1.0, clamp_fraction=1.0)
    tstate = convert.train_state_from_numpy(fields(jstate), "cpu")
    _, tmeta, tstats = tloop.train_loop(
        tstate, convert.config_from(meta, tg.GaussianMeta),
        [convert.camera_batch_from_numpy(fields(b), "cpu") for b in batches],
        tcfg.OptimizationConfig(**opt), tcfg.PipelineConfig(**pipe),
        tcfg.ModelConfig(), cameras_extent=3.0, spatial_lr_scale=1.0,
        clamp_fraction=1.0)
    assert len(tstats["losses"]) == len(jstats["losses"]) == 24
    assert len(tstats["n_active"]) == len(jstats["n_active"]) == 3
    assert np.isfinite(tstats["losses"]).all()
    np.testing.assert_allclose(np.mean(tstats["losses"]),
                               np.mean(jstats["losses"]), rtol=0.2)
    assert tmeta.capacity >= jmeta.capacity // 2


def test_train_loop_budget_grows_from_worst_step():
    """Exact-mode budget growth reads the worst single step's overflow,
    not the sum over the check window; the self-sizing sentinel resolves
    to a budget before the first step (tests/test_torch_autosize.py holds
    its knobs against JAX's)."""
    assert tloop.grown_budget(64, 300, 128) == 128
    assert tloop.grown_budget(512, 200_000, 128) == 2176
    params, active, meta, batches = big_splats()
    tm = convert.config_from(meta, tg.GaussianMeta)
    state = convert.train_state_from_numpy(
        fields(jstep.init_state(params, active, len(batches))), "cpu")
    tb = [convert.camera_batch_from_numpy(fields(b), "cpu") for b in batches]
    opt = tcfg.OptimizationConfig(iterations=4)
    _, _, stats = tloop.train_loop(
        state, tm, tb, opt, tcfg.PipelineConfig(**dict(
            EXACT, exact_extra=-1)), tcfg.ModelConfig(), 3.0, 1.0,
        densify_enabled=False, clamp_fraction=1.0)
    auto = stats["final_pipe"]
    assert auto.exact_extra > 0 and auto.exact_extra % 128 == 0
    assert auto.max_dup in (2, 4, 8, 16) and stats["skipped_updates"] == 0
    _, _, stats = tloop.train_loop(
        state, tm, tb, opt, tcfg.PipelineConfig(**dict(
            EXACT, exact_extra=1, max_dup=64)), tcfg.ModelConfig(), 3.0, 1.0,
        densify_enabled=False, clamp_fraction=1.0)
    assert stats["exact_growths"] == 1 and stats["skipped_updates"] >= 1
    assert stats["final_pipe"].exact_extra == 128
