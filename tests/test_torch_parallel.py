"""PyTorch port, multi-rank layer (``parallel/``): the mesh and its
groups, the autograd collectives, the tile-sharded padded and exact
renders and the ring-staged render and train step, each held against the
JAX parallel function on the 8-device virtual CPU mesh (Pallas in
interpret mode, as ``tests/test_parallel.py`` runs it) on the same numpy
inputs at that file's sizes (48x48, 192 rows, K = 128 or 256, max_dup 16).

The port's side runs in one spawned ``gloo`` world of 4 ranks on the CPU
(``tests/torch_parallel_ranks.py``), shared by every case of this file.
Bars: images and depth at 2e-5; grads at 3e-4 * max|g| with rtol 2e-3
(``tests/test_parallel.py:66-67``); the ring step's loss at rtol 1e-5,
params within one Adam quantum, exposure at 1e-6, ``denom`` exact."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.config import OptimizationConfig, PipelineConfig
from street_sparse_3dgs_tpu.data.toy import make_toy_scene
from street_sparse_3dgs_tpu.models.gaussians import create_from_pcd
from street_sparse_3dgs_tpu.ops.rasterize import RasterConfig
from street_sparse_3dgs_tpu.parallel.mesh import make_mesh
from street_sparse_3dgs_tpu.parallel.ring import (make_ring_train_step,
                                                  rasterize_ring_staged)
from street_sparse_3dgs_tpu.parallel.tiles import rasterize_tile_sharded
from street_sparse_3dgs_tpu.train.step import CameraBatch, init_state
from street_sparse_3dgs_tpu_torch.parallel.mesh import run_world

import torch_parallel_ranks as ranks

torch.set_num_threads(1)
WORLD = 4
PADDED = RasterConfig(method="pallas", tile_capacity=128, max_dup=16)
EXACT = RasterConfig(method="pallas", tile_capacity=128, max_dup=16,
                     exact_extra=32)
RING = RasterConfig(method="pallas", tile_capacity=256, max_dup=16)


def fields(x):
    """A JAX NamedTuple as nested numpy dicts."""
    return {k: (fields(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in x._asdict().items()}


def view_batch(scene, i, reliable):
    """View ``i`` of ``tests/test_parallel.py``'s mixed batch (its seed-3
    GT and mono depth), as a JAX ``CameraBatch``."""
    h = w = 48
    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 1, (4, 3, h, w)).astype(np.float32)
    mono = rng.uniform(0.1, 1.0, (4, 1, h, w)).astype(np.float32)
    return CameraBatch(
        camera=scene.cameras[i], gt_image=jnp.asarray(gt[i]),
        alpha_mask=jnp.ones((1, h, w)), mono_invdepth=jnp.asarray(mono[i]),
        depth_mask=jnp.ones((1, h, w)),
        depth_reliable=jnp.asarray(reliable),
        image_index=jnp.asarray(i, jnp.int32))


def bg_draw(it, shape):
    """JAX's step background: uniform(fold_in(PRNGKey(17), it))."""
    return np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(17), it), shape))


def mesh4(n_data, n_tile):
    return make_mesh(n_data=n_data, n_tile=n_tile,
                     devices=jax.devices()[:n_data * n_tile])


@pytest.fixture(scope="module")
def scene():
    return make_toy_scene(seed=0, n=192, n_cameras=8, width=48, height=48)


@pytest.fixture(scope="module")
def ring_setup(scene):
    params, active, meta = create_from_pcd(
        jax.random.PRNGKey(0), np.asarray(scene.means3d),
        np.full((scene.means3d.shape[0], 3), 0.5), capacity=256)
    return params, active, meta, view_batch(scene, 0, True)


@pytest.fixture(scope="module")
def port(scene, ring_setup, tmp_path_factory):
    """Every rank's results of ``ranks.tile_and_ring_cases``."""
    params, active, meta, view = ring_setup
    inp = {"rows": {k: np.asarray(getattr(scene, k)) for k in
                    ("means3d", "scales", "quats", "opacities",
                     "sh_coeffs")},
           "cams": [fields(c) for c in scene.cameras],
           "meta": {k: getattr(meta, k) for k in meta.__dataclass_fields__},
           "state_ring": fields(init_state(params, active, n_images=1)),
           "ring_view": fields(view),
           "bg_ring": bg_draw(1, (3,))}
    root = tmp_path_factory.mktemp("parallel")
    path = root / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return run_world(ranks.tile_and_ring_cases, WORLD, root / "world",
                     "gloo", args=(str(path),), timeout_s=600)


def close_grads(got, want):
    scale = float(np.abs(want).max()) + 1e-8
    np.testing.assert_allclose(got, want, atol=3e-4 * scale, rtol=2e-3)


def same_on_every_rank(port, key):
    """The replicated result ``key`` of rank 0, after checking every rank
    holds it bit for bit."""
    outs, grads = port[0][key]
    for r in port[1:]:
        for k, v in outs.items():
            np.testing.assert_array_equal(r[key][0][k], v, err_msg=k)
        for a, b in zip(r[key][1], grads):
            np.testing.assert_array_equal(a, b)
    return outs, grads


@pytest.mark.parametrize("shape", [(1, WORLD), (WORLD, 1), (2, WORLD // 2)])
def test_make_mesh_groups_match_jax(port, shape):
    """Rank r of a port mesh sits where device r sits in JAX's mesh over
    devices[:4]: its coordinates, each axis's size, and its 'tile' group
    (its mesh row) and 'data' group (its column)."""
    grid = np.vectorize(lambda d: d.id)(mesh4(*shape).devices)
    for r, res in enumerate(port):
        got = res["mesh"][shape]
        d, t = map(int, np.argwhere(grid == r)[0])
        assert got["index"] == {"data": d, "tile": t}
        assert got["combined"] == d * shape[1] + t
        assert got["size"] == {"data": shape[0], "tile": shape[1]}
        assert got["groups"]["tile"] == grid[d].tolist()
        assert got["groups"]["data"] == grid[:, t].tolist()


def test_collectives_backward(port):
    """``all_gather_slabs``: every rank's rows in rank order; its backward
    this rank's own slice of the cotangent (not a sum over ranks).
    ``ring_shift``: rank i's tensor at rank i + 1; its backward the reverse
    shift.  ``all_reduce`` SUM, MAX and the bool union."""
    n = WORLD
    weight = np.arange(n * 3 * 2, dtype=np.float32).reshape(n * 3, 2)
    for r, res in enumerate(port):
        c = res["collectives"]
        np.testing.assert_array_equal(
            c["gathered"], np.repeat(np.arange(1, n + 1, dtype=np.float32),
                                     3)[:, None].repeat(2, 1))
        np.testing.assert_array_equal(c["gather_grad"],
                                      weight[3 * r:3 * r + 3])
        np.testing.assert_array_equal(c["shifted"], np.full(4, (r - 1) % n))
        np.testing.assert_array_equal(c["shift_grad"],
                                      np.full(4, 10 + (r + 1) % n))
        np.testing.assert_array_equal(c["sum"], [6.0, -6.0])
        np.testing.assert_array_equal(c["max"], [3.0, 0.0])
        np.testing.assert_array_equal(c["union"], [True, False])


def test_tile_sharded_padded_matches_jax(port, scene):
    """Padded path (K1 at tile0 = rank · t_local): image and depth at 2e-5,
    the grad of mean(render^2) w.r.t. the means at JAX's bar."""
    mesh = mesh4(1, WORLD)
    cam = scene.cameras[0]
    rest = (scene.scales, scene.quats, scene.opacities, scene.sh_coeffs)

    def run(means):
        return rasterize_tile_sharded(means, *rest, cam, 3, jnp.zeros(3),
                                      mesh, PADDED)

    with mesh:
        want = jax.jit(run)(scene.means3d)
        g = jax.jit(jax.grad(lambda m: jnp.mean(run(m)["render"] ** 2)))(
            scene.means3d)
    outs, grads = same_on_every_rank(port, "tiles_padded")
    for k in ("render", "depth", "alpha"):
        np.testing.assert_allclose(outs[k], np.asarray(want[k]), atol=2e-5)
    assert int(outs["tile_overflow"]) == int(want["tile_overflow"])
    close_grads(grads[0], np.asarray(g))


def test_tile_sharded_exact_matches_jax(port, scene):
    """Exact path (shard-segmented windows, K3 over each rank's tiles
    through ``order``): image at 2e-5 with no tile overflow, the grad of
    mean(render^2) + 0.2 mean(depth) at JAX's bar."""
    mesh = mesh4(1, WORLD)
    cam = scene.cameras[0]
    rest = (scene.scales, scene.quats, scene.opacities, scene.sh_coeffs)
    bg = jnp.array([0.2, 0.1, 0.3])

    def run(means):
        return rasterize_tile_sharded(means, *rest, cam, 3, bg, mesh, EXACT)

    def loss(means):
        o = run(means)
        return jnp.mean(o["render"] ** 2) + 0.2 * jnp.mean(o["depth"])

    want = jax.jit(run)(scene.means3d)
    g = jax.jit(jax.grad(loss))(scene.means3d)
    outs, grads = same_on_every_rank(port, "tiles_exact")
    assert int(outs["tile_overflow"]) == int(want["tile_overflow"]) == 0
    for k in ("render", "depth", "alpha"):
        np.testing.assert_allclose(outs[k], np.asarray(want[k]), atol=2e-5)
    close_grads(grads[0], np.asarray(g))


def test_ring_staged_matches_jax(port, scene):
    """Ring render (rows and tiles over 4 ranks, K1 at each rank's tile0):
    image and depth at 2e-5, no pair or tile overflow; the grads of
    mean(render^2) + mean(depth) w.r.t. the means and SH, each rank's own
    rows, at JAX's bar."""
    mesh = mesh4(1, WORLD)
    cam = scene.cameras[0]

    def run(means, sh):
        return rasterize_ring_staged(means, scene.scales, scene.quats,
                                     scene.opacities, sh, cam, 3,
                                     jnp.zeros(3), mesh, RING)

    def loss(means, sh):
        o = run(means, sh)
        return jnp.mean(o["render"] ** 2) + jnp.mean(o["depth"])

    with mesh:
        want = jax.jit(run)(scene.means3d, scene.sh_coeffs)
        gm, gsh = jax.jit(jax.grad(loss, argnums=(0, 1)))(scene.means3d,
                                                          scene.sh_coeffs)
    outs = port[0]["ring"][0]
    for r in port[1:]:
        np.testing.assert_array_equal(r["ring"][0]["render"], outs["render"])
    for k in ("pair_overflow", "tile_overflow", "dup_overflow"):
        assert int(outs[k]) == int(want[k]), k
    assert int(outs["pair_overflow"]) == int(outs["tile_overflow"]) == 0
    for k in ("render", "depth", "alpha"):
        np.testing.assert_allclose(outs[k], np.asarray(want[k]), atol=2e-5)
    got_m = np.concatenate([r["ring"][1][0] for r in port])
    got_sh = np.concatenate([r["ring"][1][1] for r in port])
    close_grads(got_m, np.asarray(gm))
    close_grads(got_sh, np.asarray(gsh))


def test_ring_pair_overflow_counted_as_jax(port, scene):
    """A stage capacity of 8 pairs drops pairs, and the port counts the
    same dropped pairs as JAX."""
    mesh = mesh4(1, WORLD)
    with mesh:
        want = jax.jit(lambda m: rasterize_ring_staged(
            m, scene.scales, scene.quats, scene.opacities, scene.sh_coeffs,
            scene.cameras[0], 3, jnp.zeros(3), mesh, PADDED,
            stage_pair_capacity=8)["pair_overflow"])(scene.means3d)
    assert int(want) > 0
    for r in port:
        assert r["ring_pair_overflow"] == int(want)


def test_ring_rejects_exact_mode(port, scene):
    mesh = mesh4(1, WORLD)
    with pytest.raises(ValueError, match="exact_extra"):
        rasterize_ring_staged(
            scene.means3d, scene.scales, scene.quats, scene.opacities,
            scene.sh_coeffs, scene.cameras[0], 3, jnp.zeros(3), mesh,
            RasterConfig(method="pallas", tile_capacity=128, exact_extra=64))
    for r in port:
        assert "exact_extra" in r["ring_exact_refused"]


def adam_quantum(opt, name):
    """One Adam step's size for a parameter field."""
    return {"xyz": opt.position_lr_init, "features_dc": opt.feature_lr,
            "features_rest": opt.feature_lr / 20.0,
            "opacity_raw": opt.opacity_lr, "log_scales": opt.scaling_lr,
            "quats": opt.rotation_lr}[name]


def assert_state_close(got, want, opt, what):
    """Params within one Adam quantum (2.05 lr + 1e-5, the bar of
    ``tests/test_parallel.py:211-221``), exposure at 1e-6, grad_accum and
    max_radii2d at 1e-5, denom exact."""
    for name in want["params"]:
        dev = float(np.abs(got["params"][name] - want["params"][name]).max())
        bound = 2.05 * adam_quantum(opt, name) + 1e-5
        assert dev <= bound, f"{what} {name}: {dev} > {bound}"
    np.testing.assert_allclose(got["exposure"], want["exposure"], atol=1e-6)
    np.testing.assert_allclose(got["grad_accum"], want["grad_accum"],
                               atol=1e-5)
    np.testing.assert_array_equal(got["denom"], want["denom"])
    np.testing.assert_allclose(got["max_radii2d"], want["max_radii2d"],
                               atol=1e-5)


def test_ring_train_step_matches_jax(port, ring_setup):
    """The ring train step (rows, moments and stats sharded over 4 ranks)
    against JAX's on the (1 x 4) mesh, from the same state with JAX's
    background draw: loss at rtol 1e-5, n_visible equal, the state as
    ``assert_state_close`` (the ranks' rows concatenated); the depth-only
    flag changes the update."""
    params, active, meta, view = ring_setup
    opt = OptimizationConfig()
    pipe = PipelineConfig(tile_capacity=256, max_dup=16,
                          raster_method="pallas")
    mesh = mesh4(1, WORLD)
    step, shard_state = make_ring_train_step(meta, opt, pipe, 1.0, mesh)
    with mesh:
        state, aux = step(shard_state(init_state(params, active,
                                                 n_images=1)), view, 3)
    want = fields(state)
    got = {k: v for k, v in port[0]["ring_step"]["state"].items()}
    for k in ("grad_accum", "denom", "max_radii2d"):
        got[k] = np.concatenate([r["ring_step"]["state"][k] for r in port])
    got["params"] = {
        k: np.concatenate([r["ring_step"]["state"]["params"][k]
                           for r in port]) for k in want["params"]}
    np.testing.assert_allclose(port[0]["ring_step"]["loss"],
                               float(aux["loss"]), rtol=1e-5, atol=1e-6)
    assert port[0]["ring_step"]["n_visible"] == int(aux["n_visible"])
    assert_state_close(got, want, opt, "ring")
    for r in port:
        assert r["ring_step"]["loss"] == port[0]["ring_step"]["loss"]
        np.testing.assert_array_equal(r["ring_step"]["state"]["exposure"],
                                      got["exposure"])
    flagged = np.concatenate([r["ring_step"]["xyz_depth_flag"]
                              for r in port])
    assert not np.allclose(flagged, got["params"]["xyz"])
