"""PyTorch port, multi-rank training (``parallel/dp.py``, ``parallel/
tp.py``, ``parallel/dryrun.py``): the data-parallel step, the batch
tile-sharded padded and exact renders and grads and the (data x tile)
steps, padded and exact counts, each held against the JAX parallel
function on the 8-device virtual CPU mesh (Pallas in interpret mode) on
the same numpy inputs and JAX's background draws, at
``tests/test_parallel.py``'s sizes; the exact counts step's revert on a
forced overflow; and the port's dry run at world 2.

The port's side runs in one spawned ``gloo`` world of 4 ranks on the CPU
(``tests/torch_parallel_ranks.py``): the DP step on a (4 x 1) mesh, the
batch renders and tp steps on (2 x 2).  Bars: images at 2e-5; grads at
3e-4 * max|g| with rtol 2e-3; steps: loss at rtol 1e-5, params within one
Adam quantum, exposure at 1e-6, ``denom`` exact (``tests/
test_parallel.py:203-224``)."""

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
from street_sparse_3dgs_tpu.parallel.dp import make_dp_train_step
from street_sparse_3dgs_tpu.parallel.tp import (make_tile_sharded_train_step,
                                                rasterize_batch_tile_sharded)
from street_sparse_3dgs_tpu.train.step import init_state
from street_sparse_3dgs_tpu_torch.parallel import dryrun
from street_sparse_3dgs_tpu_torch.parallel.mesh import run_world

import torch_parallel_ranks as ranks
from test_torch_parallel import (WORLD, assert_state_close, bg_draw,
                                 close_grads, fields, mesh4, view_batch)

torch.set_num_threads(1)
B = 4
FLAGS = [False, True, False, False]
BGS2 = np.array([[0.1, 0.2, 0.3], [0.9, 0.5, 0.0]], np.float32)
BATCH_CFG = {
    "batch_padded": RasterConfig(method="pallas", tile_capacity=128,
                                 max_dup=16),
    "batch_exact": RasterConfig(method="pallas", tile_capacity=128,
                                max_dup=16, exact_extra=16,
                                grad_reduce="counts")}
TP_PIPE = {
    "tp_padded": PipelineConfig(tile_capacity=128, max_dup=16,
                                raster_method="pallas"),
    "tp_exact": PipelineConfig(tile_capacity=128, max_dup=16,
                               raster_method="pallas", exact_extra=16,
                               grad_reduce="counts")}


@pytest.fixture(scope="module")
def scene():
    return make_toy_scene(seed=0, n=192, n_cameras=8, width=48, height=48)


@pytest.fixture(scope="module")
def setup(scene):
    params, active, meta = create_from_pcd(
        jax.random.PRNGKey(0), np.asarray(scene.means3d),
        np.full((scene.means3d.shape[0], 3), 0.5), capacity=256)
    views = [view_batch(scene, i, i == 1) for i in range(B)]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *views)
    return params, active, meta, views, batch


@pytest.fixture(scope="module")
def port(scene, setup, tmp_path_factory):
    """Every rank's results of ``ranks.step_cases``."""
    params, active, meta, views, _ = setup
    inp = {"rows": {k: np.asarray(getattr(scene, k)) for k in
                    ("means3d", "scales", "quats", "opacities",
                     "sh_coeffs")},
           "cams": [fields(c) for c in scene.cameras],
           "meta": {k: getattr(meta, k) for k in meta.__dataclass_fields__},
           "state": fields(init_state(params, active, n_images=B)),
           "batch": [fields(v) for v in views], "flags": FLAGS,
           "bgs_step": bg_draw(1, (B, 3)), "bgs2": BGS2}
    root = tmp_path_factory.mktemp("parallel_steps")
    path = root / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return run_world(ranks.step_cases, WORLD, root / "world", "gloo",
                     args=(str(path),), timeout_s=600)


def check_step(port, key, want_state, want_aux):
    """Every rank holds the same state and loss (replicated update), and
    rank 0's match JAX's."""
    got = port[0][key]
    for r in port[1:]:
        assert r[key]["loss"] == got["loss"]
        np.testing.assert_array_equal(r[key]["state"]["params"]["xyz"],
                                      got["state"]["params"]["xyz"])
        np.testing.assert_array_equal(r[key]["state"]["exposure"],
                                      got["state"]["exposure"])
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], float(want_aux["loss"]),
                               rtol=1e-5, atol=1e-6)
    assert_state_close(got["state"], fields(want_state), OptimizationConfig(),
                       key)
    return got


def test_dp_step_matches_jax(port, setup):
    """The data-parallel step, one view a rank over 4 ranks, against JAX's
    on a (4 x 1) mesh with its own background draw, on the mixed batch
    (view 1 depth-only)."""
    params, active, meta, _, batch = setup
    mesh = mesh4(B, 1)
    step, shard_batch, shard_state = make_dp_train_step(
        meta, OptimizationConfig(), TP_PIPE["tp_padded"], 1.0, mesh)
    with mesh:
        state, aux = step(shard_state(init_state(params, active,
                                                 n_images=B)),
                          shard_batch(batch), 3, jnp.asarray(FLAGS))
    got = check_step(port, "dp", state, aux)
    assert got["n_visible"] == int(aux["n_visible"])


@pytest.mark.parametrize("key", sorted(BATCH_CFG))
def test_batch_tile_sharded_matches_jax(port, scene, key):
    """Two views' tiles over (2 x 2) ranks (K1 at t_mod = T_pad with
    per-tile backgrounds; K3 at t_mod = tpp over each rank's tiles with
    the background composited outside) against JAX's on (2 x 4): images
    and alpha at 2e-5, the grads of mean(render^2) + 0.3 mean(depth^2)
    w.r.t. the means and scales at JAX's bar."""
    cfg = BATCH_CFG[key]
    mesh = mesh4(2, 4)
    cams = jax.tree.map(lambda *xs: jnp.stack(xs), *scene.cameras[:2])
    bgs = jnp.asarray(BGS2)
    rest = (scene.quats, scene.opacities, scene.sh_coeffs)

    def run(means, scales):
        return rasterize_batch_tile_sharded(means, scales, *rest, cams, 3,
                                            bgs, mesh, config=cfg)

    def loss(means, scales):
        o = run(means, scales)
        return jnp.mean(o["render"] ** 2) + 0.3 * jnp.mean(o["depth"] ** 2)

    with mesh:
        want = jax.jit(run)(scene.means3d, scene.scales)
        gm, gs = jax.jit(jax.grad(loss, argnums=(0, 1)))(scene.means3d,
                                                         scene.scales)
    outs, grads = port[0][key]
    for r in port[1:]:
        np.testing.assert_array_equal(r[key][0]["render"], outs["render"])
        np.testing.assert_array_equal(r[key][1][0], grads[0])
    assert int(outs["tile_overflow"]) == int(want["tile_overflow"])
    for k in ("render", "alpha", "depth"):
        np.testing.assert_allclose(outs[k], np.asarray(want[k]), atol=2e-5)
    close_grads(grads[0], np.asarray(gm))
    close_grads(grads[1], np.asarray(gs))


@pytest.mark.parametrize("key", sorted(TP_PIPE))
def test_tp_step_matches_jax(port, setup, key):
    """The (data x tile) step over (2 x 2) ranks against JAX's on (2 x 4),
    on the mixed batch with JAX's draws: the loss, the state within one
    Adam quantum, exposure at 1e-6, denom exact; exact counts mode skips
    no update; the depth-only flag changes the padded step's update."""
    params, active, meta, _, batch = setup
    mesh = mesh4(2, 4)
    step, replicate = make_tile_sharded_train_step(
        meta, OptimizationConfig(), TP_PIPE[key], 1.0, mesh)
    with mesh:
        state, aux = step(replicate(init_state(params, active, n_images=B)),
                          replicate(batch), 3, jnp.asarray(FLAGS))
    got = check_step(port, key, state, aux)
    assert got["aux"]["tile_overflow"] == int(aux["tile_overflow"])
    assert got["aux"]["n_visible"] == int(aux["n_visible"])
    if key == "tp_exact":
        assert got["aux"]["update_skipped"] == int(aux["update_skipped"]) == 0
    else:
        assert not np.allclose(got["xyz_flags_off"],
                               got["state"]["params"]["xyz"])


def test_tp_counts_revert_on_forced_overflow(port):
    """The (data x tile) exact counts step with splats 4x larger and a
    one-window budget overflows, as ``tests/test_torch_train.py`` forces
    the serial step to: every rank keeps the old state bit for bit,
    advances the step counter and reports update_skipped."""
    def leaves(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + k + ".")
            elif k != "step" or path:
                yield path + k, v

    for r in port:
        got = r["tp_overflow"]
        assert got["aux"]["tile_overflow"] > 0
        assert got["aux"]["update_skipped"] == 1
        assert int(got["state"]["step"]) == int(got["old"]["step"]) + 1
        old = dict(leaves(got["old"]))
        new = dict(leaves(got["state"]))
        assert old.keys() == new.keys()
        for k in old:
            np.testing.assert_array_equal(new[k], old[k], err_msg=k)


def test_dryrun_world_2(tmp_path):
    """``parallel/dryrun.py`` at world 2 on the CPU: every stage of the
    sequence runs and reports finite losses and images of the right
    shape."""
    rec = dryrun.run(device="cpu", world=2, store_dir=tmp_path)
    assert rec["world"] == 2
    for name in ("dp", "tp_padded", "tp_exact", "ring_step"):
        assert np.isfinite(rec[name]["loss"]), name
    assert rec["tp_exact"]["update_skipped"] == 0
    for name in ("tiles_padded", "tiles_exact", "ring", "hierarchy_cut"):
        assert rec[name]["shape"] == [3, 32, 32], name
        assert rec[name]["finite"], name
    assert rec["post"]["finite"]
    assert rec["full_train"]["merged"]
