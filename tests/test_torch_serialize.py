"""PyTorch port, checkpoints and stage artifacts (``models/serialize.py``,
``data/ply.py``): a checkpoint written by either package loads in the other
bit for bit; the Gaussian ``.ply``, the packed ``.bin``, the point-cloud
``.ply`` and the stage artifact set are byte-identical to the JAX
package's; a corrupt ``.bin`` is refused; the loop writes its default
checkpoint under ``model_path``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.data import ply as jply
from street_sparse_3dgs_tpu.models import gaussians as jg
from street_sparse_3dgs_tpu.models import serialize as jser
from street_sparse_3dgs_tpu.train import step as jstep
from street_sparse_3dgs_tpu_torch import config as tcfg
from street_sparse_3dgs_tpu_torch import convert
from street_sparse_3dgs_tpu_torch.data import ply as tply
from street_sparse_3dgs_tpu_torch.data.toy import make_toy_scene
from street_sparse_3dgs_tpu_torch.models import gaussians as tg
from street_sparse_3dgs_tpu_torch.models import serialize as tser
from street_sparse_3dgs_tpu_torch.train import loop as tloop
from street_sparse_3dgs_tpu_torch.train.step import CameraBatch, init_state

torch.set_num_threads(1)


def fields(x):
    return {k: (fields(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in x._asdict().items()}


def leaves(x, prefix=""):
    """{path: numpy array} of a (nested) NamedTuple of JAX or torch
    arrays."""
    out = {}
    for k, v in x._asdict().items():
        if hasattr(v, "_asdict"):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def assert_bit_identical(got, want):
    a, b = leaves(got), leaves(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def jax_state(c=40, n=33, seed=0):
    """A JAX TrainState with every field away from its init values."""
    rng = np.random.default_rng(seed)

    def p():
        return jg.GaussianParams(*(jnp.asarray(rng.normal(0, 1, s).astype(
            np.float32)) for s in ((c, 3), (c, 1, 3), (c, 15, 3), (c, 3),
                                   (c, 4), (c, 1))))

    params, active = jg.pad_to_capacity(
        jg.GaussianParams(*(x[:n] for x in p())), n, c)
    st = jstep.init_state(params, active, n_images=3)
    mu, nu = p(), p()
    return st._replace(
        adam_state=st.adam_state._replace(mu=mu, nu=nu,
                                          step=jnp.int32(17)),
        exposure=st.exposure + 0.01,
        exposure_adam=st.exposure_adam._replace(
            mu=st.exposure + 0.5, step=jnp.int32(5)),
        grad_accum=jnp.asarray(rng.uniform(0, 1, c).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 9, c).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.uniform(0, 9, c).astype(np.float32)),
        step=jnp.int32(123))


META = jg.GaussianMeta(sh_degree=3, capacity=40, skybox_points=2,
                       scaffold_points=0)


def test_jax_checkpoint_loads_in_port_bit_for_bit(tmp_path):
    st = jax_state()
    jser.save_checkpoint(tmp_path / "j.npz", st, META, 123)
    got, meta, it = tser.load_checkpoint(tmp_path / "j.npz", device="cpu")
    assert it == 123
    assert dataclasses.asdict(meta) == dataclasses.asdict(META)
    assert got.step.device.type == "cpu" and int(got.step) == 123
    assert_bit_identical(got, st)


def test_port_checkpoint_loads_in_jax_bit_for_bit(tmp_path):
    st = convert.train_state_from_numpy(fields(jax_state(seed=1)), "cpu")
    tser.save_checkpoint(tmp_path / "t.npz", st,
                         convert.config_from(META, tg.GaussianMeta), 9)
    got, meta, it = jser.load_checkpoint(tmp_path / "t.npz")
    assert it == 9 and meta == META
    assert_bit_identical(got, st)
    # And back into the port.
    again, _, _ = tser.load_checkpoint(tmp_path / "t.npz", device="cpu")
    assert_bit_identical(again, st)


@pytest.mark.parametrize("masked", [False, True])
def test_gaussian_ply_and_packed_bin_byte_identical(tmp_path, masked):
    st = jax_state(seed=2)
    active = np.asarray(st.active) if masked else None
    tparams = convert.params_from_numpy(fields(st.params), "cpu")
    tactive = torch.tensor(active) if masked else None
    jply.save_gaussian_ply(tmp_path / "j.ply", st.params, active)
    tply.save_gaussian_ply(tmp_path / "t.ply", tparams, tactive)
    assert (tmp_path / "j.ply").read_bytes() == \
        (tmp_path / "t.ply").read_bytes()
    jser.save_packed_bin(tmp_path / "j.bin", st.params, active)
    tser.save_packed_bin(tmp_path / "t.bin", tparams, tactive)
    assert (tmp_path / "j.bin").read_bytes() == \
        (tmp_path / "t.bin").read_bytes()
    for loaded, want in ((tply.load_gaussian_ply(tmp_path / "j.ply", "cpu"),
                          jply.load_gaussian_ply(tmp_path / "t.ply")),
                         (tser.load_packed_bin(tmp_path / "j.bin", "cpu"),
                          jser.load_packed_bin(tmp_path / "t.bin"))):
        assert_bit_identical(loaded, want)


def test_corrupt_packed_bin_is_refused(tmp_path):
    st = jax_state(seed=3)
    path = tmp_path / "p.bin"
    tser.save_packed_bin(path, convert.params_from_numpy(fields(st.params),
                                                         "cpu"))
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(ValueError, match="corrupt"):
        tser.load_packed_bin(path, device="cpu")
    with pytest.raises(ValueError, match="corrupt"):
        jser.load_packed_bin(path)


def test_scene_artifacts_byte_identical(tmp_path, monkeypatch):
    """``save_scene`` writes the same files as JAX's (the packed .bin too,
    with its threshold lowered), and ``load_scene_ply`` reads them back."""
    monkeypatch.setattr(jser, "PACKED_BIN_THRESHOLD", 10)
    monkeypatch.setattr(tser, "PACKED_BIN_THRESHOLD", 10)
    st = jax_state(seed=4)
    names = ["a.png", "b.png", "c.png"]
    jdir = jser.save_scene(tmp_path / "j", 7, st, META, names)
    tdir = tser.save_scene(tmp_path / "t", 7,
                           convert.train_state_from_numpy(fields(st), "cpu"),
                           convert.config_from(META, tg.GaussianMeta), names)
    for rel in ("point_cloud.ply", "point_cloud.bin", "pc_info.txt",
                "scaffold_info.txt", "../../exposure.json"):
        assert (jdir / rel).read_bytes() == (tdir / rel).read_bytes(), rel
    params, sky = tser.load_scene_ply(tdir, device="cpu")
    assert sky == 2
    assert_bit_identical(params, jser.load_scene_ply(jdir)[0])


def test_point_cloud_ply_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    xyz = rng.normal(0, 1, (50, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    jply.store_point_cloud(tmp_path / "j.ply", xyz, rgb)
    tply.store_point_cloud(tmp_path / "t.ply", xyz, rgb)
    assert (tmp_path / "j.ply").read_bytes() == \
        (tmp_path / "t.ply").read_bytes()
    for a, b in zip(tply.fetch_point_cloud(tmp_path / "t.ply"),
                    jply.fetch_point_cloud(tmp_path / "j.ply")):
        np.testing.assert_array_equal(a, b)


def test_loop_default_checkpoint_under_model_path(tmp_path):
    """Without an ``on_checkpoint`` hook the loop writes
    ``model_path/chkpnt{it}.npz``, which resumes in both packages."""
    scene = make_toy_scene(seed=6, n=120, n_cameras=2, width=32, height=32,
                           device="cpu")
    params, active, meta = tg.create_from_pcd(
        scene.means3d, torch.full((120, 3), 0.5), capacity=128)
    state = init_state(params, active, n_images=2)
    batches = [CameraBatch(
        camera=c, gt_image=torch.full((3, 32, 32), 0.2),
        alpha_mask=torch.ones((1, 32, 32)),
        mono_invdepth=torch.zeros((1, 32, 32)),
        depth_mask=torch.zeros((1, 32, 32)),
        depth_reliable=torch.tensor(False), image_index=torch.tensor(i))
        for i, c in enumerate(scene.cameras)]
    state, meta, _ = tloop.train_loop(
        state, meta, batches, tcfg.OptimizationConfig(iterations=3),
        tcfg.PipelineConfig(tile_capacity=128),
        tcfg.ModelConfig(model_path=str(tmp_path)), 3.0, 1.0,
        hooks=tloop.LoopHooks(checkpoint_iterations=(2,)))
    path = tmp_path / "chkpnt2.npz"
    loaded, lmeta, it = tser.load_checkpoint(path, device="cpu")
    assert it == 2 and int(loaded.step) == 2 and lmeta == meta
    jstate, _, jit = jser.load_checkpoint(path)
    assert jit == 2
    assert_bit_identical(loaded, jstate)
    assert not (tmp_path / "chkpnt3.npz").exists()
