"""PyTorch port, the 5-stage orchestrator (``pipeline/full_train.py``)
against the JAX package's on the same tiny project (64x48,
``tests/test_pipeline.py::make_project``, tiled method on the CPU):

- one JAX ``full_train`` and one port ``full_train`` (the coarse stage fed
  JAX's skybox draws) over copies of the same project: the same artifact
  names, and the port's rerun skips every stage;
- the coarse and chunk stages: the init (the state handed to
  ``train_loop``) equal at the bars of
  ``tests/test_torch_train.py::test_create_from_pcd_matches_jax``, the mean
  loss within 20% of JAX's (the bar of
  ``test_train_loop_with_densify_matches_jax_cadence``: the random
  backgrounds and split noise differ);
- ``build_hierarchy_stage`` on JAX's chunk PLY at the hierarchy tests' bar,
  ``post_opt_stage`` on JAX's hierarchy in the tiled and the pallas exact
  counts configs (the post step is deterministic), ``consolidate_stage``
  on JAX's optimised chunk hierarchies exactly;
- twins of ``tests/test_aux.py::test_multi_host_partitioning`` and
  ``::test_consolidation_single_merger``;
- slow twins of ``tests/test_pipeline.py::test_full_train_pipeline`` and
  ``tests/test_convergence.py::test_convergence_psnr_floor``."""

import contextlib
import dataclasses
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu import config as jcfg
from street_sparse_3dgs_tpu.hierarchy import io as jio
from street_sparse_3dgs_tpu.models.gaussians import GaussianParams
from street_sparse_3dgs_tpu.pipeline import full_train as jft
from street_sparse_3dgs_tpu_torch import config as tcfg
from street_sparse_3dgs_tpu_torch.hierarchy import io as tio
from street_sparse_3dgs_tpu_torch.pipeline import full_train as tft

from test_pipeline import make_project
from test_torch_hierarchy import assert_same_hierarchy, fields

torch.set_num_threads(1)
W, H = 64, 48
SKYBOX = 50
ITERS = dict(coarse_iterations=6, chunk_iterations=6, post_iterations=3)
OPT = dict(densify_from_iter=2, densification_interval=2,
           densify_until_iter=5, opacity_reset_interval=1000,
           position_lr_init=2e-4, position_lr_final=2e-6,
           densify_grad_threshold=2e-4)
MODEL = dict(eval=True, resolution=1)
PIPES = {"tiled": dict(tile_capacity=256),
         "pallas": dict(raster_method="pallas", tile_capacity=128,
                        max_dup=32, exact_extra=64, grad_reduce="counts")}


def cfgs(mod, pipe="tiled"):
    return (mod.ModelConfig(**MODEL), mod.OptimizationConfig(**OPT),
            mod.PipelineConfig(**PIPES[pipe]))


def jax_skybox_draws(seed: int = 0, n: int = SKYBOX) -> np.ndarray:
    """The [2, n] uniforms of JAX's coarse-stage dome of n rows
    (``create_from_pcd``'s ``jax.random.split(PRNGKey(seed))``)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return np.stack([np.asarray(jax.random.uniform(k1, (n,))),
                     np.asarray(jax.random.uniform(k2, (n,)))])


def snapshot(state, meta) -> dict:
    """The params and the active mask as numpy, and the metadata."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    out = {k: host(getattr(state.params, k)) for k in GaussianParams._fields}
    out["active"] = host(state.active)
    out["meta"] = dataclasses.asdict(meta)
    return out


@contextlib.contextmanager
def recording(mod):
    """Wraps ``mod.train_loop``: every call's init snapshot and stats."""
    real = mod.train_loop
    calls = []

    def wrapped(state, meta, *a, **k):
        init = snapshot(state, meta)
        out = real(state, meta, *a, **k)
        calls.append((init, out[2]))
        return out

    mod.train_loop = wrapped
    try:
        yield calls
    finally:
        mod.train_loop = real


def files(root) -> list:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The project (``bare``), JAX's full_train over a copy (``jax``) and
    the port's over another (``port``), with the train_loop calls of
    each."""
    base = tmp_path_factory.mktemp("pipeline")
    bare = base / "bare"
    make_project(bare, n=120, n_views=6, width=W, height=H)
    for name in ("jax", "port"):
        shutil.copytree(bare, base / name)
    with recording(jft) as jcalls:
        jft.full_train(base / "jax", *cfgs(jcfg), skybox_num=SKYBOX, **ITERS)
    with recording(tft) as tcalls:
        merged = tft.full_train(
            base / "port", *cfgs(tcfg), skybox_num=SKYBOX,
            skybox_uniform=torch.tensor(jax_skybox_draws()), device="cpu",
            **ITERS)
    return dict(base=base, bare=bare, jax=base / "jax", port=base / "port",
                jcalls=jcalls, tcalls=tcalls, merged=merged)


def copy_project(runs, tmp_path, src="jax"):
    dst = tmp_path / "proj"
    shutil.copytree(runs[src], dst)
    return dst, tft.ProjectPaths(dst)


def assert_same_init(got: dict, want: dict):
    """Every parameter within 1e-6 (log scales 1e-4: the 3-NN distances
    round apart; xyz 1e-6 of its largest magnitude, where the f32 sin/cos
    of the dome round apart), the active mask and the metadata equal."""
    for name in GaussianParams._fields:
        w = want[name]
        tol = {"log_scales": 1e-4,
               "xyz": 1e-6 * np.abs(w).max()}.get(name, 1e-6)
        np.testing.assert_allclose(got[name], w, rtol=1e-6 if
                                   name != "log_scales" else tol, atol=tol,
                                   err_msg=name)
    np.testing.assert_array_equal(got["active"], want["active"])
    assert got["meta"] == want["meta"]


def test_full_train_artifacts_match_jax_and_rerun_skips(runs, capsys):
    """The port's run leaves JAX's artifact names; its rerun skips the
    coarse stage and every chunk, reloads the merged tree unchanged and
    logs only the consolidation."""
    port = runs["port"]
    assert files(port / "output") == files(runs["jax"] / "output")
    for rel in ("output/merged.hier.npz",
                "output/trained_chunks/0_0/hierarchy.hier_opt.npz",
                "output/trained_chunks/1_0/hierarchy.hier.npz"):
        assert (port / rel).exists(), rel
    log = port / "output" / "training_pipeline_timing.txt"
    stages = [ln.split(":")[0] for ln in log.read_text().splitlines()]
    assert stages == ["coarse", "chunk_0_0_train", "chunk_0_0_hierarchy",
                      "chunk_0_0_post", "chunk_1_0_train",
                      "chunk_1_0_hierarchy", "chunk_1_0_post",
                      "consolidation"]
    stamp = (port / "output" / "merged.hier.npz").stat().st_mtime_ns
    capsys.readouterr()
    again = tft.full_train(port, *cfgs(tcfg), skybox_num=SKYBOX,
                           device="cpu")
    out = capsys.readouterr().out
    assert "Skipping coarse" in out
    assert "Skipping chunk 0_0" in out and "Skipping chunk 1_0" in out
    assert "Stage 1" not in out and "Stage 2" not in out
    assert [ln.split(":")[0] for ln in log.read_text().splitlines()] == \
        stages + ["consolidation"]
    assert (port / "output" / "merged.hier.npz").stat().st_mtime_ns == stamp
    np.testing.assert_array_equal(fields(again)["xyz"],
                                  fields(runs["merged"])["xyz"])
    assert again.n_nodes == runs["merged"].n_nodes


@pytest.mark.parametrize("stage", [0, 1, 2],
                         ids=["coarse", "chunk_0_0", "chunk_1_0"])
def test_training_stage_loss_matches_jax(runs, stage):
    """Each training stage of the two full runs: the same number of
    losses, all finite, their mean within 20% of JAX's; the coarse stage
    (fed JAX's skybox draws) from JAX's init.  The chunk stages start from
    each package's own scaffold here; test_chunk_stage_on_jax_scaffold
    holds their init."""
    (j_init, j_stats) = runs["jcalls"][stage]
    (t_init, t_stats) = runs["tcalls"][stage]
    if stage == 0:
        assert_same_init(t_init, j_init)
        assert t_init["meta"]["skybox_points"] == SKYBOX
    assert t_init["meta"] == j_init["meta"]
    assert len(t_stats["losses"]) == len(j_stats["losses"]) == 6
    assert np.isfinite(t_stats["losses"]).all()
    np.testing.assert_allclose(np.mean(t_stats["losses"]),
                               np.mean(j_stats["losses"]), rtol=0.2)


def test_chunk_stage_on_jax_scaffold(runs, tmp_path):
    """The chunk stage on JAX's scaffold: the init JAX's chunk stage
    started from (the scaffold ring selected from the same PLY), the loss
    mean within 20%."""
    root, paths = copy_project(runs, tmp_path)
    with recording(tft) as calls:
        tft.train_chunk_stage(paths, "0_0", *cfgs(tcfg)[:2],
                              cfgs(tcfg)[2], iterations=6, device="cpu")
    (j_init, j_stats), ((t_init, t_stats),) = runs["jcalls"][1], calls
    assert_same_init(t_init, j_init)
    assert t_init["meta"]["scaffold_points"] > 0
    np.testing.assert_allclose(np.mean(t_stats["losses"]),
                               np.mean(j_stats["losses"]), rtol=0.2)


def test_build_hierarchy_stage_matches_jax(runs, tmp_path):
    """On the PLY that JAX's chunk stage saved: the tree of JAX's
    build_hierarchy_stage (structure equal, floats to 1e-6)."""
    root, paths = copy_project(runs, tmp_path)
    out = paths.trained_chunks_dir / "0_0" / "hierarchy.hier.npz"
    out.unlink()
    h = tft.build_hierarchy_stage(paths, "0_0", device="cpu")
    want = jio.load_hierarchy(runs["jax"] / "output" / "trained_chunks"
                              / "0_0" / "hierarchy.hier.npz")
    assert h.n_nodes == want.n_nodes and h.anchors.any()
    assert_same_hierarchy(h, want)
    assert_same_hierarchy(tio.load_hierarchy(out, device="cpu"), want)


@contextlib.contextmanager
def final_post_state(mod):
    """Wraps ``mod.CompactPostDriver``: the final state of each driver."""
    real = mod.CompactPostDriver
    states = []

    class Driver(real):
        def finish(self):
            states.append(super().finish())
            return states[-1]

    mod.CompactPostDriver = Driver
    try:
        yield states
    finally:
        mod.CompactPostDriver = real


POST_STEPS = 3


@pytest.fixture(scope="module")
def jax_post(runs):
    """JAX's post_opt_stage of chunk 0_0 in the tiled config: (the final
    driver state, the optimised tree's fields, the start tree's fields)."""
    root = runs["base"] / "jax_post"
    shutil.copytree(runs["jax"], root)
    rel = "output/trained_chunks/0_0/hierarchy"
    (root / f"{rel}.hier_opt.npz").unlink()
    with final_post_state(jft) as states:
        jft.post_opt_stage(jft.ProjectPaths(root), "0_0", *cfgs(jcfg),
                           iterations=POST_STEPS)
    return (states[0], fields(jio.load_hierarchy(root / f"{rel}.hier_opt.npz")),
            fields(jio.load_hierarchy(root / f"{rel}.hier.npz")))


@pytest.mark.parametrize("pipe", ["tiled", "pallas"])
def test_post_opt_stage_matches_jax(runs, jax_post, tmp_path, pipe):
    """Three post steps on JAX's chunk hierarchy and exposures (fixed
    background, ``random.Random(0)`` limits, the same shuffle) against
    JAX's stage in the tiled config, at the bar of
    tests/test_torch_post.py::test_post_step_matches_jax scaled to the step
    count: the first Adam moment (a decayed sum of the grads) within
    3 x 3e-4 x max|mu| plus rtol 2e-3; the optimised parameters within
    3 x 3e-4 x max|their move| plus rtol 2e-3 wherever the grad sets Adam's
    direction (|mu| above 1e-3 x max|mu|; near 0 Adam's normalised step of
    rounding noise may take either sign, so there within two of the
    largest moves).  The pallas exact counts config is held against JAX's
    tiled stage: on this tree JAX's own Pallas backward is off its tiled
    path (test_jax_pallas_post_grads_off_tiled_on_chunk_tree).  The saved
    tree reloads equal and keeps its structure."""
    j_state, want, start = jax_post
    root, paths = copy_project(runs, tmp_path)
    rel = "output/trained_chunks/0_0/hierarchy.hier_opt.npz"
    (root / rel).unlink()
    with final_post_state(tft) as tstates:
        got = fields(tft.post_opt_stage(paths, "0_0", *cfgs(tcfg, pipe)[:2],
                                        cfgs(tcfg, pipe)[2],
                                        iterations=POST_STEPS, device="cpu"))
    assert int(tstates[0].step) == int(j_state.step) == POST_STEPS
    back = fields(tio.load_hierarchy(root / rel, device="cpu"))
    for name in GaussianParams._fields:
        mu_j = np.asarray(getattr(j_state.adam_state.mu, name))
        mu_t = getattr(tstates[0].adam_state.mu, name).numpy()
        np.testing.assert_allclose(
            mu_t, mu_j, atol=POST_STEPS * 3e-4 * np.abs(mu_j).max(),
            rtol=2e-3, err_msg=f"mu {name}")
        move = np.abs(want[name] - start[name]).max()
        assert move > 0, name
        steered = np.abs(mu_j) > 1e-3 * np.abs(mu_j).max()
        np.testing.assert_allclose(got[name][steered], want[name][steered],
                                   atol=POST_STEPS * 3e-4 * move, rtol=2e-3,
                                   err_msg=name)
        assert np.abs(got[name] - want[name]).max() <= 2 * move, name
        np.testing.assert_array_equal(back[name], got[name])
    for k in ("parent", "child_start", "child_count", "anchors"):
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_jax_pallas_post_grads_off_tiled_on_chunk_tree(runs):
    """A fault of the reference: one post step on JAX's chunk 0_0 tree (a
    skybox of 50 dome rows) through JAX's Pallas blends (exact counts, in
    interpret mode) gives xyz grads more than 1% of max|g| off JAX's own
    tiled path, while the port's pallas config (the plain K3/K4 on the
    CPU) stays within 3e-4 of it; the losses agree to 1e-5."""
    import random

    import jax.numpy as jnp

    from street_sparse_3dgs_tpu.data.scene import (CameraStream as JStream,
                                                   load_scene_info as jload)
    from street_sparse_3dgs_tpu.train import post as jpost
    from street_sparse_3dgs_tpu.train.step import CameraBatch as JBatch
    from street_sparse_3dgs_tpu_torch.data.scene import (
        CameraStream as TStream, load_scene_info as tload)
    from street_sparse_3dgs_tpu_torch.train import post as tpost

    paths = jft.ProjectPaths(runs["jax"])
    path = paths.trained_chunks_dir / "0_0" / "hierarchy.hier.npz"
    h_j, h_t = jio.load_hierarchy(path), tio.load_hierarchy(path, "cpu")
    src = str(paths.chunks_dir / "0_0")
    model = dict(MODEL, images=str(paths.images_dir))
    b_j = next(iter(JStream(jload(src, jcfg.ModelConfig(**model))
                            .train_cameras, resolution=1)))
    b_t = next(iter(TStream(tload(src, tcfg.ModelConfig(**model))
                            .train_cameras, resolution=1, num_workers=0,
                            device="cpu")))
    limit = jpost.random_limit(random.Random(0))
    eye = np.eye(3, 4, dtype=np.float32)
    grads, losses = {}, {}
    for who, pipe in (("jax", "tiled"), ("jax", "pallas"),
                      ("port", "pallas")):
        if who == "jax":
            step = jpost.make_post_step(h_j, jcfg.OptimizationConfig(),
                                        jcfg.PipelineConfig(**PIPES[pipe]),
                                        compact_capacity=512)
            state, aux = step(jpost.init_post_state(h_j), JBatch(*b_j),
                              jnp.float32(limit), jnp.asarray(eye))
        else:
            step = tpost.make_post_step(h_t, tcfg.OptimizationConfig(),
                                        tcfg.PipelineConfig(**PIPES[pipe]),
                                        compact_capacity=512)
            state, aux = step(tpost.init_post_state(h_t), b_t, limit,
                              torch.tensor(eye))
        grads[who, pipe] = np.asarray(state.adam_state.mu.xyz)
        losses[who, pipe] = float(aux["loss"])
    ref = grads["jax", "tiled"]
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(grads["jax", "pallas"] - ref).max() > 1e-2 * scale
    assert np.abs(grads["port", "pallas"] - ref).max() < 3e-4 * scale
    np.testing.assert_allclose([losses["jax", "pallas"],
                                losses["port", "pallas"]],
                               losses["jax", "tiled"], rtol=1e-5)


def test_consolidate_stage_matches_jax(runs, tmp_path):
    """From JAX's optimised chunk hierarchies: JAX's merged tree exactly
    (both merge in the same numpy), the claim taken and the output in
    place."""
    root, paths = copy_project(runs, tmp_path)
    for f in ("merged.hier.npz", "merged.hier.claim"):
        (paths.output_dir / f).unlink()
    merged = tft.consolidate_stage(paths, ["0_0", "1_0"], device="cpu")
    want = fields(jio.load_hierarchy(runs["jax"] / "output"
                                     / "merged.hier.npz"))
    for got in (fields(merged), fields(tio.load_hierarchy(
            paths.output_dir / "merged.hier.npz", device="cpu"))):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (paths.output_dir / "merged.hier.claim").exists()


def test_multi_host_partitioning(tmp_path, monkeypatch):
    """Chunks partition round-robin; consolidation waits for all (the
    twin of tests/test_aux.py::test_multi_host_partitioning)."""
    paths = tft.ProjectPaths(tmp_path)
    for name in ("0_0", "1_0", "2_0"):
        (paths.chunks_dir / name).mkdir(parents=True)
    pc = paths.scaffold_dir / "point_cloud" / "iteration_1"
    pc.mkdir(parents=True)
    (pc / "point_cloud.ply").write_text("")

    processed = []
    monkeypatch.setattr(tft, "train_chunk_stage",
                        lambda *a, **k: processed.append(a[1]))
    monkeypatch.setattr(tft, "build_hierarchy_stage", lambda *a, **k: None)

    def fake_post(paths_, name, *a, **k):
        out = paths_.trained_chunks_dir / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "hierarchy.hier_opt.npz").write_text("")

    monkeypatch.setattr(tft, "post_opt_stage", fake_post)
    merged_calls = []
    monkeypatch.setattr(tft, "consolidate_stage",
                        lambda p, names, **k: merged_calls.append(
                            sorted(names)))

    tft.full_train(tmp_path, host_id=0, num_hosts=2, skip_if_exists=True,
                   device="cpu")
    assert processed == ["0_0", "2_0"]
    assert merged_calls == []          # host 1's chunk not ready yet
    tft.full_train(tmp_path, host_id=1, num_hosts=2, skip_if_exists=True,
                   device="cpu")
    assert processed == ["0_0", "2_0", "1_0"]
    assert merged_calls == [["0_0", "1_0", "2_0"]]
    with pytest.raises(ValueError, match="exceeds the runtime process"):
        tft.full_train(tmp_path, num_hosts=2, device="cpu")


def test_consolidation_single_merger(tmp_path, monkeypatch):
    """Two hosts finishing at once run the merge once (the O_EXCL claim),
    the output lands by os.replace with no temp file left, and a later
    call reloads it (the twin of
    tests/test_aux.py::test_consolidation_single_merger)."""
    from street_sparse_3dgs_tpu_torch import convert
    from street_sparse_3dgs_tpu_torch.hierarchy.build import build_hierarchy

    from test_hierarchy import toy_params

    paths = tft.ProjectPaths(tmp_path)
    names = ["c0", "c1"]
    for i, name in enumerate(names):
        p, _ = toy_params(n=30, seed=i)
        p = convert.params_from_numpy(
            {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
        h = build_hierarchy(p._replace(xyz=p.xyz + 3.0 * i), device="cpu")
        d = paths.trained_chunks_dir / name
        d.mkdir(parents=True)
        tio.save_hierarchy(d / "hierarchy.hier_opt.npz", h)
    paths.output_dir.mkdir(exist_ok=True)

    real_merge = tft.merge_hierarchies
    merges = []

    def counting_merge(hs, **kw):
        merges.append(threading.get_ident())
        time.sleep(0.3)          # widen the race window
        return real_merge(hs, **kw)

    monkeypatch.setattr(tft, "merge_hierarchies", counting_merge)
    barrier = threading.Barrier(2)
    results = [None, None]

    def run(i):
        barrier.wait()
        results[i] = tft.consolidate_stage(paths, names, device="cpu")

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(merges) == 1, f"merge ran {len(merges)} times"
    assert (paths.output_dir / "merged.hier.npz").exists()
    assert not list(paths.output_dir.glob(".merged.*"))
    winner = next(r for r in results if r is not None)
    assert sum(r is None for r in results) == 1
    again = tft.consolidate_stage(paths, names, device="cpu")
    assert len(merges) == 1 and again.n_nodes == winner.n_nodes


def test_full_train_needs_the_card_by_default(tmp_path):
    """Without a card the default device raises before any stage runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.full_train(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tft.train_coarse_stage(tft.ProjectPaths(tmp_path),
                               *cfgs(tcfg))
    assert not (tmp_path / "output").exists()


# ---- slow twins -----------------------------------------------------------

@pytest.mark.slow
def test_full_train_pipeline_port(tmp_path):
    """The port's twin of tests/test_pipeline.py::test_full_train_pipeline
    on the CPU (plain versions): held-out tau 0 PSNR at least 18.9 dB after
    the 5 stages, every tau finite, and an idempotent rerun.  The coarse
    stage gets JAX's dome draws, as every parity test here: the floor is
    JAX's seed-0 value less 0.8 dB, and this fixture's held-out PSNR moves
    by more than that with the random streams (JAX's own pipeline at seeds
    1 and 2 scores below the floor)."""
    from street_sparse_3dgs_tpu_torch.eval.render_hier import (
        render_hierarchy_eval)
    from test_pipeline import PSNR_FLOOR_TAU0

    proj = make_project(tmp_path)
    opt = tcfg.OptimizationConfig(
        iterations=800, densification_interval=100, densify_from_iter=200,
        densify_until_iter=600, opacity_reset_interval=10_000,
        position_lr_init=2e-4, position_lr_final=2e-6,
        densify_grad_threshold=2e-4)
    pipe = tcfg.PipelineConfig(tile_capacity=512)
    model = tcfg.ModelConfig(eval=True, resolution=1)
    merged = tft.full_train(proj.project_dir, model, opt, pipe,
                            skip_if_exists=True, coarse_iterations=200,
                            chunk_iterations=800, post_iterations=300,
                            skybox_num=500, skybox_uniform=torch.tensor(
                                jax_skybox_draws(n=500)), device="cpu")
    assert merged is not None
    h = tio.load_hierarchy(proj.output_dir / "merged.hier.npz", device="cpu")
    assert h.skybox_count > 0
    results = render_hierarchy_eval(
        h, str(proj.colmap_dir), tcfg.ModelConfig(
            eval=True, resolution=1, images=str(proj.images_dir)),
        pipe, taus=(0.0, 6.0), with_lpips=True)
    print("port pipeline tau sweep:",
          {t: round(r["psnr"], 2) for t, r in results.items()})
    assert results[0.0]["lpips_weights"] == "random"
    assert results[0.0]["psnr"] >= PSNR_FLOOR_TAU0, results
    for tau, row in results.items():
        assert np.isfinite(row["psnr"]) and row["psnr"] > 5.0, (tau, row)
        assert 0.0 <= row["ssim"] <= 1.0
    merged2 = tft.full_train(proj.project_dir, model, opt, pipe,
                             skip_if_exists=True, skybox_num=500,
                             device="cpu")
    assert merged2 is not None and merged2.n_nodes == merged.n_nodes


@pytest.mark.slow
def test_convergence_psnr_floor_port():
    """The port's twin of
    tests/test_convergence.py::test_convergence_psnr_floor: the same GT
    (JAX's oracle at 2x, pooled), start points and schedule through the
    port's ``create_from_pcd`` and ``train_loop`` on the CPU; mean PSNR at
    least 23.5 dB."""
    import math

    from street_sparse_3dgs_tpu.data.toy import lookat_camera, make_toy_scene
    from street_sparse_3dgs_tpu_torch import convert
    from street_sparse_3dgs_tpu_torch.models import gaussians as tg
    from street_sparse_3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                            rasterize)
    from street_sparse_3dgs_tpu_torch.train import losses
    from street_sparse_3dgs_tpu_torch.train.loop import train_loop
    from street_sparse_3dgs_tpu_torch.train.step import (CameraBatch,
                                                         init_state)
    from test_convergence import PSNR_FLOOR, RES, oracle_gt_2x

    scene = make_toy_scene(seed=11, n=400, n_cameras=6, width=RES,
                           height=RES)
    cams_hi = []
    for i in range(6):
        ang = 2.0 * math.pi * i / 6
        pos = np.array([3.0 * math.cos(ang), 3.0 * math.sin(ang), 0.8])
        cams_hi.append(lookat_camera(pos, np.zeros(3), RES * 2, RES * 2))
    gts = [torch.tensor(np.asarray(oracle_gt_2x(scene, ch)))
           for ch in cams_hi]
    key = jax.random.PRNGKey(0)
    pts = np.asarray(scene.means3d) + 0.03 * np.asarray(
        jax.random.normal(key, scene.means3d.shape))
    cols = np.clip(np.asarray(scene.sh_coeffs[:, 0, :]) * 0.28 + 0.5, 0, 1)
    params, active, meta = tg.create_from_pcd(
        torch.tensor(pts), torch.tensor(cols), sh_degree=3, capacity=2048)
    cams = [convert.camera_from_numpy(
        {k: (v if isinstance(v, int) else np.asarray(v))
         for k, v in c._asdict().items()}, "cpu") for c in scene.cameras]
    shape = (1, RES, RES)
    batches = [CameraBatch(
        camera=cam, gt_image=gt, alpha_mask=torch.ones(shape),
        mono_invdepth=torch.zeros(shape), depth_mask=torch.zeros(shape),
        depth_reliable=torch.tensor(False), image_index=torch.tensor(i))
        for i, (cam, gt) in enumerate(zip(cams, gts))]
    opt = tcfg.OptimizationConfig(
        iterations=1500, densification_interval=100, densify_from_iter=300,
        densify_until_iter=1200, opacity_reset_interval=10_000,
        densify_grad_threshold=2e-4)
    state = init_state(params, active, n_images=len(gts))
    state, meta, _ = train_loop(
        state, meta, batches, opt, tcfg.PipelineConfig(tile_capacity=1024),
        tcfg.ModelConfig(), cameras_extent=3.0, spatial_lr_scale=1.0,
        clamp_fraction=1.0, rng_seed=5)
    cfg = RasterConfig(method="tiled", tile_capacity=600)
    vals = []
    with torch.no_grad():
        for cam, gt in zip(cams, gts):
            out = rasterize(state.params.xyz, tg.activate_scales(state.params),
                            state.params.quats,
                            tg.activate_opacity(state.params, meta),
                            tg.sh_coeffs(state.params), cam, 3,
                            torch.zeros(3), cfg, active_mask=state.active)
            vals.append(float(losses.psnr(torch.clamp(out["render"], 0, 1),
                                          gt)))
    mean_psnr = float(np.mean(vals))
    print(f"port convergence PSNR {mean_psnr:.2f} (floor {PSNR_FLOOR})")
    assert mean_psnr >= PSNR_FLOOR
