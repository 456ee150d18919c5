"""PyTorch port, ``tools/pipeline_quality`` and ``tools/fork_features`` on
the CPU at n=120, 6 views, 64x48 and a few steps a stage (the projects
from ``tools/synth_project``, the tiled config of the JAX tools' CPU
runs):

- ``pipeline_quality`` prints the per-chunk, sweep and merged tables and
  returns them; a rerun skips every stage and prints the same tables;
- ``fork_features``: each arm's ``results.json`` has the keys of the JAX
  tool's (``tools/fork_features_tpu.py:340-353``), its values those of
  JAX's ``render_hierarchy_eval`` on the same merged tree at rtol 1e-4
  (the two evals' SSIM and depth reductions round apart); ``--report``
  prints the JAX tool's table from the same files, character for
  character; a rerun skips.
"""

import importlib.util
import io
import json
import re
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu.config import ModelConfig as JModelConfig
from street_sparse_3dgs_tpu.config import PipelineConfig as JPipelineConfig
from street_sparse_3dgs_tpu.eval.render_hier import (
    render_hierarchy_eval as j_eval)
from street_sparse_3dgs_tpu.hierarchy.io import load_hierarchy as j_load
from street_sparse_3dgs_tpu_torch.tools import (fork_features,
                                                pipeline_quality,
                                                synth_project)

torch.set_num_threads(1)
DEPTHS = dict(coarse_iterations=4, chunk_iterations=4, post_iterations=2)
SKYBOX = 50
SMALL = dict(n_views=6, width=64, height=48)


@pytest.fixture()
def cut(monkeypatch):
    """Both tools at a cut depth and a small skybox."""
    for mod in (pipeline_quality, fork_features):
        monkeypatch.setattr(mod, "DEPTHS", DEPTHS)
        monkeypatch.setattr(mod, "SKYBOX", SKYBOX)
    monkeypatch.setattr(fork_features, "PROJECT",
                        {**fork_features.PROJECT, **SMALL})


def test_pipeline_quality_tables_and_rerun(tmp_path, cut, capsys,
                                          monkeypatch):
    """Also from a relative ``--dir``: the tool resolves it, so that the
    scene loader finds the GT images (a relative images dir joined to the
    source path finds none and loads black images)."""
    monkeypatch.chdir(tmp_path)
    synth_project.make_project(tmp_path / "proj", n=120, device="cpu",
                               **SMALL)
    argv = ["--dir", "proj", "--config", "cpu", "--device", "cpu"]
    rec = pipeline_quality.main(argv)
    out = capsys.readouterr().out
    assert "reusing project" in out
    assert rec["project"] == str(tmp_path / "proj")
    assert sorted(rec["per_chunk"]) == [
        f"{c}/hierarchy.{h}.npz" for c in ("0_0", "1_0")
        for h in ("hier", "hier_opt")]
    for name, r in rec["per_chunk"].items():
        assert re.search(rf"{re.escape(name)}: held-out tau0 "
                         rf"{r['test']['psnr']:.2f}  train tau0 "
                         rf"{r['train']['psnr']:.2f}", out)
    for tau in pipeline_quality.TAUS:
        r = rec["merged_test"][tau]
        assert np.isfinite([r["psnr"], r["ssim"], r["lpips"]]).all()
        assert f"merged held-out tau{tau:g}: PSNR {r['psnr']:.2f}" in out
    assert rec["merged_test"][15.0]["psnr"] <= \
        rec["merged_test"][0.0]["psnr"] + 0.1
    assert f"merged train tau0 PSNR {rec['merged_train']['psnr']:.2f}" in out
    assert (f"merged: held-out tau0 {rec['merged_test'][0.0]['psnr']:.2f}  "
            f"train tau0 {rec['merged_train']['psnr']:.2f}") in out

    again = pipeline_quality.main(argv)
    out = capsys.readouterr().out
    for line in ("Skipping coarse", "Skipping chunk 0_0",
                 "Skipping chunk 1_0"):
        assert line in out
    assert "== Stage" not in out.replace("== Stage 5", "")
    assert again["merged_test"][0.0]["psnr"] == \
        rec["merged_test"][0.0]["psnr"]


def test_pipeline_quality_configs():
    """``--config cpu`` is the tiled K 512, pallas the padded K 384
    (``--exact`` adds exact_extra 128), ``--large`` the exact counts
    K 128 with exact_extra 512."""
    pc = pipeline_quality.pipe_config
    assert pc("cpu", False, False, "f32").raster_method == "tiled"
    assert pc("cpu", False, False, "f32").tile_capacity == 512
    pad = pc("pallas", False, False, "f32")
    assert (pad.raster_method, pad.tile_capacity, pad.max_dup,
            pad.exact_extra) == ("pallas", 384, 64, 0)
    assert pc("pallas", True, False, "bf16").exact_extra == 128
    large = pc("pallas", False, True, "f32")
    assert (large.tile_capacity, large.exact_extra, large.grad_reduce) == \
        (128, 512, "counts")
    assert pipeline_quality.LARGE == dict(n=1200, n_views=24, width=192,
                                          height=144, held_out=2)


def jax_fork_tool():
    """``tools/fork_features_tpu.py`` as a module (its top level imports
    no JAX)."""
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "fork_features_tpu.py"
    spec = importlib.util.spec_from_file_location("fork_features_tpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_results(arm_dir: Path) -> dict:
    """JAX's ``run_arm`` eval (``fork_features_tpu.py:336-353``) of the
    arm's merged tree, tiled K 512."""
    proj = arm_dir
    mc = JModelConfig(eval=True, resolution=1,
                      images=str(proj / "rectified" / "images"),
                      depths=str(proj / "rectified" / "depths"))
    h = j_load(proj / "output" / "merged.hier.npz")
    pipe = JPipelineConfig(raster_method="tiled", tile_capacity=512)
    res = {}
    for split, on_train in (("test", False), ("train", True)):
        r = j_eval(h, str(proj / "camera_calibration" / "aligned"), mc, pipe,
                   taus=(0.0,), with_lpips=False, on_train=on_train)
        res[split] = {k: v for k, v in r[0.0].items()
                      if isinstance(v, float)}
    res["n_nodes"] = int(h.n_nodes)
    return res


def test_fork_features_arms_report_and_rerun(tmp_path, cut, capsys):
    root = tmp_path / "ff"
    for arm in ("on", "off"):
        res = fork_features.main(["--dir", str(root), "--arm", arm,
                                  "--scale", "0.3", "--device", "cpu"])
        saved = json.loads((root / arm / "results.json").read_text())
        assert saved == json.loads(json.dumps(res))
        want = jax_results(root / arm)
        assert sorted(saved) == sorted(want) == ["n_nodes", "test", "train"]
        assert saved["n_nodes"] == want["n_nodes"]
        for split in ("test", "train"):
            assert sorted(saved[split]) == sorted(want[split]), split
            for k, v in want[split].items():
                np.testing.assert_allclose(saved[split][k], v, rtol=1e-4,
                                           err_msg=f"{arm} {split} {k}")
        assert {"psnr", "ssim", "imae", "irmse"} <= set(saved["test"])
    capsys.readouterr()

    rows = fork_features.main(["--dir", str(root), "--report"])
    got = capsys.readouterr().out
    assert sorted(rows) == ["off", "on"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        jax_fork_tool().report(root)
    assert got == buf.getvalue()
    assert "(held-out tau0)" in got and "train psnr" in got

    fork_features.main(["--dir", str(root), "--arm", "on", "--scale", "0.3",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "reusing on project" in out and "Skipping coarse" in out
    assert "Skipping chunk 0_0" in out and "Skipping chunk 1_0" in out


def test_fork_features_arm_configs():
    on = fork_features.arm_model_cfg("on")
    assert on.additional_depth_maps and on.gt_point_cloud_constraints
    assert on.constraint_treshold == 0.15
    off = fork_features.arm_model_cfg("off")
    assert (off.depths, off.alpha_masks) == ("no_depths", "no_masks")
    card = fork_features.pipe_config(torch.device("cuda"))
    assert (card.raster_method, card.tile_capacity, card.max_dup,
            card.exact_extra, card.grad_sort) == ("pallas", 384, 64, 128,
                                                  "bf16")
    cpu = fork_features.pipe_config(torch.device("cpu"))
    assert (cpu.raster_method, cpu.tile_capacity) == ("tiled", 512)


@pytest.mark.parametrize("tool, argv", [
    (pipeline_quality, ["--dir", "unused"]),
    (fork_features, ["--dir", "unused", "--arm", "on"])])
def test_pipeline_tools_need_the_card_by_default(tool, argv, tmp_path,
                                                 monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)
    assert not (tmp_path / "unused").exists()


def test_fork_features_needs_an_arm():
    with pytest.raises(SystemExit, match="--arm on|off"):
        fork_features.main(["--dir", "x"])
