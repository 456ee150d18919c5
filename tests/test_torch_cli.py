"""PyTorch port, the command line and what it stands on, each against the
JAX package on the same inputs:

- ``config``: the same flags and defaults, equal dataclasses from a sample
  argv, ``cfg_args`` byte-identical, and a snapshot written by one package
  loading in the other with explicit overrides;
- ``utils``: ``stage_timer``'s line and log in JAX's format,
  ``safe_state``'s seeding and line stamps;
- ``parallel/distributed``: ``host_identity``'s results and errors
  uninitialised, and a 1-process ``gloo`` group joined from the
  ``SS3DGS_*`` variables in a subprocess;
- ``pipeline/experiments``: snapshots and datasets saved by one package
  listed and restored by the other, the same error types;
- ``cli``: every command on the CPU (``--device cpu``) on a 64x48 project:
  ``cfg_args`` byte-identical to JAX's for the same argv, ``results.json``
  with JAX's keys and metrics (the bars of
  ``tests/test_torch_eval.py::assert_results_close``), ``full-train`` and
  its skipping rerun; an unknown command returns 1; without ``--device
  cpu`` the commands raise on a machine without a card."""

import contextlib
import dataclasses
import io
import json
import os
import random
import re
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from street_sparse_3dgs_tpu import cli as jcli
from street_sparse_3dgs_tpu import config as jcfg
from street_sparse_3dgs_tpu import utils as jutils
from street_sparse_3dgs_tpu.pipeline import experiments as jexp
from street_sparse_3dgs_tpu.parallel import distributed as jdist
from street_sparse_3dgs_tpu_torch import cli as tcli
from street_sparse_3dgs_tpu_torch import config as tcfg
from street_sparse_3dgs_tpu_torch import utils as tutils
from street_sparse_3dgs_tpu_torch.parallel import distributed as tdist
from street_sparse_3dgs_tpu_torch.pipeline import experiments as texp
from street_sparse_3dgs_tpu_torch.pipeline import full_train as tft

from test_pipeline import make_project

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
SAMPLE_ARGV = ["--sh_degree", "2", "--eval", "--resolution", "1",
               "--raster_method", "pallas", "--exact_extra", "9216",
               "--dup_tails", "262144:6,16384:24", "--grad_reduce", "counts",
               "--iterations", "77", "--feature_lr", "0.001",
               "--white_background", "--constraint_treshold", "0.1",
               "--source_path", "/data/x"]


# ---- config ---------------------------------------------------------------

def actions(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                     getattr(a.type, "__name__", a.type), type(a).__name__)
            for a in parser._actions}


def test_parser_matches_jax():
    """make_parser: the same option strings, defaults, types and
    actions."""
    assert actions(tcfg.make_parser()) == actions(jcfg.make_parser())


def test_cli_parser_adds_only_device():
    """The commands' parser is JAX's plus ``--device`` (default cuda)."""
    *_, args_t = tcli._parse(SAMPLE_ARGV)
    *_, args_j = jcli._parse(SAMPLE_ARGV)
    got = vars(args_t)
    assert got.pop("device") == "cuda"
    assert got == vars(args_j)


def test_extract_group_matches_jax():
    for cls in ("ModelConfig", "PipelineConfig", "OptimizationConfig"):
        got = tcfg.parse_all(SAMPLE_ARGV)
        want = jcfg.parse_all(SAMPLE_ARGV)
        for a, b in zip(got[:3], want[:3]):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), cls
    pipe = tcfg.parse_all(SAMPLE_ARGV)[1]
    assert pipe.dup_tails == ((262144, 6), (16384, 24))


def test_cfg_args_byte_identical_and_cross_load(tmp_path):
    """save_cfg_args writes JAX's bytes; load_combined of either package's
    snapshot with explicit overrides equals the other's result."""
    t_cfgs = tcfg.parse_all(SAMPLE_ARGV)[:3]
    j_cfgs = jcfg.parse_all(SAMPLE_ARGV)[:3]
    tcfg.save_cfg_args(tmp_path / "t", *t_cfgs)
    jcfg.save_cfg_args(tmp_path / "j", *j_cfgs)
    assert (tmp_path / "t" / "cfg_args").read_bytes() == \
        (tmp_path / "j" / "cfg_args").read_bytes()
    over = ["--iterations", "5", "--exact_extra=-1", "--dup_tails",
            "4096:224"]
    for src in ("t", "j"):
        got = tcfg.load_combined(tmp_path / src, over)
        want = jcfg.load_combined(tmp_path / src, over)
        assert [dataclasses.asdict(c) for c in got] == \
            [dataclasses.asdict(c) for c in want]
        assert got[2].iterations == 5 and got[1].exact_extra == -1
        assert got[1].dup_tails == ((4096, 224),)
        assert got[0].resolution == 1


# ---- utils ----------------------------------------------------------------

def test_stage_timer_matches_jax(tmp_path, capsys):
    """The printed line and the appended log line: ``<name>: <s> s`` with
    two decimals, as JAX's."""
    for mod, log in ((tutils, tmp_path / "t.txt"), (jutils, tmp_path / "j.txt")):
        for name in ("coarse", "chunk_0_0_train"):
            with mod.stage_timer(name, log):
                sum(range(1000))
    out = capsys.readouterr().out.splitlines()
    pat = re.compile(r"^(coarse|chunk_0_0_train): \d+\.\d\d s$")
    assert len(out) == 4 and all(pat.match(ln) for ln in out)
    t_lines = (tmp_path / "t.txt").read_text().splitlines()
    j_lines = (tmp_path / "j.txt").read_text().splitlines()
    assert [ln.split(":")[0] for ln in t_lines] == \
        [ln.split(":")[0] for ln in j_lines] == ["coarse", "chunk_0_0_train"]
    assert all(pat.match(ln) for ln in t_lines + j_lines)


def test_safe_state_matches_jax():
    """Python's and numpy's generators seeded as JAX's safe_state seeds
    them, torch's default generator seeded too; every non-empty line
    stamped ``[dd/mm HH:MM:SS] `` as JAX's stream stamps it."""
    saved = sys.stdout
    try:
        draws = []
        for mod in (tutils, jutils):
            mod.safe_state(silent=True, seed=7)
            draws.append((random.random(), float(np.random.rand())))
        assert draws[0] == draws[1]
        tutils.safe_state(silent=True, seed=7)
        assert torch.equal(torch.rand(3),
                           torch.rand(3, generator=torch.Generator()
                                      .manual_seed(7)))
        outs = []
        for mod in (tutils, jutils):
            buf = io.StringIO()
            sys.stdout = buf
            mod.safe_state(seed=0)
            assert type(sys.stdout).__name__ == "_TimestampedStream"
            print("first line")
            print("second", end="")
            print(" continued\n\nthird")
            sys.stdout = saved
            outs.append(buf.getvalue())
    finally:
        sys.stdout = saved
    stamp = r"\[\d\d/\d\d \d\d:\d\d:\d\d\] "
    for text in outs:
        assert re.fullmatch(f"{stamp}first line\n{stamp}second continued\n"
                            f"\n{stamp}third\n", text), text
    assert [re.sub(stamp, "", t) for t in outs[:1]] == \
        [re.sub(stamp, "", t) for t in outs[1:]]


# ---- parallel/distributed -----------------------------------------------------

@pytest.fixture
def no_dist_env(monkeypatch):
    for var in (tdist.ENV_COORDINATOR, tdist.ENV_NUM_PROCESSES,
                tdist.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("args", [(None, None), (2, 4), (0, 1), (None, 1),
                                  (None, 4), (5, 4), (-1, 2)])
def test_host_identity_matches_jax(args, no_dist_env):
    """Uninitialised: the same pairs and the same errors as JAX's
    (tests/test_parallel.py:374-398)."""
    def run(fn):
        try:
            return ("ok", fn(*args))
        except ValueError as exc:
            return ("ValueError", str(exc))
    assert run(tdist.host_identity) == run(jdist.host_identity)
    assert tdist.init_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()


def test_gloo_group_from_env_in_subprocess():
    """One process joins a 1-process gloo group from the SS3DGS_* variables
    (a free localhost port); the second call is a no-op; host_identity
    reads the group; an all-reduce runs; the group is destroyed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import torch, torch.distributed as dist
from street_sparse_3dgs_tpu_torch.parallel.distributed import (
    host_identity, init_distributed)
assert init_distributed(device="cpu") == (0, 1)
assert dist.is_initialized() and dist.get_backend() == "gloo"
assert init_distributed(device="cpu") == (0, 1)
assert host_identity() == (0, 1) and host_identity(0, 1) == (0, 1)
x = torch.ones(3)
dist.all_reduce(x)
assert x.tolist() == [1.0, 1.0, 1.0]
dist.destroy_process_group()
print("joined")
"""
    env = dict(os.environ, SS3DGS_COORDINATOR=f"127.0.0.1:{port}",
               SS3DGS_NUM_PROCESSES="1", SS3DGS_PROCESS_ID="0")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "joined"


# ---- pipeline/experiments -----------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_experiments_cross_packages(tmp_path, writer):
    """A snapshot and a dataset saved by one package list and restore in
    the other; the same error types on a second save, a missing load and
    a missing removal."""
    w, r = (jexp, texp) if writer == "jax" else (texp, jexp)
    out = tmp_path / "output"
    (out / "sub").mkdir(parents=True)
    (out / "sub" / "results.json").write_text('{"psnr": 20.0}')
    store = tmp_path / "store"
    w.save_test(out, store, "run1", note="baseline")
    listed = r.list_tests(store)
    assert [m["name"] for m in listed] == ["run1"]
    assert listed[0]["note"] == "baseline"
    r.load_test(store, "run1", tmp_path / "restored")
    assert (tmp_path / "restored" / "sub" / "results.json").read_text() \
        == '{"psnr": 20.0}'
    assert not (tmp_path / "restored" / jexp.SNAPSHOT_META).exists()
    for mod in (jexp, texp):
        with pytest.raises(FileExistsError):
            mod.save_test(out, store, "run1")
        with pytest.raises(FileNotFoundError):
            mod.load_test(store, "nope", tmp_path / "x")
        with pytest.raises(FileNotFoundError):
            mod.remove_test(store, "nope")
        with pytest.raises(FileExistsError):
            mod.load_test(store, "run1", tmp_path / "restored")
    r.remove_test(store, "run1")
    assert w.list_tests(store) == []

    proj = tmp_path / "proj"
    (proj / "camera_calibration" / "aligned").mkdir(parents=True)
    (proj / "rectified" / "images").mkdir(parents=True)
    (proj / "rectified" / "images" / "a.png").write_bytes(b"png")
    w.save_dataset(proj, store, "ds")
    assert [m["name"] for m in r.list_tests(store)] == ["ds"]
    r.load_dataset(store, "ds", tmp_path / "proj2")
    assert (tmp_path / "proj2" / "rectified" / "images" / "a.png")\
        .read_bytes() == b"png"
    for mod in (jexp, texp):
        with pytest.raises(FileExistsError):
            mod.save_dataset(proj, store, "ds")
        with pytest.raises(FileExistsError):
            mod.load_dataset(store, "ds", tmp_path / "proj2")
        with pytest.raises(FileNotFoundError):
            mod.load_dataset(store, "nope", tmp_path / "proj3")


# ---- cli ------------------------------------------------------------------

@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli") / "proj"
    return make_project(root, n=120, n_views=6, width=64, height=48)


def common(proj) -> list:
    return ["--eval", "--resolution", "1", "--images", str(proj.images_dir),
            "--iterations", "3", "--tile_capacity", "256",
            "--disable_viewer", "--seed", "1"]


def run_both(argv, out: Path, produced: str) -> dict:
    """JAX's command, then the port's (``--device cpu``) on the same argv
    and output directory: {who: (bytes of ``produced``, file names)}."""
    res = {}
    for who, main in (("jax", jcli.main), ("port", tcli.main)):
        shutil.rmtree(out, ignore_errors=True)
        extra = ["--device", "cpu"] if who == "port" else []
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(argv + extra) == 0
        res[who] = ((out / produced).read_bytes(),
                    sorted(str(p.relative_to(out)) for p in out.rglob("*")))
    return res


def test_train_commands_match_jax(project, tmp_path):
    """train-coarse (a 20-point skybox) and train-single (with the coarse
    scaffold ring) on the CPU: cfg_args byte-identical to JAX's for the
    same argv, the same artifact names, a point cloud the other package
    loads; then train-post on a hierarchy of the single run and
    render-hierarchy of it: JAX's results.json keys and metrics."""
    from street_sparse_3dgs_tpu.models.serialize import load_scene_ply
    from street_sparse_3dgs_tpu_torch.hierarchy.build import build_hierarchy
    from street_sparse_3dgs_tpu_torch.hierarchy.io import save_hierarchy
    from street_sparse_3dgs_tpu_torch.models import serialize as tser
    from test_torch_eval import assert_results_close

    coarse = tmp_path / "coarse"
    res = run_both(["train-coarse", "-s", str(project.colmap_dir),
                    "--model_path", str(coarse), "--skybox_num", "20",
                    *common(project)], coarse, "cfg_args")
    assert res["port"] == res["jax"]
    params, sky = load_scene_ply(coarse / "point_cloud" / "iteration_3")
    assert sky == 20 and np.isfinite(np.asarray(params.xyz)).all()

    single = tmp_path / "single"
    chunk = project.chunks_dir / "0_0"
    res = run_both(["train-single", "-s", str(chunk), "--model_path",
                    str(single), "--scaffold_file",
                    str(coarse / "point_cloud" / "iteration_3"),
                    "--densify_from_iter", "1", "--densification_interval",
                    "2", *common(project)], single, "cfg_args")
    assert res["port"] == res["jax"]
    cfg = json.loads(res["port"][0])
    assert cfg["model"]["scaffold_file"].endswith("iteration_3")

    params, sky = tser.load_scene_ply(single / "point_cloud" / "iteration_3",
                                      device="cpu")
    hdir = tmp_path / "h"
    hdir.mkdir()
    save_hierarchy(hdir / "chunk.hier.npz", build_hierarchy(
        params, scaffold_rows=int((single / "point_cloud" / "iteration_3"
                                   / "scaffold_info.txt").read_text()),
        skybox_rows=sky, device="cpu"))
    post = ["train-post", "--hierarchy", str(hdir / "chunk.hier.npz"), "-s",
            str(chunk), *common(project)]
    for who, main in (("jax", jcli.main), ("port", tcli.main)):
        extra = ["--device", "cpu"] if who == "port" else []
        with contextlib.redirect_stdout(io.StringIO()):
            assert main(post + extra) == 0
        shutil.move(hdir / "chunk.hier_opt.npz", hdir / f"{who}.hier_opt.npz")
    from street_sparse_3dgs_tpu_torch.hierarchy.io import load_hierarchy
    got, want = (load_hierarchy(hdir / f"{w}.hier_opt.npz", device="cpu")
                 for w in ("port", "jax"))
    assert torch.equal(got.parent, want.parent)
    assert bool(torch.isfinite(got.params.xyz).all())

    evald = tmp_path / "eval"
    res = run_both(["render-hierarchy", "--hierarchy",
                    str(hdir / "port.hier_opt.npz"), "-s",
                    str(project.colmap_dir), "--model_path", str(evald),
                    "--taus", "0", "6", *common(project)], evald,
                   "results.json")
    assert res["port"][1] == res["jax"][1]
    got, want = (json.loads(res[w][0]) for w in ("port", "jax"))
    assert list(got) == ["0.0", "6.0"]
    assert_results_close(got, want)


def test_full_train_command_and_rerun(project, tmp_path, monkeypatch):
    """full-train through ``main`` (the post stage cut to 2 steps by
    wrapping the orchestrator: the command has no flag for it), every
    artifact written, ``--skybox_num_override`` reaching the coarse stage;
    the rerun skips every stage."""
    root = tmp_path / "proj"
    shutil.copytree(project.project_dir, root)
    real = tft.full_train
    seen = []

    def cut(*a, **k):
        seen.append(k)
        return real(*a, **{**k, "post_iterations": 2})

    monkeypatch.setattr(tft, "full_train", cut)
    argv = ["full-train", "--project_dir", str(root), "--device", "cpu",
            "--skybox_num_override", "30", "--skip_if_exists",
            "--densify_from_iter", "1", "--densification_interval", "2",
            *common(project)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(argv) == 0
    assert seen[0]["skybox_num"] == 30 and seen[0]["device"] == "cpu"
    assert seen[0]["skip_if_exists"] and seen[0]["seed"] == 1
    paths = tft.ProjectPaths(root)
    assert (paths.scaffold_dir / "point_cloud" / "iteration_3" /
            "pc_info.txt").read_text().split()[0] == "30"
    for name in ("0_0", "1_0"):
        for f in ("hierarchy.hier.npz", "hierarchy.hier_opt.npz",
                  "exposure.json"):
            assert (paths.trained_chunks_dir / name / f).exists()
    assert (paths.output_dir / "merged.hier.npz").exists()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(argv) == 0
    out = buf.getvalue()
    assert "Skipping coarse" in out and "Skipping chunk 1_0" in out
    assert "== Stage 2" not in out


def test_unknown_command_prints_usage(capsys):
    """As JAX's main: no command or an unknown one prints the usage and
    returns 1; the port has every command of JAX's (mask-images and
    viewer: tests/test_torch_viewer_app.py)."""
    for argv in ([], ["nope"]):
        assert tcli.main(argv) == 1
    out = capsys.readouterr().out
    assert out.count("usage: python -m street_sparse_3dgs_tpu_torch.cli") \
        == 2
    assert set(tcli.COMMANDS) == set(jcli.COMMANDS)


@pytest.mark.parametrize("command", ["train-coarse", "train-single",
                                     "train-post", "render-hierarchy",
                                     "full-train"])
def test_commands_need_the_card_by_default(command, tmp_path):
    """Without ``--device cpu`` every command raises on a machine without
    a card, before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    argv = [command, "-s", str(tmp_path / "none"), "--hierarchy",
            str(tmp_path / "none.hier.npz"), "--project_dir",
            str(tmp_path / "none"), "--model_path", str(tmp_path / "m")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(argv)
    assert list(tmp_path.iterdir()) == []
