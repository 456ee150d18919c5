"""The import guard compares whole top-level names, and a run without a
card, or without the program beside the benchmark, prints no result."""

import subprocess
import sys

from benchmark import harness


def test_guard_compares_top_level_names_whole():
    assert harness.forbidden_modules(
        ["street_sparse_3dgs_tpu_torch", "street_sparse_3dgs_tpu_torch.ops",
         "numpy", "jaxtyping", "jax_like"]) == []
    assert harness.forbidden_modules(
        ["street_sparse_3dgs_tpu.ops.binning"]) == ["street_sparse_3dgs_tpu"]
    assert harness.forbidden_modules(
        ["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax", "jaxlib"]


def test_run_loads_no_jax(tmp_path):
    from benchmark.conftest import copy_bench

    bench = copy_bench(tmp_path)
    code = ("import sys, time, torch\n"
            f"sys.path.insert(0, {str(harness.ROOT)!r})\n"
            "from benchmark import harness\n"
            "harness.run('train_chunk_street', 3, 0.2, False, "
            f"time.perf_counter(), device=torch.device('cpu'), "
            f"bench_path={str(bench)!r})\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "train_chunk_street", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=cwd)


def test_run_without_card_prints_no_result():
    import torch

    out = _run(harness.ROOT)
    if not torch.cuda.is_available():
        assert out.returncode != 0
        assert out.stdout.strip() == ""


def test_run_without_the_program_fails(tmp_path):
    import shutil

    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
