"""Test settings of the benchmark: the ``card`` marker, and a copy of the
benchmark's files at a tiny size that runs on the CPU in seconds."""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent

TINY_CONFIG = {"street_chunk_1m": dict(n_gaussians=3000, width=64, height=48),
               "street_hier_2m": dict(n_leaves=3000, width=64, height=48)}
TINY_MIX = dict(sample_below=2, check_frames=2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card and skips without one; run "
        "them there with python -m pytest benchmark/tests -m card")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def copy_bench(dst: Path, tiny: bool = True) -> Path:
    """``BENCHMARK.json`` and the benchmark's data and metric files under
    ``dst``, its configurations and serving mixes cut to a tiny size.
    Returns the new ``BENCHMARK.json``."""
    (dst / "benchmark").mkdir(parents=True)
    shutil.copy(HERE.parent / "BENCHMARK.json", dst / "BENCHMARK.json")
    for d in ("configs", "mixes", "metrics"):
        shutil.copytree(HERE / d, dst / "benchmark" / d)
    if tiny:
        for name, over in TINY_CONFIG.items():
            p = dst / "benchmark" / "configs" / f"{name}.json"
            cfg = json.loads(p.read_text())
            cfg.update(over)
            p.write_text(json.dumps(cfg))
        for p in (dst / "benchmark" / "mixes").glob("*.json"):
            mix = json.loads(p.read_text())
            if "sample_below" in mix:
                mix.update(TINY_MIX)
                p.write_text(json.dumps(mix))
    return dst / "BENCHMARK.json"


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    return copy_bench(tmp_path)
