"""The control on the card: the plain reference in TF32, the precision
below the float32 (TF32 off) that the configurations state, put in the
program's place, must come out incorrect.  At the cells' own sizes this
is ``benchmark/control.py``; here at a size a test run holds."""

import json
import shutil

import pytest

from benchmark import harness
from benchmark.conftest import copy_bench


def mid_bench(tmp_path):
    """The chunk cut to 200k rows; the hierarchy at its own size."""
    bench = copy_bench(tmp_path, tiny=False)
    p = tmp_path / "benchmark" / "configs" / "street_chunk_1m.json"
    cfg = json.loads(p.read_text())
    cfg.update(n_gaussians=200_000)
    p.write_text(json.dumps(cfg))
    return bench


@pytest.mark.card
@pytest.mark.parametrize("cell", ["train_chunk_street", "view_fly_tau6",
                                  "view_overview_tau15"])
def test_control_is_incorrect(tmp_path, cuda_device, cell):
    import importlib

    bench = mid_bench(tmp_path)
    spec = harness.load_cell(cell, bench)
    drivers = importlib.import_module(
        f"benchmark.drivers.{spec['mix']['driver']}")
    drv = drivers.Driver(spec["cfg"], spec["mix"], 11, cuda_device)
    checks = drv.compare(drv.reference_outputs(tf32=True),
                         drv.reference_outputs(), spec["mix"]["limits"])
    assert any(v > lim for _, v, lim in checks), checks
    shutil.rmtree(tmp_path / "benchmark")
