"""Every cell of ``BENCHMARK.json`` driven end to end on the CPU at a tiny
size (the port's plain paths stand in for its kernels there), against the
reference; and each fault the cell can have, planted under the timed path,
turns ``correct`` false."""

import json
import time

import pytest
import torch

from benchmark import faults, harness

CPU = torch.device("cpu")
CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
FAULTS = {"train_chunk_street": ["state_unchanged", "half_batch"],
          "view_fly_tau6": ["altered_frame"],
          "view_overview_tau15": ["altered_frame"]}


def run(bench, cell, seed=2 ** 33 + 5, trace=False):
    return harness.run(cell, seed, 1.5, trace, time.perf_counter(),
                       device=CPU, bench_path=bench)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_cpu(tiny_bench, cell):
    rec = run(tiny_bench, cell)
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert "setup_s" in rec["metrics"] and len(rec["metrics"]) >= 2
    assert list(rec)[-2:] == ["checks", "_stderr"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_fault_makes_run_incorrect(tiny_bench, monkeypatch, cell, fault):
    faults.plant(fault, monkeypatch.setattr)
    rec = run(tiny_bench, cell)
    assert not rec["correct"], rec["checks"]


def test_every_cell_has_its_faults():
    assert sorted(FAULTS) == sorted(CELLS)


def test_same_seed_same_inputs(tiny_bench):
    from benchmark.drivers import train_chunk

    spec = harness.load_cell("train_chunk_street", tiny_bench)
    a, va = train_chunk.make_inputs(spec["cfg"], 2 ** 33 + 1, CPU)
    b, vb = train_chunk.make_inputs(spec["cfg"], 2 ** 33 + 1, CPU)
    c, _ = train_chunk.make_inputs(spec["cfg"], 2 ** 33 + 2, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(va[3]["gt"], vb[3]["gt"])
    assert not torch.equal(a["xyz"], c["xyz"])


def test_traced_run_reports_per_layer_metrics(tiny_bench):
    rec = run(tiny_bench, "view_fly_tau6", trace=True)
    assert rec["correct"]
    assert {"busy_s", "window_s"} <= set(rec["device"])
    assert set(rec["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "frame_ms_p95" not in rec["metrics"]
