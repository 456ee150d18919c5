"""A later change adds a cell, its mix and a per-layer metric by adding
files and ``BENCHMARK.json`` entries alone: the harness finds them by
name, and no file the benchmark already has is edited."""

import json
import time

import torch

from benchmark import harness

from benchmark.conftest import copy_bench


def test_cell_from_files_alone(tmp_path):
    bench = copy_bench(tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    root = tmp_path / "benchmark"
    cfg = json.loads((root / "configs" / "street_hier_2m.json").read_text())
    cfg.update(name="street_hier_small", n_leaves=2000)
    (root / "configs" / "street_hier_small.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "mixes" / "fly_road_tau6.json").read_text())
    mix.update(tau=3.0, step_m=1.0, heading_deg=180.0)
    (root / "mixes" / "fly_back_tau3.json").write_text(json.dumps(mix))
    (root / "metrics" / "traced_frames.py").write_text(
        "def read(ctx):\n"
        "    return float(ctx['requests'])\n")
    b = json.loads(bench.read_text())
    b["configs"].append({"name": "street_hier_small", "source": "x",
                         "file": "benchmark/configs/street_hier_small.json",
                         "reduced": ["n_leaves"], "why": "test"})
    b["workloads"].append({"name": "fly_back_small",
                           "config": "street_hier_small",
                           "traffic": "fly_back_tau3", "chips": 1,
                           "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] in ("frame_ms_p95", "frames_per_s"):
            m["workloads"].append("fly_back_small")
    b["per_layer"].append({"name": "traced_frames.serve", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "frame_ms_p95",
                           "workloads": ["fly_back_small"]})
    bench.write_text(json.dumps(b))

    rec = harness.run("fly_back_small", 17, 1.5, True, time.perf_counter(),
                      device=torch.device("cpu"), bench_path=bench)
    assert rec["correct"], rec["checks"]
    assert rec["metrics"]["traced_frames.serve"]["value"] == 6.0
    rec = harness.run("fly_back_small", 17, 1.5, False, time.perf_counter(),
                      device=torch.device("cpu"), bench_path=bench)
    assert set(rec["metrics"]) == {"frame_ms_p95", "frames_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before
