"""PyTorch port, ``profiling.py``: a CPU trace of a small function through
``trace_fn`` (warm-up outside the trace), its host-op summary and printout,
and the card's data-sheet peaks.  The device-side summary and
``device_summary``'s idle share are read on the card by chip_smoke.py."""

import torch

from street_sparse_3dgs_tpu_torch import profiling

torch.set_num_threads(1)


def test_trace_fn_summarizes_host_ops(tmp_path, capsys):
    calls = []

    def fn(x):
        calls.append(1)
        return torch.mm(x, x).relu().sum()

    x = torch.randn(64, 64)
    path = tmp_path / "trace.json"
    trace = profiling.trace_fn(fn, x, iters=3, warmup=2, device="cpu",
                               trace_path=str(path))
    assert len(calls) == 5 and trace.iters == 3 and trace.wall_ms > 0
    assert path.exists() and path.stat().st_size > 0
    assert profiling.summarize_trace(trace) == []     # no device events
    rows = profiling.summarize_trace(trace, device_only=False)
    by_name = {r["name"]: r for r in rows}
    assert by_name["aten::mm"]["count"] == 1
    assert rows == sorted(rows, key=lambda r: -r["ms"])
    profiling.print_summary(rows, top=3)
    assert "aten::" in capsys.readouterr().out
    summary = profiling.device_summary(trace)
    assert summary["device_busy_ms"] == 0.0
    assert summary["device_idle_share"] == 1.0


def test_peaks_are_the_h100_data_sheet():
    assert profiling.PEAK_BYTES_S == 3.35e12
    assert profiling.PEAK_FLOP_S == 67e12
