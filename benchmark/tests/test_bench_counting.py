"""The frozen counts behind the rooflines and MFU figures, on cases worked
by hand, and the readers that turn a trace into per-layer metrics."""


import pytest
import torch

from benchmark import harness
from benchmark.reference import counting, raster


def test_bounds_by_hand():
    # No passing steps: bytes alone, 4 B x (10 floats x 1000 rows + 5 x
    # 16 x 16 pixels) over 3.35 TB/s.
    assert counting.blend_fwd_bound_s(0, 1000, 16, 16) == pytest.approx(
        4 * (10 * 1000 + 5 * 256) / 3.35e12)
    # Many passing steps: 18 operations each over 67 TFLOP/s.
    assert counting.blend_fwd_bound_s(10 ** 9, 10, 16, 16) == pytest.approx(
        18e9 / 67e12)
    assert counting.blend_bwd_bound_s(10 ** 9, 10, 16, 16) == pytest.approx(
        50e9 / 67e12)
    assert counting.blend_bwd_bound_s(0, 1000, 16, 16) == pytest.approx(
        4 * (20 * 1000 + 5 * 256) / 3.35e12)
    assert counting.train_step_ops(10, 2, 100) == 68 * 10 + 1050 * 2 + 1200
    assert counting.serve_frame_ops(10, 2) == 18 * 10 + 350 * 2


def stacked(alphas, size=16):
    """Coincident wide Gaussians, nearest first, over a size x size image."""
    n = len(alphas)
    z = torch.zeros(n)
    return raster.Projected(
        mean2d=torch.full((n, 2), size / 2 - 0.5),
        conic=torch.tensor([[1e-6, 0.0, 1e-6]]).repeat(n, 1),
        color=torch.rand(n, 3, generator=torch.Generator().manual_seed(0)),
        opacity=torch.tensor(alphas), inv_depth=z + 0.5,
        depth=torch.arange(1.0, n + 1.0), radius=z + 3.0 * size,
        valid=torch.ones(n, dtype=torch.bool))


def test_passing_steps_stop_at_transmittance():
    # 0.95 each: transmittance 5e-2, 2.5e-3, 1.25e-4 after three; the
    # fourth would bring it to 6.25e-6 < 1e-4 and is not taken.
    p = stacked([0.95] * 4)
    *_, passes = raster.render(raster.plan_tiles(p, 16, 16), raster.attrs_of(p),
                               torch.zeros(3))
    assert passes == 3 * 256


def test_passing_steps_skip_faint_gaussians():
    # 1/300 < 1/255: skipped everywhere and not counted.
    p = stacked([0.5, 1 / 300, 0.5])
    *_, passes = raster.render(raster.plan_tiles(p, 16, 16), raster.attrs_of(p),
                               torch.zeros(3))
    assert passes == 2 * 256


def reader(name):
    return harness.metric_module(harness.ROOT, name)


def test_roofline_reader_by_hand():
    counts = [{"passes": 10 ** 9, "visible": 10, "height": 16, "width": 16}]
    ctx = {"counts": counts,
           "kernel_s": {"void exact_pass_kernel<ExactBlend>(...)": 0.5,
                        "void exact_combine_kernel(...)": 0.5,
                        "elementwise": 7.0}}
    assert reader("k3_roofline.serve").read(ctx) == pytest.approx(
        100 * 18e9 / 67e12 / 1.0)
    assert reader("k3_roofline.serve").read(dict(ctx, kernel_s={})) is None
    assert reader("k4_roofline.train").read(ctx) is None


def test_idle_and_layer_readers():
    ctx = {"busy_s": 0.3, "window_s": 0.4,
           "layer_s": {"ops/binning": 0.05, "models/adam": 0.01},
           "stack_requests": 2, "request_s": 0.06,
           "counts": [{"passes": 10 ** 7, "visible": 10 ** 5,
                       "param_elems": 59 * 10 ** 6}]}
    assert reader("device_idle_share.train").read(ctx) == pytest.approx(25.0)
    assert reader("device_idle_share.serve").read(dict(ctx, window_s=0)) is None
    assert reader("binning_ms.train").read(ctx) == pytest.approx(25.0)
    assert reader("adam_ms.train").read(ctx) == pytest.approx(5.0)
    ops = 68e7 + 1050e5 + 12 * 59e6
    assert reader("train_mfu").read(ctx) == pytest.approx(
        100 * ops / (0.06 * 67e12))
    assert reader("cut_ms.serve").read(ctx) is None
