"""PyTorch port, the program's own spans and counters (``profiling.py``):
off by default and free of records there; under ``tracing()`` and a CPU
profiler, a train step and a served frame of the toy scene open the span
tree the benchmark reads, binning's counters equal what the JAX
package's tables and probes give on the same projected rows, the frame's
compaction passes its one sync point; and ``span_table`` /
``device_summary`` read a synthetic trace exactly."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from street_sparse_3dgs_tpu.data.toy import make_toy_scene as jtoy
from street_sparse_3dgs_tpu.ops import autosize as jautosize
from street_sparse_3dgs_tpu.ops import binning as jbinning
from street_sparse_3dgs_tpu.ops.preprocess import (
    project_gaussians as jproject)
from street_sparse_3dgs_tpu_torch import profiling as P
from street_sparse_3dgs_tpu_torch.config import (OptimizationConfig,
                                                 PipelineConfig)
from street_sparse_3dgs_tpu_torch.data.toy import make_toy_scene
from street_sparse_3dgs_tpu_torch.hierarchy import render, structure
from street_sparse_3dgs_tpu_torch.hierarchy.build import build_hierarchy
from street_sparse_3dgs_tpu_torch.models.gaussians import (GaussianMeta,
                                                           GaussianParams)
from street_sparse_3dgs_tpu_torch.ops.binning import (DUP_OVERSCAN,
                                                      bin_gaussians,
                                                      num_tiles)
from street_sparse_3dgs_tpu_torch.ops.preprocess import Projected
from street_sparse_3dgs_tpu_torch.ops.rasterize import RasterConfig
from street_sparse_3dgs_tpu_torch.train.step import (CameraBatch, init_state,
                                                     make_train_step)

torch.set_num_threads(1)
W = H = 64
N = 300
EXACT = dict(raster_method="pallas", tile_capacity=128, max_dup=32,
             exact_extra=64, grad_reduce="counts")
BINNING = {"binning": None, **{f"binning.{s}": "binning" for s in (
    "depth_sort", "scan", "row_sort", "tails", "key_sort", "windows",
    "k5")}, "trace.count": "binning",
    "sync.binning_alpha_min": "binning.scan"}
# The places a train step waits for the device, each a sync point.
STEP_SYNCS = {"sync.exposure_row": 1, "sync.exposure_grad": 1,
              "sync.project_size": 1, "sync.binning_alpha_min": 1,
              "sync.ssim_window": 5}
TRAIN_TREE = {
    "train.step": None, "train.forward": "train.step",
    "raster.project": "train.forward", **BINNING,
    "blend.k3": "train.forward", "train.loss": "train.step",
    "train.backward": "train.step", "blend.k4": "train.backward",
    "blend.slot_grads": "train.backward", "adam.sparse": "train.step",
    "adam.dense": "train.step", "train.stats": "train.step",
    "sync.exposure_row": "train.step", "sync.exposure_grad": "train.step",
    "sync.project_size": "raster.project", "sync.ssim_window": "train.loss"}
TRAIN_TREE["binning"] = "train.forward"
FRAME_TREE = {"hierarchy.cut": None, "hierarchy.compact": None,
              "sync.compact_nonzero": "hierarchy.compact",
              "raster.project": None, "sync.project_size": "raster.project",
              **BINNING, "blend.k3": None}


@functools.lru_cache(maxsize=None)
def scene():
    return make_toy_scene(seed=3, n=N, n_cameras=2, width=W, height=H,
                          device="cpu")


def raw_params(s) -> GaussianParams:
    op = s.opacities.clamp(1e-4, 1 - 1e-4)
    return GaussianParams(
        xyz=s.means3d, features_dc=s.sh_coeffs[:, :1].contiguous(),
        features_rest=s.sh_coeffs[:, 1:].contiguous(),
        log_scales=torch.log(s.scales), quats=s.quats,
        opacity_raw=torch.log(op / (1 - op))[:, None])


def train_step():
    s = scene()
    step = make_train_step(GaussianMeta(sh_degree=3, capacity=N),
                           OptimizationConfig(iterations=50),
                           PipelineConfig(**EXACT), 1.0,
                           sh_degree_schedule=False)
    state = init_state(raw_params(s), torch.ones(N, dtype=torch.bool), 2)
    batch = CameraBatch(
        camera=s.cameras[1], gt_image=torch.rand(
            3, H, W, generator=torch.Generator().manual_seed(0)),
        alpha_mask=torch.ones(1, H, W),
        mono_invdepth=torch.full((1, H, W), 0.2),
        depth_mask=torch.ones(1, H, W), depth_reliable=torch.tensor(True),
        image_index=torch.tensor(1))
    return step, state, batch


def traced(fn):
    """``fn()`` under ``tracing()`` and a CPU profiler: (its result, the
    span table, the counters)."""
    P.counters()
    with P.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, P.span_table(prof), P.counters()


def tree(table) -> dict:
    return {k: r["parent"] for k, r in table["rows"].items()
            if k != "outside"}


def test_off_path_records_nothing():
    """Off (the default): every span and sync point is the one shared
    no-op, and neither a count nor a whole train step leaves a counter."""
    assert P.span("a") is P._NOOP and P.span("b", "1") is P._NOOP
    assert P.sync_point("a") is P._NOOP
    P.count("a", 3)
    P.count("b", torch.ones(4, dtype=torch.int32))
    step, state, batch = train_step()
    step(state, batch)
    assert P.counters() == {}


def test_counters_add_on_both_sides_and_reset():
    with P.tracing():
        P.count("host", 2)
        P.count("host", 5)
        P.count("dev", torch.tensor([1, 2, 3], dtype=torch.int32))
        P.count("dev", torch.tensor([True, False, True]))
        with P.sync_point("probe"):
            pass
    assert P.counters() == {"dev": 8, "host": 7, "sync.probe": 1}
    assert P.counters() == {}


def test_train_step_opens_the_span_tree(monkeypatch):
    """One exact-mode counts step: the tree of ``train.step`` (opened with
    the 1-based step number), its forward, loss, backward (K4 and the
    slot sums under it), Adam and the stats, and its nine sync points."""
    step, state, batch = train_step()
    state, _ = step(state, batch)
    opened = []
    real = torch.profiler.record_function

    def record(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", record)
    _, table, ctrs = traced(lambda: step(state, batch))
    assert tree(table) == TRAIN_TREE
    assert opened[0] == ("train.step", "2")
    assert table["rows"]["train.step"]["calls"] == 1
    assert table["rows"]["trace.count"]["calls"] == 4
    assert {k: v for k, v in ctrs.items() if k.startswith("sync.")} == \
        STEP_SYNCS
    assert {k for k in ctrs if not k.startswith("sync.")} == {
        "binning.rows", "binning.slots", "binning.covered", "binning.kept",
        "binning.pairs", "binning.extra_windows"}


def test_served_frame_opens_the_span_tree():
    """``select_cut`` + ``render_cut_compact``: the cut, the compaction
    with its ``nonzero`` sync point, then projection, binning and the
    blend at the root (the frame has no root span of its own);
    ``cut.rows`` the live rows handed to the rasterizer."""
    s = scene()
    h = build_hierarchy(raw_params(s), device="cpu")
    cam = s.cameras[0]
    limit = structure.pixel_limit(3.0, float(cam.tan_fovx), cam.width)
    cfg = RasterConfig(method="pallas", tile_capacity=128, max_dup=32,
                       exact_extra=64)

    def frame():
        cut = structure.select_cut(h, cam.campos, limit)
        render.render_cut_compact(h.params, cut, h.n_nodes, h.skybox_count,
                                  cam, 3, torch.zeros(3), cfg)
        return cut

    for frames in (1, 2):
        cuts, table, ctrs = traced(lambda: [frame() for _ in range(frames)])
        assert tree(table) == FRAME_TREE
        assert {k: v for k, v in ctrs.items() if k.startswith("sync.")} == {
            "sync.compact_nonzero": frames, "sync.project_size": frames,
            "sync.binning_alpha_min": frames}
        assert table["rows"]["sync.compact_nonzero"]["calls"] == frames
        assert ctrs["cut.rows"] == sum(int(c.selected.sum()) for c in cuts)


@functools.lru_cache(maxsize=None)
def jax_projected():
    """The JAX package's toy scene projected by the JAX package (view 0)."""
    s = jtoy(seed=3, n=N, n_cameras=1, width=W, height=H)
    return jproject(s.means3d, s.scales, s.quats, s.opacities, s.sh_coeffs,
                    s.cameras[0], 3)


@pytest.mark.parametrize("exact_extra", [0, 64])
def test_binning_counters_equal_its_tables(exact_extra):
    """On the JAX package's projected rows: covered Σ min(coverage, scan)
    and kept (the culled scan's survivors) from the JAX package's
    ``_coverage_pass`` and ``_kept_probe``, pairs Σ counts and, in exact
    mode, the windows past one a tile from the JAX package's
    ``bin_gaussians``; rows and slots (rows × scan) known on the host."""
    jproj = jax_projected()
    proj = Projected(*(torch.tensor(np.asarray(x)) for x in jproj))
    max_dup = 4
    _, _, ctrs = traced(lambda: bin_gaussians(
        proj, H, W, max_dup, 16, exact_extra=exact_extra))
    tx, ty = num_tiles(H, W)
    scan = max_dup * DUP_OVERSCAN
    cov = np.asarray(jautosize._coverage_pass(jproj, tx, ty))
    kept = np.asarray(jautosize._kept_probe(jproj, jnp.arange(N), scan, tx,
                                            ty))
    jbins = jbinning.bin_gaussians(jproj, H, W, max_dup, 16,
                                   exact_extra=exact_extra)
    want = {"sync.binning_alpha_min": 1,
            "binning.rows": N, "binning.slots": N * scan,
            "binning.covered": int(np.minimum(cov, scan).sum()),
            "binning.kept": int(kept.sum()),
            "binning.pairs": int(np.asarray(jbins.counts).sum())}
    if exact_extra:
        want["binning.extra_windows"] = int(
            (np.asarray(jbins.t_of_v) < tx * ty).sum()) - tx * ty
        assert want["binning.extra_windows"] > 0
    assert ctrs == want
    assert 0 < want["binning.kept"] < want["binning.covered"]


def synthetic():
    """Two threads: ``a`` holds ``b`` on the caller's thread, ``c`` runs
    on another thread inside ``b`` (as autograd's thread inside
    ``train.backward``)."""
    E = P.Event
    return [E("window", "", 0, 100),
            E("span", "a", 10, 60), E("span", "b", 20, 40),
            E("span", "c", 25, 35),
            E("device", "k1", 12, 18, launch=11),    # launched in a
            E("device", "k2", 26, 30, launch=26),    # in c
            E("device", "k3", 50, 70, launch=38),    # in b, runs after it
            E("device", "k4", 80, 90, launch=75),    # outside
            E("device", "k5", 84, 88),               # no launch: by start
            E("sync", "cudaStreamSynchronize", 36, 38),
            E("sync", "cudaDeviceSynchronize", 95, 96)]


def test_span_table_reads_a_synthetic_trace():
    t = P.span_table(synthetic())
    rows = t["rows"]
    assert (t["window_ms"], t["busy_ms"]) == (0.1, 0.04)
    assert tree(t) == {"a": None, "b": "a", "c": "b"}
    got = {k: (r["calls"], round(r["host_ms"] * 1e3), round(
        r["host_self_ms"] * 1e3), round(r["device_ms"] * 1e3), round(
            r["device_incl_ms"] * 1e3), round(r["idle_ms"] * 1e3),
        r["syncs"]) for k, r in rows.items()}
    # Idle goes to the span innermost at each microsecond: a gets 10-12,
    # 18-20 and 40-50; b 20-25 and 35-40; c 25-26 and 30-35.
    assert got == {"a": (1, 50, 30, 6, 30, 14, 0),
                   "b": (1, 20, 10, 20, 24, 10, 1),
                   "c": (1, 10, 10, 4, 4, 6, 0),
                   "outside": (0, 50, 50, 14, 14, 30, 1)}
    assert sum(r["device_ms"] for r in rows.values()) * 1e3 == \
        pytest.approx(44)                   # k5 overlaps k4: summed apart
    assert sum(r["idle_ms"] for r in rows.values()) == \
        pytest.approx(t["idle_ms"])


def test_device_summary_counts_overlapping_events_once():
    E = P.Event
    trace = P.Trace([E("device", "a", 0, 10), E("device", "b", 5, 15),
                     E("device", "c", 30, 40)], wall_ms=0.1, iters=1)
    s = P.device_summary(trace)
    assert s["device_busy_ms"] == pytest.approx(0.025)
    assert s["device_idle_share"] == pytest.approx(0.75)
    assert s["top_device_self_ms"] == []


def test_trace_fn_traces_the_program():
    """``trace_fn`` opens ``tracing()``: the spans reach the summary as
    ``span:`` rows and the counters the trace, per traced call."""
    def fn():
        with P.span("probe"):
            P.count("calls", 1)
            return torch.ones(8).sum()

    trace = P.trace_fn(fn, iters=3, warmup=2, device="cpu")
    assert trace.counters == {"calls": 3}
    rows = {r["name"]: r for r in P.summarize_trace(trace,
                                                    device_only=False)}
    assert rows["span:probe"]["count"] == 1 and rows["span:probe"]["ms"] > 0
    assert "probe" not in rows and rows["aten::ones"]["count"] == 1
    assert P.counters() == {} and P.span("probe") is P._NOOP


class _Kineto:
    """A kineto event as torch 2.11 gives it: no ``activity_type``."""

    def __init__(self, name, device, start_us, dur_us, corr=0):
        self._v = (name, device, start_us, dur_us, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return int(self._v[2] * 1000)

    def duration_ns(self):
        return int(self._v[3] * 1000)

    def correlation_id(self):
        return self._v[4]


def test_trace_events_read_kineto_events_without_activity_type():
    """Runtime calls by name, annotations' device-side copies left out,
    each kernel linked to its launch by correlation id."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = [_Kineto("binning", cpu, 10, 30), _Kineto("aten::sort", cpu, 12, 5),
           _Kineto("cudaLaunchKernel", cpu, 13, 1, corr=7),
           _Kineto("cudaStreamSynchronize", cpu, 20, 4, corr=8),
           _Kineto("binning", cuda, 14, 20), _Kineto("sort_kernel", cuda,
                                                     15, 6, corr=7)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return raw

    got = P.trace_events(Prof, names={"binning"})
    E = P.Event
    assert sorted(got) == sorted([
        E("span", "binning", 10, 40), E("sync", "cudaStreamSynchronize",
                                        20, 24),
        E("device", "sort_kernel", 15, 21, launch=13),
        E("window", "", 10, 40)])
