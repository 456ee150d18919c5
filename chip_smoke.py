#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's forward LOD render path on the card and holds every
hand-written kernel against its plain PyTorch version:

1. build   — compile ``street_sparse_3dgs_tpu_torch/csrc/*.cu`` (one nvcc per
             source, in parallel) into the ignored ``build/kernels/``;
2. kernels — K1 (padded blend), K3 (exact blend) and K5 (slab gather) on
             small inputs against their plain versions;
3. render  — the street scene (1M Gaussians, 4 views, 1920x1088) through
             ``rasterize(method="pallas")`` in the production exact config
             (K3) and a padded config (K1); every image is compared with the
             plain path on the same inputs;
4. hierarchy — a LOD hierarchy over the same rows, saved to ``.hier.npz``
             and loaded back, rendered per view at tau in {0, 3, 6, 15}
             through ``pixel_limit -> select_cut -> render_cut_compact``;
5. layers  — the stages of one street render timed apart, and a profile
             of it (device time by op, device idle share);
6. the kernels line (launches counted on phases 3 and 4 only, error against
             the plain version, times, bound) and the device line.

Every phase prints one JSON line.  Any failure raises and exits nonzero.
Without a CUDA card it exits 1 before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense rates at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SFU_PER_SM_PER_CLK = 16          # special-function results per SM per clock
FLOPS_PER_EVAL = 20              # f32 ops of one (slot, pixel) blend step
SFU_PER_EVAL = 2                 # exp(power) and log1p(-alpha) per step

IMG_ATOL = 2e-5                  # tests/test_pallas_blend.py forward bar
FLIP_SHARE = 1e-4                # pixels allowed to differ by a T=1e-4 flip

STREET = dict(method="pallas", max_dup=2, tile_capacity=128, dup_overscan=32,
              dup_tails=((262144, 6), (16384, 24), (4096, 224)))
TAUS = (0.0, 3.0, 6.0, 15.0)
TIMED_RUNS = 5
DEVICE = "cuda"
N_ROWS, N_VIEWS, WIDTH, HEIGHT = 1_000_000, 4, 1920, 1088


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_runs(fn, runs: int = TIMED_RUNS):
    """(median ms over ``runs`` event-timed calls after a warm-up, last
    result)."""
    out = fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


class Recorder:
    """Wraps ``module.name`` so every call's arguments and result are kept
    while the ``with`` block runs (the comparison harness only)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls: list = []

    def __enter__(self):
        def wrapped(*args):
            out = self.fn(*args)
            self.calls.append((args, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def compare_blend(k_out: torch.Tensor, p_out: torch.Tensor) -> dict:
    """Kernel vs plain packed rows [T, 8, 256], per pixel over rows R, G, B,
    invdepth, alpha and log T.  ``flips`` counts pixels whose n_contrib
    differs: a termination flip at T ~ 1e-4, where the kernel's running sum
    of log(1 - alpha) and the plain version's cumsum round differently."""
    err = (k_out[:, :6] - p_out[:, :6]).abs().amax(dim=1)      # [T, 256]
    flip = k_out[:, 6] != p_out[:, 6]
    zero = torch.zeros_like(err)
    return dict(max_abs_err=float(err.max()),
                pixels_over_atol=int((err > IMG_ATOL).sum()),
                pixels=int(err.numel()), flips=int(flip.sum()),
                max_err_without_flips=float(torch.where(flip, zero,
                                                        err).max()))


def check_blend(name: str, cmp: dict, strict: bool) -> None:
    """Every pixel within IMG_ATOL (strict), or all but FLIP_SHARE of
    them."""
    limit = 0 if strict else FLIP_SHARE * cmp["pixels"]
    if cmp["pixels_over_atol"] > limit:
        raise AssertionError(f"{name}: {cmp['pixels_over_atol']} pixels "
                             f"over {IMG_ATOL} (limit {limit}): {cmp}")


def blend_bound(live_slots: int, out_t: int, vec_reads: int, evals: int,
                sfu_rate: float):
    """(bound ms, bound_by) of a forward blend: bytes = live attrs (10 f32
    each) + per-tile int32 metadata + [T, 8, 256] f32 output; operations =
    (slot, pixel) steps actually walked, each two transcendentals on the
    special-function units and FLOPS_PER_EVAL f32 operations."""
    bytes_ = live_slots * 40 + vec_reads * 4 + out_t * 8 * 256 * 4
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = max(evals * SFU_PER_EVAL / sfu_rate,
                evals * FLOPS_PER_EVAL / FP32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def walked(out: torch.Tensor, live: torch.Tensor) -> int:
    """(slot, pixel) steps a blend walked: n_contrib slots passed, plus the
    terminating slot where the walk stopped before the tile's live count."""
    nc = out[:, 6].to(torch.int64)
    return int(torch.minimum(nc + 1, live[:, None]).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from street_sparse_3dgs_tpu_torch import native
    from street_sparse_3dgs_tpu_torch.data.toy import make_street_scene
    from street_sparse_3dgs_tpu_torch.hierarchy.build import build_hierarchy
    from street_sparse_3dgs_tpu_torch.hierarchy.io import (load_hierarchy,
                                                           save_hierarchy)
    from street_sparse_3dgs_tpu_torch.hierarchy.render import (
        render_cut_compact)
    from street_sparse_3dgs_tpu_torch.hierarchy.structure import (pixel_limit,
                                                                  select_cut)
    from street_sparse_3dgs_tpu_torch.models.gaussians import GaussianParams
    from street_sparse_3dgs_tpu_torch.ops import binning
    from street_sparse_3dgs_tpu_torch.ops import cuda_blend as cb
    from street_sparse_3dgs_tpu_torch.ops.preprocess import project_gaussians
    from street_sparse_3dgs_tpu_torch.ops.rasterize import (RasterConfig,
                                                            rasterize)

    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmuls must run in full precision")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    t_all = time.perf_counter()

    # ---- 1. build -------------------------------------------------------
    info = native.build()
    card = smi("name,power.limit")
    print(card, flush=True)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    sfu_rate = sm_count * SFU_PER_SM_PER_CLK * max_mhz * 1e6
    emit({"phase": "build", "seconds": info["seconds"],
          "built": info["built"], "ptxas": info["ptxas"], "card": card,
          "sms": sm_count, "max_sm_mhz": max_mhz})

    # ---- 2. kernels at small shapes ----------------------------------------
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    t_small, k_small, tiles_x = 12, 256, 4
    attrs = torch.zeros(t_small, 10, k_small)
    attrs[:, 0] = torch.rand(t_small, k_small, generator=g) * 64
    attrs[:, 1] = torch.rand(t_small, k_small, generator=g) * 48
    attrs[:, 2] = 0.02 + 0.1 * torch.rand(t_small, k_small, generator=g)
    attrs[:, 3] = 0.01 * torch.randn(t_small, k_small, generator=g)
    attrs[:, 4] = 0.02 + 0.1 * torch.rand(t_small, k_small, generator=g)
    attrs[:, 5:8] = torch.rand(t_small, 3, k_small, generator=g)
    attrs[:, 8] = torch.rand(t_small, k_small, generator=g)
    attrs[:, 9] = torch.rand(t_small, k_small, generator=g)
    counts = torch.randint(0, 300, (t_small,), generator=g, dtype=torch.int32)
    small = {}
    for bg in (torch.tensor([[0.2, 0.1, 0.3]]),
               torch.rand(t_small, 3, generator=g)):
        for tile0 in (0, 5):
            a = [x.to(dev) for x in (attrs, counts, bg)]
            k_out = cb.blend_padded(*a, tiles_x, tile0, t_small)
            p_out = cb.blend_padded_plain(*a, tiles_x, tile0, t_small)
            cmp = compare_blend(k_out, p_out)
            check_blend("K1 small", cmp, strict=True)
            small[f"K1 tile0={tile0} bg={tuple(bg.shape)}"] = cmp
    # K3: 5 real tiles over 12 used windows (+8 budget windows never read).
    pairs = attrs.permute(0, 2, 1).reshape(-1, 10)[:20 * 128]
    pairs = pairs.reshape(20, 128, 10).contiguous()
    vcounts = torch.tensor([128, 128, 40, 100, 128, 7, 0, 128, 128, 128, 128,
                            3] + [0] * 8, dtype=torch.int32)
    wt = torch.tensor([0, 1, 2, 0, 0, 1, 0, 0, 1, 2, 3, 4] + [0] * 8,
                      dtype=torch.int32)
    last_v = torch.tensor([2, 3, 5, 6, 11], dtype=torch.int32)
    a = [x.to(dev) for x in (pairs, vcounts, wt, last_v,
                             torch.tensor([[0.2, 0.1, 0.3]]))]
    cmp = compare_blend(cb.blend_exact(*a, 3), cb.blend_exact_plain(*a, 3))
    check_blend("K3 small", cmp, strict=True)
    small["K3"] = cmp
    vals = torch.sort(torch.randint(0, 1 << 40, (5000,), generator=g)).values
    starts = torch.sort(torch.randint(0, 5000, (13,), generator=g)).values
    cnts = torch.clamp(5000 - starts, max=300).to(torch.int32)
    a = [x.to(dev) for x in (vals, starts.to(torch.int32), cnts)]
    if not torch.equal(binning.slab_gather(*a, 256, 12, 5000),
                       binning.slab_gather_plain(*a, 256, 12, 5000)):
        raise AssertionError("K5 small: kernel table differs from plain")
    small["K5"] = "equal"
    torch.cuda.synchronize()
    emit({"phase": "kernels_small", "seconds": time.perf_counter() - t0,
          "atol": IMG_ATOL, "checks": small})

    # ---- 3. street render (main path, counted) ---------------------------
    t0 = time.perf_counter()
    scene = make_street_scene(seed=0, n=N_ROWS, n_cameras=N_VIEWS,
                              width=WIDTH, height=HEIGHT, device=dev)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    configs = {"exact": RasterConfig(**STREET, exact_extra=9216),
               "padded": RasterConfig(**{**STREET, "tile_capacity": 1024})}
    bg = torch.zeros(3, device=dev)
    rows = (scene.means3d, scene.scales, scene.quats, scene.opacities,
            scene.sh_coeffs)

    native.reset_launches()
    renders = []
    for v, cam in enumerate(scene.cameras):
        for cname, cfg in configs.items():
            ms, out = timed_runs(lambda: rasterize(*rows, cam, 3, bg, cfg))
            renders.append((v, cname, ms, out))
    launches_render = dict(native.LAUNCHES)
    for name in ("blend_padded", "blend_exact", "slab_gather"):
        if launches_render[name] == 0:
            raise AssertionError(f"render path never launched {name}")

    # Comparison harness (launches here are not counted): rerun each view
    # once with the wrappers recorded, hold every kernel against its plain
    # version on the recorded inputs, and the image against the plain path.
    street = {}
    per_view = []
    for (v, cname, ms, out), cam in zip(
            renders, [c for c in scene.cameras for _ in configs]):
        cfg = configs[cname]
        blend_name = "blend_exact" if cfg.exact_extra else "blend_padded"
        with Recorder(binning, "slab_gather") as k5, \
                Recorder(cb, blend_name) as kb:
            again = rasterize(*rows, cam, 3, bg, cfg)
        k5_args, k5_out = k5.calls[0]
        if not torch.equal(k5_out, binning.slab_gather_plain(*k5_args)):
            raise AssertionError(f"K5 view {v} {cname}: table differs")
        b_args, b_out = kb.calls[0]
        plain_fn = (cb.blend_exact_plain if cfg.exact_extra
                    else cb.blend_padded_plain)
        p_out = plain_fn(*b_args)
        cmp = compare_blend(b_out, p_out)
        check_blend(f"{blend_name} view {v}", cmp, strict=False)
        tiles_x = b_args[-1]
        ty = -(-cam.height // 16)
        plain_img = cb._to_image(p_out[:, :5], tiles_x, ty, cam.height,
                                 cam.width)
        main_img = torch.cat([out["render"], out["depth"],
                              out["alpha"][None]])
        if not torch.equal(main_img, torch.cat(
                [again["render"], again["depth"], again["alpha"][None]])):
            raise AssertionError(f"view {v} {cname}: render not repeatable")
        over = int(((main_img - plain_img).abs().amax(dim=0)
                    > IMG_ATOL).sum())
        if over > FLIP_SHARE * cam.height * cam.width:
            raise AssertionError(f"view {v} {cname}: {over} pixels over "
                                 f"{IMG_ATOL} against the plain path")
        img = out["render"]
        if tuple(img.shape) != (3, cam.height, cam.width) or \
                not bool(torch.isfinite(main_img).all()):
            raise AssertionError(f"view {v} {cname}: bad image")
        if v == 0:
            street[cname] = dict(k5=k5_args, k5_out=k5_out, blend=b_args,
                                 blend_out=b_out, plain_out=p_out)
        per_view.append({
            "view": v, "config": cname, "ms": ms,
            # Binned pairs: window counts plus what the budget dropped, or
            # the pre-clip tile counts.
            "pairs": int(k5_args[2].sum()) + (
                int(out["tile_overflow"]) if cfg.exact_extra else 0),
            "visible": int(out["visibility"].sum()),
            "tile_overflow": int(out["tile_overflow"]),
            "dup_overflow": int(out["dup_overflow"]),
            "vis_overflow": int(out["vis_overflow"]),
            "image_std": float(img.std()),
            "pixels_over_atol": over, "blend_vs_plain": cmp})
    torch.cuda.synchronize()
    emit({"phase": "render", "seconds": time.perf_counter() - t0,
          "scene_seconds": scene_s, "n": N_ROWS, "width": WIDTH,
          "height": HEIGHT, "timed_runs": TIMED_RUNS, "launches":
          launches_render, "views": per_view})

    # ---- 4. hierarchy: build, save/load, tau sweep (main path, counted) ----
    t0 = time.perf_counter()
    params = GaussianParams(
        xyz=scene.means3d, features_dc=scene.sh_coeffs[:, :1],
        features_rest=scene.sh_coeffs[:, 1:],
        log_scales=torch.log(scene.scales), quats=scene.quats,
        opacity_raw=scene.opacities[:, None])
    h = build_hierarchy(params, opacity_activation="abs", device=dev)
    build_s = time.perf_counter() - t0
    path = ROOT / "build" / "smoke" / "street.hier.npz"
    save_hierarchy(path, h)
    h2 = load_hierarchy(path, device=dev)
    for name in ("parent", "child_count", "size", "box_center"):
        if not torch.equal(getattr(h, name), getattr(h2, name)):
            raise AssertionError(f"hierarchy field {name} changed on reload")
    if not torch.equal(h.params.xyz, h2.params.xyz):
        raise AssertionError("hierarchy params changed on reload")
    h = h2
    io_s = time.perf_counter() - t0 - build_s
    cfg = configs["exact"]

    native.reset_launches()
    cuts = []
    for v, cam in enumerate(scene.cameras):
        for tau in TAUS:
            lim = pixel_limit(tau, float(cam.tan_fovx), cam.width)
            cut_ms, cut = timed_runs(lambda: select_cut(h, cam.campos, lim))
            ms, out = timed_runs(lambda: render_cut_compact(
                h.params, cut, h.n_nodes, h.skybox_count, cam, 3, bg, cfg))
            cuts.append((v, tau, cut, cut_ms, ms, out))
    launches_hier = dict(native.LAUNCHES)
    for name in ("blend_exact", "slab_gather"):
        if launches_hier[name] == 0:
            raise AssertionError(f"hierarchy path never launched {name}")

    sweep = []
    for v, tau, cut, cut_ms, ms, out in cuts:
        cam = scene.cameras[v]
        with Recorder(cb, "blend_exact") as kb:
            render_cut_compact(h.params, cut, h.n_nodes, h.skybox_count, cam,
                               3, bg, cfg)
        b_args, b_out = kb.calls[0]
        cmp = compare_blend(b_out, cb.blend_exact_plain(*b_args))
        check_blend(f"K3 hierarchy view {v} tau {tau}", cmp, strict=False)
        img = out["render"]
        if tuple(img.shape) != (3, cam.height, cam.width) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"hierarchy view {v} tau {tau}: bad image")
        sweep.append({"view": v, "tau": tau,
                      "cut_size": int(cut.selected.sum()),
                      "select_ms": cut_ms, "ms": ms,
                      "tile_overflow": int(out["tile_overflow"]),
                      "dup_overflow": int(out["dup_overflow"]),
                      "image_std": float(img.std()),
                      "blend_vs_plain": cmp})
    torch.cuda.synchronize()
    emit({"phase": "hierarchy", "seconds": time.perf_counter() - t0,
          "build_seconds": build_s, "save_load_seconds": io_s,
          "nodes": h.n_nodes, "launches": launches_hier, "sweep": sweep})

    # ---- 5. where the time goes: one exact-config render of view 0 --------
    t0 = time.perf_counter()
    cam, cfg = scene.cameras[0], configs["exact"]
    stages = {}
    stages["project"], proj = timed_runs(
        lambda: project_gaussians(*rows, cam, 3))
    stages["bin"], bins = timed_runs(lambda: binning.bin_gaussians(
        proj, cam.height, cam.width, cfg.max_dup, cfg.tile_capacity,
        vis_capacity=cfg.vis_capacity, exact_extra=cfg.exact_extra,
        dup_overscan=cfg.dup_overscan, dup_tails=cfg.dup_tails))
    stages["pack"], attrs = timed_runs(lambda: cb.pack_gather_attrs(
        bins.gather, proj.mean2d, proj.conic, proj.color, proj.opacity,
        proj.inv_depth, order=bins.order, rank=bins.rank, pair_major=True))
    stages["blend K3"], flat = timed_runs(lambda: cb.blend_exact(
        attrs, bins.vcounts, bins.wt, bins.last_v, bg.reshape(1, 3),
        bins.tiles_x))
    stages["assemble"], _ = timed_runs(lambda: cb._to_image(
        flat[:, :5], bins.tiles_x, bins.tiles_y, cam.height,
        cam.width).contiguous())
    stages["end_to_end"], _ = timed_runs(
        lambda: rasterize(*rows, cam, 3, bg, cfg))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        wall0 = time.perf_counter()
        rasterize(*rows, cam, 3, bg, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - wall0) * 1e3
    # Device busy time: the kernels' own spans (device-side events).  Per
    # op: the device time of the kernels each host-side op launched.
    cuda = torch.autograd.DeviceType.CUDA
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == cuda) / 1e3
    top = sorted((e for e in prof.key_averages() if e.device_type != cuda),
                 key=lambda e: e.self_device_time_total, reverse=True)[:15]
    emit({"phase": "layers", "seconds": time.perf_counter() - t0,
          "view": 0, "config": "exact", "stage_ms": stages,
          "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "top_device_self_ms": [[e.key, e.self_device_time_total / 1e3,
                                  e.count] for e in top]})

    # ---- 6. kernels at the street shapes of view 0 ------------------------
    t0 = time.perf_counter()
    n_renders = {"blend_padded": len(scene.cameras),
                 "blend_exact": len(scene.cameras) * (1 + len(TAUS)),
                 "slab_gather": len(scene.cameras) * (2 + len(TAUS))}
    kernels = []

    ex, pd = street["exact"], street["padded"]
    for name, rec, src, replaces in (
            ("K1 blend_padded", pd, "blend_padded.cu",
             "street_sparse_3dgs_tpu/ops/pallas_blend.py:147"),
            ("K3 blend_exact", ex, "blend_exact.cu",
             "street_sparse_3dgs_tpu/ops/pallas_blend.py:439")):
        args = rec["blend"]
        exact = name.startswith("K3")
        kern = cb.blend_exact if exact else cb.blend_padded
        plain = cb.blend_exact_plain if exact else cb.blend_padded_plain
        ms = event_ms(lambda: kern(*args), 20)
        plain_ms = event_ms(lambda: plain(*args), 2)
        out = rec["blend_out"]
        if exact:
            # Pairs of each real tile: the sum of its windows' counts.
            _, vcounts, wt, last_v = args[:4]
            last = last_v.to(torch.int64)
            csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                              torch.cumsum(vcounts.to(torch.int64), 0)])
            per_tile = csum[last + 1] - csum[last - wt[last]]
            vec_reads = 2 * vcounts.shape[0] + last_v.shape[0]
        else:
            per_tile = torch.clamp(args[1].to(torch.int64),
                                   max=args[0].shape[2])
            vec_reads = args[1].shape[0]
        evals = walked(out, per_tile)
        bound_ms, bound_by = blend_bound(int(per_tile.sum()), out.shape[0],
                                         vec_reads, evals, sfu_rate)
        cmp = compare_blend(out, rec["plain_out"])
        key = "blend_exact" if exact else "blend_padded"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"street_sparse_3dgs_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches_render[key] + launches_hier[key],
            "launches_render": launches_render[key],
            "launches_hierarchy": launches_hier[key],
            "launches_per_view": (launches_render[key] + launches_hier[key])
            / (n_renders[key] * (1 + TIMED_RUNS)),
            "max_abs_err": cmp["max_abs_err"],
            "pixels_over_atol": cmp["pixels_over_atol"],
            "pixels": cmp["pixels"], "flips": cmp["flips"],
            "max_err_without_flips": cmp["max_err_without_flips"],
            "tolerance": f"{IMG_ATOL} on rows RGB/invdepth/alpha/logT at "
                         f"all but {FLIP_SHARE} of the pixels",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "live_slots": int(per_tile.sum()), "evals": evals,
            "tiles": out.shape[0]})

    k5_args = ex["k5"]
    sorted_vals, starts, counts_v, k_cap = k5_args[:4]
    ms = event_ms(lambda: binning.slab_gather(*k5_args), 50)
    plain_ms = event_ms(lambda: binning.slab_gather_plain(*k5_args), 5)
    padded = torch.cat([sorted_vals, torch.zeros(k_cap, dtype=torch.int64,
                                                 device=dev)])
    idx = (starts.to(torch.int64)[:, None]
           + torch.arange(k_cap, device=dev)[None, :])
    library_ms = event_ms(lambda: padded[idx], 50)
    live = int(torch.clamp(counts_v, max=k_cap).sum())
    k5_bytes = live * 8 + starts.shape[0] * 8 + starts.shape[0] * k_cap * 4
    kernels.append({
        "name": "K5 slab_gather", "route": "cuda",
        "source": "street_sparse_3dgs_tpu_torch/csrc/slab_gather.cu",
        "replaces": "street_sparse_3dgs_tpu/ops/binning.py:159",
        "launches": launches_render["slab_gather"]
        + launches_hier["slab_gather"],
        "launches_render": launches_render["slab_gather"],
        "launches_hierarchy": launches_hier["slab_gather"],
        "launches_per_view": (launches_render["slab_gather"]
                              + launches_hier["slab_gather"])
        / (n_renders["slab_gather"] * (1 + TIMED_RUNS)),
        "max_abs_err": float((ex["k5_out"] - binning.slab_gather_plain(
            *k5_args)).abs().max()),
        "tolerance": "exactly equal",
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": k5_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": library_ms, "rows": starts.shape[0], "k": k_cap,
        "live_slots": live})
    torch.cuda.synchronize()
    emit({"phase": "kernels_street", "seconds": time.perf_counter() - t0,
          "card": card})

    print(card, flush=True)
    emit({"kernels": kernels})
    print(json.dumps({"phase": "total",
                      "seconds": time.perf_counter() - t_all}),
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
