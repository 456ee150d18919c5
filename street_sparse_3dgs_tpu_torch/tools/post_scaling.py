"""Post-opt step cost against hierarchy size: the mask form is O(nodes), the
compacted form O(cut) — the port of ``tools/post_scaling_tpu.py``.

Builds synthetic balanced hierarchies of growing leaf count with a FIXED
cut of about 2k nodes at the render limit, and times one post-opt step
through each form on the card, in the production exact counts config
(K5, K3, K4).  Run:

    python -m street_sparse_3dgs_tpu_torch.tools.post_scaling [--device cuda]

It prints one JSON line per size: nodes, cut size, mask and compact ms per
step (host clock around synchronised steps, best of 3 runs of 5), their
ratio and the compact step's ``cut_overflow``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from ..config import OptimizationConfig, PipelineConfig
from ..data.toy import lookat_camera
from ..device import DEFAULT_DEVICE, resolve_device
from ..hierarchy.structure import Hierarchy, select_cut
from ..models.gaussians import GaussianParams
from ..train.post import init_post_state, make_post_step
from ..train.step import CameraBatch

SIZES = (32_768, 131_072, 524_288)
CUT_TARGET = 2048
RES = 256
COMPACT_CAPACITY = 4096
PIPE = PipelineConfig(raster_method="pallas", tile_capacity=128, max_dup=16,
                      exact_extra=1024, grad_reduce="counts",
                      grad_sort="bf16")


def synth_hierarchy(n_leaves: int, seed: int = 0,
                    device: str | torch.device = DEFAULT_DEVICE) -> Hierarchy:
    """Balanced binary tree over random leaves in a unit-ish box: leaves
    first (builder convention), each internal level follows, root last.
    The same draws and arithmetic as the JAX tool's ``synth_hierarchy``,
    with each level's boxes computed at once instead of node by node."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    counts = []
    c = n_leaves
    while c > 1:
        counts.append(c)
        c = (c + 1) // 2
    counts.append(1)
    n_nodes = sum(counts)
    parent = np.full(n_nodes, -1, np.int32)
    child_start = np.zeros(n_nodes, np.int32)
    child_count = np.zeros(n_nodes, np.int32)
    level_start = np.cumsum([0] + counts[:-1])
    for li in range(len(counts) - 1):
        s, n = level_start[li], counts[li]
        parent[s:s + n] = level_start[li + 1] + np.arange(n) // 2
    for li in range(1, len(counts)):
        s, n = level_start[li], counts[li]
        cs, cn = level_start[li - 1], counts[li - 1]
        ids = np.arange(n)
        child_start[s:s + n] = cs + ids * 2
        child_count[s:s + n] = np.minimum(2, cn - ids * 2)

    xyz = np.zeros((n_nodes, 3), np.float32)
    xyz[:n_leaves] = rng.uniform(-1, 1, (n_leaves, 3))
    half = np.zeros((n_nodes, 3), np.float32)
    half[:n_leaves] = 0.01
    for li in range(1, len(counts)):
        s, n = level_start[li], counts[li]
        first = child_start[s:s + n]
        # A parent of one child takes that child's box twice.
        second = first + child_count[s:s + n] - 1
        lo = np.minimum(xyz[first] - half[first], xyz[second] - half[second])
        hi = np.maximum(xyz[first] + half[first], xyz[second] + half[second])
        xyz[s:s + n] = (lo + hi) / 2
        half[s:s + n] = (hi - lo) / 2
    size = 2.0 * np.linalg.norm(half, axis=1).astype(np.float32) + 1e-3

    k = 16  # sh_degree 3
    dc = rng.normal(0, 0.2, (n_nodes, 1, 3)).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    params = GaussianParams(
        xyz=t(xyz), features_dc=t(dc),
        features_rest=torch.zeros((n_nodes, k - 1, 3), device=dev),
        log_scales=torch.full((n_nodes, 3), math.log(0.02), device=dev),
        quats=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(
            n_nodes, 1),
        opacity_raw=torch.full((n_nodes, 1), 0.7, device=dev))
    return Hierarchy(params=params, parent=t(parent),
                     child_start=t(child_start), child_count=t(child_count),
                     box_center=t(xyz), box_half=t(half), size=t(size),
                     anchors=torch.zeros(n_nodes, dtype=torch.bool,
                                         device=dev),
                     skybox_count=0)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_step(step, state, batch, limit, iters: int = 5, runs: int = 3):
    """(best ms per step over ``runs`` runs of ``iters`` steps after a
    warm-up, n_selected, cut_overflow of the last step)."""
    dev = state.params.xyz.device
    eye = torch.eye(3, 4, device=dev)
    _, aux = step(state, batch, limit, eye)
    _sync(dev)
    best = math.inf
    for _ in range(runs):
        t0 = time.perf_counter()
        cur = state
        for _ in range(iters):
            cur, aux = step(cur, batch, limit, eye)
        _sync(dev)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3, int(aux["n_selected"]), int(aux["cut_overflow"])


def cut_limit(h: Hierarchy, campos: torch.Tensor,
              target: int = CUT_TARGET) -> float:
    """A limit that lands the cut on an interior level (at most ``target``
    nodes), by bisection in log space."""
    lo, hi = 1e-5, 10.0
    for _ in range(40):
        mid = math.sqrt(lo * hi)
        if int(torch.sum(select_cut(h, campos, mid).selected)) > target:
            lo = mid
        else:
            hi = mid
    return hi


def measure(device: str | torch.device = DEFAULT_DEVICE, sizes=SIZES,
            res: int = RES) -> list[dict]:
    """One record per leaf count: nodes, cut, mask_ms, compact_ms, ratio,
    cut_overflow."""
    dev = resolve_device(device)
    cam = lookat_camera(np.array([3.0, 0.0, 1.0]), np.zeros(3), res, res,
                        device=dev)
    shape = (1, res, res)
    batch = CameraBatch(camera=cam, gt_image=torch.zeros((3, res, res),
                                                         device=dev),
                        alpha_mask=torch.ones(shape, device=dev),
                        mono_invdepth=torch.zeros(shape, device=dev),
                        depth_mask=torch.zeros(shape, device=dev),
                        depth_reliable=torch.tensor(False, device=dev),
                        image_index=torch.tensor(0, device=dev))
    opt = OptimizationConfig()
    out = []
    for n_leaves in sizes:
        h = synth_hierarchy(n_leaves, device=dev)
        limit = cut_limit(h, cam.campos)
        n_sel = int(torch.sum(select_cut(h, cam.campos, limit).selected))
        kw = dict(skybox_locked=False, use_trained_exp=False)
        t_mask, _, _ = time_step(make_post_step(h, opt, PIPE, **kw),
                                 init_post_state(h), batch, limit)
        t_comp, _, ovf = time_step(
            make_post_step(h, opt, PIPE, compact_capacity=COMPACT_CAPACITY,
                           **kw), init_post_state(h), batch, limit)
        out.append({"leaves": n_leaves, "nodes": h.n_nodes, "cut": n_sel,
                    "limit": limit, "capacity": COMPACT_CAPACITY,
                    "mask_ms": t_mask, "compact_ms": t_comp,
                    "ratio": t_mask / t_comp, "cut_overflow": ovf})
        del h
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    for rec in measure(args.device):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
