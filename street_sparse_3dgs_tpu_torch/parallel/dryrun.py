"""Dry run of the whole multi-rank layer at tiny shapes, the port's
counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py:44-258``), in the same sequence:

1. the data-parallel step (world x 1, one 32x32 view a rank);
2. the tile-sharded render, padded and exact counts (1 x world);
3. the ring-staged render (1 x world);
4. the (data x tile) training step, padded and exact counts (2 x world/2
   for an even world), the latter with ``update_skipped == 0``;
5. the ring training step (1 x world);
6. one ``CompactPostDriver`` run of two post-optimization steps, and a
   tile-sharded render of a hierarchy cut;
7. the two-host ``full_train`` chunk fan-out over a tiny two-chunk project
   on disk (host h on rank h % world, in host order).

The execution model: a rank is a process with one explicit
``torch.device`` (``parallel/mesh.py``); ``run`` spawns ``world`` ranks on
one ``FileStore``.  On the CPU they use ``gloo``; on CUDA rank r takes
``cuda:r % count``, on ``gloo`` when ranks share a card (NCCL refuses
two ranks on one device), else on ``nccl``.  Every render and step uses
``method="pallas"`` (the CUDA kernels on a card) at capacities that are
multiples of 128, as the kernels require (JAX's dry run used 160).
Random draws are inputs (the backgrounds from a seeded generator).

    python -m street_sparse_3dgs_tpu_torch.parallel.dryrun [world] [--cpu]
"""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig, OptimizationConfig, PipelineConfig
from ..data import colmap
from ..data.png import write_png
from ..data.toy import lookat_camera, make_toy_scene, random_gaussians
from ..device import DEFAULT_DEVICE, resolve_device
from ..hierarchy.build import build_hierarchy
from ..hierarchy.render import blend_cut
from ..hierarchy.structure import select_cut
from ..models.gaussians import (GaussianParams, create_from_pcd,
                                inverse_sigmoid)
from ..ops.rasterize import RasterConfig, rasterize
from ..pipeline.full_train import ProjectPaths, full_train
from ..train.post import CompactPostDriver
from ..train.step import CameraBatch, init_state
from . import collectives
from .dp import make_dp_train_step
from .mesh import make_mesh, run_world
from .ring import make_ring_train_step, rasterize_ring_staged
from .tiles import rasterize_tile_sharded
from .tp import make_tile_sharded_train_step

H = W = 32
N_ROWS = 128
CAPACITY = 256


def rank_device(device: str | torch.device, rank: int) -> torch.device:
    """Rank r's device: the CPU, or ``cuda:r % count``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def backend_for(device: str | torch.device, world: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def micro_project(root: Path, device: torch.device, n: int = 120,
                  n_views: int = 6, width: int = 64,
                  height: int = 48) -> Path:
    """A two-chunk project small enough for the dry run (the layout of
    ``tests/test_pipeline.py``'s fixture, written with the port's COLMAP
    and PNG writers): a slab of Gaussians along x, views orbiting above,
    GT rendered by the oracle, chunks split at x = 0."""
    gen = torch.Generator().manual_seed(7)
    means, scales, quats, opac, sh = random_gaussians(gen, n, 3, extent=2.0,
                                                      device=device)
    means[:, 2] *= 0.2
    sh[:, 1:] *= 0.1
    paths = ProjectPaths(root)
    paths.images_dir.mkdir(parents=True)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", width, height, np.array(
        [width / (2 * math.tan(0.5)), height / (2 * math.tan(0.4)),
         width / 2, height / 2]))}
    images = {}
    for i in range(n_views):
        ang = 2 * math.pi * i / n_views
        pos = np.array([2.2 * math.cos(ang), 2.2 * math.sin(ang), 1.4])
        cam = lookat_camera(pos, np.zeros(3), width, height, device=device)
        out = rasterize(means, scales, quats, opac, sh, cam, 3,
                        torch.zeros(3, device=device),
                        RasterConfig(method="oracle"))
        img = torch.clamp(out["render"], 0, 1).permute(1, 2, 0).cpu()
        name = f"view{i:03d}.png"
        write_png(paths.images_dir / name,
                  (img.numpy() * 255).astype(np.uint8))
        w2c = cam.viewmatrix.cpu().numpy()
        images[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros(0, np.int64))
    xyz = means.cpu().numpy().astype(np.float64)
    rgb = np.clip((sh[:, 0].cpu().numpy() * 0.28 + 0.5) * 255, 0,
                  255).astype(np.uint8)
    held = "view000.png\n"
    aligned = paths.colmap_dir / "sparse" / "0"
    colmap.write_model(cams, images, colmap.ColmapPoints(
        xyz=xyz, rgb=rgb, error=np.zeros(n), ids=np.arange(n)), aligned)
    (aligned / "test.txt").write_text(held)
    for ci, (lo, hi) in enumerate(((-10, 0), (0, 10))):
        cdir = paths.chunks_dir / f"{ci}_0"
        m = (xyz[:, 0] >= lo) & (xyz[:, 0] < hi)
        sparse = cdir / "sparse" / "0"
        colmap.write_model(cams, images, colmap.ColmapPoints(
            xyz=xyz[m], rgb=rgb[m], error=np.zeros(int(m.sum())),
            ids=np.arange(int(m.sum()))), sparse)
        (sparse / "test.txt").write_text(held)
        (cdir / "center.txt").write_text(f"{(lo + hi) / 2} 0.0 0.0\n")
        (cdir / "extent.txt").write_text("2.0 2.0 2.0\n")
    return root


def _image(out: dict) -> dict:
    img = out["render"]
    return {"shape": list(img.shape),
            "finite": bool(torch.isfinite(img).all())}


def _timed(rec: dict, name: str, dev: torch.device, fn):
    """Run ``fn``, keep its record under ``name`` with its seconds (the
    card synchronised)."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec[name] = {**out, "seconds": time.perf_counter() - t0}


def dryrun_rank(rank: int, world: int, device: str, project: str) -> dict:
    """The dry run's sequence in rank ``rank`` of ``world``; returns the
    rank's record (losses, image shapes, overflow, seconds by stage)."""
    dev = rank_device(device, rank)
    if world > 1 and N_ROWS % world:
        raise ValueError(f"{N_ROWS} rows do not split over {world} ranks")
    scene = make_toy_scene(seed=0, n=N_ROWS, n_cameras=world, width=W,
                           height=H, device=dev)
    rows = (scene.means3d, scene.scales, scene.quats, scene.opacities,
            scene.sh_coeffs)
    params, active, meta = create_from_pcd(
        scene.means3d, torch.full((N_ROWS, 3), 0.5, device=dev),
        sh_degree=3, capacity=CAPACITY)
    opt = OptimizationConfig()
    views = [CameraBatch(
        camera=c, gt_image=torch.zeros((3, H, W), device=dev),
        alpha_mask=torch.ones((1, H, W), device=dev),
        mono_invdepth=torch.zeros((1, H, W), device=dev),
        depth_mask=torch.zeros((1, H, W), device=dev),
        depth_reliable=torch.tensor(False, device=dev),
        image_index=torch.tensor(i, device=dev))
        for i, c in enumerate(scene.cameras)]
    bgs = torch.rand((world, 3), generator=torch.Generator().manual_seed(
        17)).to(dev)
    zero = torch.zeros(3, device=dev)
    cam0 = scene.cameras[0]
    rec = {"rank": rank, "world": world, "device": str(dev),
           "backend": dist.get_backend()}

    def state0():
        return init_state(params, active, n_images=world)

    def step_rec(aux):
        return {"loss": float(aux["loss"]),
                **{k: int(v) for k, v in aux.items() if k != "loss"}}

    dp_mesh = make_mesh(world, 1, device=dev)
    pipe = PipelineConfig(tile_capacity=256, max_dup=8,
                          raster_method="pallas")
    dp_step, shard_batch, shard_state = make_dp_train_step(
        meta, opt, pipe, 1.0, dp_mesh)
    _timed(rec, "dp", dev, lambda: step_rec(dp_step(
        shard_state(state0()), shard_batch(views), shard_batch(bgs),
        3)[1]))

    tmesh = make_mesh(1, world, device=dev)
    padded = RasterConfig(method="pallas", tile_capacity=128, max_dup=8)
    exact = RasterConfig(method="pallas", tile_capacity=128, max_dup=8,
                         exact_extra=world * 8, grad_reduce="counts")
    for name, cfg in (("tiles_padded", padded), ("tiles_exact", exact)):
        _timed(rec, name, dev, lambda: _image(rasterize_tile_sharded(
            *rows, cam0, 3, zero, tmesh, cfg)))
    blk = N_ROWS // world
    mine = [x[rank * blk:(rank + 1) * blk] for x in rows]
    _timed(rec, "ring", dev, lambda: _image(rasterize_ring_staged(
        *mine, cam0, 3, zero, tmesh, padded)))

    n_data = 2 if world % 2 == 0 else 1
    tp_mesh = make_mesh(n_data, world // n_data, device=dev)
    for name, tp_pipe in (
            ("tp_padded", pipe),
            ("tp_exact", PipelineConfig(
                tile_capacity=128, max_dup=8, raster_method="pallas",
                exact_extra=world * 8, grad_reduce="counts"))):
        tp_step, replicate = make_tile_sharded_train_step(
            meta, opt, tp_pipe, 1.0, tp_mesh)
        _timed(rec, name, dev, lambda: step_rec(tp_step(
            replicate(state0()), views, bgs, 3)[1]))
    if rec["tp_exact"]["update_skipped"]:
        raise AssertionError("dry run: the exact counts tp step skipped "
                             "its update")

    ring_step, shard_ring = make_ring_train_step(meta, opt, pipe, 1.0, tmesh)
    _timed(rec, "ring_step", dev, lambda: step_rec(ring_step(
        shard_ring(state0()), views[0], bgs[0], 3)[1]))

    # The hierarchy path: two compact post-opt steps (the driver grows its
    # capacity as the cut needs) and a tile-sharded render of a cut.
    hp = GaussianParams(
        xyz=scene.means3d, features_dc=scene.sh_coeffs[:, :1],
        features_rest=scene.sh_coeffs[:, 1:],
        log_scales=torch.log(scene.scales), quats=scene.quats,
        opacity_raw=inverse_sigmoid(scene.opacities)[:, None])
    hier = build_hierarchy(hp, device=dev)

    def post():
        driver = CompactPostDriver(
            hier, opt, PipelineConfig(tile_capacity=256,
                                      raster_method="pallas"),
            capacity=64, use_trained_exp=False)
        for _ in range(2):
            driver.step(views[0], 0.01, torch.eye(3, 4, device=dev))
        state = driver.finish()
        return {"capacity": driver.capacity, "redos": driver.redos,
                "finite": bool(torch.isfinite(state.params.xyz).all())}

    _timed(rec, "post", dev, post)
    cut = select_cut(hier, cam0.campos, 0.01)
    *cut_rows, cut_active = blend_cut(hier.params, cut, hier.n_nodes,
                                      hier.skybox_count)
    _timed(rec, "hierarchy_cut", dev, lambda: _image(rasterize_tile_sharded(
        *cut_rows, cam0, 3, zero, tmesh, padded, active_mask=cut_active)))

    # Two hosts over one project on disk, in host order: every stage is
    # idempotent, and the host that finds every chunk's artifact merges.
    def fan_out():
        fan_opt = OptimizationConfig(
            iterations=30, densification_interval=10, densify_from_iter=5,
            densify_until_iter=20, opacity_reset_interval=10_000,
            position_lr_init=2e-4, position_lr_final=2e-6,
            densify_grad_threshold=2e-4)
        merged = None
        for host in range(2):
            if rank == host % world:
                if rank == 0 and host == 0:
                    micro_project(Path(project), dev)
                merged = full_train(
                    project, ModelConfig(eval=True, resolution=1), fan_opt,
                    PipelineConfig(tile_capacity=256,
                                   raster_method="pallas"),
                    skip_if_exists=True, coarse_iterations=10,
                    chunk_iterations=30, post_iterations=10, skybox_num=100,
                    host_id=host, num_hosts=2, device=dev) or merged
            dist.barrier()
        got = collectives.all_reduce(torch.tensor(
            [merged is not None], device=dev), "max")
        return {"merged": bool(got[0])}

    _timed(rec, "full_train", dev, fan_out)
    rec["transport"] = dict(collectives.TRANSPORT)
    if dev.type == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return rec


def run(device: str | torch.device = DEFAULT_DEVICE, world: int = 2,
        store_dir: str | Path = "build/dryrun",
        timeout_s: float = 900.0) -> dict:
    """The dry run in ``world`` spawned ranks; returns rank 0's record
    (with every rank's under ``"ranks"``).  Raises if a rank fails or the
    world outlives ``timeout_s``."""
    dev = resolve_device(device)
    store_dir = Path(store_dir)
    project = store_dir / f"project-{time.monotonic_ns()}"
    recs = run_world(dryrun_rank, world, store_dir, backend_for(dev, world),
                     args=(str(dev), str(project)), timeout_s=timeout_s)
    return {**recs[0], "ranks": recs}


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    out = run("cpu" if "--cpu" in sys.argv else DEFAULT_DEVICE,
              int(args[0]) if args else 2)
    print({k: v for k, v in out.items() if k != "ranks"})
