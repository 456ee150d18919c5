"""End-to-end training orchestrator, mirroring
``street_sparse_3dgs_tpu/pipeline/full_train.py`` (the reference's
``scripts/full_train.py:87-285``):

  1. coarse scaffold training on the aligned global COLMAP (skybox 100k,
     xyz lr frozen) -> ``output/scaffold``;
  2. per chunk: training with the scaffold ring and the depth losses
     (``train_single``) -> hierarchy build (Creator) -> post-optimization
     (``train_post`` with the orchestrator's overrides: 15k iterations,
     feature_lr 5e-4, opacity_lr 0.01, scaling_lr 1e-3) ->
     ``output/trained_chunks/<name>``;
  3. consolidation of every chunk's optimised hierarchy (Merger) ->
     ``output/merged.hier.npz``.

Every stage is idempotent on its artifact (``skip_if_exists``),
``keep_running`` continues past a failed chunk, chunks fan out round-robin
over hosts, and one host merges (an ``O_EXCL`` claim, the output landed by
``os.replace``).  Every stage and ``full_train`` take ``device=`` (default
``"cuda"``, which raises without a card).  The skybox dome's uniform draws
are an input (``skybox_uniform`` [2, skybox_num]); without it they come
from a ``torch.Generator`` seeded with ``seed`` on the device.

Project directory layout (reference ``setup_dirs``):
  camera_calibration/aligned/sparse/0       global colmap
  camera_calibration/chunks/<name>/         per-chunk colmap + center/extent
  rectified/{images,depths,masks}           shared image data
  output/                                   all artifacts
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..config import ModelConfig, OptimizationConfig, PipelineConfig
from ..data.scene import CameraStream, load_scene_info
from ..device import DEFAULT_DEVICE, resolve_device
from ..hierarchy.build import build_hierarchy
from ..hierarchy.io import load_hierarchy, save_hierarchy
from ..hierarchy.merge import merge_hierarchies
from ..models.gaussians import create_from_pcd
from ..models.serialize import load_scene_ply, save_scene
from ..train.loop import train_loop
from ..train.post import (CompactPostDriver, default_post_capacity,
                          random_limit)
from ..train.step import init_state


@dataclasses.dataclass
class ProjectPaths:
    project_dir: Path

    @property
    def colmap_dir(self):
        return self.project_dir / "camera_calibration" / "aligned"

    @property
    def chunks_dir(self):
        return self.project_dir / "camera_calibration" / "chunks"

    @property
    def images_dir(self):
        return self.project_dir / "rectified" / "images"

    @property
    def depths_dir(self):
        return self.project_dir / "rectified" / "depths"

    @property
    def masks_dir(self):
        return self.project_dir / "rectified" / "masks"

    @property
    def output_dir(self):
        return self.project_dir / "output"

    @property
    def scaffold_dir(self):
        return self.output_dir / "scaffold"

    @property
    def trained_chunks_dir(self):
        return self.output_dir / "trained_chunks"


def _model_cfg_for(paths: ProjectPaths, base: ModelConfig,
                   source: Path) -> ModelConfig:
    cfg = dataclasses.replace(base, source_path=str(source))
    if paths.depths_dir.exists() and not cfg.depths:
        cfg = dataclasses.replace(cfg, depths=str(paths.depths_dir))
    if paths.masks_dir.exists() and not cfg.alpha_masks:
        cfg = dataclasses.replace(cfg, alpha_masks=str(paths.masks_dir))
    if paths.images_dir.exists():
        cfg = dataclasses.replace(cfg, images=str(paths.images_dir))
    return cfg


def skybox_draws(n: int, seed: int, device) -> torch.Tensor:
    """[2, n] uniform draws of the skybox dome from a generator seeded with
    ``seed`` on ``device``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((2, n), generator=g, device=dev)


def train_coarse_stage(paths: ProjectPaths, model_cfg: ModelConfig,
                       opt: OptimizationConfig, pipe: PipelineConfig,
                       skybox_num: int = 100_000, iterations=None,
                       seed: int = 0, skybox_uniform=None,
                       device: str | torch.device = DEFAULT_DEVICE):
    """Stage 1 (``train_coarse.py``): skybox + coarse scene optimization with
    xyz lr 0 and skybox-scaling grads zeroed."""
    dev = resolve_device(device)
    cfg = _model_cfg_for(paths, model_cfg, paths.colmap_dir)
    info = load_scene_info(cfg.source_path, cfg)
    if skybox_uniform is None and skybox_num > 0:
        skybox_uniform = skybox_draws(skybox_num, seed, dev)
    params, active, meta = create_from_pcd(
        torch.as_tensor(info.points, device=dev),
        torch.as_tensor(info.colors, device=dev), sh_degree=cfg.sh_degree,
        skybox_points=skybox_num,
        capacity=_round_up(info.points.shape[0] + skybox_num),
        skybox_locked=cfg.skybox_locked, skybox_uniform=skybox_uniform)
    state = init_state(params, active, n_images=len(info.train_cameras))
    stream = CameraStream(info.train_cameras, resolution=cfg.resolution,
                          seed=seed, device=dev)
    try:
        state, meta, stats = train_loop(
            state, meta, stream, opt, pipe, cfg,
            cameras_extent=info.nerf_radius,
            spatial_lr_scale=info.nerf_radius,
            iterations=iterations or opt.iterations, densify_enabled=False,
            coarse_mode=True, rng_seed=seed)
    finally:
        stream.close()
    it = iterations or opt.iterations
    save_scene(paths.scaffold_dir, it, state, meta,
               [c.image_name for c in info.train_cameras])
    return state, meta, stats


def train_chunk_stage(paths: ProjectPaths, chunk_name: str,
                      model_cfg: ModelConfig, opt: OptimizationConfig,
                      pipe: PipelineConfig, iterations=None, seed: int = 0,
                      device: str | torch.device = DEFAULT_DEVICE):
    """Stage 2 (``train_single.py``): per-chunk training with the scaffold
    ring, skybox locked, depth regularization and densification."""
    dev = resolve_device(device)
    chunk_dir = paths.chunks_dir / chunk_name
    cfg = _model_cfg_for(paths, model_cfg, chunk_dir)
    info = load_scene_info(cfg.source_path, cfg)

    scaffold_iter = _find_iteration_dir(paths.scaffold_dir / "point_cloud")
    scaffold, scaffold_skybox = load_scene_ply(scaffold_iter, device=dev)
    center = _read_vec(chunk_dir / "center.txt")
    extent = _read_vec(chunk_dir / "extent.txt")

    params, active, meta = create_from_pcd(
        torch.as_tensor(info.points, device=dev),
        torch.as_tensor(info.colors, device=dev), sh_degree=cfg.sh_degree,
        scaffold=scaffold, scaffold_skybox_points=scaffold_skybox,
        chunk_center=center, chunk_extent=extent,
        # 2x headroom: densification grows in place before the capacity
        # doubling kicks in.
        capacity=_round_up(2 * (info.points.shape[0]
                                + scaffold.xyz.shape[0])),
        skybox_locked=True)
    # GT-point-cloud constraint: the reference loads <chunk>/chunk.ply into
    # a FAISS index (``train_single.py:34-36``); here a voxel-hash index.
    gt_index = None
    gt_ply = Path(cfg.source_path) / "chunk.ply"
    if cfg.gt_point_cloud_constraints and gt_ply.exists():
        from ..data.ply import fetch_point_cloud
        from ..models.gt_constraint import build_index

        gt_xyz, _ = fetch_point_cloud(gt_ply)
        gt_index = build_index(gt_xyz, cfg.constraint_treshold, device=dev)

    state = init_state(params, active, n_images=len(info.train_cameras))
    stream = CameraStream(info.train_cameras, resolution=cfg.resolution,
                          seed=seed, device=dev)
    try:
        state, meta, stats = train_loop(
            state, meta, stream, opt, pipe, cfg,
            cameras_extent=info.nerf_radius,
            spatial_lr_scale=info.nerf_radius,
            iterations=iterations or opt.iterations, densify_enabled=True,
            rng_seed=seed, gt_index=gt_index)
    finally:
        stream.close()
    out = paths.trained_chunks_dir / chunk_name
    it = iterations or opt.iterations
    save_scene(out, it, state, meta,
               [c.image_name for c in info.train_cameras])
    return state, meta, stats


def build_hierarchy_stage(paths: ProjectPaths, chunk_name: str,
                          device: str | torch.device = DEFAULT_DEVICE):
    """Stage 3 (GaussianHierarchyCreator): trained chunk -> LOD hierarchy
    (built in numpy on the host, landed on ``device``)."""
    dev = resolve_device(device)
    out = paths.trained_chunks_dir / chunk_name
    pc_dir = _find_iteration_dir(out / "point_cloud")
    params, skybox = load_scene_ply(pc_dir, device="cpu")
    # Anchor marking: the scaffold row count that save_scene records beside
    # the ply; without it, the skybox head alone.
    scaffold_file = pc_dir / "scaffold_info.txt"
    scaffold_points = int(scaffold_file.read_text()) \
        if scaffold_file.exists() else skybox
    h = build_hierarchy(params, scaffold_rows=scaffold_points,
                        skybox_rows=skybox, device=dev)
    save_hierarchy(out / "hierarchy.hier.npz", h)
    return h


def post_opt_stage(paths: ProjectPaths, chunk_name: str,
                   model_cfg: ModelConfig, base_opt: OptimizationConfig,
                   pipe: PipelineConfig, iterations: int | None = None,
                   seed: int = 0,
                   device: str | torch.device = DEFAULT_DEVICE):
    """Stage 4 (``train_post.py``) with the orchestrator's lr overrides
    (``scripts/full_train.py:155-158``)."""
    dev = resolve_device(device)
    out = paths.trained_chunks_dir / chunk_name
    chunk_dir = paths.chunks_dir / chunk_name
    cfg = _model_cfg_for(paths, model_cfg, chunk_dir)
    info = load_scene_info(cfg.source_path, cfg)
    h = load_hierarchy(out / "hierarchy.hier.npz", device=dev)

    opt = dataclasses.replace(base_opt, iterations=iterations or 15_000,
                              feature_lr=0.0005, opacity_lr=0.01,
                              scaling_lr=0.001)
    exp_path = out / "exposure.json"
    exposures = json.loads(exp_path.read_text()) if exp_path.exists() else {}

    rng = random.Random(seed)
    photo = [c for c in info.train_cameras if not c.is_depth_only]
    stream = CameraStream(photo, resolution=cfg.resolution, seed=seed,
                          device=dev)
    eye = np.eye(3, 4, dtype=np.float32)
    # The trained exposures staged on the device once, indexed per step.
    exp_rows = [torch.as_tensor(np.asarray(exposures.get(c.image_name, eye),
                                           np.float32), device=dev)
                for c in photo]
    # O(cut) compacted step: capacity sampled from the finest cuts, grown
    # (with the step redone) on overflow.
    driver = CompactPostDriver(
        h, opt, pipe,
        capacity=default_post_capacity(
            h, [(-np.asarray(c.R) @ np.asarray(c.T)).astype(np.float32)
                for c in photo[:8]]),
        skybox_locked=True)
    it = 0
    total = opt.iterations
    batch_iter = iter(stream)
    try:
        while it < total:
            try:
                batch = next(batch_iter)
            except StopIteration:
                batch_iter = iter(stream)
                batch = next(batch_iter)
            it += 1
            driver.step(batch, random_limit(rng),
                        exp_rows[int(batch.image_index)])
        state = driver.finish()
    finally:
        stream.close()
    if driver.redos:
        print(f"  post-opt: cut capacity grown to {driver.capacity} "
              f"({driver.redos} redo steps)")
    h_opt = h._replace(params=state.params)
    save_hierarchy(out / "hierarchy.hier_opt.npz", h_opt)
    return h_opt


def consolidate_stage(paths: ProjectPaths, chunk_names: list[str],
                      device: str | torch.device = DEFAULT_DEVICE):
    """Stage 5 (GaussianHierarchyMerger): merge optimized chunk hierarchies.

    Single-merger semantics on shared filesystems (the reference runs the
    Merger exactly once, ``scripts/full_train.py:259-282``): the merge is
    claimed atomically via ``O_EXCL`` so two hosts finishing simultaneously
    never both write, and the output lands via write-to-temp + ``os.replace``
    so readers never observe a partial ``merged.hier.npz``.  Returns ``None``
    when another process holds (or completed) the claim."""
    dev = resolve_device(device)
    out_path = paths.output_dir / "merged.hier.npz"
    claim = paths.output_dir / "merged.hier.claim"
    try:
        fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        if out_path.exists():     # completed earlier run: idempotent re-load
            return load_hierarchy(out_path, device=dev)
        print("consolidation already claimed by another host; skipping")
        return None
    try:
        os.write(fd, f"pid={os.getpid()}\n".encode())
    finally:
        os.close(fd)
    try:
        hs = [load_hierarchy(paths.trained_chunks_dir / c
                             / "hierarchy.hier_opt.npz", device="cpu")
              for c in chunk_names]
        merged = merge_hierarchies(hs, device=dev)
        tmp = out_path.parent / f".merged.{os.getpid()}.hier.npz"
        save_hierarchy(tmp, merged)
        os.replace(tmp, out_path)
    except BaseException:
        # Release the claim so a retry (or another host) can merge.
        claim.unlink(missing_ok=True)
        raise
    return merged


def full_train(project_dir, model_cfg: ModelConfig | None = None,
               opt: OptimizationConfig | None = None,
               pipe: PipelineConfig | None = None,
               skip_if_exists: bool = True, keep_running: bool = False,
               coarse_iterations=None, chunk_iterations=None,
               post_iterations=None, skybox_num: int = 100_000,
               chunk_filter: list[str] | None = None, seed: int = 0,
               host_id: int | None = None, num_hosts: int | None = None,
               skybox_uniform=None,
               device: str | torch.device = DEFAULT_DEVICE):
    """Run the full 5-stage pipeline over a project directory on
    ``device``.

    Multi-host chunk fan-out (the reference's Slurm parallelism): launch
    this on every host with its ``host_id``/``num_hosts`` — chunks are
    partitioned round-robin, stages stay idempotent on the shared
    filesystem, and whichever host finds all per-chunk artifacts present
    runs the consolidation.  Left as ``None``, the pair resolves from the
    ``torch.distributed`` process group (``parallel.distributed``);
    uninitialised it is (0, 1).  ``skybox_uniform`` is the coarse stage's
    skybox draws (see ``train_coarse_stage``)."""
    from ..parallel.distributed import host_identity
    from ..utils import stage_timer

    dev = resolve_device(device)
    host_id, num_hosts = host_identity(host_id, num_hosts)

    paths = ProjectPaths(Path(project_dir))
    model_cfg = model_cfg or ModelConfig()
    opt = opt or OptimizationConfig()
    pipe = pipe or PipelineConfig()
    timing_log = paths.output_dir / "training_pipeline_timing.txt"
    t0 = time.time()

    scaffold_ply = None
    pc_root = paths.scaffold_dir / "point_cloud"
    if pc_root.exists():
        try:
            scaffold_ply = _find_iteration_dir(pc_root)
        except FileNotFoundError:
            pass
    if skip_if_exists and scaffold_ply is not None:
        print("Skipping coarse")
    else:
        print("== Stage 1: coarse scaffold ==")
        with stage_timer("coarse", timing_log):
            train_coarse_stage(paths, model_cfg, opt, pipe, skybox_num,
                               iterations=coarse_iterations, seed=seed,
                               skybox_uniform=skybox_uniform, device=dev)

    all_chunk_names = sorted(
        p.name for p in paths.chunks_dir.iterdir()
        if p.is_dir()) if paths.chunks_dir.exists() else []
    chunk_names = all_chunk_names
    if chunk_filter:
        chunk_names = [c for c in chunk_names if c in chunk_filter]
    if num_hosts > 1:
        chunk_names = chunk_names[host_id::num_hosts]

    done_chunks = []
    for name in chunk_names:
        out = paths.trained_chunks_dir / name
        try:
            if skip_if_exists and (out / "hierarchy.hier_opt.npz").exists():
                print(f"Skipping chunk {name}")
                done_chunks.append(name)
                continue
            print(f"== Stage 2: chunk {name} training ==")
            with stage_timer(f"chunk_{name}_train", timing_log):
                train_chunk_stage(paths, name, model_cfg, opt, pipe,
                                  iterations=chunk_iterations, seed=seed,
                                  device=dev)
            print(f"== Stage 3: chunk {name} hierarchy ==")
            with stage_timer(f"chunk_{name}_hierarchy", timing_log):
                build_hierarchy_stage(paths, name, device=dev)
            print(f"== Stage 4: chunk {name} post-opt ==")
            with stage_timer(f"chunk_{name}_post", timing_log):
                post_opt_stage(paths, name, model_cfg, opt, pipe,
                               iterations=post_iterations, seed=seed,
                               device=dev)
            done_chunks.append(name)
        except Exception:
            traceback.print_exc()
            if not keep_running:
                raise
            print(f"chunk {name} failed; continuing (keep_running)")

    merged = None
    # Consolidate over every chunk whose optimized hierarchy exists (on a
    # multi-host run only the host that sees all of them will merge).
    ready = [c for c in all_chunk_names
             if (paths.trained_chunks_dir / c
                 / "hierarchy.hier_opt.npz").exists()]
    if ready and (chunk_filter or set(ready) >= set(all_chunk_names)):
        print("== Stage 5: consolidation ==")
        with stage_timer("consolidation", timing_log):
            merged = consolidate_stage(paths, ready, device=dev)
    elif ready:
        print(f"consolidation deferred: {len(ready)}/{len(all_chunk_names)} "
              "chunk hierarchies ready")
    print(f"full_train done in {(time.time() - t0) / 60:.1f} min "
          f"({len(done_chunks)}/{len(chunk_names)} chunks on this host)")
    return merged


def _read_vec(path: Path) -> np.ndarray:
    return np.array([float(v) for v in Path(path).read_text().split()],
                    np.float32)


def _round_up(n: int, mult: int = 1024) -> int:
    return ((n + mult - 1) // mult) * mult


def _find_iteration_dir(point_cloud_root: Path) -> Path:
    iters = sorted(point_cloud_root.glob("iteration_*"),
                   key=lambda p: int(p.name.split("_")[1]))
    if not iters:
        raise FileNotFoundError(f"no iteration_* under {point_cloud_root}")
    return iters[-1]
