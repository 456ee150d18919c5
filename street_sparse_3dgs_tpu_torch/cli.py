"""Command-line entry points, mirroring ``street_sparse_3dgs_tpu/cli.py``
(the reference's repo-root scripts):

    python -m street_sparse_3dgs_tpu_torch.cli train-coarse  -s <colmap> ...
    python -m street_sparse_3dgs_tpu_torch.cli train-single  -s <chunk> ...
    python -m street_sparse_3dgs_tpu_torch.cli train-post    --hierarchy <h> ...
    python -m street_sparse_3dgs_tpu_torch.cli render-hierarchy --hierarchy <h> ...
    python -m street_sparse_3dgs_tpu_torch.cli full-train    --project_dir <dir> ...

The flags are the JAX CLI's, plus ``--device`` (default ``cuda``, which
raises without a card; ``--device cpu`` runs the plain PyTorch versions of
the kernels).  ``--raster_method pallas`` selects the CUDA kernels.  Each
training command writes a ``cfg_args`` snapshot into the model path
(replayable via ``config.load_combined``, readable by either package),
like the reference training scripts (``train_single.py:260-261``).
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import config as cfg_mod
from .config import ModelConfig, OptimizationConfig, PipelineConfig


def _make_viewer(args, model, pipe):
    """Construct the live-viewer hook unless disabled (a port that cannot
    be bound, e.g. a second trainer on the same port, disables the viewer
    with a warning)."""
    if args.disable_viewer:
        return None
    from .viewer.hook import ViewerHook
    from .viewer.network_gui import NetworkGUI

    try:
        gui = NetworkGUI(args.ip, args.port)
    except OSError as exc:
        print(f"viewer disabled: cannot listen on "
              f"{args.ip}:{args.port} ({exc})")
        return None
    return ViewerHook(gui, model.source_path, pipe)


def _parse(argv, extra=()):
    parser = cfg_mod.make_parser()
    parser.add_argument("-s", dest="source_path_short", default=None)
    parser.add_argument("-i", dest="images_short", default=None)
    parser.add_argument("-d", dest="depths_short", default=None)
    parser.add_argument("--save_iterations", type=int, default=-1)
    parser.add_argument("--checkpoint_iterations", type=int, nargs="*",
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default="")
    parser.add_argument("--seed", type=int, default=0)
    # Live-viewer flags (reference train scripts: --ip/--port/
    # --disable_viewer; SIBR remote viewer dials 127.0.0.1:6009).
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    for name, kw in extra:
        parser.add_argument(name, **kw)
    args, _ = parser.parse_known_args(argv)
    if args.source_path_short:
        args.source_path = args.source_path_short
    if args.images_short:
        args.images = args.images_short
    if args.depths_short:
        args.depths = args.depths_short
    model = cfg_mod.extract_group(args, ModelConfig)
    pipe = cfg_mod.extract_group(args, PipelineConfig)
    opt = cfg_mod.extract_group(args, OptimizationConfig)
    return model, pipe, opt, args


def _train(model, pipe, opt, args, info, params, active, meta,
           densify: bool, coarse: bool, dev, start_checkpoint=""):
    """The shared body of train-coarse and train-single: the loop over the
    shuffled views with the viewer hook, then the scene and ``cfg_args``
    saved under the model path."""
    from .models.serialize import load_checkpoint, save_scene
    from .data.scene import CameraStream
    from .train.loop import LoopHooks, train_loop
    from .train.step import init_state

    state = init_state(params, active, len(info.train_cameras))
    if start_checkpoint:
        state, meta, it0 = load_checkpoint(start_checkpoint, device=dev)
        print(f"restored checkpoint at iteration {it0}")
    stream = CameraStream(info.train_cameras, model.resolution, args.seed,
                          train_test_exp=(not coarse
                                          and model.train_test_exp),
                          device=dev)
    viewer = _make_viewer(args, model, pipe)
    try:
        state, meta, stats = train_loop(
            state, meta, stream, opt, pipe, model,
            cameras_extent=info.nerf_radius,
            spatial_lr_scale=info.nerf_radius, densify_enabled=densify,
            coarse_mode=coarse, rng_seed=args.seed,
            gt_index=None if coarse else _gt_index(model, dev),
            hooks=LoopHooks(
                checkpoint_iterations=(() if coarse else tuple(
                    args.checkpoint_iterations)),
                viewer_poll=viewer))
    finally:
        if viewer is not None:
            viewer.close()
        stream.close()
    save_scene(model.model_path, opt.iterations, state, meta,
               [c.image_name for c in info.train_cameras])
    cfg_mod.save_cfg_args(model.model_path, model, pipe, opt)
    return stats


def _gt_index(model, dev):
    """The GT point-cloud index of ``<source>/chunk.ply`` when the
    constraint is on and the file exists."""
    gt_ply = Path(model.source_path) / "chunk.ply"
    if not (model.gt_point_cloud_constraints and gt_ply.exists()):
        return None
    from .data.ply import fetch_point_cloud
    from .models.gt_constraint import build_index

    gt_xyz, _ = fetch_point_cloud(gt_ply)
    return build_index(gt_xyz, model.constraint_treshold, device=dev)


def train_coarse(argv):
    import torch

    from .data.scene import load_scene_info
    from .device import resolve_device
    from .models.gaussians import create_from_pcd
    from .pipeline.full_train import skybox_draws

    model, pipe, opt, args = _parse(argv)
    dev = resolve_device(args.device)
    info = load_scene_info(model.source_path, model)
    skybox = model.skybox_num
    params, active, meta = create_from_pcd(
        torch.as_tensor(info.points, device=dev),
        torch.as_tensor(info.colors, device=dev), sh_degree=model.sh_degree,
        skybox_points=skybox, skybox_locked=model.skybox_locked,
        capacity=info.points.shape[0] + skybox,
        skybox_uniform=(skybox_draws(skybox, args.seed, dev) if skybox
                        else None))
    stats = _train(model, pipe, opt, args, info, params, active, meta,
                   densify=False, coarse=True, dev=dev)
    print(f"coarse done; final loss {stats['losses'][-1]:.5f}")


def train_single(argv):
    import torch

    from .data.scene import load_scene_info
    from .device import resolve_device
    from .models.gaussians import create_from_pcd
    from .models.serialize import load_scene_ply
    from .pipeline.full_train import _read_vec, skybox_draws

    model, pipe, opt, args = _parse(argv)
    dev = resolve_device(args.device)
    info = load_scene_info(model.source_path, model)
    scaffold = None
    scaffold_skybox = 0
    center = extent = None
    if model.scaffold_file:
        scaffold, scaffold_skybox = load_scene_ply(model.scaffold_file,
                                                   device=dev)
        bounds = Path(model.bounds_file or model.source_path)
        center = _read_vec(bounds / "center.txt")
        extent = _read_vec(bounds / "extent.txt")
    sky = model.skybox_num if scaffold is None else 0
    params, active, meta = create_from_pcd(
        torch.as_tensor(info.points, device=dev),
        torch.as_tensor(info.colors, device=dev), sh_degree=model.sh_degree,
        skybox_points=model.skybox_num, scaffold=scaffold,
        scaffold_skybox_points=scaffold_skybox, chunk_center=center,
        chunk_extent=extent, skybox_locked=model.skybox_locked,
        capacity=None,
        skybox_uniform=skybox_draws(sky, args.seed, dev) if sky else None)
    stats = _train(model, pipe, opt, args, info, params, active, meta,
                   densify=True, coarse=False, dev=dev,
                   start_checkpoint=args.start_checkpoint)
    print(f"single done; final loss {stats['losses'][-1]:.5f}")


def train_post(argv):
    import random

    import numpy as np
    import torch

    from .data.scene import CameraStream, load_scene_info
    from .device import resolve_device
    from .hierarchy.io import load_hierarchy, save_hierarchy
    from .train.post import (CompactPostDriver, default_post_capacity,
                             random_limit)

    model, pipe, opt, args = _parse(argv)
    dev = resolve_device(args.device)
    h = load_hierarchy(model.hierarchy, device=dev)
    info = load_scene_info(model.source_path, model)
    photo = [c for c in info.train_cameras if not c.is_depth_only]
    stream = CameraStream(photo, model.resolution, args.seed, device=dev)
    driver = CompactPostDriver(
        h, opt, pipe,
        capacity=default_post_capacity(
            h, [(-np.asarray(c.R) @ np.asarray(c.T)).astype(np.float32)
                for c in photo[:8]]),
        skybox_locked=True)
    rng = random.Random(args.seed)
    it = 0
    eye = torch.eye(3, 4, dtype=torch.float32, device=dev)
    batch_iter = iter(stream)
    try:
        while it < opt.iterations:
            try:
                batch = next(batch_iter)
            except StopIteration:
                batch_iter = iter(stream)
                batch = next(batch_iter)
            it += 1
            driver.step(batch, random_limit(rng), eye)
        state = driver.finish()
    finally:
        stream.close()
    out = Path(model.hierarchy).with_suffix("").with_suffix("")
    save_hierarchy(str(out) + ".hier_opt.npz",
                   h._replace(params=state.params))
    print(f"post done; capacity {driver.capacity} "
          f"({driver.redos} overflow redos)")


def render_hierarchy(argv):
    import json

    from .device import resolve_device
    from .eval.render_hier import render_hierarchy_eval
    from .hierarchy.io import load_hierarchy

    model, pipe, opt, args = _parse(
        argv, extra=(("--taus", dict(type=float, nargs="*",
                                     default=[0.0, 3.0, 6.0, 15.0])),
                     ("--on_train", dict(action="store_true")),
                     ("--no_lpips", dict(action="store_true"))))
    h = load_hierarchy(model.hierarchy, device=resolve_device(args.device))
    out = Path(model.model_path or ".") / "renders"
    results = render_hierarchy_eval(h, model.source_path, model, pipe,
                                    taus=tuple(args.taus), out_dir=out,
                                    on_train=args.on_train,
                                    with_lpips=not args.no_lpips,
                                    sh_degree=model.sh_degree)
    # Self-describing results file (the reference writes results.txt; this
    # one also records the LPIPS weights' provenance: 'random' numbers are
    # not comparable to real LPIPS).
    rpath = Path(model.model_path or ".") / "results.json"
    rpath.write_text(json.dumps({str(k): v for k, v in results.items()},
                                indent=1, default=float))
    print(f"results written to {rpath}")


def full_train(argv):
    from .pipeline.full_train import full_train as run

    model, pipe, opt, args = _parse(
        argv, extra=(("--project_dir", dict(type=str, required=True)),
                     ("--skip_if_exists", dict(action="store_true")),
                     ("--keep_running", dict(action="store_true")),
                     ("--skybox_num_override",
                      dict(type=int, default=100_000)),
                     ("--host_id", dict(type=int, default=None)),
                     ("--num_hosts", dict(type=int, default=None)),
                     ("--distributed", dict(action="store_true"))))
    if args.distributed:
        # Join the process group; host fan-out then follows its rank and
        # world size unless --host_id/--num_hosts override.
        from .parallel.distributed import init_distributed
        init_distributed(device=args.device)
    run(args.project_dir, model, opt, pipe,
        skip_if_exists=args.skip_if_exists, keep_running=args.keep_running,
        skybox_num=args.skybox_num_override, seed=args.seed,
        host_id=args.host_id, num_hosts=args.num_hosts, device=args.device)


def mask_images_parser():
    import argparse

    p = argparse.ArgumentParser(prog="mask-images")
    p.add_argument("--project_dir", required=True)
    p.add_argument("--process_6_images", action="store_true")
    p.add_argument("--detections_dir", default=None,
                   help="precomputed per-image .npz detections; default "
                        "runs torchvision Mask R-CNN if installed")
    p.add_argument("--batch", choices=["confirm-all", "reject-all"],
                   default=None, help="skip the web UI and decide "
                        "uniformly for every confirmation-class instance")
    p.add_argument("--port", type=int, default=5001)
    p.add_argument("--device", default="cuda",
                   help="device of the torchvision detector")
    return p


def mask_images_cmd(argv):
    """Moving-object mask generation (``ss_utils/mask_images.py`` analog):
    interactive (HTTP confirmation UI) or batch with a fixed decision."""
    from .preprocess import mask_images as mi

    args = mask_images_parser().parse_args(argv)
    detector = (mi.precomputed_detector(args.detections_dir)
                if args.detections_dir
                else mi.torchvision_detector(device=args.device))
    if args.batch:
        n = mi.process_images(
            args.project_dir, detector,
            decide=lambda *_: args.batch == "confirm-all",
            process_6_images=args.process_6_images)
    else:
        srv = mi.ConfirmationServer(
            args.project_dir, detector, port=args.port,
            process_6_images=args.process_6_images)
        print(f"confirmation UI on http://127.0.0.1:{args.port}/")
        n = srv.serve()
    print(f"wrote {n} masks")


def viewer_cmd(argv):
    """Standalone interactive web viewer (the SIBR viewer app analogue),
    rendering on ``--device`` (the card by default)."""
    from .viewer.app import main as viewer_main

    viewer_main(argv)


COMMANDS = {
    "train-coarse": train_coarse,
    "train-single": train_single,
    "train-post": train_post,
    "render-hierarchy": render_hierarchy,
    "full-train": full_train,
    "mask-images": mask_images_cmd,
    "viewer": viewer_cmd,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m street_sparse_3dgs_tpu_torch.cli "
              f"{{{','.join(COMMANDS)}}} [options]")
        return 1
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
