"""The port's side of ``tests/test_torch_parallel*.py``: functions that run
in each rank of a spawned ``gloo`` world on the CPU (``parallel.mesh.
run_world``).  They import torch and the port only, load the numpy inputs
the test saved (JAX's scene, state, batch and random draws) and return
numpy results for the test to hold against the JAX functions."""

from __future__ import annotations

import dataclasses
import math
import pickle

import torch
import torch.distributed as dist

from street_sparse_3dgs_tpu_torch import config as tcfg, convert
from street_sparse_3dgs_tpu_torch.models.gaussians import GaussianMeta
from street_sparse_3dgs_tpu_torch.ops.rasterize import RasterConfig
from street_sparse_3dgs_tpu_torch.parallel import collectives as coll
from street_sparse_3dgs_tpu_torch.parallel.dp import make_dp_train_step
from street_sparse_3dgs_tpu_torch.parallel.mesh import make_mesh
from street_sparse_3dgs_tpu_torch.parallel.ring import (make_ring_train_step,
                                                        rasterize_ring_staged)
from street_sparse_3dgs_tpu_torch.parallel.tiles import rasterize_tile_sharded
from street_sparse_3dgs_tpu_torch.parallel.tp import (
    make_tile_sharded_train_step, rasterize_batch_tile_sharded)

CPU = "cpu"
PADDED = RasterConfig(method="pallas", tile_capacity=128, max_dup=16)
EXACT = RasterConfig(method="pallas", tile_capacity=128, max_dup=16,
                     exact_extra=32)
RING = RasterConfig(method="pallas", tile_capacity=256, max_dup=16)
BATCH_EXACT = RasterConfig(method="pallas", tile_capacity=128, max_dup=16,
                           exact_extra=16, grad_reduce="counts")


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def rows_of(inp):
    return tuple(torch.tensor(inp["rows"][k]) for k in
                 ("means3d", "scales", "quats", "opacities", "sh_coeffs"))


def cams_of(inp):
    return [convert.camera_from_numpy(c, CPU) for c in inp["cams"]]


def np_(x):
    return x.detach().cpu().numpy()


def state_np(state):
    return convert.to_numpy(state)


def mesh_cases(rank, world):
    """Each mesh's coordinates and the global ranks of its groups."""
    out = {}
    for shape in ((1, world), (world, 1), (2, world // 2)):
        m = make_mesh(*shape, device=CPU)
        out[shape] = {
            "index": {a: m.index(a) for a in ("data", "tile")},
            "combined": m.index(("data", "tile")),
            "size": {a: m.size(a) for a in ("data", "tile")},
            "groups": {a: dist.get_process_group_ranks(m.group(a))
                       for a in ("data", "tile")}}
    return out


def collective_cases(rank, world):
    """The backward of ``all_gather_slabs`` (this rank's slice) and of
    ``ring_shift`` (the reverse shift), on a (1 x world) mesh, and
    ``all_reduce`` SUM / MAX."""
    m = make_mesh(1, world, device=CPU)
    x = torch.full((3, 2), float(rank + 1), requires_grad=True)
    full = coll.all_gather_slabs(x, m.group("tile"))
    weight = torch.arange(full.numel(), dtype=torch.float32).reshape(
        full.shape)
    (full * weight).sum().backward()
    y = torch.full((4,), float(rank), requires_grad=True)
    z = coll.ring_shift(y, m.group("tile"))
    (z * (rank + 10)).sum().backward()
    v = torch.tensor([float(rank), -float(rank)])
    return {"gathered": np_(full), "gather_grad": np_(x.grad),
            "shifted": np_(z), "shift_grad": np_(y.grad),
            "sum": np_(coll.all_reduce(v, "sum")),
            "max": np_(coll.all_reduce(v, "max")),
            "union": np_(coll.all_reduce(torch.tensor([rank == 1, False]),
                                         "max"))}


def render_grads(fn, rows, leaves, loss_fn):
    """(outputs, grads of ``leaves`` (indices into ``rows``)) of
    ``loss_fn(fn(*rows))``."""
    rows = [r.clone().requires_grad_(i in leaves) for i, r in enumerate(rows)]
    out = fn(*rows)
    loss_fn(out).backward()
    return ({k: np_(v) for k, v in out.items()},
            [np_(rows[i].grad) for i in leaves])


def tile_and_ring_cases(rank, world, path):
    """Tile-sharded padded and exact renders and grads (1 x world), the
    ring render and grads, its counted pair overflow, its refusal of exact
    mode and the ring train step (1 x world); the mesh and collective
    cases."""
    torch.manual_seed(0)
    inp = load(path)
    rows, cams = rows_of(inp), cams_of(inp)
    mesh = make_mesh(1, world, device=CPU)
    res = {"mesh": mesh_cases(rank, world),
           "collectives": collective_cases(rank, world)}
    cam = cams[0]
    res["tiles_padded"] = render_grads(
        lambda *r: rasterize_tile_sharded(*r, cam, 3, torch.zeros(3), mesh,
                                          PADDED),
        rows, (0,), lambda o: torch.mean(o["render"] ** 2))
    bg = torch.tensor([0.2, 0.1, 0.3])
    res["tiles_exact"] = render_grads(
        lambda *r: rasterize_tile_sharded(*r, cam, 3, bg, mesh, EXACT),
        rows, (0,), lambda o: torch.mean(o["render"] ** 2)
        + 0.2 * torch.mean(o["depth"]))
    blk = rows[0].shape[0] // world
    mine = [x[rank * blk:(rank + 1) * blk] for x in rows]
    res["ring"] = render_grads(
        lambda *r: rasterize_ring_staged(*r, cam, 3, torch.zeros(3), mesh,
                                         RING),
        mine, (0, 4), lambda o: torch.mean(o["render"] ** 2)
        + torch.mean(o["depth"]))
    with torch.no_grad():
        small = rasterize_ring_staged(*mine, cam, 3, torch.zeros(3), mesh,
                                      PADDED, stage_pair_capacity=8)
    res["ring_pair_overflow"] = int(small["pair_overflow"])
    try:
        rasterize_ring_staged(*mine, cam, 3, torch.zeros(3), mesh,
                              dataclasses.replace(PADDED, exact_extra=64))
        res["ring_exact_refused"] = ""
    except ValueError as e:
        res["ring_exact_refused"] = str(e)

    # The ring train step on this rank's rows, and with the depth flag on.
    meta = GaussianMeta(**inp["meta"])
    opt = tcfg.OptimizationConfig()
    pipe = tcfg.PipelineConfig(tile_capacity=256, max_dup=16,
                               raster_method="pallas")
    step, shard_state = make_ring_train_step(meta, opt, pipe, 1.0, mesh)
    state0 = convert.train_state_from_numpy(inp["state_ring"], CPU)
    view = convert.camera_batch_from_numpy(inp["ring_view"], CPU)
    bg = torch.tensor(inp["bg_ring"])
    new, aux = step(shard_state(state0), view, bg, 3)
    new_d, _ = step(shard_state(state0), view, bg, 3, depth_flag=True)
    res["ring_step"] = {"state": state_np(new),
                        "loss": float(aux["loss"]),
                        "n_visible": int(aux["n_visible"]),
                        "xyz_depth_flag": np_(new_d.params.xyz)}
    return res


def step_cases(rank, world, path):
    """The DP step (world x 1, one view a rank), the batch tile-sharded
    padded and exact renders and grads (2 x world/2) and the tp steps,
    padded and exact counts (2 x world/2), on JAX's inputs; and the exact
    counts tp step on a batch forced to overflow."""
    inp = load(path)
    rows, cams = rows_of(inp), cams_of(inp)
    meta = GaussianMeta(**inp["meta"])
    opt = tcfg.OptimizationConfig()
    batch = [convert.camera_batch_from_numpy(b, CPU) for b in inp["batch"]]
    flags = list(inp["flags"])
    bgs = torch.tensor(inp["bgs_step"])
    state0 = convert.train_state_from_numpy(inp["state"], CPU)
    res = {}

    dp_mesh = make_mesh(world, 1, device=CPU)
    pipe = tcfg.PipelineConfig(tile_capacity=128, max_dup=16,
                               raster_method="pallas")
    step, shard_batch, shard_state = make_dp_train_step(meta, opt, pipe, 1.0,
                                                        dp_mesh)
    new, aux = step(shard_state(state0), shard_batch(batch),
                    shard_batch(bgs), 3, shard_batch(flags))
    res["dp"] = {"state": state_np(new), "loss": float(aux["loss"]),
                 "n_visible": int(aux["n_visible"])}

    mesh = make_mesh(2, world // 2, device=CPU)
    bgs2 = torch.tensor(inp["bgs2"])
    for name, cfg in (("batch_padded", PADDED),
                      ("batch_exact", BATCH_EXACT)):
        res[name] = render_grads(
            lambda *r: rasterize_batch_tile_sharded(
                *r, cams[:2], 3, bgs2, mesh, config=cfg),
            rows, (0, 1), lambda o: torch.mean(o["render"] ** 2)
            + 0.3 * torch.mean(o["depth"] ** 2))

    for name, extra in (("tp_padded", {}),
                        ("tp_exact", dict(exact_extra=16,
                                          grad_reduce="counts"))):
        pipe = tcfg.PipelineConfig(tile_capacity=128, max_dup=16,
                                   raster_method="pallas", **extra)
        step, replicate = make_tile_sharded_train_step(meta, opt, pipe, 1.0,
                                                       mesh)
        new, aux = step(replicate(state0), batch, bgs, 3, flags)
        res[name] = {"state": state_np(new), "loss": float(aux["loss"]),
                     "aux": {k: int(v) for k, v in aux.items()
                             if k != "loss"}}
        if name == "tp_padded":
            off, _ = step(replicate(state0), batch, bgs, 3,
                          [False] * len(batch))
            res[name]["xyz_flags_off"] = np_(off.params.xyz)

    # Splats 4x larger and a one-window budget (rounded up to a multiple of
    # the ranks): the exact counts step overflows and must revert.
    pipe = tcfg.PipelineConfig(tile_capacity=128, max_dup=16,
                               raster_method="pallas", exact_extra=1,
                               grad_reduce="counts")
    step, replicate = make_tile_sharded_train_step(meta, opt, pipe, 1.0, mesh)
    big = replicate(state0._replace(params=state0.params._replace(
        log_scales=state0.params.log_scales + math.log(4.0))))
    new, aux = step(big, batch, bgs, 3, flags)
    res["tp_overflow"] = {"old": state_np(big), "state": state_np(new),
                          "aux": {k: int(v) for k, v in aux.items()
                                  if k != "loss"}}
    return res
