"""The (data, tile) rank grid of multi-rank training, mirroring
``street_sparse_3dgs_tpu/parallel/mesh.py``, on ``torch.distributed``.

The execution model: a rank is a process with one explicit
``torch.device``.  On a machine with several cards rank r takes
``cuda:r % count`` on an ``nccl`` group (``init_rank``, or
``parallel.distributed.init_distributed`` under a launcher); in the tests
rank r takes the CPU on a ``gloo`` group; on one card W ranks share
``cuda:0`` on a ``gloo`` group, their collectives going through the host
(``parallel.collectives``, the one place that knows the backend).

``make_mesh(n_data, n_tile)`` lays the ranks of the default group out as
an n_data x n_tile grid (rank = data · n_tile + tile) with one group per
data row (the ranks that share a view's tiles: axis ``"tile"``) and one
per tile column (axis ``"data"``).  The counterparts of JAX's shardings
are ``data_shard`` (this rank's part of a batch's leading axis) and
``replicate_state`` (a ``TrainState`` broadcast from rank 0).
``run_world`` starts W ranks as spawned processes on one ``FileStore``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import DEFAULT_DEVICE, resolve_device
from . import collectives

AXES = ("data", "tile")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, tile) grid and the grid's groups."""

    n_data: int
    n_tile: int
    rank: int                 # rank in the default group
    device: torch.device
    world: object             # the group of every rank of the grid
    data_group: object        # my tile column: the ranks along "data"
    tile_group: object        # my data row: the ranks along "tile"

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "tile": self.n_tile}

    def _axes(self, axis) -> tuple:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if not axes or any(a not in AXES for a in axes):
            raise ValueError(f"unknown mesh axis {axis!r}")
        return axes

    def size(self, axis="tile") -> int:
        """The number of ranks along ``axis`` (a name or a tuple)."""
        n = 1
        for a in self._axes(axis):
            n *= self.shape[a]
        return n

    def index(self, axis="tile") -> int:
        """This rank's index along ``axis``; along ("data", "tile") it is
        data · n_tile + tile, JAX's combined index."""
        coords = {"data": self.rank // self.n_tile,
                  "tile": self.rank % self.n_tile}
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def group(self, axis="tile"):
        """The group of the ranks along ``axis`` that share this rank's
        other coordinates (the group a psum over ``axis`` reduces in)."""
        axes = set(self._axes(axis))
        if axes == {"data", "tile"}:
            return self.world
        return self.tile_group if axes == {"tile"} else self.data_group


def make_mesh(n_data: int | None = None, n_tile: int = 1,
              device: str | torch.device = DEFAULT_DEVICE) -> Mesh:
    """The (data, tile) grid over every rank of the initialised default
    group; ``n_data`` defaults to world // n_tile and n_data · n_tile must
    be the world size.  Every rank calls it with the same arguments (it
    creates one group per data row and per tile column, on the default
    group's backend)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(init_rank or init_distributed)")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_tile
    if n_data * n_tile != world:
        raise ValueError(f"mesh {n_data} x {n_tile} does not cover the "
                         f"{world} ranks")
    rank = dist.get_rank()
    data_group = tile_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_tile + t for t in range(n_tile)])
        if rank // n_tile == d:
            tile_group = g
    for t in range(n_tile):
        g = dist.new_group([d * n_tile + t for d in range(n_data)])
        if rank % n_tile == t:
            data_group = g
    return Mesh(n_data=n_data, n_tile=n_tile, rank=rank,
                device=resolve_device(device), world=dist.group.WORLD,
                data_group=data_group, tile_group=tile_group)


def data_shard(mesh: Mesh, seq):
    """This rank's part of a batch's leading axis (a tensor or a list of
    views): contiguous blocks of len / n_data, by data index."""
    n = len(seq)
    if n % mesh.n_data:
        raise ValueError(f"batch of {n} does not split over "
                         f"{mesh.n_data} data ranks")
    per = n // mesh.n_data
    d = mesh.index("data")
    return seq[d * per:(d + 1) * per]


def _broadcast_tree(x, mesh: Mesh):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        # A CPU scalar (the step counter) rides on the rank's device.
        return collectives.broadcast(x.to(mesh.device), 0,
                                     mesh.world).to(x.device)
    return type(x)(*(_broadcast_tree(v, mesh) for v in x))


def replicate_state(mesh: Mesh, state):
    """A ``TrainState`` (any NamedTuple of tensors) as rank 0 of the grid
    holds it, on every rank (one broadcast per tensor)."""
    return _broadcast_tree(state, mesh)


# ---- starting ranks --------------------------------------------------------

def init_rank(rank: int, world: int, store_path: str | Path,
              backend: str, timeout_s: float = 300.0) -> None:
    """Join the default group as ``rank`` of ``world`` through a
    ``FileStore`` at ``store_path`` (no port, so concurrent worlds cannot
    collide); ``timeout_s`` bounds the rendezvous and every collective."""
    store = dist.FileStore(str(store_path), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank, fn, world, store_path, backend, out_dir, timeout_s,
               args):
    torch.set_num_threads(1)
    # The ranks of one world share this machine: both backends bootstrap
    # over the loopback interface unless told otherwise.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init_rank(rank, world, store_path, backend, timeout_s)
    try:
        result = fn(rank, world, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, store_dir: str | Path, backend: str,
              args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes on one
    ``backend`` group (a fresh ``FileStore`` under ``store_dir``) and
    return each rank's result (saved with ``torch.save``) in rank order.
    ``fn`` must be importable by name.  A rank's exception, or a world
    still running after ``timeout_s`` (a hung collective), kills every
    rank and raises."""
    store_dir = Path(store_dir)
    store_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{time.monotonic_ns()}"
    store = store_dir / f"store-{tag}"
    out_dir = store_dir / f"out-{tag}"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, str(store), backend, str(out_dir),
                          timeout_s, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {world} ranks still running "
                                   f"after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    results = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
               for r in range(world)]
    for path in list(out_dir.iterdir()):
        path.unlink()
    out_dir.rmdir()
    if store.exists():
        store.unlink()
    return results
