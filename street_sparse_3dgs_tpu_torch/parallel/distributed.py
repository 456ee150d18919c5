"""Multi-host runtime (``torch.distributed``) and host identity, mirroring
``street_sparse_3dgs_tpu/parallel/distributed.py``.

The reference scales across machines through Slurm array jobs, one process
per chunk coordinated through the filesystem.  ``pipeline.full_train``
keeps that fan-out (``host_id``/``num_hosts``); left as ``None`` the pair
resolves from an initialised process group, so the same ``full_train``
invocation on every host partitions the chunk list.  On a single process
with nothing initialised everything is (0, 1).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve_device

# Environment variables understood by ``init_distributed`` (the same names
# as the JAX package's).
ENV_COORDINATOR = "SS3DGS_COORDINATOR"
ENV_NUM_PROCESSES = "SS3DGS_NUM_PROCESSES"
ENV_PROCESS_ID = "SS3DGS_PROCESS_ID"


def _runtime() -> tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str | torch.device = DEFAULT_DEVICE
                     ) -> tuple[int, int]:
    """Join (or create) the process group; returns ``(rank, world_size)``.

    Arguments default from the ``SS3DGS_COORDINATOR`` (``host:port`` or a
    ``tcp://`` URL) / ``SS3DGS_NUM_PROCESSES`` / ``SS3DGS_PROCESS_ID``
    environment.  With none of them set it returns (0, 1) without touching
    ``torch.distributed``.  The backend is ``nccl`` for a CUDA ``device``,
    ``gloo`` on the CPU.  A second call is a no-op returning the current
    identity."""
    if dist.is_available() and dist.is_initialized():
        return _runtime()
    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator_address is None and num_processes is None:
        return 0, 1
    dev = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"       # MASTER_ADDR / MASTER_PORT
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if dev.type == "cuda":
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1)
    return _runtime()


def host_identity(host_id: int | None = None,
                  num_hosts: int | None = None) -> tuple[int, int]:
    """Resolve the (host_id, num_hosts) pair used for chunk fan-out.

    Explicit arguments (the reference-style launcher contract) win; ``None``
    falls back to the process group's rank and world size, which are (0, 1)
    unless ``init_distributed`` joined a larger group."""
    rank, world = _runtime()
    if num_hosts is None:
        num_hosts = world
    if host_id is None:
        if num_hosts > world:
            # Every process would resolve to index 0 and train the same
            # chunk partition while the others never get produced.
            raise ValueError(
                f"num_hosts={num_hosts} exceeds the runtime process count "
                f"({world}): pass host_id explicitly (the "
                "launcher contract) or join the runtime via "
                "init_distributed() first")
        host_id = rank if num_hosts > 1 else 0
    if not (0 <= host_id < num_hosts):
        raise ValueError(f"host_id {host_id} out of range for "
                         f"{num_hosts} hosts")
    return host_id, num_hosts
