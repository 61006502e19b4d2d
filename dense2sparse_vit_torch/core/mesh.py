"""Process groups and batch sharding for multi-process training (port of
`dense2sparse_vit_tpu/core/mesh.py`).

The JAX package runs one program over a ('data', 'model') device mesh and
lets XLA insert the collectives. Here every process drives one device, as
the reference's DDP over NCCL did: `maybe_initialize_distributed` joins the
process group (NCCL on the card, gloo on the CPU), and `make_mesh` lays the
processes out as the JAX mesh lays out its devices, rank = d * model + m,
and returns the rank's data group (the ranks that hold the same parameter
shards and split the batch) and its model group (the ranks that split a
block's matrices, `parallel/tensor_parallel.py`).

With no process group (one process) every helper is the identity: the mesh
is 1 x 1, its groups None, and nothing is communicated.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def distributed() -> bool:
    """Whether a process group is up."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def is_primary() -> bool:
    """Rank 0 (or the one process): the only rank that logs, prints and
    writes checkpoints and artifacts."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank; nothing with one process."""
    if world_size() > 1:
        dist.barrier()


def free_port() -> int:
    """A free TCP port on this host, from the kernel (a socket bound to port
    0), for a coordinator on localhost."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    LOCAL_RANK, else the rank modulo the host's cards."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank() % max(n, 1)


def local_device(device_type: str = "cuda") -> torch.device:
    """The device this rank drives: cuda:LOCAL_RANK on the card, the CPU
    otherwise."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device(device_type, local_rank())


def maybe_initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
    backend: Optional[str] = None,
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Join the process group where one is configured; returns whether a
    group is up.

    Explicit arguments win (the CLI's --dist-coordinator host:port,
    --dist-num-processes, --dist-process-id); otherwise torchrun's RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT. A coordinator becomes
    tcp://host:port. The backend is NCCL for the card and gloo for the CPU
    unless `backend` names one; on the card the rank's device is
    cuda:LOCAL_RANK (`local_device`), made the current one. `timeout`: the
    collectives' (torch's default where None). A group already up is kept.
    """
    if distributed():
        return True
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        if (num_processes or 1) > 1:
            raise ValueError(f"{num_processes} processes need a coordinator address "
                             "(--dist-coordinator host:port, or torchrun's MASTER_ADDR/PORT)")
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and this process's id")
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device_type == "cuda":
        torch.cuda.set_device(int(env["LOCAL_RANK"]) if env.get("LOCAL_RANK")
                              else process_id % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, **({} if timeout is None else {"timeout": timeout}))
    return True


@dataclass(frozen=True)
class Mesh:
    """A data x model layout of the processes, rank = d * model + m.

    shape: {"data": n, "model": m}, as the JAX mesh's; data_group: the m-th
    column (the same shards, different samples; None with one data rank);
    model_group: the d-th row (None with model = 1)."""

    shape: dict
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The data x model mesh over every process of the group (no group:
    1 x 1 without groups; a group of one rank: its data group is that
    group). Raises ValueError when data x model does not cover the world,
    as the JAX make_mesh does. Every rank must call it, in the same order
    as its other group creations: it makes the groups collectively."""
    world = world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not cover {world} processes")
    if not distributed():
        return Mesh({"data": 1, "model": 1})
    d, m = divmod(rank(), model)
    data_group = model_group = None
    if model == 1:
        data_group = dist.group.WORLD
    else:
        for col in range(model):
            g = dist.new_group([i * model + col for i in range(data)])
            if col == m and data > 1:
                data_group = g
        for row in range(data):
            g = dist.new_group([row * model + j for j in range(model)])
            if row == d:
                model_group = g
    return Mesh({"data": data, "model": model}, d, m, data_group, model_group)


def host_local_batch(global_batch: int, mesh: Mesh) -> int:
    """Per-data-rank batch size; raises on indivisibility."""
    n = mesh.shape["data"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n}")
    return global_batch // n


def process_local_indices(indices, mesh: Optional[Mesh] = None) -> np.ndarray:
    """This rank's shard of a dataset index list, round-robin:
    indices[rank::world] (the JAX rule, DistributedSampler's split). With a
    mesh the data rank and size stand for rank and world, so that the ranks
    of one model group read the same samples."""
    indices = np.asarray(indices)
    if mesh is None:
        return indices[rank()::world_size()]
    return indices[mesh.data_rank::mesh.shape["data"]]


def local_rows(full, mesh: Mesh):
    """This data rank's rows of a batch every rank holds whole: the
    contiguous block a 'data'-sharded array puts on it (JAX
    `put_global_batch_from_full`)."""
    n = host_local_batch(len(full), mesh)
    return full[mesh.data_rank * n:(mesh.data_rank + 1) * n]
