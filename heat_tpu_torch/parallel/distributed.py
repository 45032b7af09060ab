"""Process-group initialization and the rank's place in the job.

Counterpart of ``heat_tpu/parallel/distributed.py``. The JAX package
starts ``jax.distributed`` (from the TPU runtime, or from explicit
arguments); here every rank is one process with one device, started by a
launcher (``python -m torch.distributed.run``, which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``) or by the caller, who passes the coordinator's address,
the number of processes and this one's id:

* :func:`initialize` starts ``torch.distributed`` once. The backend is
  chosen before ``init_process_group``, from the topology alone: NCCL when
  every rank of the node has a card of its own, gloo when ranks share a
  card or run on the CPU. The choice is printed (by rank 0) and is never a
  retry after a failure;
* the rank's device is ``cuda:{LOCAL_RANK % device_count}``, or the CPU;
* :func:`global_mesh` is the ("data", "model") mesh over all ranks, and
  :func:`process_shard_index` the (shards, this shard) pair that
  ``shard_by_user_range`` takes.

Every process then loads the data itself and keeps its user range
(``data.datasets.shard_by_user_range``): no data crosses between ranks.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

# The backend and device of this process, set by initialize().
_STATE: dict = {}


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def choose_backend(device_type: str, local_world_size: int,
                   device_count: int) -> str:
    """The backend rule: "nccl" when the ranks run on cards and every rank
    of the node has its own, else "gloo" (ranks that share a card, which
    NCCL refuses, or ranks on the CPU)."""
    if device_type == "cuda" and local_world_size <= device_count:
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> None:
    """Start ``torch.distributed`` for this process (a no-op when it is
    already started).

    coordinator_address: ``host:port`` of rank 0's store; by default
      ``MASTER_ADDR:MASTER_PORT`` of the launcher's environment, else a
      free port on localhost (a world of one).
    num_processes / process_id: the world size and this rank; by default
      ``WORLD_SIZE`` and ``RANK``, else 1 and 0.
    device: "cuda" (each rank on ``cuda:{LOCAL_RANK % device_count}``) or
      "cpu"; with the topology it chooses the backend
      (:func:`choose_backend`).
    """
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", 1)
    rank = process_id if process_id is not None else _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
        elif world == 1:
            coordinator_address = f"127.0.0.1:{_free_port()}"
        else:
            raise ValueError(
                "a job of several processes needs coordinator_address (or "
                "MASTER_ADDR and MASTER_PORT from the launcher)")
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False (pass --device cpu to run on the CPU)")
        count = torch.cuda.device_count()
        rank_device = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(rank_device)
    elif dev_type == "cpu":
        count = 0
        rank_device = torch.device("cpu")
    else:
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    backend = choose_backend(dev_type, local_world, count)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = rank_device
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank, **kwargs)
    _STATE.update(backend=backend, device=rank_device)
    if rank == 0:
        print(f"torch.distributed backend: {backend} ({world} ranks, "
              f"{local_world} on this node, device {dev_type}, "
              f"{count} cards)", flush=True)


def backend() -> str:
    """The backend :func:`initialize` chose."""
    return _STATE["backend"]


def rank_device() -> torch.device:
    """This rank's device (set by :func:`initialize`)."""
    return _STATE["device"]


def shutdown() -> None:
    """End the process group (a no-op when none was started)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


def global_mesh(model_parallel: int = 1, device: str = "cuda"):
    """The ("data", "model") mesh over every rank of the job: ranks along
    "data" but for ``model_parallel`` of them along "model" (the CLI's
    mesh is (world, 1))."""
    from heat_tpu_torch.parallel.mesh import make_mesh

    initialize(device=device)
    n = dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} ranks not divisible by model_parallel={model_parallel}")
    return make_mesh(n // model_parallel, model_parallel, device=device)


def process_shard_index() -> tuple[int, int]:
    """(num_shards, this_shard) for ``shard_by_user_range``: the world size
    and this rank (1 and 0 before :func:`initialize`)."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()
