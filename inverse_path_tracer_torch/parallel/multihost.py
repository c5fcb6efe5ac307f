"""Multi-process start-up over torch.distributed (the counterpart of the JAX
package's parallel/multihost.py).

Every process runs the same program with its own rank; init_distributed
wires them into one process group, and parallel/shard.py splits the rays
of a render or a recovery step over the group's ranks.  Failure recovery is
a restart with a checkpoint resume (models/recover.py): renders are
deterministic given their keys, so a resumed run is bit-identical.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def choose_backend(device=None, local_ranks: int = 1) -> str:
    """The collective backend for ranks that compute on `device` (None means
    CUDA, as everywhere in the package): "nccl" when the ranks are on CUDA
    and each of the `local_ranks` ranks of this host has a card of its own;
    "gloo" on the CPU and when ranks share a card (NCCL refuses two ranks on
    one device).  The backend never changes a rank's device:
    parallel/shard.py moves tensors through the CPU for gloo's collectives
    and leaves them on their device otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available() and \
            torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> dict:
    """Join the process group if asked: explicitly (coordinator_address
    "host:port", with num_processes and process_id), or through the
    variables torchrun sets (MASTER_ADDR and MASTER_PORT with RANK and
    WORLD_SIZE); otherwise a no-op.  backend=None takes choose_backend for
    `device`, with LOCAL_WORLD_SIZE (else every process) as the ranks that
    share this host.

    Returns {process_index, process_count, local_devices, global_devices,
    backend}: each process drives one device, so local_devices is 1 and
    global_devices the number of processes; backend is None without a
    process group."""
    env_wired = all(os.environ.get(k) for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if (coordinator_address or env_wired) and not dist.is_initialized():
        if coordinator_address:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator needs num_processes and process_id")
            world, rank = int(num_processes), int(process_id)
            init = f"tcp://{coordinator_address}"
        else:
            world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
            init = "env://"
        if backend is None:
            backend = choose_backend(device, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
        dist.init_process_group(backend=backend, init_method=init, world_size=world, rank=rank)
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_devices": 1,
                "global_devices": 1, "backend": None}
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world, "local_devices": 1,
            "global_devices": world, "backend": dist.get_backend()}


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
