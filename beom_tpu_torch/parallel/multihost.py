"""Multi-process bootstrap and gather helpers: the port's twin of
beom_tpu/parallel/multihost.py, on torch.distributed.

Every process runs the same program.  `init()` joins them into one
process group (NCCL between cards, gloo on the CPU); a single process
skips it, and every helper then works on the one process's arrays.

The port's mesh (parallel/mesh.py) is single-controller: one process
holds every shard, so within a process `gather_to_host` gathers a
Sharded field through `mesh.gather`.  Across processes it assumes the
layout of the reference's `process_allgather(tiled=True)`: each process
holds its whole addressable part as one array, the parts joined along the
leading axis in rank order, every part of one shape.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from beom_tpu_torch.parallel.mesh import gather, host_array


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group over `num_processes` ranks.

    NCCL when a card is present, gloo otherwise; `coordinator_address`
    ('host:port') as the TCP rendezvous, else the env:// variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  Returns at once for a
    single process.
    """
    if num_processes is not None and num_processes <= 1:
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    method = (f"tcp://{coordinator_address}" if coordinator_address
              else "env://")
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend, init_method=method, **kw)


def _multi() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_to_host(x) -> Optional[np.ndarray]:
    """The global array of `x` (a tensor, or a Sharded field gathered
    through its mesh) as numpy on the primary process, None elsewhere.

    With several processes each gives its part, joined along the leading
    axis in rank order (an all_gather on the process group's device)."""
    if not _multi():
        return host_array(x)
    local = gather(x)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    part = local.detach().to(dev).contiguous()
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, part)
    return torch.cat(parts).cpu().numpy() if is_primary() else None
