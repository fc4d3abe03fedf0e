"""Multi-host runtime: process-group init + host-level work sharding.

Port of ``mercat2_tpu.parallel.dist``. Every host runs the same program
and claims a deterministic slice of the input files (:func:`host_shard`);
the filesystem (or a shared mount) holds inputs and outputs, each host
writes the outputs it owns, and process 0 writes the combined ones. The
hosts meet only at barriers of a **gloo** ``torch.distributed`` process
group: no tensor crosses hosts, as in the JAX package, where counting is
process-local too (``parallel.count`` meshes over one host's cards).
"""

from __future__ import annotations

import os

__all__ = ["init_distributed", "host_shard", "is_coordinator", "barrier"]


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join the gloo process group when running multi-host; no-op otherwise.

    ``coordinator`` is rank 0's ``host:port``. The arguments default to
    torchrun's variables (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); when none of them is given, nothing is initialized. Returns
    True if a group of more than one process is up.
    """
    import torch.distributed as dist

    if _initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator is None and num_processes is None and process_id is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-host run needs the coordinator address, the number of "
            "processes and this process's rank (MASTER_ADDR/MASTER_PORT, "
            f"WORLD_SIZE, RANK); got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def is_coordinator() -> bool:
    """True on rank 0, and in a run without a process group."""
    import torch.distributed as dist

    return not _initialized() or dist.get_rank() == 0


def host_shard(items: list, process_id: int | None = None,
               num_processes: int | None = None) -> list:
    """Deterministic round-robin slice of ``items`` owned by this host.

    Replaces Ray's dynamic task queue (MerCat2's per-sample
    ``run_mercat2.remote`` fan-out, bin/mercat2.py:336-339) with static
    ownership: host p takes items p, p+P, p+2P, ... of the
    sorted list, so every host computes the same assignment without
    communication.
    """
    import torch.distributed as dist

    up = _initialized()
    p = (dist.get_rank() if up else 0) if process_id is None else process_id
    n = (dist.get_world_size() if up else 1) if num_processes is None else num_processes
    ordered = sorted(items, key=str)
    return ordered[p::n]


def barrier(name: str = "mercat2") -> None:
    """Cross-host sync point (no-op without a process group); ``name``
    labels it for a reader of the code, as in the JAX package."""
    import torch.distributed as dist

    if _initialized():
        dist.barrier()
