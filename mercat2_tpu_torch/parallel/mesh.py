"""Device meshes for the sharded count: plain lists of ``torch.device``.

Port of ``mercat2_tpu.parallel.mesh``. The JAX mesh is a ``(data, bins)``
grid laid over the TPU's chip-to-chip links; the port keeps no bins axis
(the dense histogram's partials are summed on the first device, see
``parallel.count.sharded_dense_histogram``). A mesh is the list of the
devices its shards run on, in shard order; a device may repeat, so that
several shards share one card (or the CPU, as the tests run it).
One process drives every card of its host, as the JAX package's single
controller does; counting never crosses hosts (``parallel.dist``).
"""

from __future__ import annotations

import torch

__all__ = ["flat_mesh", "make_mesh", "mesh_shape_for"]


def mesh_shape_for(n_devices: int, bins_parallel: int | None = None) -> tuple[int, int]:
    """Pick a (data, bins) split of ``n_devices``.

    Default: bins axis of 2 when it divides evenly and there are >= 4
    devices (keeps most parallelism on the embarrassingly-parallel data
    axis; the bins axis only pays off when the histogram is large).
    """
    if bins_parallel is None:
        bins_parallel = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    if n_devices % bins_parallel:
        raise ValueError(f"bins_parallel={bins_parallel} must divide {n_devices}")
    return n_devices // bins_parallel, bins_parallel


def _cuda_devices() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first ``n_devices`` CUDA cards (default: all); raises when
    fewer are visible."""
    devices = _cuda_devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    return devices[:n_devices]


def flat_mesh(n_devices: int | None = None,
              devices: list | None = None) -> list[torch.device]:
    """The first ``n_devices`` of ``devices`` (default: every CUDA card of
    this host), as the mesh the sharded count takes."""
    if devices is None:
        devices = _cuda_devices()
    if n_devices is None:
        n_devices = len(devices)
    return [torch.device(d) for d in devices[:n_devices]]
