"""Finalize: sorted key columns -> compacted (key, count) table.

The port of the Pallas kernel ``finalize_sorted_pallas``
(``mercat2_tpu/ops/pallas_finalize.py:251-344``) and of the XLA finalizes
the uniform path runs (``_finalize_sorted_u64`` for fused 2-word keys,
``_finalize_sorted`` for other widths). One CUDA kernel
(``csrc/finalize.cu``) serves both input forms: one sorted int64 column
(fused keys) or n sorted int32 columns, in one pass over the keys (a scan
chained across tiles by decoupled look-back). It has no per-tile emission
cap, so the Pallas overflow sentinel is gone; ``n_out > cap`` still tells
the caller to retry with room.

``finalize_sorted`` launches the kernel for CUDA tensors and takes the
plain twin :func:`finalize_sorted_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from mercat2_tpu_torch.ops import _build
from mercat2_tpu_torch.ops.finalize import _finalize_sorted, _finalize_sorted_u64

__all__ = ["finalize_sorted", "finalize_sorted_plain"]


def _is_u64(cols) -> bool:
    return len(cols) == 1 and cols[0].dtype == torch.int64


def finalize_sorted_plain(cols, n_valid, *, min_count: int, cap: int):
    """Plain-torch twin of :func:`finalize_sorted`."""
    if _is_u64(cols):
        keys, counts, n_out = _finalize_sorted_u64(cols[0], n_valid, min_count, cap)
        return (keys,), counts, n_out
    return _finalize_sorted(tuple(cols), n_valid, min_count, cap)


def finalize_sorted(cols, n_valid, *, min_count: int, cap: int):
    """Runs of the sorted keys that occur at least ``min_count`` times.

    Args:
        cols: ``(s,)`` with ``s`` one sorted int64 column (fused keys), or
            a tuple of int32 columns sorted in lexicographic order. Only
            equality of rows is read, so any order-preserving encoding of
            the keys works.
        n_valid: int tensor (or int): rows at index >= n_valid belong to
            no run. A device tensor is read on the device, without a sync.
        min_count: keep runs of at least this many rows.
        cap: output rows (at most the column length).

    Returns:
        (key columns, int32[rows] counts, int32 n_out): the leading
        surviving runs in sorted order, then filler rows (the key of the
        last row, count 0); ``n_out`` is the true number of survivors and
        may exceed ``cap``.
    """
    dev = cols[0].device
    if dev.type == "cpu":
        return finalize_sorted_plain(cols, n_valid, min_count=min_count, cap=cap)
    u64 = _is_u64(cols)
    if not u64 and any(c.dtype != torch.int32 for c in cols):
        raise ValueError("finalize_sorted takes one int64 column or int32 columns")
    p = int(cols[0].shape[0])
    if not 0 < p < (1 << 31) or any(c.shape != (p,) or c.device != dev for c in cols):
        raise ValueError("columns must be 1-D, of one length in [1, 2**31), on one device")
    n = len(cols)
    if u64:
        keys, ld = cols[0].contiguous(), p
        if keys.data_ptr() % 16:  # the kernel stages 16-byte vectors
            keys = keys.clone()
    else:  # column stride a multiple of 4: every column 16-byte aligned
        ld = -(-p // 4) * 4
        keys = torch.empty((n, ld), dtype=torch.int32, device=dev)
        for c, col in enumerate(cols):
            keys[c, :p].copy_(col)
    rows = min(cap, p)
    nv = torch.as_tensor(n_valid, device=dev).to(torch.int64).reshape(1)
    lib = _build.load_library()
    tile = lib.m2t_finalize_tile_rows(int(u64), n)
    status = torch.empty(-(-p // tile) + 1, dtype=torch.int64, device=dev)
    n_out = torch.empty(1, dtype=torch.int32, device=dev)
    if u64:
        out_keys = torch.empty(rows, dtype=torch.int64, device=dev)
    else:
        out_keys = torch.empty((n, rows), dtype=torch.int32, device=dev)
    counts = torch.empty(rows, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the launch and its attribute go to the tensors' card
        rc = lib.m2t_finalize(
            int(u64), keys.data_ptr(), n, ld, p, nv.data_ptr(),
            max(int(min_count), 1), rows, status.data_ptr(), status.shape[0],
            n_out.data_ptr(), out_keys.data_ptr(), counts.data_ptr(),
            _build.stream_of(dev),
        )
    _build.check(rc, "finalize")
    finalize_sorted.launches += 1
    out = (out_keys,) if u64 else tuple(out_keys.unbind(0))
    return out, counts, n_out.reshape(())


#: kernel launches since the last reset (CPU tensors never count)
finalize_sorted.launches = 0
