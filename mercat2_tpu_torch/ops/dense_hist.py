"""Dense small-keyspace count: per-file histograms instead of a sort.

The port of ``mercat2_tpu.ops.mxu_hist`` (``count_kmers_dense_segments``,
``decode_dense_histogram``) and ``ops/dense_hist.py``. When the keyspace
``S**k`` of a round is at most ``MAX_BINS`` (``keyspace``, the JAX
package's own test), a launch bins its windows instead of sorting them::

    packed words + gap ranges + file starts   (the sorted path's launch)
      -> window validity
      -> bin = fid * S**k + base-S window value     (bin order = lexicographic)
      -> one scatter-add histogram of n_files * S**k bins
      -> per-file min-count filter, compaction of the survivors

The JAX function is a one-hot matmul on the TPU's matrix unit, not a
Pallas kernel, so it has no hand-written counterpart: this plain PyTorch
form runs on both devices. Nothing here waits for the device: the
histogram is a scatter-add into a fixed ``n_files * S**k + 1`` bins
(``torch.bincount`` reads the input's max to size its output, a device
sync per launch) and the compaction a cumsum and a scatter (``nonzero``
would sync too), so ``n_out`` stays on the device until the caller
fetches every launch's at once.
"""

from __future__ import annotations

import torch

from mercat2_tpu_torch.ops.finalize import packed_window_validity, unpack_codes

__all__ = ["MAX_BINS", "count_kmers_dense", "keyspace"]

#: largest keyspace routed to the dense histogram (``MXU_MAX_BINS``,
#: mercat2_tpu/ops/mxu_hist.py:35)
MAX_BINS = 1 << 14


def keyspace(k: int, bits: int, alphabet_size: int) -> int:
    """S**k, capped: an output table can never have more rows
    (``KmerCounter._keyspace``, mercat2_tpu/engine/counter.py:816)."""
    if k * bits > 30:
        return 1 << 62
    return min(alphabet_size**k, 1 << 62)


def count_kmers_dense(packed: torch.Tensor, gap_begin: torch.Tensor,
                      gap_end: torch.Tensor, file_starts: torch.Tensor,
                      min_count: int, *, k: int, bits: int,
                      alphabet_size: int, n_files: int, n_sym: int):
    """Per-file dense histograms of one fid-tagged launch, filtered and
    compacted.

    Takes the sorted path's launch (``count_kmers_packed``): big-endian
    packed ``bits``-bit codes, half-open gap ranges and the first symbol
    of each of ``n_files`` files. Requires ``S**k <= MAX_BINS``.

    Returns (bins, counts, n_out): int32[n_files * S**k] surviving bins in
    ascending order (``fid * S**k + window value``), then filler, their
    int32 counts, and the int32 survivor count, all on the device.
    """
    s = alphabet_size
    n_bins = s**k
    if n_bins > MAX_BINS:
        raise ValueError(f"keyspace {s}**{k} = {n_bins} > {MAX_BINS}")
    dev = packed.device
    p = n_sym - k + 1
    valid = packed_window_validity(gap_begin, gap_end, k, p)
    codes = torch.clamp(unpack_codes(packed, bits, n_sym), max=s - 1)
    idx = torch.zeros(p, dtype=torch.int32, device=dev)
    for j in range(k):  # Horner: the base-S value, first symbol most significant
        idx = idx * s + codes[j : j + p]
    pos = torch.arange(p, device=dev)
    fid = torch.searchsorted(file_starts.to(torch.int64), pos, right=True) - 1
    total = n_files * n_bins
    # invalid windows land in one extra bin past the files', dropped below
    bins = torch.where(valid, fid * n_bins + idx, total)
    hist = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    hist.index_add_(0, bins, torch.ones(p, dtype=torch.int32, device=dev))
    hist = hist[:total]

    keep = hist >= max(1, int(min_count))
    rank = torch.cumsum(keep, 0, dtype=torch.int64) - 1
    # survivors to their rank, the rest to a trash row past the end
    dest = torch.where(keep, rank, total)
    out_bins = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    out_counts = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    out_bins.scatter_(0, dest, torch.arange(total, dtype=torch.int32, device=dev))
    out_counts.scatter_(0, dest, hist)
    count_kmers_dense.launches += 1
    return out_bins[:total], out_counts[:total], keep.sum(dtype=torch.int32)


#: launches since the last reset, on either device (the route has no
#: kernel; the count shows that a run took it)
count_kmers_dense.launches = 0

