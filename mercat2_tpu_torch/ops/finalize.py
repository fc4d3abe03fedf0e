"""The count path's device ops in PyTorch: validity, key build, sort and
finalize.

Port of ``mercat2_tpu.ops.finalize``. One launch group of the packed
transport becomes a compacted (key, count) table::

    packed words + gap ranges
      -> window validity (difference array + cumsum)
      -> masked sort-key columns, tagged with the file id, a 2-word key
         fused into one sign-flipped int64, valid windows counted
                                                            (build_keys kernel)
      -> one sort: of the fused int64 column, or LSD passes otherwise
      -> run boundaries, min-count filter, compaction      (finalize kernel)

Key words are int32 bit patterns of the JAX package's uint32 words, fused
keys int64 bit patterns of its uint64 keys. The all-ones invalid marker is
-1 in both, which sorts first in signed order, so every sort key becomes
an int64 whose signed order is the unsigned order of the original (a
fused pair with its sign bit flipped, a single word zero-extended).
``_select_first_positions`` (an ``approx_min_k`` compaction for a TPU
without scatter) has no counterpart: ``torch.nonzero`` does it.
"""

from __future__ import annotations

import torch

from mercat2_tpu_torch.ops.kmer_pack import key_words_for

__all__ = [
    "build_keyed_words", "count_kmers_packed", "fid_layout", "fuse_u64",
    "packed_sort_keys", "packed_window_validity", "sort_words", "split_u64",
    "unpack_codes",
]

_ONES32 = -1
_SIGN64 = -(1 << 63)
_LOW32 = 0xFFFFFFFF


def fuse_u64(keyed: list[torch.Tensor]) -> torch.Tensor:
    """Fuse a 2-word key column pair into one int64 column.

    Word 0 carries the most significant key bits, so ``(w0 << 32) | w1``
    keeps the unsigned order of the (w0, w1) tuple. Returns the column with
    its sign bit flipped (see the module docstring), so that its signed
    order is that unsigned order; equality, which is all the finalize
    reads, is unchanged by the flip.
    """
    x = (keyed[0].to(torch.int64) << 32) | (keyed[1].to(torch.int64) & _LOW32)
    return x ^ _SIGN64


def split_u64(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign-flipped fused int64 keys -> (hi, lo) int32 word columns."""
    x = s ^ _SIGN64
    return (x >> 32).to(torch.int32), x.to(torch.int32)


def sort_words(cols: list[torch.Tensor]) -> list[torch.Tensor]:
    """Sort int32 key columns in unsigned lexicographic order.

    PyTorch has no multi-key sort, so this is an LSD radix over chunks of
    one or two columns (each fused into an int64 whose signed order is the
    chunk's unsigned order): a stable sort per chunk, least significant
    chunk first, then one gather of every column.
    """
    n = len(cols)
    chunks = [cols[max(0, e - 2) : e] for e in range(n, 0, -2)]
    perm = None
    for chunk in chunks:
        if len(chunk) == 2:
            key = (chunk[0].to(torch.int64) << 32) | (chunk[1].to(torch.int64) & _LOW32)
            key = key ^ _SIGN64
        else:
            key = chunk[0].to(torch.int64) & _LOW32
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return [c[perm] for c in cols]


def _finalize_sorted_u64(s: torch.Tensor, n_valid, min_count: int, cap: int):
    """Run-length, min-count filter and compaction over one SORTED int64
    key column (plain torch; the twin of the finalize kernel's u64 mode).

    Same contract as the JAX package's ``_finalize_sorted_u64``: rows at
    index >= ``n_valid`` belong to no run; a run starting at i survives
    iff key[i + min_count - 1] == key[i] inside the valid rows; its END
    satisfies the mirrored test, and starts and ends of surviving runs
    pair up 1:1 in order, so counts = end - start + 1.

    Returns (keys int64[rows], counts int32[rows], n_out int32), rows =
    min(cap, p): the leading surviving runs in sorted order, then filler
    rows (key of row p-1, count 0). ``n_out`` is the true number of
    survivors and may exceed ``cap``.
    """
    p = s.shape[0]
    pos = torch.arange(p, device=s.device)
    in_valid = pos < n_valid
    m = max(int(min_count), 1)
    ne = s[1:] != s[:-1]
    one = torch.ones(1, dtype=torch.bool, device=s.device)

    is_start = torch.cat([one, ne]) & in_valid
    fwd = pos + (m - 1)
    keep = is_start & (fwd < n_valid) & (s[fwd.clamp(max=p - 1)] == s)
    is_end = (torch.cat([ne, one]) | (pos == n_valid - 1)) & in_valid
    bwd = pos - (m - 1)
    end_keep = is_end & (bwd >= 0) & (s[bwd.clamp(min=0)] == s)

    starts = torch.nonzero(keep).flatten()
    ends = torch.nonzero(end_keep).flatten()
    n_out = starts.shape[0]
    rows = min(cap, p)
    take = min(n_out, rows)
    keys = s[p - 1].repeat(rows)
    counts = torch.zeros(rows, dtype=torch.int32, device=s.device)
    keys[:take] = s[starts[:take]]
    counts[:take] = (ends[:take] - starts[:take] + 1).to(torch.int32)
    return keys, counts, torch.tensor(n_out, dtype=torch.int32, device=s.device)


def _finalize_sorted(words, n_valid, min_count: int, cap: int):
    """Run-length, min-count filter and compaction over SORTED int32 key
    columns (plain torch; the twin of the finalize kernel's word mode).

    Same contract as the JAX package's ``_finalize_sorted``: a run starts
    where any word differs from the row before, rows at index >=
    ``n_valid`` belong to no run, and a run survives iff its length is at
    least ``min_count``. Returns (words, counts, n_out) with the row
    layout of :func:`_finalize_sorted_u64`.
    """
    p = words[0].shape[0]
    dev = words[0].device
    pos = torch.arange(p, device=dev)
    boundary = torch.zeros(p, dtype=torch.bool, device=dev)
    boundary[0] = True
    for w in words:
        boundary[1:] |= w[1:] != w[:-1]
    boundary &= pos < n_valid

    bpos = torch.nonzero(boundary).flatten()
    nv = torch.as_tensor(n_valid, device=dev).reshape(1).to(bpos.dtype)
    run_len = torch.cat([bpos[1:], nv]) - bpos
    kept = run_len >= int(min_count)
    starts = bpos[kept]
    lens = run_len[kept]
    n_out = starts.shape[0]
    rows = min(cap, p)
    take = min(n_out, rows)
    safe = torch.full((rows,), p - 1, dtype=torch.int64, device=dev)
    safe[:take] = starts[:take]
    counts = torch.zeros(rows, dtype=torch.int32, device=dev)
    counts[:take] = lens[:take].to(torch.int32)
    out_words = tuple(w[safe] for w in words)
    return out_words, counts, torch.tensor(n_out, dtype=torch.int32, device=dev)


def build_keyed_words(payload, valid, fid, k: int, bits: int,
                      n_files: int) -> tuple[list, int]:
    """Masked sort-key columns for a (possibly multi-file) window set.

    Invalid windows get the all-ones key in every word so they sort last;
    the marker never collides with a real key because word 0 has spare
    bits (fid field or short top word) that are never all-ones for valid
    rows, or an all-zero tie-break word is appended (``strip_tail`` = 1)
    when the payload fills its words exactly.

    Args:
        payload: list of int32[P] packed key words (pack_kmer_words).
        valid: bool[P] window validity.
        fid: int64[P] per-window file id (required when n_files > 1).
        n_files: number of files sharing the stream.

    Returns:
        (keyed, strip_tail): sort-key columns and how many trailing
        columns to drop before decode.
    """
    if n_files == 1:
        _, tiebreak = key_words_for(k, bits)
        keyed = [torch.where(valid, w, _ONES32) for w in payload]
        if tiebreak:
            keyed.append(torch.where(valid, 0, _ONES32).to(torch.int32))
        return keyed, int(tiebreak)
    mode, shift = fid_layout(k, bits, n_files)
    if mode == "embedded":
        payload = [payload[0] | (fid << shift).to(torch.int32)] + payload[1:]
        keyed = [torch.where(valid, w, _ONES32) for w in payload]
    else:
        keyed = [torch.where(valid, fid.to(torch.int32), _ONES32)]
        keyed += [torch.where(valid, w, _ONES32) for w in payload]
    return keyed, 0


def unpack_codes(packed: torch.Tensor, bits: int, n_sym: int) -> torch.Tensor:
    """int32[W] big-endian packed words -> int32[n_sym] symbol codes.

    Symbol 0 of a word sits in its most significant ``bits`` bits, as the
    host packers lay it out; ``per = 32 // bits`` symbols ride each word.
    Requires ``n_sym == W * per``.
    """
    per = 32 // bits
    if packed.shape[0] * per != n_sym:
        raise ValueError(f"{packed.shape[0]} words x {per} != {n_sym} symbols")
    shifts = 32 - bits * (torch.arange(per, device=packed.device, dtype=torch.int32) + 1)
    return ((packed[:, None] >> shifts) & ((1 << bits) - 1)).reshape(n_sym)


def packed_window_validity(gap_begin: torch.Tensor, gap_end: torch.Tensor,
                           k: int, p: int) -> torch.Tensor:
    """bool[p]: window validity from half-open gap symbol ranges.

    A window [i, i+k) is invalid iff it intersects a gap range [b, e),
    i.e. i in [b-k+1, e). A difference array and one cumsum; ranges share
    endpoints, so the +1/-1 updates go through ``index_add_``, which adds
    every duplicate index (plain indexed ``+=`` would keep only one).
    """
    b = (gap_begin.to(torch.int64) - (k - 1)).clamp(0, p)
    e = torch.maximum(gap_end.to(torch.int64).clamp(0, p), b)
    ones = torch.ones(b.shape[0], dtype=torch.int32, device=b.device)
    d = torch.zeros(p + 1, dtype=torch.int32, device=b.device)
    d.index_add_(0, b, ones)
    d.index_add_(0, e, -ones)
    return torch.cumsum(d[:p], 0, dtype=torch.int32) == 0


def fid_layout(k: int, bits: int, n_files: int) -> tuple[str, int]:
    """How to tag each window's sort key with its file id.

    ("embedded", shift) when the key's top word has enough spare bits to
    hold the fid, else ("word", 0): a dedicated leading fid word, which
    replaces the tie-break word when there is one.
    """
    fid_bits = max(1, n_files.bit_length())
    payload = max(1, -(-(k * bits) // 32))
    kb0 = k * bits - 32 * (payload - 1)  # key bits living in word0
    if 32 - kb0 >= fid_bits:
        return "embedded", kb0
    return "word", 0


def _sort_and_finalize(keyed: list, n_valid, min_count: int, cap: int,
                       strip_tail: int):
    """Sort key columns and reduce them to the compacted table.

    A fused int64 column (2-word keys) takes one sort and the finalize
    kernel's u64 mode; int32 columns take the LSD sort and its word mode.
    Returns (words, counts, n_out) with ``strip_tail`` trailing columns
    dropped.
    """
    from mercat2_tpu_torch.ops.finalize_kernel import finalize_sorted

    if keyed[0].dtype == torch.int64:
        (keys,), counts, n_out = finalize_sorted(
            (torch.sort(keyed[0]).values,), n_valid, min_count=min_count, cap=cap
        )
        return list(split_u64(keys))[: 2 - strip_tail], counts, n_out
    words = sort_words(keyed)
    out, counts, n_out = finalize_sorted(
        tuple(words[: len(words) - strip_tail]), n_valid,
        min_count=min_count, cap=cap,
    )
    return list(out), counts, n_out


def count_kmers_packed(packed: torch.Tensor, gap_begin: torch.Tensor,
                       gap_end: torch.Tensor, file_starts: torch.Tensor,
                       min_count: int, *, k: int, bits: int, cap: int,
                       n_files: int, n_sym: int):
    """Count k-mers of one launch group from a bit-packed transport buffer.

    Port of the JAX ``count_kmers_packed``: the same transport (``bits``
    per symbol, out-of-band gap ranges), per-file fid-tagged sort keys and
    per-file min-count. The key build and the finalize go through the
    kernel wrappers, which launch the CUDA kernels for CUDA tensors and
    take their plain twins for CPU tensors. Nothing here waits for the
    device: ``n_out`` stays a device tensor until the caller fetches it.

    Returns (words, counts, n_out): int32 key columns with the fid still
    in them, int32 counts and the int32 survivor count (> cap: retry).
    """
    keyed, n_valid, strip_tail = packed_sort_keys(
        packed, gap_begin, gap_end, file_starts, k=k, bits=bits,
        n_files=n_files, n_sym=n_sym,
    )
    return _sort_and_finalize(keyed, n_valid, min_count, cap, strip_tail)


def packed_sort_keys(packed: torch.Tensor, gap_begin: torch.Tensor,
                     gap_end: torch.Tensor, file_starts: torch.Tensor, *,
                     k: int, bits: int, n_files: int, n_sym: int):
    """The pre-sort half of :func:`count_kmers_packed`.

    Returns (keyed, n_valid, strip_tail): the sort-key columns (one fused,
    sign-flipped int64 column for 2-word keys, else masked, fid-tagged
    int32 columns), the device count of valid windows, and how many
    trailing key words are dropped after the finalize.
    """
    from mercat2_tpu_torch.ops.build_keys import build_keys

    p = n_sym - k + 1
    valid = packed_window_validity(gap_begin, gap_end, k, p)
    keyed, n_valid = build_keys(packed, valid, file_starts, k=k, bits=bits, p=p,
                                n_files=n_files)
    _, tiebreak = key_words_for(k, bits)
    return list(keyed), n_valid, int(tiebreak) if n_files == 1 else 0
