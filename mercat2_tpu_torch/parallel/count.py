"""Sharded k-mer counting over a list of devices.

Port of ``mercat2_tpu.parallel.count``. A mesh is a list of
``torch.device``s (``parallel.mesh``); one process drives them all, and
the JAX collectives become copies between the shards' devices.

Stream sharding uses a (k-1)-symbol halo: shard d covers a contiguous
range of window starts of the launch group and carries the next k-1
symbols, so every window is counted exactly once and none straddles a
shard boundary invisibly (the exact form of MerCat2's record-boundary
chunking, lib/mercat2_Chunker.py:39-59). Ranges start on whole packed
words, so a shard's transport is a slice of the group's words.

Two reductions:

- dense (small k): a histogram per shard, summed on the first device
  (the JAX package's ``psum_scatter`` over bins, then ``psum``).
- sorted, the distributed sort-count of one launch group::

      per shard, on its device:  validity -> key build kernel -> sort
      splitters: 64 regular samples of each shard's valid keys, weighted
                 by its valid count, gathered to devices[0]; D-1 chosen
      route:     each shard cuts its sorted keys at the splitters
                 (searchsorted, side right: a run of equal keys is never
                 split); the D x D segment lengths reach the host (the
                 batch's one sync) and each destination concatenates
                 its D segments (the JAX ``all_to_all``)
      merge:     each destination re-sorts what it received and runs the
                 finalize kernel on it
      output:    the destinations' tables in shard order (ascending key
                 ranges) are the group's sorted, filtered table

  Because the partition is by key range, every run of equal keys lands on
  one destination, so its run lengths, and the per-file min-count, are
  exact. Segments are sized by their content, so the JAX package's
  block-cyclic layout, fixed ``seg_cap`` exchange and retry loops (which
  existed to keep a fixed-shape exchange from overflowing under skew) have
  no counterpart: under any skew the merge is exact, and the splitters
  balance it as far as the keys allow.

A CUDA tensor goes through the kernels or raises, as everywhere in the
port; CPU devices take the kernels' plain twins, which is how the tests
run a mesh of several shards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mercat2_tpu_torch.engine.counter import to_torch_group
from mercat2_tpu_torch.engine.host import (
    _REC_GAP, KmerTable, NumpySource, PackedGroup, _split_fid_tables,
    build_packed_group,
)
from mercat2_tpu_torch.ops.build_keys import MAX_FILES
from mercat2_tpu_torch.ops.finalize import (
    _sort_and_finalize, fid_layout, fuse_u64, packed_sort_keys, sort_words,
)
from mercat2_tpu_torch.ops.kmer_pack import key_words_for
from mercat2_tpu_torch.parallel.mesh import flat_mesh

__all__ = [
    "shard_stream", "sharded_dense_histogram", "sharded_count_streams",
    "sharded_count_sources", "flat_mesh",
]

_LOW32 = 0xFFFFFFFF


def _bucket8(n: int, floor: int = 1024) -> int:
    """Round up to eighth-power-of-two granularity (bounded compile shapes)."""
    n = max(n, floor)
    e = (n - 1).bit_length()
    step = 1 << max(e - 3, 0)
    return -(-n // step) * step


def shard_stream(stream: np.ndarray, k: int, n_shards: int, sentinel: int) -> np.ndarray:
    """uint8[N] stream -> uint8[n_shards, L + k - 1] haloed shard matrix.

    L = ceil(N / n_shards) window starts per shard, rounded up to an
    eighth-power-of-two bucket so the compiled program-shape family stays
    small WITHOUT padding the stream itself to a bucket first (which would
    concentrate all data — and all sort work — on the leading shards). The
    trailing k-1 symbols of each row replicate the head of the next shard.
    Tail rows are sentinel padded, so their surplus windows are invalid and
    drop out downstream. Callers should pass the TRIMMED stream.
    """
    n = int(stream.shape[0])
    L = _bucket8(-(-max(n, 1) // n_shards))
    total = n_shards * L + k - 1
    padded = np.full(total, sentinel, np.uint8)
    padded[:n] = stream
    idx = np.arange(L + k - 1)[None, :] + (np.arange(n_shards) * L)[:, None]
    return padded[idx]


def _dense_hist(codes: torch.Tensor, k: int, alphabet_size: int) -> torch.Tensor:
    """int64[S**k] histogram of one shard's windows whose symbols are all
    below ``alphabet_size`` (the JAX ``dense_kmer_histogram``)."""
    s = alphabet_size
    hist = torch.zeros(s**k, dtype=torch.int64, device=codes.device)
    p = codes.shape[0] - k + 1
    if p <= 0:
        return hist
    bad = torch.cat([codes.new_zeros(1), torch.cumsum(codes >= s, 0)])
    valid = bad[k:] == bad[:p]
    idx = torch.zeros(p, dtype=torch.int64, device=codes.device)
    clamped = codes.clamp(max=s - 1)
    for j in range(k):  # Horner: first symbol most significant
        idx = idx * s + clamped[j : j + p]
    return hist.index_add_(0, idx, valid.to(torch.int64))


def sharded_dense_histogram(shards: np.ndarray, *, k: int, alphabet_size: int,
                            devices: list | None = None) -> np.ndarray:
    """Fully-merged dense histogram (int64 on host) from haloed shards.

    ``shards`` has one row per device (see :func:`shard_stream`); each row
    is histogrammed on its device and the partials are summed on the first
    one. Plain PyTorch: the JAX function is an XLA scatter and collectives,
    not a Pallas kernel.
    """
    devices = flat_mesh() if devices is None else flat_mesh(devices=devices)
    if shards.shape[0] != len(devices):
        raise ValueError(f"{shards.shape[0]} shard rows for {len(devices)} devices")
    parts = [
        _dense_hist(torch.from_numpy(np.ascontiguousarray(row)).to(dev).to(torch.int64),
                    k, alphabet_size)
        for row, dev in zip(shards, devices)
    ]
    return sum(part.to(devices[0]) for part in parts).cpu().numpy()


#: samples taken per shard for splitter agreement. More samples -> tighter
#: load balance; D*S int64s ride one small gather either way.
_SAMPLES = 64


def _key_columns(k: int, bits: int, n_files: int) -> int:
    """Sort-key columns the key build gives a launch group (before the
    fuse of two into one int64 column)."""
    total, tiebreak = key_words_for(k, bits)
    if n_files == 1:
        return total
    payload = total - int(tiebreak)
    return payload + (1 if fid_layout(k, bits, n_files)[0] == "word" else 0)


@dataclasses.dataclass
class _Shard:
    """One shard's sorted keys on its device."""

    cols: list               # one fused int64 column, or int32 key words
    split_key: torch.Tensor  # int64[p], non-decreasing: what the splitters cut
    n_valid: torch.Tensor    # int64 scalar: rows below it are valid windows


def _shard_windows(p: int, per: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous window ranges [a, b) of about p / n_shards windows each,
    starting on whole words (``per`` symbols); trailing ones may be empty."""
    width = -(-(-(-p // n_shards)) // per) * per
    return [(min(d * width, p), min((d + 1) * width, p)) for d in range(n_shards)]


def _shard_group(group: PackedGroup, k: int, per: int, a: int, b: int) -> PackedGroup:
    """The transport of windows [a, b) of ``group``: its words from symbol
    ``a`` on (with the k-1 halo), the gap ranges that touch them and the
    file starts, shifted to the shard's first symbol, and one gap range
    that closes the windows past ``b`` (they belong to the next shard)."""
    n_sym = -(-(b - a + k - 1) // per) * per
    words = group.words[a // per : (a + n_sym) // per]
    gb = group.gap_begin.astype(np.int64)
    ge = group.gap_end.astype(np.int64)
    touch = (ge > a) & (gb < b + k - 1)  # gap [gb, ge) closes windows [gb-k+1, ge)
    return PackedGroup(
        words=words,
        n_sym=n_sym,
        file_starts=(group.file_starts.astype(np.int64) - a).astype(np.int32),
        gap_begin=np.append(gb[touch] - a, b - a + k - 1).astype(np.int32),
        gap_end=np.append(ge[touch] - a, n_sym).astype(np.int32),
    )


def _presort(counter, group: PackedGroup, devices: list,
             n_files: int) -> list[_Shard | None]:
    """Per shard, on its device: validity, the key-build kernel and the
    sort. A shard that owns no windows launches nothing (None)."""
    k, bits = counter.k, counter.codec.bits
    per = 32 // bits
    ranges = _shard_windows(group.n_sym - k + 1, per, len(devices))
    shards: list[_Shard | None] = []
    for dev, (a, b) in zip(devices, ranges):
        if b <= a:
            shards.append(None)
            continue
        sub = _shard_group(group, k, per, a, b)
        t = to_torch_group(sub, dev)
        keyed, n_valid, _ = packed_sort_keys(
            t.words, t.gap_begin, t.gap_end, t.file_starts, k=k, bits=bits,
            n_files=n_files, n_sym=sub.n_sym)
        if keyed[0].dtype == torch.int64:  # the fused column sorts alone
            cols = [torch.sort(keyed[0]).values]
            split_key = cols[0]
        else:
            cols = sort_words(keyed)
            # the order-preserving int64 of words 0 and 1 (or of the one
            # word): both words whole, so a file-id or short top word
            # leaves the splitters the next word's entropy
            split_key = (fuse_u64(cols[:2]) if len(cols) > 1
                         else cols[0].to(torch.int64) & _LOW32)
        shards.append(_Shard(cols, split_key, n_valid))
    return shards


def _exchange(shards: list, devices: list) -> tuple[list, list[int]]:
    """Splitter agreement and routing: returns, per destination shard, the
    key columns it received (None for none) and their row counts. The
    segment lengths reach the host once; nothing else waits."""
    n = len(devices)
    root = devices[0]
    smp, wgt = [], []
    for s in shards:
        if s is None:
            continue
        dev = s.split_key.device
        ranks = torch.arange(1, _SAMPLES + 1, device=dev) * s.n_valid // (_SAMPLES + 1)
        smp.append(s.split_key[ranks.clamp(0, s.split_key.shape[0] - 1)]
                   .to(root, non_blocking=True))
        wgt.append(s.n_valid.expand(_SAMPLES).to(root, non_blocking=True))
    allsmp, allwgt = torch.cat(smp), torch.cat(wgt)
    order = torch.argsort(allsmp, stable=True)
    ssmp, cumw = allsmp[order], torch.cumsum(allwgt[order], 0)
    # splitter j: the first sample whose weight prefix reaches (j+1)/D of
    # the total (integer arithmetic: cumw * D >= (j+1) * total)
    targets = torch.arange(1, n, device=root) * cumw[-1]
    spl = ssmp[torch.searchsorted(cumw * n, targets).clamp(max=ssmp.shape[0] - 1)]

    zero = torch.zeros(1, dtype=torch.int64, device=root)
    edges = []
    for s in shards:
        if s is None:
            edges.append(zero.expand(n + 1))
            continue
        dev = s.split_key.device
        cut = torch.searchsorted(s.split_key, spl.to(dev), right=True)
        nv = s.n_valid.reshape(1)
        edges.append(torch.cat([zero.to(dev), torch.minimum(cut, nv), nv]).to(root))
    host = torch.stack(edges).cpu().tolist()  # [D, D + 1]: the one sync

    recv: list = [[] for _ in range(n)]
    for s, row in zip(shards, host):
        if s is None:
            continue
        for e, dev in enumerate(devices):
            if row[e + 1] > row[e]:
                recv[e].append([c[row[e] : row[e + 1]].to(dev, non_blocking=True)
                                for c in s.cols])
    n_recv = [sum(row[e + 1] - row[e] for row in host) for e in range(n)]
    cols = [[torch.cat(list(parts)) for parts in zip(*segs)] if segs else None
            for segs in recv]
    return cols, n_recv


def _merge(recv: list, n_recv: list[int], min_count: int, strip: int) -> list:
    """Per destination: re-sort what it received and run the finalize
    kernel, with room for every row. A destination that received nothing
    launches nothing (None). The row count goes to each card as a device
    fill, not a copy from the host, which would wait for that card's sort
    and so run the destinations' merges one after another."""
    return [_sort_and_finalize(
                cols, torch.full((), n, dtype=torch.int64, device=cols[0].device),
                min_count, n, strip) if n else None
            for cols, n in zip(recv, n_recv)]


def _tables(counter, merged: list, root, n_files: int) -> list[KmerTable]:
    """The destinations' tables, concatenated in shard order (ascending
    key ranges), split per file on the host."""
    k, codec = counter.k, counter.codec
    live = [m for m in merged if m is not None]
    if not live:
        return [KmerTable.empty(k)] * n_files
    n_outs = torch.stack([m[2].to(root) for m in live]).cpu().tolist()
    blocks = [torch.stack([w[:n] for w in words] + [counts[:n]]).cpu().numpy()
              for (words, counts, _), n in zip(live, n_outs) if n]
    total = sum(n_outs)
    if total == 0:
        return [KmerTable.empty(k)] * n_files
    small = list(np.concatenate(blocks, axis=1).view(np.uint32))
    small[-1] = small[-1].view(np.int32)
    mode, shift = ("none", 0) if n_files == 1 else fid_layout(k, codec.bits, n_files)
    return _split_fid_tables(k, codec, small, total, mode, shift, n_files)


#: device bytes a card holds per window of its shards, in units of the
#: window's sort-key bytes: the sorted keys, the segments received, the
#: finalize's output (up to 1.5 key bytes a row) and one shard's sort
#: scratch (values, indices and CUB's double buffers) spread over the rest
_LIVE_COPIES = 4
#: default device-memory budget a card gives a batch's buffers: a fifth
#: of an H100's 80 GB. At k=21 DNA (8 key bytes a window) it holds 512M
#: windows on one card, twice the pipeline's 256M-symbol batches, so the
#: pipeline's batches are never split further there.
_ROUTE_BUDGET = 16 << 30


def _key_bytes(k: int, bits: int, n_files: int) -> int:
    """Sort-key bytes a shard holds per window: one fused int64 column, or
    int32 words plus the int64 split key."""
    cols = _key_columns(k, bits, n_files)
    return 8 if cols == 2 else 4 * cols + 8


def _route_batches(counter, sources: list, devices: list,
                   hbm_budget: int) -> list[list[int]]:
    """Greedy batches of source indices whose buffers fit ``hbm_budget``
    bytes on the card that holds the most shards (see ``_LIVE_COPIES``),
    of at most ``MAX_FILES`` files (the key build's file starts). A
    single oversized file still gets its own batch: per-file min-count
    semantics need every window of a file in one batch."""
    n = len(devices)
    most = max(devices.count(d) for d in devices)
    per_sym = _LIVE_COPIES * _key_bytes(counter.k, counter.codec.bits, len(sources))
    max_content = max(1, hbm_budget * n // (most * per_sym))
    batches: list[list[int]] = []
    cur: list[int] = []
    cur_sym = 0
    for i, s in enumerate(sources):
        length = s.packed_len(_REC_GAP) + _REC_GAP
        if cur and (cur_sym + length > max_content or len(cur) >= MAX_FILES):
            batches.append(cur)
            cur, cur_sym = [], 0
        cur.append(i)
        cur_sym += length
    if cur:
        batches.append(cur)
    return batches


def sharded_count_sources(counter, sources: list, min_count: int,
                          devices: list | None = None, *,
                          hbm_budget: int = _ROUTE_BUDGET,
                          stats: dict | None = None) -> list[KmerTable]:
    """Count several files across ``devices`` (default: every CUDA card)
    from packed-transport sources: one exact, per-file min-count-filtered,
    lexicographically sorted KmerTable per source, the tables the single
    device counter gives.

    ``counter`` gives k and the codec (any width 1-8: the port packs them
    all). Files are batched so that each batch's buffers fit
    ``hbm_budget`` bytes a card (:func:`_route_batches`); files stay whole
    within a batch. ``stats``, when given, receives ``n_devices``,
    ``batches`` and, per batch, the rows each shard received
    (``rows_received``).
    """
    n_files = len(sources)
    if n_files == 0:
        return []
    devices = flat_mesh() if devices is None else flat_mesh(devices=devices)
    batches = _route_batches(counter, sources, devices, hbm_budget)
    result: list = [None] * n_files
    received = []
    for b in batches:
        tables, n_recv = _count_batch(counter, [sources[i] for i in b], min_count,
                                      devices)
        received.append(n_recv)
        for row, i in enumerate(b):
            result[i] = tables[row]
    if stats is not None:
        stats.update(n_devices=len(devices), batches=len(batches),
                     rows_received=received)
    return result


def _count_batch(counter, sources: list, min_count: int, devices: list):
    """One batch of :func:`sharded_count_sources`: (tables, rows received
    per shard)."""
    k, bits = counter.k, counter.codec.bits
    n_files = len(sources)
    group = build_packed_group(k, counter.codec, sources)
    if group is None:
        return [KmerTable.empty(k)] * n_files, [0] * len(devices)
    shards = _presort(counter, group, devices, n_files)
    recv, n_recv = _exchange(shards, devices)
    del shards  # the sorted keys are copied out; free them before the merge
    _, tiebreak = key_words_for(k, bits)
    strip = int(tiebreak) if n_files == 1 else 0
    merged = _merge(recv, n_recv, min_count, strip)
    del recv
    return _tables(counter, merged, devices[0], n_files), n_recv


def _stream_source(stream: np.ndarray, codec) -> NumpySource:
    """A uint8 code stream as a packed-transport source: codes >= the
    codec's size separate records, so every window that holds one is
    closed, as the stream's own validity has it."""
    s = np.asarray(stream, np.uint8)
    sep = s >= codec.size
    return NumpySource(codec.symbols[s[~sep]], np.cumsum(sep)[~sep], codec)


def sharded_count_streams(counter, streams: list, min_count: int,
                          devices: list | None = None, *,
                          stats: dict | None = None) -> list[KmerTable]:
    """Count several files' uint8 code streams across ``devices``; one
    exact, min-count-filtered, lexicographically sorted KmerTable per file.

    The mesh-parallel equivalent of the single-device count of each stream
    (per-file filter semantics, MerCat2's lib/mercat2_kmers.py:73-76). The
    port packs every codec width, so the streams are packed into sources
    (:func:`_stream_source`) and take :func:`sharded_count_sources`.
    ``streams`` are raw code streams (sentinel padding is fine).
    """
    sources = [_stream_source(s, counter.codec) for s in streams]
    return sharded_count_sources(counter, sources, min_count, devices, stats=stats)
