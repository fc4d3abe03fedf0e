"""Host half of the count engine: transport buffers, tables, decode.

Copied from ``mercat2_tpu.engine.counter`` with numpy kept as it is, so
that both packages lay out transport buffers and decode tables the same
way. ``mercat2_tpu.engine.counter`` imports JAX at module level, which
is why the port owns these copies. The ``KmerCounter`` methods
``source_for`` and ``build_packed_group`` become functions of
``(k, codec)`` here, and ``build_packed_group`` sizes each buffer to its
content instead of to a compiled shape. ``_count_host`` is the JAX
package's exact numpy path for k above the key-build kernel's bound.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from mercat2_tpu_torch.engine.codec import Codec

__all__ = [
    "KmerTable", "NumpySource", "PackedGroup", "build_packed_group",
    "count_file_host", "merge_tables", "pack_codes_into", "source_for",
]

#: symbols between consecutive records in the packed transport. One is
#: enough: validity comes from gap *ranges* widened by k-1 on the device
#: (ops.finalize.packed_window_validity), not from sentinel codes.
_REC_GAP = 1

_MIN_BUCKET = 1 << 16


def _bucket_size(n: int) -> int:
    """Round up to eighth-power-of-two granularity (<= 12.5% padding)."""
    if n <= _MIN_BUCKET:
        return _MIN_BUCKET
    e = (n - 1).bit_length()  # 2**e >= n
    step = 1 << (e - 3)
    return -(-n // step) * step


@dataclasses.dataclass
class KmerTable:
    """Sorted (k-mer, count) table.

    kmers: uint8[M, k] — ASCII bytes of each k-mer, lexicographically sorted.
    counts: int64[M].
    """

    kmers: np.ndarray
    counts: np.ndarray

    @property
    def k(self) -> int:
        return int(self.kmers.shape[1]) if self.kmers.ndim == 2 else 0

    def __len__(self) -> int:
        return int(self.counts.shape[0])

    def kmer_strings(self) -> list[str]:
        k = self.k
        flat = self.kmers.tobytes()
        return [flat[i * k : (i + 1) * k].decode("latin-1") for i in range(len(self))]

    def to_dict(self) -> dict[str, int]:
        return dict(zip(self.kmer_strings(), (int(c) for c in self.counts)))

    @staticmethod
    def empty(k: int) -> "KmerTable":
        return KmerTable(np.zeros((0, k), np.uint8), np.zeros(0, np.int64))


def _decode_payload(words: np.ndarray, k: int, bits: int, codec: Codec) -> np.ndarray:
    """uint32[M, payload] big-endian packed keys -> uint8[M, k] ASCII bytes."""
    m, payload = words.shape
    mask = np.uint32((1 << bits) - 1)
    out = np.empty((m, k), dtype=np.uint8)
    for j in range(k):
        bitpos = bits * (k - 1 - j)  # from LSB of the whole payload
        col = payload - 1 - bitpos // 32
        off = bitpos % 32
        sym = words[:, col] >> np.uint32(off)
        spill = off + bits - 32
        if spill > 0:
            sym = sym | (
                (words[:, col - 1] & np.uint32((1 << spill) - 1))
                << np.uint32(32 - off)
            )
        out[:, j] = (sym & mask).astype(np.uint8)
    return codec.symbols[out]


def _drop_short_records(seq: np.ndarray, rec: np.ndarray, k: int):
    """Remove records shorter than k (they yield no windows)."""
    if seq.shape[0] == 0 or k <= 1:
        return seq, rec
    # rec is non-decreasing; record boundaries are change points
    boundary = np.empty(rec.shape[0], dtype=bool)
    boundary[0] = True
    np.not_equal(rec[1:], rec[:-1], out=boundary[1:])
    starts = np.flatnonzero(boundary)
    lens = np.diff(np.append(starts, rec.shape[0]))
    if lens.min() >= k:
        return seq, rec
    keep_rec = lens >= k
    keep = np.repeat(keep_rec, lens)
    return seq[keep], rec[keep]


def _count_host(seq: np.ndarray, rec: np.ndarray, k: int, min_count: int) -> KmerTable:
    """Exact host count for k above the key-build kernel's bound
    (vectorized numpy; ``mercat2_tpu.engine.counter._count_host``)."""
    from numpy.lib.stride_tricks import sliding_window_view

    p = seq.shape[0] - k + 1
    windows = sliding_window_view(seq, k)
    valid = rec[: p] == rec[k - 1 :]
    rows = np.ascontiguousarray(windows[valid])
    if rows.shape[0] == 0:
        return KmerTable.empty(k)
    void = rows.view([("", np.uint8)] * k).ravel()
    uniq, counts = np.unique(void, return_counts=True)
    if min_count > 1:
        keepm = counts >= min_count
        uniq, counts = uniq[keepm], counts[keepm]
    kmers = uniq.view(np.uint8).reshape(-1, k)
    return KmerTable(kmers, counts.astype(np.int64))


def count_file_host(path, k: int, min_count: int) -> KmerTable:
    """One file's table by :func:`_count_host`, after dropping records
    shorter than k (``KmerCounter.count`` of the JAX package for k > 256)."""
    from mercat2_tpu_torch.io.fasta import parse_fasta_seq

    seq, rec = _drop_short_records(*parse_fasta_seq(path), k)
    if seq.shape[0] < k:
        return KmerTable.empty(k)
    return _count_host(seq, rec, k, min_count)


def _sorted_table(k: int, codec: Codec, cols: list[np.ndarray],
                  counts: np.ndarray, n_out: int) -> KmerTable:
    """Host decode of fetched (already compacted) sorted key columns."""
    if n_out == 0:
        return KmerTable.empty(k)
    packed = np.stack([col[:n_out] for col in cols], axis=1)
    kmers = _decode_payload(packed, k, codec.bits, codec)
    return KmerTable(kmers, counts[:n_out].astype(np.int64))


def _split_fid_tables(k: int, codec: Codec, small, n_out: int, mode: str,
                      shift: int, n_files: int) -> list[KmerTable]:
    """Fetched uint32 (words..., counts) columns -> per-file sorted tables.

    Rows are sorted by (fid, key); the fid lives in the top bits of word 0
    ("embedded"), in a dedicated leading word ("word"), or nowhere ("none",
    single file)."""
    if mode == "embedded":
        fids = (small[0][:n_out] >> np.uint32(shift)).astype(np.int64)
        cols = [np.ascontiguousarray(w[:n_out]) for w in small[:-1]]
        cols[0] = cols[0] & np.uint32((1 << shift) - 1)
    elif mode == "word":
        fids = small[0][:n_out].astype(np.int64)
        cols = [np.ascontiguousarray(w[:n_out]) for w in small[1:-1]]
    else:  # "none": single file, no fid anywhere
        fids = np.zeros(n_out, np.int64)
        cols = [np.ascontiguousarray(w[:n_out]) for w in small[:-1]]
    cnts = small[-1][:n_out]
    bounds = np.searchsorted(fids, np.arange(n_files + 1))
    return [
        _sorted_table(
            k, codec, [col[bounds[f] : bounds[f + 1]] for col in cols],
            cnts[bounds[f] : bounds[f + 1]],
            int(bounds[f + 1] - bounds[f]),
        )
        for f in range(n_files)
    ]


def _split_dense_tables(k: int, codec: Codec, bins: np.ndarray,
                        counts: np.ndarray, n_files: int) -> list[KmerTable]:
    """Fetched surviving bins of a dense launch (``fid * S**k`` + the
    base-S window value, ascending) -> per-file sorted tables; the decode
    of ``decode_dense_histogram`` (mercat2_tpu/ops/mxu_hist.py:142-158)."""
    s = codec.size
    n_bins = s**k
    vals = bins.astype(np.int64)
    bounds = np.searchsorted(vals // n_bins, np.arange(n_files + 1))
    vals %= n_bins
    kmers = np.empty((vals.size, k), np.uint8)
    for j in range(k - 1, -1, -1):
        kmers[:, j] = codec.symbols[vals % s]
        vals //= s
    counts = counts.astype(np.int64)
    return [KmerTable(kmers[a:b], counts[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


class NumpySource:
    """Packed-transport source backed by host numpy arrays.

    Mirrors the NativeFasta packed interface (packed_len / gap_ranges /
    fill_packed) for files parsed without the C++ library, and for tests.
    """

    def __init__(self, seq: np.ndarray, rec: np.ndarray, codec: Codec):
        self._codec = codec
        if seq.shape[0]:
            # drop empty records by construction: rec deltas > 1 mean empty
            # records between; gap scales with the delta like the C++ side
            boundary = np.empty(rec.shape[0], dtype=bool)
            boundary[0] = True
            np.not_equal(rec[1:], rec[:-1], out=boundary[1:])
            starts = np.flatnonzero(boundary)
            self._lens = np.diff(np.append(starts, rec.shape[0]))
            self._deltas = np.diff(rec[starts]).astype(np.int64)  # per gap
        else:
            self._lens = np.zeros(0, np.int64)
            self._deltas = np.zeros(0, np.int64)
        self._codes = codec.encode(seq)

    def packed_len(self, gap: int) -> int:
        if self._lens.size == 0:
            return 0
        return int(self._codes.shape[0] + self._deltas.sum() * gap)

    def gap_ranges(self, gap: int) -> tuple[np.ndarray, np.ndarray]:
        if self._lens.size <= 1:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        gaps = self._deltas * gap
        ends_of_rec = np.cumsum(self._lens[:-1] + gaps) - gaps
        return ends_of_rec, ends_of_rec + gaps

    def gapped_codes(self, gap: int) -> np.ndarray:
        """uint8 code stream with `gap*delta` zero symbols between records."""
        total = self.packed_len(gap)
        out = np.zeros(total, np.uint8)
        if self._lens.size == 0:
            return out
        gaps = self._deltas * gap
        starts = np.concatenate(
            [[0], np.cumsum(self._lens[:-1] + gaps)]
        ).astype(np.int64)
        src = 0
        for s, ln in zip(starts, self._lens):
            out[s : s + ln] = self._codes[src : src + ln]
            src += ln
        return out

    def fill_packed(self, bits: int, gap: int, lut256_unused, words: np.ndarray,
                    sym_off: int) -> int:
        codes = self.gapped_codes(gap)
        pack_codes_into(codes, words, sym_off, bits)
        return codes.shape[0]

    def close(self) -> None:
        pass


def pack_codes_into(codes: np.ndarray, words: np.ndarray, sym_off: int,
                    bits: int) -> None:
    """Big-endian bit-pack uint8 codes into a zeroed uint32 word buffer at
    symbol offset ``sym_off`` (must be a multiple of 32//bits)."""
    per = 32 // bits
    assert sym_off % per == 0
    n = codes.shape[0]
    if n == 0:
        return
    w0 = sym_off // per
    nw = -(-n // per)
    mat = np.zeros((nw, per), np.uint32)
    mat.reshape(-1)[:n] = codes
    shifts = (32 - bits * (np.arange(per) + 1)).astype(np.uint32)
    np.bitwise_or.reduce(mat << shifts, axis=1, out=words[w0 : w0 + nw])


@dataclasses.dataclass
class PackedGroup:
    """Host-assembled transport buffer for one multi-file device launch."""

    words: np.ndarray        # uint32[n_sym // per], big-endian packed codes
    n_sym: int               # symbol count, whole words
    file_starts: np.ndarray  # int32[n_files], symbol offset of each file
    gap_begin: np.ndarray    # int32[G], half-open no-window symbol ranges
    gap_end: np.ndarray      # (record gaps, inter-file gaps, tail padding)


def source_for(path, codec: Codec, nf=None):
    """Packed-transport source for one file: native handle or numpy."""
    if nf is not None:
        return nf
    from mercat2_tpu_torch.io.native import open_fasta_native

    try:
        nf = open_fasta_native(path)
    except OSError:
        nf = None
    if nf is not None:
        return nf
    from mercat2_tpu_torch.io.fasta import parse_fasta_seq

    seq, rec = parse_fasta_seq(path)
    return NumpySource(seq, rec, codec)


def build_packed_group(k: int, codec: Codec, sources: list,
                       workers: int | None = None) -> PackedGroup | None:
    """Assemble one transport buffer for several files.

    File segments are word-aligned (so the native fillers write disjoint
    uint32s and can run in parallel threads) and separated by >= 1 gap
    symbol; record gaps, inter-file gaps and the tail up to the word
    boundary all become gap ranges for the device-side validity mask.
    Returns None when no file contributes a window. Unlike the JAX
    package, which pads every buffer and gap array to one of a few
    compiled shapes, the buffer holds exactly its content.
    """
    per = 32 // codec.bits
    gap = _REC_GAP
    lens = [s.packed_len(gap) for s in sources]
    offs: list[int] = []
    inter: list[tuple[int, int]] = []
    off = 0
    for i, length in enumerate(lens):
        offs.append(off)
        end = off + length
        if i < len(lens) - 1:
            noff = -(-(end + 1) // per) * per  # >=1 gap symbol, aligned
            inter.append((end, noff))
            off = noff
        else:
            off = end
    total = off
    if total < k:
        return None
    size = -(-total // per) * per  # whole words
    words = np.zeros(size // per, np.uint32)
    lut = codec.lut_encode()

    def fill(i: int) -> None:
        sources[i].fill_packed(codec.bits, gap, lut, words, offs[i])

    if len(sources) > 1 and workers != 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(fill, range(len(sources))))
    else:
        for i in range(len(sources)):
            fill(i)

    gb: list[np.ndarray] = []
    ge: list[np.ndarray] = []
    for i, s in enumerate(sources):
        b, e = s.gap_ranges(gap)
        gb.append(np.asarray(b, np.int64) + offs[i])
        ge.append(np.asarray(e, np.int64) + offs[i])
    if inter:
        b, e = zip(*inter)
        gb.append(np.asarray(b, np.int64))
        ge.append(np.asarray(e, np.int64))
    gb.append(np.asarray([total], np.int64))
    ge.append(np.asarray([size], np.int64))
    return PackedGroup(
        words=words,
        n_sym=size,
        file_starts=np.asarray(offs, np.int32),
        gap_begin=np.concatenate(gb).astype(np.int32),
        gap_end=np.concatenate(ge).astype(np.int32),
    )


def merge_tables(tables: list[KmerTable], k: int) -> KmerTable:
    """Sum counts of already-filtered per-file tables (host-side reduce).

    Mirrors MerCat2's dict merge (bin/mercat2.py:121-127): the min-count
    filter has already been applied per file, so this is a plain sorted
    multiway sum.
    """
    tables = [t for t in tables if len(t)]
    if not tables:
        return KmerTable.empty(k)
    if len(tables) == 1:
        return tables[0]
    allk = np.concatenate([t.kmers for t in tables], axis=0)
    allc = np.concatenate([t.counts for t in tables], axis=0)
    # lexicographic sort of the byte rows: view as void records
    void = np.ascontiguousarray(allk).view([("", np.uint8)] * k).ravel()
    order = np.argsort(void, kind="stable")
    allk, allc = allk[order], allc[order]
    void = void[order]
    change = np.empty(len(void), dtype=bool)
    change[0] = True
    change[1:] = void[1:] != void[:-1]
    starts = np.flatnonzero(change)
    sums = np.add.reduceat(allc, starts)
    return KmerTable(allk[starts], sums.astype(np.int64))
