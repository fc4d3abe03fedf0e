"""The port's CUDA kernels against their plain twins, and the routing of
the kernel wrappers. Imports no JAX, so that it runs on a machine with a
card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The tests marked ``cuda`` skip without a card; the routing tests run
anywhere. The helpers here are shared with tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from mercat2_tpu_torch.engine.codec import DNA_CODEC
from mercat2_tpu_torch.engine.counter import KmerCounter, fetch_tables
from mercat2_tpu_torch.engine.host import NumpySource
from mercat2_tpu_torch.ops import _build
from mercat2_tpu_torch.ops.build_keys import build_keys, build_keys_plain
from mercat2_tpu_torch.ops.dense_hist import count_kmers_dense
from mercat2_tpu_torch.ops.finalize import (
    count_kmers_packed, fid_layout, fuse_u64, split_u64,
)
from mercat2_tpu_torch.ops.kmer_pack import key_words_for
from mercat2_tpu_torch.ops.finalize_kernel import (
    finalize_sorted, finalize_sorted_plain,
)

ONES = np.uint32(0xFFFFFFFF)
#: the invalid marker of a fused key column: all-ones, sign bit flipped
MARK64 = (1 << 63) - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def counters():
    """Launch counters reset to 0 for the test, restored after."""
    saved = build_keys.launches, finalize_sorted.launches
    build_keys.launches = finalize_sorted.launches = 0
    yield
    build_keys.launches, finalize_sorted.launches = saved


def i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def sorted_columns(rng, p, n_words, n_valid, max_run):
    """Sorted uint32 key columns in runs of 1..max_run rows, all-ones tail
    (the generator of tests/test_pallas_kernels.py)."""
    n_runs = max(1, n_valid // max(1, (max_run // 2)))
    lens = rng.integers(1, max_run + 1, size=n_runs)
    while lens.sum() < n_valid:
        lens = np.concatenate([lens, rng.integers(1, max_run + 1, size=8)])
    csum = np.cumsum(lens)
    n_runs = int(np.searchsorted(csum, n_valid) + 1)
    lens = lens[:n_runs]
    lens[-1] -= csum[n_runs - 1] - n_valid
    lens = lens[lens > 0]
    keys = np.sort(rng.choice(np.arange(0, 1 << 20, dtype=np.uint64), len(lens),
                              replace=False))
    cols = []
    for w in range(n_words):
        col = ((keys >> (10 * (n_words - 1 - w))) & 0x3FF).astype(np.uint32)
        cols.append(np.concatenate([np.repeat(col, lens),
                                    np.full(p - n_valid, ONES, np.uint32)]))
    return cols


def key_columns(cols) -> tuple:
    """Key-build columns as int32 key words: a fused int64 column split
    back into its two words."""
    if len(cols) == 1 and cols[0].dtype == torch.int64:
        return split_u64(cols[0])
    return tuple(cols)


def assert_same_keys(got, want):
    """Two ``build_keys`` results (columns, n_valid) are identical."""
    (gc, gn), (wc, wn) = got, want
    assert int(gn) == int(wn)
    assert len(gc) == len(wc)
    for g, t in zip(gc, wc):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert torch.equal(g.cpu(), t.cpu())


def file_starts(rng, n_sym, n_real):
    """32 sorted file starts as a launch pads them: ``n_real`` files from 0
    on (two of them empty), the rest at ``n_sym``."""
    starts = np.full(32, n_sym, np.int32)
    inner = np.sort(rng.choice(np.arange(1, n_sym), n_real - 2, replace=False))
    starts[:n_real] = np.concatenate([[0], inner[:1], inner]).astype(np.int32)
    return starts


def packed_stream(rng, k, bits, n):
    """Random codes packed into big-endian words, and 90%-valid windows."""
    per = 32 // bits
    n = -(-n // per) * per
    codes = rng.integers(0, 1 << bits, size=n).astype(np.uint32)
    shifts = (32 - bits * (np.arange(per) + 1)).astype(np.uint32)
    words = np.bitwise_or.reduce(codes.reshape(-1, per) << shifts, axis=1)
    p = n - k + 1
    return words, rng.random(p) < 0.9, p


# -- routing: CPU tensors take the twin, anything else the kernel ---------------


def test_cpu_tensors_leave_launch_counters_at_zero(counters):
    rng = np.random.default_rng(0)
    words, valid, p = packed_stream(rng, 21, 2, 4000)
    (col,), _ = build_keys(i32(words), torch.from_numpy(valid), k=21, bits=2, p=p)
    s = torch.sort(col).values
    finalize_sorted((s,), torch.tensor(p), min_count=1, cap=64)
    gb = torch.tensor([100, 4000], dtype=torch.int32)
    count_kmers_packed(i32(words), gb, gb + 3, torch.zeros(1, dtype=torch.int32),
                       2, k=21, bits=2, cap=64, n_files=1, n_sym=words.shape[0] * 16)
    assert build_keys.launches == 0 and finalize_sorted.launches == 0


def test_non_cpu_tensors_never_take_the_twin(monkeypatch, counters):
    """A tensor off the CPU goes to the kernel or raises: when the kernel
    library cannot be had, the wrappers raise instead of computing."""
    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "load_library", no_library)
    words = torch.empty(64, dtype=torch.int32, device="meta")
    valid = torch.empty(1000, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="unavailable"):
        build_keys(words, valid, k=21, bits=2, p=1000)
    with pytest.raises(ValueError):  # outside the kernel's range: no twin
        build_keys(words, valid, k=257, bits=2, p=1000)
    s = torch.empty(1000, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="unavailable"):
        finalize_sorted((s,), torch.empty((), dtype=torch.int64, device="meta"),
                        min_count=2, cap=64)
    assert build_keys.launches == 0 and finalize_sorted.launches == 0


# -- the CUDA kernels against their twins (card only) ------------------------------


#: bits that do not divide 32 (3-bit soft-masked DNA, 5-bit protein, 6-bit
#: mixed-case protein, 7-bit printable bytes) at every k of interest; n is
#: chosen so that p is not a multiple of the kernel's 256-thread block
SPLIT_CASES = [(k, bits, 20011) for bits in (3, 5, 6, 7)
               for k in (1, 5, 6, 21, 130, 256)]
#: 8 bits: codes >= 128 set bit 31 of a word; k=4 fills one word exactly
#: (the tie-break word)
WIDE_CASES = [(k, 8, 20011) for k in (1, 3, 4, 5, 21, 130, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,bits,n", [
    (21, 2, 50000), (16, 2, 20000), (5, 2, 4000), (31, 2, 40000), (7, 4, 9000),
    (129, 2, 30000), (2, 1, 9000), (64, 4, 30000), (32, 1, 9000),
    (1, 2, 9000), (256, 4, 30000), *SPLIT_CASES, *WIDE_CASES,
])
def test_build_keys_kernel_matches_twin(cuda, counters, k, bits, n):
    rng = np.random.default_rng(k + bits)
    words, valid, p = packed_stream(rng, k, bits, n)
    if p % 256 == 0:
        raise AssertionError("p is a multiple of the block size")
    valid[: min(p, 700)] = False  # whole blocks of invalid windows
    w, v = i32(words).to(cuda), torch.from_numpy(valid).to(cuda)
    got = build_keys(w, v, k=k, bits=bits, p=p)
    want = build_keys_plain(w, v, k=k, bits=bits, p=p)
    torch.cuda.synchronize()
    assert build_keys.launches == 1
    assert_same_keys(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 5, 6, 7, 8])
def test_build_keys_kernel_all_invalid(cuda, counters, bits):
    """Every window invalid: every key word all-ones, as the twin has it."""
    rng = np.random.default_rng(bits)
    words, _, p = packed_stream(rng, 21, bits, 5003)
    w = i32(words).to(cuda)
    v = torch.zeros(p, dtype=torch.bool, device=cuda)
    got = build_keys(w, v, k=21, bits=bits, p=p)
    want = build_keys_plain(w, v, k=21, bits=bits, p=p)
    assert build_keys.launches == 1
    assert_same_keys(got, want)
    assert int(got[1]) == 0
    for g in got[0]:
        assert bool((g == (MARK64 if g.dtype == torch.int64 else -1)).all())


#: every width at a k whose key fills one word and the next in part (two
#: columns: fused), at one that fills one word (the tie-break word, or the
#: fid word at 32 files: fused), and at k=130 (many int32 columns)
FID_CASES = [(k, bits, n_files) for bits in range(1, 9) for n_files in (1, 32)
             for k in (32 // bits, 40 // bits + 1, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,bits,n_files", FID_CASES)
def test_build_keys_kernel_fid_fused_matches_twin(cuda, counters, k, bits, n_files):
    """The fid tag (embedded and the leading word), the fused column and
    the valid count, at 1 and 32 files, against the twin."""
    rng = np.random.default_rng(1000 * bits + k + n_files)
    words, valid, p = packed_stream(rng, k, bits, 20011)
    starts = file_starts(rng, p, 7) if n_files > 1 else np.zeros(1, np.int32)
    args = (i32(words).to(cuda), torch.from_numpy(valid).to(cuda),
            torch.from_numpy(starts).to(cuda))
    kw = dict(k=k, bits=bits, p=p, n_files=n_files)
    got = build_keys(*args, **kw)
    want = build_keys_plain(*args, **kw)
    assert build_keys.launches == 1
    assert_same_keys(got, want)
    total, tiebreak = key_words_for(k, bits)
    n_cols = total
    if n_files > 1 and fid_layout(k, bits, n_files)[0] == "word":
        n_cols = total - int(tiebreak) + 1
    assert (got[0][0].dtype == torch.int64) == (n_cols == 2)


@pytest.mark.cuda
def test_build_keys_kernel_refuses_other_widths(cuda):
    w = torch.zeros(4096, dtype=torch.int32, device=cuda)
    v = torch.ones(4096 * 32, dtype=torch.bool, device=cuda)
    for k, bits in [(21, 9), (0, 2), (257, 2), (300, 5)]:
        with pytest.raises(ValueError):
            build_keys(w, v, k=k, bits=bits, p=4096 * (32 // bits) - k + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n_valid,n_words,min_count,max_run,cap", [
    (1000, 900, 2, 3, 40, 4096),
    (1000, 1000, 1, 1, 30, 4096),
    (20000, 17000, 3, 10, 400, 4096),
    (16401, 16401, 2, 2, 1200, 4096),
    (5000, 0, 2, 2, 4, 64),
    (30000, 29000, 2, 2, 6, 20000),
    (30000, 30000, 1, 1, 3, 40000),
    (20000, 19000, 3, 3, 5, 1000),   # n_out > cap
    (9000, 8999, 2, 9000, 50, 64),   # min_count beyond every run
])
def test_finalize_kernel_matches_twin(cuda, counters, p, n_valid, n_words,
                                      min_count, max_run, cap):
    rng = np.random.default_rng(p + n_words)
    cols = tuple(i32(c).to(cuda) for c in sorted_columns(rng, p, n_words, n_valid, max_run))
    nv = torch.tensor(n_valid, device=cuda)
    forms = [cols]
    if n_words == 2:  # the fused int64 form of the same keys
        forms.append((torch.sort(fuse_u64(list(cols))).values,))
    for form in forms:
        got = finalize_sorted(form, nv, min_count=min_count, cap=cap)
        want = finalize_sorted_plain(form, nv, min_count=min_count, cap=cap)
        torch.cuda.synchronize()
        assert int(got[2]) == int(want[2])
        for g, t in zip(got[0] + (got[1],), want[0] + (want[1],), strict=True):
            assert torch.equal(g, t)
    assert finalize_sorted.launches == len(forms)


#: rows of a finalize tile of the fused column (csrc/finalize.cu); word
#: columns take this many or a power-of-two fraction, so its multiples are
#: tile edges in every form
FIN_TILE = 4096


def edge_columns(rng, p, m, n_words):
    """Sorted keys in runs of 1..2m+4 rows, one run of 1.5 tiles across a
    tile edge, and n_valid inside a run; ``n_words`` 0 gives one fused
    int64 column (invalid rows MARK64), else that many int32 word columns
    (invalid rows all-ones). Returns (columns, n_valid)."""
    is_start = np.zeros(p, bool)
    is_start[np.cumsum(rng.integers(1, 2 * m + 5, size=p))[:p // 2].clip(max=p - 1)] = True
    is_start[0] = True
    long0 = FIN_TILE + 2000  # rows [long0, long0 + 6144) one run
    is_start[long0 + 1 : long0 + 6144] = False
    is_start[long0] = is_start[long0 + 6144] = True
    run = np.cumsum(is_start) - 1
    begins = np.flatnonzero(is_start)
    lens = np.diff(np.append(begins, p))
    inside = begins[(lens >= 4) & (begins > p - FIN_TILE)]
    n_valid = int(inside[0]) + 2  # cuts that run after 2 rows
    crosses = [e for e in range(FIN_TILE, p, FIN_TILE)
               if run[e - 1] == run[e] and lens[run[e]] >= max(m, 2)]
    assert crosses, "no surviving run crosses a tile edge"
    key = (run.astype(np.int64) * 3 + 1)
    if n_words == 0:
        key[n_valid:] = MARK64
        return (torch.from_numpy(key),), n_valid
    width = -(-20 // n_words)
    cols = [((key >> (width * (n_words - 1 - c))) & ((1 << width) - 1)).astype(np.uint32)
            for c in range(n_words)]
    for col in cols:
        col[n_valid:] = ONES
    return tuple(i32(col) for col in cols), n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1 << 20, 7])
@pytest.mark.parametrize("n_words", [0, 1, 3, 4])
@pytest.mark.parametrize("m", [1, 10, 100])
def test_finalize_kernel_tile_edges(cuda, counters, m, n_words, cap):
    """Runs across tile edges, a run longer than a tile, n_valid inside a
    run, m = 1 and m beyond the stage's halo (64 rows), cap below n_out,
    in the fused form and word mode with 1, 3 and 4 columns."""
    rng = np.random.default_rng(10 * m + n_words)
    p = 5 * FIN_TILE + 123
    cols, n_valid = edge_columns(rng, p, m, n_words)
    cols = tuple(c.to(cuda) for c in cols)
    nv = torch.tensor(n_valid, device=cuda)
    got = finalize_sorted(cols, nv, min_count=m, cap=cap)
    want = finalize_sorted_plain(cols, nv, min_count=m, cap=cap)
    torch.cuda.synchronize()
    assert finalize_sorted.launches == 1
    assert int(got[2]) == int(want[2]) > (cap if cap < p else 0)
    for g, t in zip(got[0] + (got[1],), want[0] + (want[1],), strict=True):
        assert torch.equal(g, t)


@pytest.mark.cuda
def test_finalize_kernel_long_run(cuda, counters):
    """One run of 3M rows (a poly-A 21-mer): counted by the galloping
    search, exactly."""
    p = 3 << 20
    s = torch.full((p,), 77, dtype=torch.int64, device=cuda)
    s[-5:] = -1
    nv = torch.tensor(p - 5, device=cuda)
    (keys,), counts, n_out = finalize_sorted((s,), nv, min_count=10, cap=4)
    assert int(n_out) == 1
    assert keys.tolist() == [77, -1, -1, -1]
    assert counts.tolist() == [p - 5, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("n_files", [1, 32])
@pytest.mark.parametrize("k", [5, 16, 21, 31, 33])
def test_count_kmers_packed_cuda_matches_cpu(cuda, counters, k, n_files):
    rng = np.random.default_rng(k + n_files)
    words, _, _ = packed_stream(rng, k, 2, 200_000)
    words[500:1500] = words[2000:3000]  # a repeated stretch
    n_sym = words.shape[0] * 16
    gb = np.sort(rng.integers(0, n_sym, size=40)).astype(np.int32)
    starts = np.full(n_files, n_sym, np.int32)
    starts[: min(n_files, 4)] = np.arange(min(n_files, 4)) * (n_sym // 4)
    args = [i32(words), torch.from_numpy(gb), torch.from_numpy(gb + 2),
            torch.from_numpy(starts)]
    kw = dict(k=k, bits=2, cap=1 << 12, n_files=n_files, n_sym=n_sym)
    want = count_kmers_packed(*args, 2, **kw)
    got = count_kmers_packed(*[a.to(cuda) for a in args], 2, **kw)
    assert build_keys.launches == finalize_sorted.launches == 1
    assert int(got[2]) == int(want[2]) > 0
    for g, t in zip(got[0] + [got[1]], want[0] + [want[1]], strict=True):
        assert torch.equal(g.cpu(), t)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 6, 21])  # fid embedded, word, embedded
def test_count_kmers_packed_protein_cuda_matches_cpu(cuda, counters, k):
    """One launch of 32 files at bits 5 (6 symbols a word): the card's
    table is the CPU's in both fid modes."""
    rng = np.random.default_rng(k)
    words, _, _ = packed_stream(rng, k, 5, 120_000)
    words[1900:2150] = words[2200:2450]  # a repeat inside file 3
    n_sym = words.shape[0] * 6
    gb = np.sort(rng.integers(0, n_sym, size=40)).astype(np.int32)
    starts = (np.arange(32) * (n_sym // 32)).astype(np.int32)
    args = [i32(words), torch.from_numpy(gb), torch.from_numpy(gb + 2),
            torch.from_numpy(starts)]
    kw = dict(k=k, bits=5, cap=1 << 12, n_files=32, n_sym=n_sym)
    want = count_kmers_packed(*args, 2, **kw)
    got = count_kmers_packed(*[a.to(cuda) for a in args], 2, **kw)
    assert build_keys.launches == finalize_sorted.launches == 1
    assert int(got[2]) == int(want[2]) > 0
    for g, t in zip(got[0] + [got[1]], want[0] + [want[1]], strict=True):
        assert torch.equal(g.cpu(), t)


@pytest.mark.cuda
def test_uniform_dispatch_cuda_matches_cpu(cuda, counters, monkeypatch):
    """Several launches, one overflow rerun: the card's tables are the
    CPU's."""
    monkeypatch.setattr(KmerCounter, "_UNIFORM_SYMS", 1 << 16)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_CAP", 256)
    rng = np.random.default_rng(5)
    files = []
    for _ in range(6):
        seq = DNA_CODEC.symbols[rng.integers(0, 4, size=20_000)]
        seq = np.concatenate([seq, seq[:3000], seq[:3000]])
        files.append((seq, np.repeat(np.arange(4), [10_000, 10_000, 3000, 3000])))
    tables = {}
    for dev in (torch.device("cpu"), cuda):
        c = KmerCounter(21, DNA_CODEC, dev)
        tables[dev.type] = fetch_tables(c.dispatch_packed_uniform(
            [NumpySource(s, r, DNA_CODEC) for s, r in files], 3))
    assert build_keys.launches >= 3
    for a, b in zip(tables["cpu"], tables["cuda"], strict=True):
        assert len(a) > 256
        np.testing.assert_array_equal(a.kmers, b.kmers)
        np.testing.assert_array_equal(a.counts, b.counts)


@pytest.mark.cuda
@pytest.mark.parametrize("k,bits", [(3, 7), (21, 7), (3, 8), (4, 8), (21, 8)])
def test_count_kmers_packed_wide_cuda_matches_cpu(cuda, counters, k, bits):
    """One launch of 32 files at 7 and 8 bits (four symbols a word; codes
    >= 128 at 8): the card's table is the CPU's."""
    rng = np.random.default_rng(k + bits)
    words, _, _ = packed_stream(rng, k, bits, 120_000)
    words[1900:2150] = words[2200:2450]  # a repeat inside file 3
    n_sym = words.shape[0] * 4
    gb = np.sort(rng.integers(0, n_sym, size=40)).astype(np.int32)
    starts = (np.arange(32) * (n_sym // 32)).astype(np.int32)
    args = [i32(words), torch.from_numpy(gb), torch.from_numpy(gb + 2),
            torch.from_numpy(starts)]
    kw = dict(k=k, bits=bits, cap=1 << 12, n_files=32, n_sym=n_sym)
    want = count_kmers_packed(*args, 2, **kw)
    got = count_kmers_packed(*[a.to(cuda) for a in args], 2, **kw)
    assert build_keys.launches == finalize_sorted.launches == 1
    assert int(got[2]) == int(want[2]) > 0
    for g, t in zip(got[0] + [got[1]], want[0] + [want[1]], strict=True):
        assert torch.equal(g.cpu(), t)


@pytest.mark.cuda
@pytest.mark.parametrize("min_count", [1, 10])
@pytest.mark.parametrize("n_files", [1, 32])
@pytest.mark.parametrize("k,bits,size", [(1, 2, 4), (5, 2, 4), (7, 2, 4),
                                         (2, 5, 26), (6, 3, 5), (1, 8, 200)])
def test_dense_cuda_matches_cpu(cuda, k, bits, size, n_files, min_count):
    """The dense route on the card against the same ops on the CPU."""
    rng = np.random.default_rng(k * bits + n_files)
    per = 32 // bits
    n_sym = 60_000 // per * per
    codes = rng.integers(0, size, size=n_sym).astype(np.uint32)
    codes[5000:11000] = np.tile(codes[5000:5100], 60)  # >= 10 copies a file
    shifts = (32 - bits * (np.arange(per) + 1)).astype(np.uint32)
    words = np.bitwise_or.reduce(codes.reshape(-1, per) << shifts, axis=1)
    gb = np.sort(rng.integers(0, n_sym, size=40)).astype(np.int32)
    starts = (np.arange(n_files) * (n_sym // n_files)).astype(np.int32)
    args = [i32(words), torch.from_numpy(gb), torch.from_numpy(gb + 2),
            torch.from_numpy(starts)]
    kw = dict(k=k, bits=bits, alphabet_size=size, n_files=n_files, n_sym=n_sym)
    want = count_kmers_dense(*args, min_count, **kw)
    before = count_kmers_dense.launches
    got = count_kmers_dense(*[a.to(cuda) for a in args], min_count, **kw)
    assert count_kmers_dense.launches == before + 1
    assert int(got[2]) == int(want[2]) > 0
    for g, t in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), t)


@pytest.mark.cuda
def test_uniform_dispatch_dense_cuda_matches_cpu(cuda, monkeypatch):
    """The dense route through the counter (k=5, DNA), several launches:
    the card's tables are the CPU's, and no kernel launched."""
    monkeypatch.setattr(KmerCounter, "_UNIFORM_SYMS", 1 << 16)
    rng = np.random.default_rng(6)
    files = []
    for _ in range(6):
        seq = DNA_CODEC.symbols[rng.integers(0, 4, size=20_000)]
        files.append((seq, np.repeat(np.arange(4), 5000)))
    tables = {}
    saved = build_keys.launches
    for dev in (torch.device("cpu"), cuda):
        c = KmerCounter(5, DNA_CODEC, dev)
        assert c.dense
        tables[dev.type] = fetch_tables(c.dispatch_packed_uniform(
            [NumpySource(s, r, DNA_CODEC) for s, r in files], 10))
    assert build_keys.launches == saved
    for a, b in zip(tables["cpu"], tables["cuda"], strict=True):
        assert len(a) > 100
        np.testing.assert_array_equal(a.kmers, b.kmers)
        np.testing.assert_array_equal(a.counts, b.counts)


@pytest.mark.cuda
def test_debug_run_traces_the_card(cuda, counters, tmp_path):
    """``-debug`` on the card: the ``torch.profiler`` trace holds the CUDA
    kernels' launches and device activity beside the CPU ops."""
    import json

    from mercat2_tpu_torch import cli

    rng = np.random.default_rng(8)
    folder = tmp_path / "in"
    folder.mkdir()
    rep = DNA_CODEC.symbols[rng.integers(0, 4, size=200)].tobytes().decode()
    for f in range(2):
        seq = DNA_CODEC.symbols[rng.integers(0, 4, size=5000)].tobytes().decode()
        (folder / f"s{f}.fna").write_text(f">r{f}\n{seq}\n>rep{f}\n{rep * 4}\n")
    out = tmp_path / "out"
    cli.main(["-k", "21", "-f", str(folder), "-o", str(out), "-c", "2",
              "-device", "cuda", "-debug"])
    assert build_keys.launches > 0 and finalize_sorted.launches > 0
    events = json.loads((out / "torch_trace" / "trace.json").read_text())["traceEvents"]
    cats = {e.get("cat") for e in events}
    assert "cpu_op" in cats and "kernel" in cats, sorted(c for c in cats if c)
    assert (out / "tsv_nucleotide" / "s0_counts.tsv").is_file()


# -- the sharded count on the card (parallel/) --------------------------------------


def mesh_sources(codec, n_files: int, seed: int, n_sym: int = 20_000):
    """(seq, rec) pairs: random symbols in records of 5,000, each file
    with a repeated stretch so that min-count 2 keeps rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_files):
        seq = codec.symbols[rng.integers(0, codec.size, size=n_sym)]
        seq[3000:6000] = seq[9000:12000]
        out.append((seq, (np.arange(n_sym) // 5000).astype(np.int64)))
    return out


def single_device_tables(k, codec, pairs, min_count, dev):
    return fetch_tables(KmerCounter(k, codec, dev).dispatch_packed_uniform(
        [NumpySource(s, r, codec) for s, r in pairs], min_count))


def assert_same_tables(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.kmers, b.kmers)
        np.testing.assert_array_equal(a.counts, b.counts)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 7])
@pytest.mark.parametrize("codec_name", ["dna", "protein"])
def test_sharded_count_cuda_matches_single_device(cuda, counters, codec_name, n):
    """32 files at k=21 over n shards of the card: 2-bit DNA (one fused
    int64 column) and 5-bit protein (4 int32 columns), against the
    single-device kernel path, exact; every shard launches both kernels
    once."""
    from mercat2_tpu_torch.engine.codec import PROTEIN_CODEC
    from mercat2_tpu_torch.parallel import sharded_count_sources

    codec = DNA_CODEC if codec_name == "dna" else PROTEIN_CODEC
    pairs = mesh_sources(codec, 32, seed=n)
    want = single_device_tables(21, codec, pairs, 2, cuda)
    build_keys.launches = finalize_sorted.launches = 0
    stats: dict = {}
    got = sharded_count_sources(KmerCounter(21, codec, cuda),
                                [NumpySource(s, r, codec) for s, r in pairs], 2,
                                [cuda] * n, stats=stats)
    torch.cuda.synchronize()
    assert build_keys.launches == finalize_sorted.launches == n
    assert stats["batches"] == 1 and min(stats["rows_received"][0]) > 0
    assert sum(len(t) for t in got) > 1000
    assert_same_tables(got, want)


@pytest.mark.cuda
def test_sharded_count_cuda_all_keys_equal(cuda, counters):
    """A poly-A file: one key, so one shard receives every row and only it
    runs the finalize; the others launch nothing after the key build."""
    from mercat2_tpu_torch.parallel import sharded_count_sources

    seq = np.full(50_000, ord("A"), np.uint8)
    rec = np.zeros(50_000, np.int64)
    want = single_device_tables(21, DNA_CODEC, [(seq, rec)], 1, cuda)
    build_keys.launches = finalize_sorted.launches = 0
    stats: dict = {}
    got = sharded_count_sources(KmerCounter(21, DNA_CODEC, cuda),
                                [NumpySource(seq, rec, DNA_CODEC)], 1, [cuda] * 4,
                                stats=stats)
    assert build_keys.launches == 4 and finalize_sorted.launches == 1
    assert sorted(stats["rows_received"][0]) == [0, 0, 0, 50_000 - 20]
    assert got[0].counts.tolist() == [50_000 - 20]
    assert_same_tables(got, want)


@pytest.mark.cuda
def test_sharded_count_cuda_shards_without_windows(cuda, counters):
    """Ten windows over 8 shards: one shard owns them all, and only it
    runs the key build; each shard that receives rows runs the finalize."""
    from mercat2_tpu_torch.parallel import sharded_count_sources

    rng = np.random.default_rng(3)
    seq = DNA_CODEC.symbols[rng.integers(0, 4, size=30)]
    rec = np.zeros(30, np.int64)
    want = single_device_tables(21, DNA_CODEC, [(seq, rec)], 1, cuda)
    build_keys.launches = finalize_sorted.launches = 0
    stats: dict = {}
    got = sharded_count_sources(KmerCounter(21, DNA_CODEC, cuda),
                                [NumpySource(seq, rec, DNA_CODEC)], 1, [cuda] * 8,
                                stats=stats)
    rows = stats["rows_received"][0]
    assert sum(rows) == 10 and build_keys.launches == 1
    assert finalize_sorted.launches == sum(r > 0 for r in rows)
    assert len(got[0]) == 10
    assert_same_tables(got, want)


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 or more CUDA cards; this machine shows "
                    f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.cuda
def test_second_card_counts_on_itself(two_cards, counters):
    """The kernels launch on the tensors' card (cuda:1), not the current
    one: the tables are the CPU's."""
    pairs = mesh_sources(DNA_CODEC, 4, seed=11)
    want = single_device_tables(21, DNA_CODEC, pairs, 2, torch.device("cpu"))
    got = single_device_tables(21, DNA_CODEC, pairs, 2, two_cards[1])
    assert build_keys.launches > 0 and finalize_sorted.launches > 0
    assert_same_tables(got, want)


@pytest.mark.cuda
def test_sharded_count_over_every_card(two_cards, counters):
    from mercat2_tpu_torch.parallel import sharded_count_sources

    pairs = mesh_sources(DNA_CODEC, 32, seed=12)
    want = single_device_tables(21, DNA_CODEC, pairs, 2, two_cards[0])
    build_keys.launches = finalize_sorted.launches = 0
    got = sharded_count_sources(KmerCounter(21, DNA_CODEC, two_cards[0]),
                                [NumpySource(s, r, DNA_CODEC) for s, r in pairs], 2,
                                two_cards)
    assert build_keys.launches == finalize_sorted.launches == len(two_cards)
    assert_same_tables(got, want)
