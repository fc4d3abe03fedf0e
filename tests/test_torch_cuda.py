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
from mercat2_tpu_torch.ops.finalize import count_kmers_packed, sort_fused_u64
from mercat2_tpu_torch.ops.finalize_kernel import (
    finalize_sorted, finalize_sorted_plain,
)

ONES = np.uint32(0xFFFFFFFF)


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
    keyed = build_keys(i32(words), torch.from_numpy(valid), k=21, bits=2, p=p)
    s = sort_fused_u64(list(keyed))
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
        build_keys(words, valid, k=21, bits=7, p=1000)
    s = torch.empty(1000, dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="unavailable"):
        finalize_sorted((s,), torch.empty((), dtype=torch.int64, device="meta"),
                        min_count=2, cap=64)
    assert build_keys.launches == 0 and finalize_sorted.launches == 0


# -- the CUDA kernels against their twins (card only) ------------------------------


#: bits that do not divide 32 (3-bit soft-masked DNA, 5-bit protein, 6-bit
#: mixed-case protein) at every k of interest; n is chosen so that p is
#: not a multiple of the kernel's 256-thread block
SPLIT_CASES = [(k, bits, 20011) for bits in (3, 5, 6)
               for k in (1, 5, 6, 21, 130, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,bits,n", [
    (21, 2, 50000), (16, 2, 20000), (5, 2, 4000), (31, 2, 40000), (7, 4, 9000),
    (129, 2, 30000), (2, 1, 9000), (64, 4, 30000), (32, 1, 9000),
    (1, 2, 9000), (256, 4, 30000), *SPLIT_CASES,
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
    for g, t in zip(got, want, strict=True):
        assert torch.equal(g, t)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [3, 5, 6])
def test_build_keys_kernel_all_invalid(cuda, counters, bits):
    """Every window invalid: every key word all-ones, as the twin has it."""
    rng = np.random.default_rng(bits)
    words, _, p = packed_stream(rng, 21, bits, 5003)
    w = i32(words).to(cuda)
    v = torch.zeros(p, dtype=torch.bool, device=cuda)
    got = build_keys(w, v, k=21, bits=bits, p=p)
    want = build_keys_plain(w, v, k=21, bits=bits, p=p)
    assert build_keys.launches == 1
    for g, t in zip(got, want, strict=True):
        assert torch.equal(g, t) and bool((g == -1).all())


@pytest.mark.cuda
def test_build_keys_kernel_refuses_other_widths(cuda):
    w = torch.zeros(4096, dtype=torch.int32, device=cuda)
    v = torch.ones(4096 * 32, dtype=torch.bool, device=cuda)
    for k, bits in [(21, 7), (5, 8), (257, 2), (300, 5)]:
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
        forms.append((sort_fused_u64(list(cols)),))
    for form in forms:
        got = finalize_sorted(form, nv, min_count=min_count, cap=cap)
        want = finalize_sorted_plain(form, nv, min_count=min_count, cap=cap)
        torch.cuda.synchronize()
        assert int(got[2]) == int(want[2])
        for g, t in zip(got[0] + (got[1],), want[0] + (want[1],), strict=True):
            assert torch.equal(g, t)
    assert finalize_sorted.launches == len(forms)


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
