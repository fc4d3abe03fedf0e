"""The port's sharded count (``mercat2_tpu_torch.parallel``) against the
JAX package's, on the CPU, exact.

The port's meshes are lists of CPU devices (``[cpu] * n``: every shard
takes the kernels' plain twins); the JAX side runs on ``flat_mesh(n)`` of
the 8 virtual CPU devices of tests/conftest.py. Tables must be equal key
for key and count for count. JAX compiles each ``shard_map`` signature
cold (~1 s each here), so the JAX cases are few and share shapes.
"""

import numpy as np
import pytest
import torch

from mercat2_tpu.engine.codec import codec_for_alphabet as jax_codec_for
from mercat2_tpu.engine.counter import KmerCounter as JaxCounter
from mercat2_tpu.engine.counter import NumpySource as JaxSource
from mercat2_tpu import parallel as jpar
from mercat2_tpu.ops.dense_hist import dense_kmer_histogram
from mercat2_tpu_torch import parallel as tpar
from mercat2_tpu_torch.engine.codec import codec_for_alphabet
from mercat2_tpu_torch.engine.counter import KmerCounter
from mercat2_tpu_torch.engine.host import NumpySource
from mercat2_tpu_torch.parallel import count as tcount

CPU = torch.device("cpu")
MESHES = [1, 2, 4, 8]


def counters(k: int, alphabet: int):
    """(port counter, JAX counter) for k over ``alphabet`` symbols."""
    symbols = np.arange(65, 65 + alphabet, dtype=np.uint8)
    return (KmerCounter(k, codec_for_alphabet(symbols), CPU),
            JaxCounter(k, jax_codec_for(symbols)))


def seq_recs(codec, specs):
    """(seq, rec) pairs from (n, seed, rec_every) specs: random symbols,
    records every ``rec_every`` symbols when set, and a repeated stretch so
    that min-count 2 keeps rows."""
    out = []
    for n, seed, rec_every in specs:
        rng = np.random.default_rng(seed)
        seq = codec.symbols[rng.integers(0, codec.size, size=n)]
        if n > 2000:
            seq[1500:1900] = seq[200:600]
        rec = (np.arange(n) // rec_every if rec_every else np.zeros(n)).astype(np.int64)
        out.append((seq, rec))
    return out


def assert_same_tables(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.kmers, w.kmers)
        np.testing.assert_array_equal(g.counts, w.counts)


def stream(n, alphabet, seed, sep_every=None):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, alphabet, size=n, dtype=np.uint8)
    if sep_every:
        s[::sep_every] = alphabet  # separators (codes >= alphabet)
    return s


# -- the sorted sharded count against the JAX package's --------------------------

#: (k, alphabet, file specs, min_count): 2-bit DNA at k 5, 21 (fused int64
#: column) and 33 (3 int32 columns); 5-bit protein at k 3 (one column) and
#: 21 (4 columns); one file and several (an empty one, one shorter than k)
SOURCE_CASES = {
    "dna-k5-1file-c1": (5, 4, [(6000, 1, 307)], 1),
    "dna-k21-4files-c2": (21, 4, [(6000, 2, 401), (0, 3, 0), (5, 4, 0), (3000, 5, 0)], 2),
    "dna-k33-1file-c2": (33, 4, [(6000, 6, 211)], 2),
    "protein-k3-3files-c1": (3, 20, [(5000, 7, 253), (2500, 8, 0), (4000, 9, 97)], 1),
    "protein-k21-1file-c2": (21, 20, [(6000, 10, 253)], 2),
}


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("case", sorted(SOURCE_CASES))
def test_sharded_count_sources_matches_jax(case, n):
    k, alphabet, specs, min_count = SOURCE_CASES[case]
    tc, jc = counters(k, alphabet)
    pairs = seq_recs(tc.codec, specs)
    want = jpar.sharded_count_sources(
        jc, [JaxSource(s, r, jc.codec) for s, r in pairs], min_count, jpar.flat_mesh(n))
    stats: dict = {}
    got = tpar.sharded_count_sources(
        tc, [NumpySource(s, r, tc.codec) for s, r in pairs], min_count, [CPU] * n,
        stats=stats)
    assert_same_tables(got, want)
    assert sum(len(t) for t in got) > 0
    assert stats["n_devices"] == n and stats["batches"] == 1
    assert len(stats["rows_received"][0]) == n


STREAM_CASES = {
    "dna-k21-c1": (21, 4, [(5000, 31, 113)], 1),
    "dna-k9-3files-c2": (9, 4, [(3000, 7, 101), (1200, 8, None), (600, 9, 53)], 2),
    "protein-k3-c3": (3, 25, [(5000, 13, 113)], 3),
}


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_sharded_count_streams_matches_jax(case, n):
    k, alphabet, specs, min_count = STREAM_CASES[case]
    tc, jc = counters(k, alphabet)
    streams = [stream(m, alphabet, seed, sep) for m, seed, sep in specs]
    want = jpar.sharded_count_streams(jc, [s.copy() for s in streams], min_count,
                                      jpar.flat_mesh(n))
    got = tpar.sharded_count_streams(tc, [s.copy() for s in streams], min_count, [CPU] * n)
    assert_same_tables(got, want)
    assert sum(len(t) for t in got) > 0


# -- cases of tests/test_parallel.py, against the single-device JAX engine ------


def balanced(stats: dict, slack: float = 2.0) -> bool:
    """Every shard received at most ``slack`` times its even share."""
    rows = stats["rows_received"][0]
    return max(rows) <= slack * sum(rows) / len(rows)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("k", [17, 18])
def test_low_entropy_word0_stays_balanced(k, n):
    """k=17/18 nt: key word 0 carries only 2/4 significant bits; splitting
    on words 0 and 1 together still balances the shards."""
    tc, jc = counters(k, 4)
    s = stream(20000, 4, 40 + k, 211)
    want = jc.count_stream(s.copy(), 1)
    stats: dict = {}
    got = tpar.sharded_count_streams(tc, [s.copy()], 1, [CPU] * n, stats=stats)
    assert_same_tables(got, [want])
    assert balanced(stats), stats


@pytest.mark.parametrize("n", [2, 4, 8])
def test_word_fid_mode_stays_balanced(n):
    """k=16 over several files puts the file id in key word 0 (the "word"
    fid layout); per-file tables, and shards still balanced."""
    tc, jc = counters(16, 4)
    streams = [stream(9000, 4, 61, 173), stream(7000, 4, 62), stream(5000, 4, 63, 97)]
    want = [jc.count_stream(s.copy(), 2) for s in streams]
    stats: dict = {}
    got = tpar.sharded_count_streams(tc, [s.copy() for s in streams], 2, [CPU] * n,
                                     stats=stats)
    assert_same_tables(got, want)
    assert balanced(stats), stats


@pytest.mark.parametrize("n", [2, 8])
def test_extreme_skew_all_keys_equal(n):
    """One repeated symbol: every window is one key, so all rows go to one
    shard and the others receive none (and launch nothing)."""
    tc, jc = counters(4, 4)
    s = np.zeros(4000, np.uint8)
    want = jc.count_stream(s.copy(), 1)
    stats: dict = {}
    got = tpar.sharded_count_streams(tc, [s.copy()], 1, [CPU] * n, stats=stats)
    assert_same_tables(got, [want])
    assert want.counts.tolist() == [3997]
    rows = stats["rows_received"][0]
    assert sorted(rows)[-1] == 3997 and sum(rows) == 3997


def test_empty_and_short_streams():
    tc, jc = counters(8, 4)
    codec = tc.codec
    streams = [np.zeros(0, np.uint8), np.full(3, codec.sentinel, np.uint8),
               stream(500, 4, 11)]
    got = tpar.sharded_count_streams(tc, streams, 1, [CPU] * 4)
    assert len(got[0]) == 0 and len(got[1]) == 0
    assert_same_tables(got[2:], [jc.count_stream(streams[2].copy(), 1)])
    nothing = tpar.sharded_count_streams(tc, streams[:2], 1, [CPU] * 4)
    assert [len(t) for t in nothing] == [0, 0]
    assert tpar.sharded_count_streams(tc, [], 1, [CPU] * 4) == []


@pytest.mark.parametrize("n_windows", [1, 7, 40])
def test_more_shards_than_windows(n_windows):
    """A stream of a few windows over 8 shards: the shards past the last
    window own none and launch nothing."""
    k = 21
    tc, jc = counters(k, 4)
    s = stream(n_windows + k - 1, 4, 70 + n_windows)
    stats: dict = {}
    got = tpar.sharded_count_streams(tc, [s.copy()], 1, [CPU] * 8, stats=stats)
    assert_same_tables(got, [jc.count_stream(s.copy(), 1)])
    assert sum(stats["rows_received"][0]) == n_windows


def test_shard_windows_cover_every_window_once():
    for p, per, n in [(1, 16, 8), (12345, 16, 4), (100, 6, 7), (5, 4, 1)]:
        ranges = tcount._shard_windows(p, per, n)
        assert len(ranges) == n and ranges[0][0] == 0 and ranges[-1][1] == p
        assert all(a <= b and (a == b or a % per == 0) for a, b in ranges)
        assert all(b == a2 for (_, b), (a2, _) in zip(ranges, ranges[1:]))


def test_route_budget_batches():
    """Batches follow the device-memory budget, keep files whole and stay
    exact; a single file above the budget still counts in one batch."""
    tc, jc = counters(21, 4)
    pairs = seq_recs(tc.codec, [(20_000, 90 + i, 5_000) for i in range(6)])
    want = [jc.count(s.copy(), r, 1) for s, r in pairs]
    stats: dict = {}
    got = tpar.sharded_count_sources(
        tc, [NumpySource(s, r, tc.codec) for s, r in pairs], 1, [CPU] * 4,
        hbm_budget=1 << 20, stats=stats)
    assert stats["batches"] > 1
    assert_same_tables(got, want)
    stats2: dict = {}
    [one] = tpar.sharded_count_sources(
        tc, [NumpySource(*pairs[0], tc.codec)], 1, [CPU] * 4, hbm_budget=1 << 16,
        stats=stats2)
    assert stats2["batches"] == 1
    assert_same_tables([one], want[:1])


def test_route_budget_counts_shards_on_one_card():
    """Four shards on one device hold the whole batch there: a quarter of
    the content fits that budget that four devices would hold."""
    tc, _ = counters(21, 4)
    sources = [NumpySource(s, r, tc.codec)
               for s, r in seq_recs(tc.codec, [(20_000, i, 0) for i in range(8)])]
    spread = tcount._route_batches(tc, sources, [torch.device("cuda", i) for i in range(4)],
                                   1 << 22)
    shared = tcount._route_batches(tc, sources, [torch.device("cuda", 0)] * 4, 1 << 22)
    assert len(shared) > len(spread) >= 1
    assert sorted(i for b in shared for i in b) == list(range(8))


# -- the dense histogram, shard_stream and mesh_shape_for --------------------------


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("k,alphabet", [(3, 4), (5, 4), (3, 25)])
def test_sharded_dense_histogram_matches_jax(n, k, alphabet):
    s = stream(4096, alphabet, 1, 97)
    shards = jpar.shard_stream(s, k, n, sentinel=alphabet)
    want = jpar.sharded_dense_histogram(shards, k=k, alphabet_size=alphabet,
                                        mesh=jpar.make_mesh(n))
    got = tpar.sharded_dense_histogram(tpar.shard_stream(s, k, n, sentinel=alphabet),
                                       k=k, alphabet_size=alphabet, devices=[CPU] * n)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    one = np.asarray(dense_kmer_histogram(s, k=k, alphabet_size=alphabet))
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("n,k,size", [(8, 5, 1000), (3, 21, 17), (1, 4, 2), (5, 3, 0)])
def test_shard_stream_matches_jax(n, k, size):
    s = stream(size, 4, size)
    np.testing.assert_array_equal(tpar.shard_stream(s, k, n, 4),
                                  jpar.shard_stream(s, k, n, 4))


def test_mesh_shape_for_matches_jax():
    for n in range(1, 17):
        for bp in (None, 1, 2, 4):
            try:
                want = jpar.mesh_shape_for(n, bp)
            except ValueError:
                with pytest.raises(ValueError):
                    tpar.mesh_shape_for(n, bp)
                continue
            assert tpar.mesh_shape_for(n, bp) == want


def test_make_mesh_takes_the_first_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tpar.make_mesh(2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert len(tpar.make_mesh()) == 4
    with pytest.raises(ValueError):
        tpar.make_mesh(5)
    assert tpar.flat_mesh(3) == tpar.make_mesh(3)
    assert tpar.flat_mesh(2, devices=["cpu"] * 4) == [CPU, CPU]
