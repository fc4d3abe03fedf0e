"""The port's uniform dispatch and fetch against the JAX package's.

Both counters get the same files, with their launch bounds shrunk as in
tests/test_uniform_dispatch.py so that the files span several launches;
the per-file tables must be equal. The fid layout of a launch is the same
in both packages (always chosen for 32 files), and so the tables are.
"""

import numpy as np
import pytest
import torch

from mercat2_tpu.engine.codec import codec_for_bytes as jax_codec_for_bytes
from mercat2_tpu.engine.counter import KmerCounter as JaxCounter
from mercat2_tpu.engine.counter import NumpySource as JaxSource
from mercat2_tpu.engine.counter import fetch_tables as jax_fetch_tables
from mercat2_tpu_torch.engine.codec import codec_for_bytes
from mercat2_tpu_torch.engine.counter import KmerCounter, fetch_tables
from mercat2_tpu_torch.engine.host import NumpySource, merge_tables

CPU = torch.device("cpu")


def _files(rng, n_files, alpha, lo, hi, n_rec=5):
    """(seq, rec) per file: random records, each file with one segment
    planted 4 times so that min-count filters keep rows."""
    out = []
    for _ in range(n_files):
        lens = rng.integers(lo, hi, size=n_rec)
        seqs = [rng.choice(alpha, size=ln).astype(np.uint8) for ln in lens]
        seg = rng.choice(alpha, size=40).astype(np.uint8)
        seqs += [seg] * 4
        seq = np.concatenate(seqs)
        rec = np.repeat(np.arange(len(seqs)), [len(s) for s in seqs])
        out.append((seq, rec))
    return out


def _shrink(monkeypatch, syms, files=4, cap=1 << 12):
    monkeypatch.setattr(JaxCounter, "_UNIFORM_SYMS", syms)
    monkeypatch.setattr(JaxCounter, "_UNIFORM_GAPS", 1 << 8)
    monkeypatch.setattr(JaxCounter, "_UNIFORM_FILES", files)
    monkeypatch.setattr(JaxCounter, "_UNIFORM_CAP", cap)
    monkeypatch.setattr(JaxCounter, "_DENSE_SMALL_K", False)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_SYMS", syms)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_FILES", files)
    monkeypatch.setattr(KmerCounter, "_UNIFORM_CAP", cap)


def _assert_tables(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.kmers, w.kmers)
        np.testing.assert_array_equal(g.counts, w.counts)


@pytest.mark.parametrize("alphabet,k,min_count", [
    (b"ACGT", 5, 2),
    (b"ACGT", 21, 3),
    (b"ACGT", 31, 2),   # fid word: 3-word keys, LSD sort
    (b"ACGT", 16, 2),   # fid word replaces the tie-break word
    (b"ACGTNacgt", 11, 2),  # 4-bit codec
    (b"ACDEFGHIKLMNPQRSTVWY", 5, 2),  # 5-bit protein codec
])
def test_uniform_matches_jax(monkeypatch, alphabet, k, min_count):
    _shrink(monkeypatch, 1 << 14)
    rng = np.random.default_rng(k + len(alphabet))
    alpha = np.frombuffer(alphabet, np.uint8)
    files = _files(rng, 9, alpha, k, 400)  # several launch groups
    jcodec = jax_codec_for_bytes(alpha)
    jc = JaxCounter(k, jcodec)
    want = jax_fetch_tables(jc.dispatch_packed_uniform(
        [JaxSource(s, r, jcodec) for s, r in files], min_count))
    codec = codec_for_bytes(alpha)
    tc = KmerCounter(k, codec, CPU)
    got = fetch_tables(tc.dispatch_packed_uniform(
        [NumpySource(s, r, codec) for s, r in files], min_count))
    assert sum(len(t) for t in got) > 0
    _assert_tables(got, want)


def test_grouping_respects_the_bounds(monkeypatch):
    """At most _UNIFORM_FILES files and _UNIFORM_SYMS symbols per launch."""
    _shrink(monkeypatch, 1 << 12, files=3)
    rng = np.random.default_rng(4)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    codec = codec_for_bytes(alpha)
    tc = KmerCounter(7, codec, CPU)
    files = _files(rng, 10, alpha, 20, 200)
    sources = [NumpySource(s, r, codec) for s, r in files]
    pendings = tc.dispatch_packed_uniform(sources, 2)
    launches: dict = {}
    for src, p in zip(sources, pendings):
        launches.setdefault(id(p._multi), []).append(src.packed_len(1))
    assert len(launches) >= 4
    for lens in launches.values():
        assert len(lens) <= 3
        assert sum(-(-(n + 1) // 16) * 16 for n in lens) <= 1 << 12
    jcodec = jax_codec_for_bytes(alpha)
    want = [JaxCounter(7, jcodec).count(s, r, 2) for s, r in files]
    _assert_tables(fetch_tables(pendings), want)


def test_overflow_rerun(monkeypatch):
    """n_out > _UNIFORM_CAP reruns the launch with room; exact output."""
    _shrink(monkeypatch, 1 << 14, cap=64)
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    (seq, rec), = _files(rng, 1, alpha, 2000, 3000, n_rec=3)
    seq = np.concatenate([seq, seq])  # every 6-mer at least twice
    rec = np.concatenate([rec, rec + rec[-1] + 1])
    codec = codec_for_bytes(alpha)
    (pending,) = KmerCounter(6, codec, CPU).dispatch_packed_uniform(
        [NumpySource(seq, rec, codec)], 2)
    got = pending.table()
    want = JaxCounter(6, jax_codec_for_bytes(alpha)).count(seq, rec, 2)
    assert len(want) > 64
    _assert_tables([got], [want])


def test_file_above_the_bound_gets_its_own_launch(monkeypatch):
    """The JAX uniform path refuses such a file (it goes to the adaptive
    path there); the port counts it in a launch of its own size."""
    _shrink(monkeypatch, 1 << 10)
    rng = np.random.default_rng(1)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    files = _files(rng, 3, alpha, 50, 120) + _files(rng, 1, alpha, 800, 900)
    jcodec = jax_codec_for_bytes(alpha)
    big = JaxSource(*files[-1], jcodec)
    assert JaxCounter(5, jcodec).dispatch_packed_uniform([big], 2) is None
    codec = codec_for_bytes(alpha)
    tc = KmerCounter(5, codec, CPU)
    sources = [NumpySource(s, r, codec) for s, r in files]
    assert not tc.fits_uniform(sources[-1])
    pendings = tc.dispatch_packed_uniform(sources, 2)
    assert pendings[-1]._multi is not pendings[0]._multi
    got = fetch_tables(pendings)
    want = [JaxCounter(5, jcodec).count(s, r, 2) for s, r in files]
    _assert_tables(got, want)


def test_empty_and_short_files():
    codec = codec_for_bytes(np.frombuffer(b"ACGT", np.uint8))
    tc = KmerCounter(5, codec, CPU)
    empty = NumpySource(np.zeros(0, np.uint8), np.zeros(0, np.int64), codec)
    short = NumpySource(np.frombuffer(b"ACG", np.uint8).copy(), np.zeros(3, np.int64), codec)
    pendings = tc.dispatch_packed_uniform([empty, short], 1)
    assert [len(t) for t in fetch_tables(pendings)] == [0, 0]


def test_merge_tables_matches_jax():
    from mercat2_tpu.engine.counter import merge_tables as jax_merge

    rng = np.random.default_rng(9)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    codec = codec_for_bytes(alpha)
    tc = KmerCounter(4, codec, CPU)
    files = _files(rng, 3, alpha, 50, 200)
    tables = fetch_tables(tc.dispatch_packed_uniform(
        [NumpySource(s, r, codec) for s, r in files], 1))
    got = merge_tables(tables, 4)
    want = jax_merge(tables, 4)
    _assert_tables([got], [want])


def test_drop_short_records_matches_jax():
    from mercat2_tpu.engine.counter import _drop_short_records as jax_drop
    from mercat2_tpu_torch.engine.host import _drop_short_records

    rng = np.random.default_rng(12)
    lens = rng.integers(1, 30, size=40)
    seq = rng.integers(65, 70, size=int(lens.sum())).astype(np.uint8)
    rec = np.repeat(np.arange(40), lens)
    for k in (1, 5, 21, 40):
        got, want = _drop_short_records(seq, rec, k), jax_drop(seq, rec, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
