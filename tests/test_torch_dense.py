"""The port's dense small-keyspace route against the JAX package's, and
against the port's own sorted route, on the CPU.

A round whose keyspace ``S**k`` is at most 2^14 bins its windows
(``ops/dense_hist.py``) where the JAX package takes its one-hot matmul
histogram (``mercat2_tpu.ops.mxu_hist``). The reference here is JAX's
``count_kmers_dense_segments`` + ``decode_dense_histogram``, one file a
call; the port counts up to 32 files in one fid-tagged launch. Tables
must be equal, exactly, to both.
"""

import numpy as np
import pytest

from mercat2_tpu.engine.codec import Codec as JaxCodec
from mercat2_tpu.engine.counter import KmerCounter as JaxCounter
from mercat2_tpu.ops.mxu_hist import (
    MXU_MAX_BINS, count_kmers_dense_segments, decode_dense_histogram,
)
from mercat2_tpu_torch.engine.codec import Codec, codec_for_bytes
from mercat2_tpu_torch.engine.counter import (
    KmerCounter, fetch_tables, to_torch_group,
)
from mercat2_tpu_torch.engine.host import NumpySource, build_packed_group
from mercat2_tpu_torch.ops.dense_hist import MAX_BINS, count_kmers_dense

PROTEIN = b"ABCDEFGHIJKLMNOPQRSTUVWXYZ"

#: (alphabet, k): DNA, the 26-symbol protein codec, and a 5-symbol 3-bit
#: codec at 5**6 = 15,625 bins, next to the bound
CASES = [(b"ACGT", 1), (b"ACGT", 5), (b"ACGT", 7), (PROTEIN, 1), (PROTEIN, 2),
         (b"ACGNT", 6)]

#: the JAX reference's launch shape: every file padded to it, so that
#: each (k, codec) compiles once
REF_WORDS = 512
REF_GAPS = 64


def _sources(rng, alphabet: bytes, n_files: int):
    """(seq, rec) per file: 3-6 records of 20-400 symbols, a record
    shorter than most k, and one 40-symbol segment planted 12 times, so
    that min-count 10 keeps rows."""
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for _ in range(n_files):
        seg = alpha[rng.integers(0, alpha.size, size=40)]
        recs = [alpha[rng.integers(0, alpha.size, size=int(n))]
                for n in rng.integers(20, 400, size=int(rng.integers(3, 7)))]
        recs += [seg] * 12 + [alpha[:3]]
        seq = np.concatenate(recs)
        out.append((seq, np.repeat(np.arange(len(recs)), [r.size for r in recs])))
    return out


def _jax_table(k: int, codec: Codec, seq, rec, min_count: int):
    """One file through the JAX dense histogram and its decode."""
    g = build_packed_group(k, codec, [NumpySource(seq, rec, codec)])
    per = 32 // codec.bits
    assert g.words.size <= REF_WORDS and g.gap_begin.size < REF_GAPS
    words = np.zeros(REF_WORDS, np.uint32)
    words[: g.words.size] = g.words
    noop = REF_WORDS * per + k  # empty ranges past the end
    gb = np.full(REF_GAPS, noop, np.int32)
    ge = np.full(REF_GAPS, noop, np.int32)
    gb[: g.gap_begin.size], ge[: g.gap_end.size] = g.gap_begin, g.gap_end
    gb[g.gap_begin.size], ge[g.gap_end.size] = g.n_sym, REF_WORDS * per
    (hist,) = count_kmers_dense_segments(
        words, gb, ge, k=k, bits=codec.bits, alphabet_size=codec.size,
        seg_words=((0, REF_WORDS),))
    return decode_dense_histogram(hist, k, JaxCodec(codec.symbols, codec.bits),
                                  min_count)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.kmers, w.kmers)
        np.testing.assert_array_equal(g.counts, w.counts)


@pytest.mark.parametrize("min_count", [1, 10])
@pytest.mark.parametrize("n_files", [1, 32])
@pytest.mark.parametrize("alphabet,k", CASES)
def test_dense_matches_jax_and_sorted(alphabet, k, n_files, min_count):
    rng = np.random.default_rng(len(alphabet) * 100 + k)
    files = _sources(rng, alphabet, n_files)
    codec = codec_for_bytes(np.concatenate([s for s, _ in files]))
    assert codec.size ** k <= MAX_BINS

    counter = KmerCounter(k, codec, "cpu")
    assert counter.dense
    before = count_kmers_dense.launches
    dense = fetch_tables(counter.dispatch_packed_uniform(
        [NumpySource(s, r, codec) for s, r in files], min_count))
    assert count_kmers_dense.launches == before + 1  # 32 files, one launch
    counter.dense = False
    sort = fetch_tables(counter.dispatch_packed_uniform(
        [NumpySource(s, r, codec) for s, r in files], min_count))
    assert count_kmers_dense.launches == before + 1

    want = [_jax_table(k, codec, s, r, min_count) for s, r in files]
    assert all(len(w) for w in want)
    _assert_same(dense, want)
    _assert_same(sort, want)


def test_routing_matches_jax():
    """The same rounds go dense in both packages: S**k <= 2^14."""
    assert MAX_BINS == MXU_MAX_BINS
    for symbols in (b"ACGT", b"ACGNT", b"ACGTacgt", PROTEIN, bytes(range(33, 127))):
        codec = codec_for_bytes(np.frombuffer(symbols, np.uint8))
        jcodec = JaxCodec(codec.symbols, codec.bits)
        for k in range(1, 12):
            want = JaxCounter(k, jcodec)._keyspace() <= MXU_MAX_BINS
            assert KmerCounter(k, codec, "cpu").dense == want, (symbols, k)


def test_dense_refuses_a_large_keyspace():
    codec = codec_for_bytes(np.frombuffer(b"ACGT", np.uint8))
    seq = np.frombuffer(b"ACGT" * 20, np.uint8)
    g = to_torch_group(build_packed_group(
        8, codec, [NumpySource(seq, np.zeros(80, np.int64), codec)]), "cpu")
    with pytest.raises(ValueError, match="keyspace"):
        count_kmers_dense(g.words, g.gap_begin, g.gap_end, g.file_starts, 1,
                          k=8, bits=2, alphabet_size=4, n_files=1, n_sym=g.n_sym)
