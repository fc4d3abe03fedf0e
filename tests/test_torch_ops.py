"""The port's plain-torch device ops against the JAX package's, on the CPU.

Every input is made with numpy from a seed and handed to both packages;
every comparison is exact (the path is integer throughout). Key words are
uint32 in JAX and int32 bit patterns in the port, compared as uint32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercat2_tpu.engine import codec as jcodec
from mercat2_tpu.engine.counter import KmerCounter as JaxCounter
from mercat2_tpu.engine.counter import NumpySource as JaxSource
from mercat2_tpu.ops import finalize as jfin
from mercat2_tpu.ops import kmer_pack as jpack
from mercat2_tpu_torch.engine import codec as tcodec
from mercat2_tpu_torch.engine.counter import to_torch_group
from mercat2_tpu_torch.ops import finalize as tfin
from mercat2_tpu_torch.ops import kmer_pack as tpack

CPU = torch.device("cpu")
KS = (5, 16, 17, 21, 31, 33)

# The JAX references, jitted: one compiled program per case instead of one
# eager compile per primitive (the tests run with a cold compile cache).
j_unpack = jax.jit(jfin.unpack_codes, static_argnums=(1, 2))
j_validity = jax.jit(jfin.packed_window_validity, static_argnums=(2, 3))
j_pack = jax.jit(jpack.pack_kmer_words, static_argnums=(1, 2))
j_pack_serial = jax.jit(jpack._pack_kmer_words_serial, static_argnums=(1, 2))
j_keyed = jax.jit(jfin.build_keyed_words, static_argnums=(3, 4, 5))
j_fin_u64 = jax.jit(jfin._finalize_sorted_u64, static_argnums=(3,))
j_fin_words = jax.jit(jfin._finalize_sorted, static_argnums=(3,))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def assert_words(jax_cols, torch_cols):
    assert len(jax_cols) == len(torch_cols)
    for j, t in zip(jax_cols, torch_cols):
        np.testing.assert_array_equal(np.asarray(j), u32(t))


def random_codes(rng, n, bits):
    return rng.integers(0, 1 << bits, size=n).astype(np.uint32)


def pack_words(codes: np.ndarray, bits: int) -> np.ndarray:
    per = 32 // bits
    shifts = (32 - bits * (np.arange(per) + 1)).astype(np.uint32)
    return np.bitwise_or.reduce(codes.reshape(-1, per) << shifts, axis=1)


# -- codec copy ----------------------------------------------------------


def test_codec_copy_matches_jax_package():
    for name in ("DNA_CODEC", "PROTEIN_CODEC"):
        a, b = getattr(jcodec, name), getattr(tcodec, name)
        assert a.bits == b.bits and a.size == b.size
        np.testing.assert_array_equal(a.symbols, b.symbols)
        np.testing.assert_array_equal(a.lut_encode(), b.lut_encode())
    for alpha in (b"ACGT", b"ACG", b"ACGNT", b"ACGt", b"01", b"",
                  b"ACDEFGHIKLMNPQRSTVWY", b"ACGTNacgt"):
        present = np.unique(np.frombuffer(alpha, np.uint8))
        ca, cb = jcodec.canonical_codec(present), tcodec.canonical_codec(present)
        assert (ca is None) == (cb is None)
        if ca is not None:
            assert ca.bits == cb.bits
            np.testing.assert_array_equal(ca.symbols, cb.symbols)
        if present.size:
            fa = jcodec.codec_for_alphabet(present)
            fb = tcodec.codec_for_alphabet(present)
            assert fa.bits == fb.bits
            np.testing.assert_array_equal(fa.symbols, fb.symbols)
            np.testing.assert_array_equal(fa.lut_encode(), fb.lut_encode())


# -- unpack, validity, pack ---------------------------------------------------


@pytest.mark.parametrize("bits", [1, 2, 4, 5])
def test_unpack_codes(bits):
    rng = np.random.default_rng(bits)
    words = rng.integers(0, 1 << 32, size=300, dtype=np.uint64).astype(np.uint32)
    n_sym = 300 * (32 // bits)
    want = j_unpack(jnp.asarray(words), bits, n_sym)
    got = tfin.unpack_codes(i32(words), bits, n_sym)
    np.testing.assert_array_equal(np.asarray(want), u32(got))


@pytest.mark.parametrize("k", [1, 3, 21])
def test_packed_window_validity(k):
    rng = np.random.default_rng(k)
    p = 2000
    gb = rng.integers(0, p + k, size=64).astype(np.int32)
    ge = (gb + rng.integers(0, 5, size=64)).astype(np.int32)
    gb[:8] = gb[8:16]  # duplicate endpoints must all count
    ge[:8] = ge[8:16]
    ge[20] = gb[20]    # an empty range is a no-op
    want = j_validity(jnp.asarray(gb), jnp.asarray(ge), k, p)
    got = tfin.packed_window_validity(torch.from_numpy(gb), torch.from_numpy(ge), k, p)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("bits", [2, 4, 5])
@pytest.mark.parametrize("k", KS)
def test_pack_kmer_words(k, bits):
    rng = np.random.default_rng(k * 10 + bits)
    codes = random_codes(rng, 700, bits)
    want = j_pack(jnp.asarray(codes), k, bits)
    got = tpack.pack_kmer_words(i32(codes), k, bits)
    assert_words(want, got)
    # the serial form on every width (the tree form covers bits | 32)
    want = j_pack_serial(jnp.asarray(codes), k, bits)
    got = tpack._pack_kmer_words_serial(i32(codes), k, bits)
    assert_words(want, got)


def test_key_words_and_fid_layout():
    for k in range(1, 70):
        for bits in (1, 2, 3, 4, 5, 8):
            assert tpack.key_words_for(k, bits) == jpack.key_words_for(k, bits)
            for n_files in (1, 2, 31, 32, 33):
                assert (tfin.fid_layout(k, bits, n_files)
                        == jfin.fid_layout(k, bits, n_files))


@pytest.mark.parametrize("n_files", [1, 32])
@pytest.mark.parametrize("bits", [2, 4, 5])
@pytest.mark.parametrize("k", KS)
def test_build_keyed_words(k, bits, n_files):
    rng = np.random.default_rng(k + bits + n_files)
    codes = random_codes(rng, 500, bits)
    p = 500 - k + 1
    valid = rng.random(p) < 0.8
    fid = np.sort(rng.integers(0, n_files, size=p)).astype(np.uint32)
    jp = j_pack(jnp.asarray(codes), k, bits)
    tp = tpack.pack_kmer_words(i32(codes), k, bits)
    want, ws = j_keyed(jp, jnp.asarray(valid), jnp.asarray(fid), k, bits, n_files)
    got, gs = tfin.build_keyed_words(tp, torch.from_numpy(valid),
                                     torch.from_numpy(fid.astype(np.int64)),
                                     k, bits, n_files)
    assert ws == gs
    assert_words(want, got)


# -- sort + finalize ------------------------------------------------------------


def sorted_column(rng, p, n_valid, max_run, top=1 << 40):
    """Sorted uint64 keys in runs of 1..max_run rows (one run when
    max_run >= n_valid), all-ones tail from n_valid on."""
    if max_run >= n_valid:
        lens = np.array([n_valid])
    else:
        lens = rng.integers(1, max_run + 1, size=n_valid)
        csum = np.cumsum(lens)
        lens = lens[: int(np.searchsorted(csum, n_valid)) + 1]
        lens[-1] -= lens.sum() - n_valid
    lens = lens[lens > 0]
    pool = np.unique(rng.integers(0, top, size=2 * len(lens) + 8, dtype=np.uint64))
    keys = np.sort(rng.permutation(pool)[: len(lens)])
    col = np.repeat(keys, lens)
    return np.concatenate([col, np.full(p - n_valid, np.uint64(2**64 - 1))])


FINALIZE_CASES = [
    # p, n_valid, min_count, max_run, cap
    (1000, 900, 3, 40, 4096),
    (1000, 1000, 1, 30, 4096),     # no invalid tail, min_count 1
    (3000, 2500, 10, 25, 512),
    (3000, 2990, 2, 3, 64),        # n_out > cap
    (500, 0, 2, 4, 64),            # empty
    (800, 800, 2, 2000, 16),       # one run spans the column
    (800, 790, 900, 50, 16),       # min_count beyond every run
]


@pytest.mark.parametrize("p,n_valid,mc,max_run,cap", FINALIZE_CASES)
def test_finalize_sorted_u64(p, n_valid, mc, max_run, cap):
    rng = np.random.default_rng(p + n_valid + mc)
    s = sorted_column(rng, p, n_valid, max_run)
    with jax.enable_x64(True):
        wk, wc, wn = j_fin_u64(jnp.asarray(s), jnp.int32(n_valid), jnp.int32(mc), cap)
        wk, wc, wn = np.asarray(wk), np.asarray(wc), int(wn)
    gk, gc, gn = tfin._finalize_sorted_u64(torch.from_numpy(s.view(np.int64)),
                                           torch.tensor(n_valid), mc, cap)
    assert int(gn) == wn
    np.testing.assert_array_equal(gk.numpy().view(np.uint64), wk)
    np.testing.assert_array_equal(gc.numpy(), wc)


@pytest.mark.parametrize("n_words", [1, 3])
@pytest.mark.parametrize("p,n_valid,mc,max_run,cap", FINALIZE_CASES)
def test_finalize_sorted_words(p, n_valid, mc, max_run, cap, n_words):
    rng = np.random.default_rng(p + n_valid + mc + n_words)
    s = sorted_column(rng, p, n_valid, max_run, top=1 << (20 * n_words))
    cols = [((s >> np.uint64(20 * (n_words - 1 - w))) & np.uint64(0xFFFFF)).astype(np.uint32)
            for w in range(n_words)]
    for c in cols:
        c[n_valid:] = 0xFFFFFFFF
    ww, wc, wn = j_fin_words(tuple(jnp.asarray(c) for c in cols),
                             jnp.int32(n_valid), jnp.int32(mc), cap)
    gw, gc, gn = tfin._finalize_sorted(tuple(i32(c) for c in cols),
                                       torch.tensor(n_valid), mc, cap)
    assert int(gn) == int(wn)
    assert_words(ww, gw)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("n_words", [1, 2, 3, 4])
def test_sort_words_is_unsigned_lexicographic(n_words):
    rng = np.random.default_rng(n_words)
    cols = [rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                                np.uint32), size=400) for _ in range(n_words)]
    got = tfin.sort_words([i32(c) for c in cols])
    order = np.lexsort(cols[::-1])
    for c, g in zip(cols, got):
        np.testing.assert_array_equal(c[order], u32(g))
    if n_words == 2:  # the fused form sorts the same, marker last
        fused = tfin.split_u64(torch.sort(tfin.fuse_u64([i32(c) for c in cols])).values)
        for c, g in zip(cols, fused):
            np.testing.assert_array_equal(c[order], u32(g))


# -- count_kmers_packed: one host buffer through both packages -----------


def _records(rng, codec, n_rec, repeat):
    """Random records with one segment planted ``repeat`` times."""
    seg = codec.symbols[rng.integers(0, codec.size, size=60)]
    parts, rec = [], []
    for r in range(n_rec):
        body = codec.symbols[rng.integers(0, codec.size, size=int(rng.integers(40, 160)))]
        body = np.concatenate([body] + [seg] * (repeat if r % 2 else 0))
        parts.append(body)
        rec.append(np.full(body.shape[0], r))
    return np.concatenate(parts), np.concatenate(rec)


def _codec(bits):
    if bits == 2:
        return jcodec.DNA_CODEC
    if bits == 5:
        return jcodec.PROTEIN_CODEC
    return jcodec.Codec(np.sort(np.frombuffer(b"ACGNTacg", np.uint8)), 4)


# every k at 2 bits; the 4- and 5-bit widths at one 2-word and one 3+-word
# key (each case is one JAX compile)
COUNT_CASES = [(k, 2) for k in KS] + [(k, b) for b in (4, 5) for k in (17, 33)]


@pytest.mark.parametrize("n_files", [1, 32])
@pytest.mark.parametrize("k,bits", COUNT_CASES)
def test_count_kmers_packed(k, bits, n_files):
    rng = np.random.default_rng(100 * k + 10 * bits + n_files)
    codec = _codec(bits)
    n_real = 1 if n_files == 1 else 3
    sources = [JaxSource(*_records(rng, codec, 6, 3), codec) for _ in range(n_real)]
    group = JaxCounter(k, codec).build_packed_group(sources, bucket=1 << 13)
    starts = np.full(n_files, group.n_sym, np.int32)
    starts[:n_real] = group.file_starts
    group.file_starts = starts
    # the 32-file launches overflow their cap: n_out > cap
    cap = 1 << 12 if n_files == 1 else 48
    want = jfin.count_kmers_packed(
        jnp.asarray(group.words), jnp.asarray(group.gap_begin),
        jnp.asarray(group.gap_end), jnp.asarray(group.file_starts), jnp.int32(2),
        k=k, bits=bits, alphabet_size=codec.size, cap=cap, n_files=n_files,
        n_sym=group.n_sym,
    )
    dev = to_torch_group(group, CPU)
    got = tfin.count_kmers_packed(
        dev.words, dev.gap_begin, dev.gap_end, dev.file_starts, 2,
        k=k, bits=bits, cap=cap, n_files=n_files, n_sym=dev.n_sym,
    )
    assert int(got[2]) == int(want[2]) > 0
    if n_files > 1:
        assert int(got[2]) > cap
    assert_words(want[0], got[0])
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
