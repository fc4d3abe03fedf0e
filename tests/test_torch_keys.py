"""The fused key build's plain twin against the JAX package's keys, on the
CPU.

``build_keys_plain`` now does what the JAX ``count_kmers_packed`` runs
between the window validity and the sort: the key build, the file-id tag
(embedded in word 0, or a leading fid word that replaces the tie-break
word), the fuse of a 2-word key into one uint64 (held here as its
sign-flipped int64) and the count of valid windows. The JAX side is that
same sequence of the JAX package's functions, stopped before the sort.
The CUDA kernel is held against the twin on the card in
tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercat2_tpu.ops import finalize as jfin
from mercat2_tpu.ops import kmer_pack as jpack
from mercat2_tpu_torch.ops.build_keys import build_keys_plain
from mercat2_tpu_torch.ops.finalize import fid_layout, packed_window_validity

SIGN64 = np.uint64(1 << 63)


@functools.partial(jax.jit, static_argnames=("k", "bits", "n_files", "n_sym"))
def jax_sort_keys(packed, gap_begin, gap_end, file_starts, *, k, bits, n_files, n_sym):
    """The JAX count path's sort keys (count_kmers_packed up to the sort)."""
    p = n_sym - k + 1
    valid = jfin.packed_window_validity(gap_begin, gap_end, k, p)
    payload = jpack.pack_kmer_words(jfin.unpack_codes(packed, bits, n_sym), k, bits)
    fid = None
    if n_files > 1:
        pos = jax.lax.broadcasted_iota(jnp.int32, (p,), 0)
        fid = jnp.searchsorted(file_starts, pos, side="right").astype(jnp.uint32) - 1
    keyed, _ = jfin.build_keyed_words(payload, valid, fid, k, bits, n_files)
    return keyed, jnp.sum(valid, dtype=jnp.int32)


@pytest.mark.parametrize("n_files", [1, 32])
@pytest.mark.parametrize("bits", [2, 5])
@pytest.mark.parametrize("k", [5, 21, 31])  # at 32 files k=31 takes the fid word
def test_fused_key_build_matches_jax(k, bits, n_files):
    rng = np.random.default_rng(1000 * k + 10 * bits + n_files)
    per = 32 // bits
    n_sym = 1200 * per
    codes = rng.integers(0, min(1 << bits, 20 if bits == 5 else 4), size=n_sym)
    shifts = (32 - bits * (np.arange(per) + 1)).astype(np.uint32)
    words = np.bitwise_or.reduce(codes.astype(np.uint32).reshape(-1, per) << shifts, axis=1)
    gb = np.sort(rng.integers(0, n_sym, size=30)).astype(np.int32)
    ge = (gb + rng.integers(1, 4, size=30)).astype(np.int32)
    starts = np.zeros(1, np.int32)
    if n_files > 1:  # 8 files, one of them empty, padded as a launch pads them
        starts = np.full(n_files, n_sym, np.int32)
        inner = np.sort(rng.choice(np.arange(1, n_sym), 6, replace=False))
        starts[:8] = np.concatenate([[0], inner[:1], inner])
    p = n_sym - k + 1

    want, want_nv = jax_sort_keys(jnp.asarray(words), jnp.asarray(gb), jnp.asarray(ge),
                                  jnp.asarray(starts), k=k, bits=bits, n_files=n_files,
                                  n_sym=n_sym)
    want = [np.asarray(w) for w in want]
    if len(want) == 2:  # the fuse of the JAX _sort_fused_u64, before its sort
        want = [(want[0].astype(np.uint64) << np.uint64(32)) | want[1].astype(np.uint64)]

    valid = packed_window_validity(torch.from_numpy(gb), torch.from_numpy(ge), k, p)
    words_t = torch.from_numpy(words.view(np.int32).copy())
    got, got_nv = build_keys_plain(words_t, valid, torch.from_numpy(starts), k=k,
                                   bits=bits, p=p, n_files=n_files)
    assert int(got_nv) == int(want_nv) < p
    assert len(got) == len(want)
    for w, g in zip(want, got):
        if g.dtype == torch.int64:  # sign-flipped: unsigned order as signed order
            np.testing.assert_array_equal(g.numpy().view(np.uint64) ^ SIGN64, w)
        else:
            np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


def test_cases_cover_both_fid_layouts():
    layouts = {fid_layout(k, bits, 32)[0] for k in (5, 21, 31) for bits in (2, 5)}
    assert layouts == {"embedded", "word"}
