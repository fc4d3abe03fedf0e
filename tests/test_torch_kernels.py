"""The kernel twins against the Pallas kernels, on the CPU.

The twins (``build_keys_plain``, ``finalize_sorted_plain``, reached here
through the wrappers, which take them for CPU tensors) are held against
``build_keys_pallas`` / ``finalize_sorted_pallas`` in Pallas interpret
mode, as tests/test_pallas_kernels.py runs them, and against the XLA
``finalize_sorted``, with exact equality. The CUDA kernels are held
against the twins on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mercat2_tpu.ops.finalize import finalize_sorted as xla_finalize_sorted
from mercat2_tpu.ops.pallas_finalize import (
    _FIN_TILE, build_keys_pallas, finalize_sorted_pallas,
)
from mercat2_tpu_torch.ops.build_keys import build_keys
from mercat2_tpu_torch.ops.finalize import split_u64
from mercat2_tpu_torch.ops.finalize_kernel import finalize_sorted
from test_torch_cuda import ONES, i32, packed_stream, sorted_columns, u32


# -- build_keys twin vs the Pallas kernel ---------------------------------------

BUILD_CASES = [(21, 2, 50000), (16, 2, 20000), (5, 2, 4000), (31, 2, 40000),
               (7, 4, 9000)]


@pytest.mark.parametrize("k,bits,n", BUILD_CASES)
def test_build_keys_twin_matches_pallas(k, bits, n):
    rng = np.random.default_rng(k * 100 + bits)
    words, valid, p = packed_stream(rng, k, bits, n)
    want = build_keys_pallas(jnp.asarray(words), jnp.asarray(valid.astype(np.uint8)),
                             k=k, bits=bits, p=p, interpret=True)
    got, n_valid = build_keys(i32(words), torch.from_numpy(valid), k=k, bits=bits, p=p)
    if got[0].dtype == torch.int64:  # two key words come fused, sign-flipped
        got = split_u64(got[0])
    assert int(n_valid) == int(valid.sum())
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), u32(g))


# -- finalize twin vs the Pallas kernel and the XLA finalize ---------------------

# p, n_valid, n_words, min_count, max_run (tests/test_pallas_kernels.py:51-60):
# at most 128 survivors per 16K-row tile, the Pallas kernel's emission
# budget. Every case is held against the XLA finalize, which
# tests/test_pallas_kernels.py holds the Pallas kernel to on these same
# cases; the two that exercise its tile structure (several tiles, a run
# across a tile edge) also run the Pallas kernel itself here, in
# interpret mode (each such case is a compile of ~10 s).
PALLAS_CASES = [
    (1000, 900, 2, 3, 40, False),
    (1000, 1000, 1, 1, 30, False),
    (20000, 17000, 3, 10, 400, True),
    (_FIN_TILE + 17, _FIN_TILE + 17, 2, 2, 1200, True),
    (5000, 0, 2, 2, 4, False),
]


def _check_against_xla(cols, n_valid, min_count, cap, got):
    ww, wc, wn = xla_finalize_sorted(tuple(jnp.asarray(c) for c in cols),
                                     jnp.int32(n_valid), jnp.int32(min_count), cap)
    assert int(got[2]) == int(wn)
    for w, g in zip(ww, got[0], strict=True):
        np.testing.assert_array_equal(np.asarray(w), u32(g))
    np.testing.assert_array_equal(np.asarray(wc), got[1].numpy())


@pytest.mark.parametrize("p,n_valid,n_words,min_count,max_run,pallas", PALLAS_CASES)
def test_finalize_twin_matches_pallas(p, n_valid, n_words, min_count, max_run,
                                      pallas):
    rng = np.random.default_rng(p + n_words)
    cols = sorted_columns(rng, p, n_words, n_valid, max_run)
    cap = 4096
    got = finalize_sorted(tuple(i32(c) for c in cols), torch.tensor(n_valid),
                          min_count=min_count, cap=cap)
    _check_against_xla(cols, n_valid, min_count, cap, got)
    if not pallas:
        return
    ww, wc, wn = finalize_sorted_pallas(tuple(jnp.asarray(c) for c in cols),
                                        n_valid, min_count=min_count, cap=cap,
                                        interpret=True)
    assert int(got[2]) == int(wn)
    n = min(int(wn), cap)  # the Pallas filler rows are zeros
    for w, g in zip(ww, got[0], strict=True):
        np.testing.assert_array_equal(np.asarray(w)[:n], u32(g)[:n])
    np.testing.assert_array_equal(np.asarray(wc)[:n], got[1].numpy()[:n])


def test_finalize_twin_long_run_many_tiles():
    """One run spanning several Pallas tiles, counted exactly."""
    p = 3 * _FIN_TILE
    n_valid = p - 5
    col = np.full(p, 7, np.uint32)
    col[n_valid:] = ONES
    got = finalize_sorted((i32(col),), torch.tensor(n_valid), min_count=2, cap=16)
    assert int(got[2]) == 1
    assert int(u32(got[0][0])[0]) == 7 and int(got[1][0]) == n_valid
    _check_against_xla([col], n_valid, 2, 16, got)


def test_finalize_twin_overflow_reports_n_out():
    """More survivors than cap: the leading cap rows and the true n_out."""
    p = 4096
    col = np.arange(p, dtype=np.uint32) // 2  # 2048 runs of length 2
    got = finalize_sorted((i32(col),), torch.tensor(p), min_count=2, cap=64)
    assert int(got[2]) == 2048
    np.testing.assert_array_equal(u32(got[0][0]), np.arange(64))
    assert np.all(got[1].numpy() == 2)
    _check_against_xla([col], p, 2, 64, got)


# denser than the Pallas emission budget: held against the XLA finalize
DENSE_CASES = [
    # p, n_valid, n_words, min_count, max_run, cap
    (4096, 4096, 1, 2, 8, 4096),  # the Pallas kernel reports its sentinel here
    (30000, 29000, 2, 2, 6, 20000),
    (30000, 30000, 1, 1, 3, 40000),
    (20000, 19000, 3, 3, 5, 1000),  # n_out > cap
]


@pytest.mark.parametrize("p,n_valid,n_words,min_count,max_run,cap", DENSE_CASES)
def test_finalize_twin_dense_tables(p, n_valid, n_words, min_count, max_run, cap):
    rng = np.random.default_rng(p + n_words + min_count)
    if max_run == 8:  # tests/test_pallas_kernels.py:105-113: 512 runs of 8
        cols = [np.arange(p, dtype=np.uint32) // 8]
    else:
        cols = sorted_columns(rng, p, n_words, n_valid, max_run)
    got = finalize_sorted(tuple(i32(c) for c in cols), torch.tensor(n_valid),
                          min_count=min_count, cap=cap)
    if max_run == 8:
        assert int(got[2]) == 512  # exact: no per-tile emission cap
    _check_against_xla(cols, n_valid, min_count, cap, got)
