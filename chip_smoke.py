#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mercat2_tpu_torch``).

Run from the repository root on a machine with one CUDA card::

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> exit.
2. build: compiles ``mercat2_tpu_torch/csrc/*.cu`` with nvcc.
3. kernels: each CUDA kernel against its plain PyTorch twin on the card,
   exact integer equality, at the main path's shapes (one 12M-symbol
   launch of 32 files, k=21, 2-bit DNA, min-count 10; the key build also
   at 5-bit protein, k=5 and k=21, and at 7 and 8 bits, where codes of
   128 and above set bit 31 of a word) and edge cases (every width at 1
   and 32 files, with the fused int64 column, the embedded fid and the fid
   word, k up to 256; the finalize over runs across tile edges, a run
   longer than a tile, n_valid inside a run, m = 1 and m beyond the halo,
   cap below n_out, word mode with 1, 3 and 4 columns); CUDA-event medians
   of both, the pre-sort half and the whole launch at the main shape, and
   the finalize's library yardstick (``torch.unique_consecutive``). Then
   the dense small-keyspace route against the sorted route on the main
   launch at k=5 and k=7: identical tables, both timed.
4. slice: 50 generated contig files, 194,489,190 bp, through the port's
   CLI (``-k 21 -c 10``); both kernels must have launched; 3 files are
   recounted with the plain path on the CPU and must give byte-identical
   count TSVs.
5. protein slice: 50 generated proteomes, 64,829,730 residues, through
   the CLI at ``-k 5 -c 10`` and ``-k 21 -c 10``; both kernels must have
   launched at 5 bits in each run; 3 files recounted on the CPU.
6. pipeline: MerCat2's documented run without ``-pca`` (``-k 5 -c 10
   -prod -fgs -device-metrics``) over 5 generated contig files, 19,448,919
   bp with planted genes; the whole output tree must be there, the
   nucleotide round must have gone dense and both kernels must have
   launched in the protein rounds.
7. fastq: 4 read sets of 200,000 reads of 150 bp (one gzipped), each from
   its own 2 Mbp genome, with adapter tails and low-quality 3' ends,
   through the CLI with the QC, trim and fq2fa front end (``-k 21 -c
   10``); both kernels must have launched and ``clean/`` must hold the
   front end's files; one sample recounted on the CPU.
8. wide codecs: a 7-bit printable alphabet through the CLI at ``-c 2``,
   k=3 and k=21 (launches at 7 bits; one file recounted on the CPU); an
   8-bit alphabet with bytes of 0x80 and above through the engine
   (``KmerCounter`` on the card against the same calls on the CPU), since
   the CLI stops in ``kmer_summary`` on such bytes, as the JAX CLI does.
9. mesh: the sharded count of ``mercat2_tpu_torch/parallel/`` over four
   shards of cuda:0 (and over every card when there are several; with one
   card that run is reported as not run): phase 4's cleaned files through
   ``pipeline._count_group_mesh``, every count TSV byte-identical to phase
   4's, both kernels launched once a shard a batch; CUDA-event times of
   its three stages (pre-sort and sort, exchange with its host sync,
   merge sort and finalize) on the first batch; phase 5's proteomes at
   k=21 (4 int32 key columns) through ``sharded_count_sources`` against
   the single-device counter; the sharded dense histogram at k=5 against
   ``count_kmers_dense``; two CLI processes joined by a gloo group (rank
   0 and 1 on one card) over 8 of the slice's files against one process.

The last line is ``{"ok": true, "device": {...}}``; the line before it a
JSON object with each kernel's launches (summed over phases 4-9), error,
times, bound (bytes at the H100 SXM's 3.35 TB/s) and library yardstick.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
#: generated inputs and outputs, one folder a phase; removed at the end
WORK = REPO / "chip_smoke_work"

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: bench.py's sustained set: 50 files, 194,489,190 bp
N_FILES = 50
N_BASES = 194_489_190
K = 21
MIN_COUNT = 10
#: the protein content of that set: 50 proteomes, 64,829,730 residues
N_RESIDUES = 64_829_730
#: the size of the 5-genome set of bench.py's full-pipeline row
PIPE_FILES = 5
PIPE_BASES = 19_448_919
#: the main path's launch shape (KmerCounter._UNIFORM_SYMS, 32 files)
MAIN_SYMS = 12 << 20
MAIN_FILES = 32
MAIN_CAP = 1 << 19
REPS = 10
#: device-memory bandwidth of the H100 SXM (NVIDIA's data sheet, 700 W)
PEAK_BYTES_S = 3.35e12

KERNELS = {
    "build_keys": {
        "source": "mercat2_tpu_torch/csrc/build_keys.cu",
        "replaces": "mercat2_tpu/ops/pallas_finalize.py:423",
    },
    "finalize": {
        "source": "mercat2_tpu_torch/csrc/finalize.cu",
        "replaces": "mercat2_tpu/ops/pallas_finalize.py:254",
    },
}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, after one warm-up
    run: CUDA events around each call, after a sleep on the stream that
    lets the host enqueue the call first, so that host overhead does not
    count where the call does not sync."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest absolute difference of two tuples of integer tensors;
    raises when shapes or dtypes differ."""
    err = 0
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs vs {len(want)}")
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def main_path_group(rng, n_sym: int, n_files: int, bits: int = 2):
    """One launch's transport at the main path's shape: random symbols
    with planted 12-fold repeats, ``n_files`` word-aligned files, record
    gaps and a gap before each file."""
    from mercat2_tpu_torch.engine.host import PackedGroup

    per = 32 // bits
    n_words = n_sym // per
    words = rng.integers(0, 1 << 32, size=n_words, dtype=np.uint64).astype(np.uint32)
    words &= np.uint32(~((1 << (32 - per * bits)) - 1) & 0xFFFFFFFF)  # unused low bits
    fam = 500  # words per repeat unit: 20 tandem families of 12 copies
    for src in rng.choice(n_words // (12 * fam), 20, replace=False) * 12 * fam:
        words[src + fam : src + 12 * fam] = np.tile(words[src : src + fam], 11)
    words[100:400] = 0  # a long run of one k-mer (poly-A)
    starts = np.sort(rng.choice(np.arange(1, n_words), n_files - 1, replace=False)) * per
    starts = np.concatenate([[0], starts]).astype(np.int32)
    rec = rng.integers(0, n_sym - 10, size=400)
    gb = np.concatenate([rec, starts[1:] - 1, [n_sym]])
    ge = np.concatenate([rec + 3, starts[1:], [n_sym]])
    return PackedGroup(words=words, n_sym=n_sym, file_starts=starts,
                       gap_begin=gb.astype(np.int32), gap_end=ge.astype(np.int32))


def bound_ms(n_bytes: int) -> float:
    """The least time the card could take to move ``n_bytes`` once."""
    return n_bytes / PEAK_BYTES_S * 1e3


#: rows of a finalize tile of the fused column (csrc/finalize.cu); word
#: columns take this many or a power-of-two fraction, so its multiples are
#: tile edges in every form
FIN_TILE = 4096
#: the fused column's invalid marker: all-ones with the sign bit flipped
MARK64 = (1 << 63) - 1


def edge_columns(rng, dev, p: int, m: int, n_words: int):
    """Sorted keys in runs of 1..2m+4 rows, one run of 1.5 tiles across a
    tile edge, and n_valid inside a run; ``n_words`` 0 gives one fused
    int64 column, else that many int32 word columns. Returns (columns,
    n_valid)."""
    is_start = np.zeros(p, bool)
    is_start[np.cumsum(rng.integers(1, 2 * m + 5, size=p))[: p // 2].clip(max=p - 1)] = True
    is_start[0] = True
    long0 = FIN_TILE + 2000
    is_start[long0 + 1 : long0 + 6144] = False
    is_start[long0] = is_start[long0 + 6144] = True
    run = np.cumsum(is_start) - 1
    begins = np.flatnonzero(is_start)
    lens = np.diff(np.append(begins, p))
    n_valid = int(begins[(lens >= 4) & (begins > p - FIN_TILE)][0]) + 2
    if not any(run[e - 1] == run[e] and lens[run[e]] >= max(m, 2)
               for e in range(FIN_TILE, p, FIN_TILE)):
        raise AssertionError("no surviving run crosses a tile edge")
    key = run.astype(np.int64) * 3 + 1
    if n_words == 0:
        key[n_valid:] = MARK64
        return (torch.from_numpy(key).to(dev),), n_valid
    width = -(-20 // n_words)
    cols = []
    for c in range(n_words):
        col = ((key >> (width * (n_words - 1 - c))) & ((1 << width) - 1)).astype(np.uint32)
        col[n_valid:] = 0xFFFFFFFF
        cols.append(torch.from_numpy(col.view(np.int32)).to(dev))
    return tuple(cols), n_valid


def phase_kernels(dev, seed: int) -> dict:
    """Each kernel against its plain twin on the card. Returns per-kernel
    results (max_abs_err over every case, main-shape times, bytes moved,
    library yardstick) and the main launch's pre-sort-half and
    whole-launch times."""
    from mercat2_tpu_torch.engine.counter import to_torch_group
    from mercat2_tpu_torch.ops.build_keys import build_keys, build_keys_plain
    from mercat2_tpu_torch.ops.finalize import (
        count_kmers_packed, packed_sort_keys, packed_window_validity, sort_words,
    )
    from mercat2_tpu_torch.ops.finalize_kernel import (
        finalize_sorted, finalize_sorted_plain,
    )

    rng = np.random.default_rng(seed)
    res = {name: {"max_abs_err": 0} for name in KERNELS}

    def check(name, case, got, want):
        err = max_abs_err(got, want)
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        print(f"  {name} {case}: max_abs_err={err}", flush=True)
        if err:
            raise AssertionError(f"{name} {case}: kernel != plain twin")

    def keys_case(grp, k, bits, n_sym, n_files):
        """build_keys against its twin on ``n_sym`` symbols of ``grp``;
        returns the call's arguments."""
        words = grp.words[: n_sym // (32 // bits)]
        p = words.shape[0] * (32 // bits) - k + 1
        valid = packed_window_validity(grp.gap_begin, grp.gap_end, k, p)
        args = (words, valid, grp.file_starts if n_files > 1 else None)
        kw = dict(k=k, bits=bits, p=p, n_files=n_files)
        (gc, gn), (wc, wn) = build_keys(*args, **kw), build_keys_plain(*args, **kw)
        form = "fused int64" if gc[0].dtype == torch.int64 else f"{len(gc)} int32"
        check("build_keys", f"k={k} bits={bits} files={n_files} p={p} ({form})",
              (*gc, gn), (*wc, wn))
        return args, kw

    # -- build_keys at the main shape, then every width at 1 and 32 files:
    # a key of one word and part of the next (fused), one word (the
    # tie-break or fid word: fused), and many words ------------------------
    g = to_torch_group(main_path_group(rng, MAIN_SYMS, MAIN_FILES), dev)
    args, kw = keys_case(g, K, 2, MAIN_SYMS, MAIN_FILES)
    r = res["build_keys"]
    r["plain_ms"] = cuda_ms(lambda: build_keys_plain(*args, **kw))
    r["ms"] = cuda_ms(lambda: build_keys(*args, **kw))
    r["plain_ms_2"] = cuda_ms(lambda: build_keys_plain(*args, **kw))
    words, valid = args[0], args[1]
    r["bytes"] = words.numel() * 4 + kw["p"] * (1 + 8) + MAIN_FILES * 4 + 8
    for bits, grp in ((1, g), (2, g), (4, g)):
        for k in sorted({32 // bits, 40 // bits + 1, 5, 31, 130}):
            for n_files in (1, MAIN_FILES):
                keys_case(grp, k, bits, 1 << 20, n_files)

    # -- 5-bit protein (6 symbols a word, keys straddle words), then the
    # other widths that do not divide 32 -----------------------------------
    gp = to_torch_group(main_path_group(rng, MAIN_SYMS, MAIN_FILES, bits=5), dev)
    for k in (5, 21, 6, 1, 256):  # k=6: the fid takes a word of its own
        args5, kw5 = keys_case(gp, k, 5, MAIN_SYMS, MAIN_FILES)
        if k == 21:
            r["bits5_plain_ms"] = cuda_ms(lambda: build_keys_plain(*args5, **kw5))
            r["bits5_ms"] = cuda_ms(lambda: build_keys(*args5, **kw5))
            r["bits5_plain_ms_2"] = cuda_ms(lambda: build_keys_plain(*args5, **kw5))
    for k in (6, 7, 9, 21):
        keys_case(gp, k, 5, 1 << 20, 1)
    for bits in (3, 6):
        per = 32 // bits
        n_sym = (2 << 20) // per * per
        ge = to_torch_group(main_path_group(rng, n_sym, MAIN_FILES, bits=bits), dev)
        for k in sorted({1, 32 // bits, 40 // bits + 1, 130, 256}):
            for n_files in (1, MAIN_FILES):
                keys_case(ge, k, bits, n_sym, n_files)

    # -- 7 and 8 bits (four symbols a word): random codes up to 127 and
    # 255, so at 8 bits a slot-0 code sets bit 31 of its word -------------
    for bits, ks in ((7, (3, 21)), (8, (4, 21))):
        gw = to_torch_group(main_path_group(rng, MAIN_SYMS, MAIN_FILES, bits=bits), dev)
        if bits == 8 and not bool((gw.words < 0).any()):
            raise AssertionError("no 8-bit word with a code >= 128 in slot 0")
        for k in ks:
            argw, kww = keys_case(gw, k, bits, MAIN_SYMS, MAIN_FILES)
            t = [cuda_ms(lambda: build_keys_plain(*argw, **kww)),
                 cuda_ms(lambda: build_keys(*argw, **kww)),
                 cuda_ms(lambda: build_keys(*argw, **kww)),
                 cuda_ms(lambda: build_keys_plain(*argw, **kww))]
            r[f"bits{bits}_k{k}"] = t
            print(f"  build_keys bits={bits} k={k}: plain, kernel, kernel, plain "
                  f"{t!r} ms", flush=True)
        for k in (32 // bits, 40 // bits + 1):
            for n_files in (1, MAIN_FILES):
                keys_case(gw, k, bits, 1 << 20, n_files)

    # -- finalize at the main shape (fused u64 keys), then edge cases ----
    main = dict(k=K, bits=2, n_files=MAIN_FILES, n_sym=MAIN_SYMS)
    (col,), n_valid, _ = packed_sort_keys(g.words, g.gap_begin, g.gap_end,
                                          g.file_starts, **main)
    s = torch.sort(col).values
    fin = dict(min_count=MIN_COUNT, cap=MAIN_CAP)
    got = finalize_sorted((s,), n_valid, **fin)
    want = finalize_sorted_plain((s,), n_valid, **fin)
    check("finalize", f"main u64 p={s.shape[0]} n_out={int(want[2])}",
          (*got[0], got[1], got[2]), (*want[0], want[1], want[2]))
    if int(want[2]) == 0:
        raise AssertionError("main-shape finalize kept no rows: the case tests nothing")
    f = res["finalize"]
    f["plain_ms"] = cuda_ms(lambda: finalize_sorted_plain((s,), n_valid, **fin))
    f["ms"] = cuda_ms(lambda: finalize_sorted((s,), n_valid, **fin))
    f["plain_ms_2"] = cuda_ms(lambda: finalize_sorted_plain((s,), n_valid, **fin))
    f["bytes"] = int(n_valid) * 8 + MAIN_CAP * (8 + 4) + 8 + 4

    def library():  # one PyTorch call for the same function, syncs included
        u, c = torch.unique_consecutive(s[: int(n_valid)], return_counts=True)
        keep = c >= MIN_COUNT
        return u[keep], c[keep]

    if len(library()[0]) != int(want[2]):
        raise AssertionError("unique_consecutive keeps another number of rows")
    f["library_ms"] = cuda_ms(library)

    keyed31, nv31, _ = packed_sort_keys(
        g.words, g.gap_begin, g.gap_end, g.file_starts, k=31, bits=2,
        n_files=MAIN_FILES, n_sym=MAIN_SYMS)
    words31 = tuple(sort_words(keyed31))  # fid word: 3 int32 columns
    protein = {}  # the protein path's word mode: 1 column at k=5, 4 at k=21
    for k in (5, 21):
        keyed_p, nv_p, _ = packed_sort_keys(
            gp.words, gp.gap_begin, gp.gap_end, gp.file_starts, k=k, bits=5,
            n_files=MAIN_FILES, n_sym=MAIN_SYMS)
        protein[k] = (tuple(sort_words(keyed_p)), nv_p)
    p = s.shape[0]
    run = torch.full((p,), 12345, dtype=torch.int64, device=dev)
    cut = int(n_valid) // 2  # n_valid inside a run of the main column
    while not bool(s[cut - 1] == s[cut]):
        cut += 1
    cases = [
        ("min_count=1", (s,), n_valid, 1, MAIN_CAP),
        ("m=100, beyond the halo", (s,), n_valid, 100, MAIN_CAP),
        ("n_out>cap", (s,), n_valid, MIN_COUNT, 1000),
        ("n_valid inside a run", (s,), torch.tensor(cut, device=dev), 2, MAIN_CAP),
        ("empty n_valid=0", (s,), torch.zeros((), dtype=torch.int64, device=dev), 2, 64),
        ("one run spans the column", (run,), torch.tensor(p, device=dev), 2, 16),
        ("3 words k=31", words31, nv31, MIN_COUNT, MAIN_CAP),
        ("bits=5 k=5, 1 word", *protein[5], 2, MAIN_CAP),
        ("bits=5 k=21, 4 words", *protein[21], 2, MAIN_CAP),
    ]
    erng = np.random.default_rng([seed, 5])
    for m in (1, 10, 100):
        for n_words in (0, 1, 3, 4):
            cols, nv = edge_columns(erng, dev, 5 * FIN_TILE + 123, m, n_words)
            form = f"{n_words} words" if n_words else "u64"
            for cap in (1 << 20, 7):
                cases.append((f"tile edges m={m} {form} cap={cap}", cols,
                              torch.tensor(nv, device=dev), m, cap))
    for case, cols, nv, mc, cap in cases:
        got = finalize_sorted(cols, nv, min_count=mc, cap=cap)
        want = finalize_sorted_plain(cols, nv, min_count=mc, cap=cap)
        check("finalize", f"{case} n_out={int(want[2])}",
              (*got[0], got[1], got[2]), (*want[0], want[1], want[2]))
        if case == "n_out>cap" and int(want[2]) <= cap:
            raise AssertionError("the n_out > cap case did not overflow")

    # -- the main launch: pre-sort half (validity -> the column torch.sort
    # takes) and the whole launch (pre-sort, sort, finalize, split) -------
    launch_args = (g.words, g.gap_begin, g.gap_end, g.file_starts)
    times = {
        "presort_ms": cuda_ms(lambda: packed_sort_keys(*launch_args, **main), reps=20),
        "launch_ms": cuda_ms(lambda: count_kmers_packed(
            *launch_args, MIN_COUNT, cap=MAIN_CAP, **main), reps=20),
    }
    torch.cuda.synchronize()
    return res, times


def phase_dense(dev, seed: int) -> dict:
    """The dense route against the sorted route on the main launch shape
    (12M symbols, 32 files, 2 bits, min-count 10) at k=5 and k=7: the
    per-file tables must be identical; CUDA-event medians of both routes
    (each from validity to the compacted table)."""
    from mercat2_tpu_torch.engine.codec import DNA_CODEC
    from mercat2_tpu_torch.engine.counter import KmerCounter, to_torch_group
    from mercat2_tpu_torch.ops.dense_hist import count_kmers_dense
    from mercat2_tpu_torch.ops.finalize import count_kmers_packed

    rng = np.random.default_rng([seed, 3])
    group = main_path_group(rng, MAIN_SYMS, MAIN_FILES)
    g = to_torch_group(group, dev)
    times = {}
    for k in (5, 7):
        c = KmerCounter(k, DNA_CODEC, dev)
        if not c.dense:
            raise AssertionError(f"k={k} DNA does not route dense")
        dense = c.dispatch_packed_fixed(group, MIN_COUNT, MAIN_FILES)
        c.dense = False
        sort = c.dispatch_packed_fixed(group, MIN_COUNT, MAIN_FILES)
        rows = 0
        for f in range(MAIN_FILES):
            a, b = dense.row_table(f), sort.row_table(f)
            if not (np.array_equal(a.kmers, b.kmers) and np.array_equal(a.counts, b.counts)):
                raise AssertionError(f"dense k={k}: file {f} differs from the sorted route")
            rows += len(a)
        if rows == 0:
            raise AssertionError(f"dense k={k}: no rows kept; the case tests nothing")
        kw = dict(k=k, bits=2, n_files=MAIN_FILES, n_sym=MAIN_SYMS)
        args = (g.words, g.gap_begin, g.gap_end, g.file_starts, MIN_COUNT)
        t = [cuda_ms(lambda: count_kmers_packed(*args, cap=MAIN_CAP, **kw)),
             cuda_ms(lambda: count_kmers_dense(*args, alphabet_size=4, **kw)),
             cuda_ms(lambda: count_kmers_dense(*args, alphabet_size=4, **kw)),
             cuda_ms(lambda: count_kmers_packed(*args, cap=MAIN_CAP, **kw))]
        times[k] = t
        print(f"  dense k={k}: {rows} rows over {MAIN_FILES} files, identical to the "
              f"sorted route; sorted, dense, dense, sorted {t!r} ms", flush=True)
    return times


def write_inputs(folder: Path, seed: int) -> list[Path]:
    """50 contig FASTA files, N_BASES symbols in all, made from ``seed``.

    Each file has 20 records, three N runs (the clean stage splits the
    records there) and planted repeat families of 12 copies with 0.1%
    substitutions, so each keeps >= 10^4 21-mers at min-count 10. Files
    0-2 (the first launch) carry 20 families of 10 kbp each: more
    survivors than a launch's 2^19 output rows, so that launch reruns
    with a larger cap. File 5 holds a 5000-base poly-A run.
    """
    folder.mkdir(parents=True, exist_ok=True)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    sizes = np.full(N_FILES, N_BASES // N_FILES)
    sizes[0] += N_BASES - sizes.sum()
    paths = []
    for f, size in enumerate(sizes):
        rng = np.random.default_rng([seed, f])
        seq = rng.integers(0, 4, size=size, dtype=np.uint8)
        n_fam, fam_len = (20, 10_000) if f < 3 else (5, 3_000)
        fams = rng.integers(0, 4, size=(n_fam, fam_len), dtype=np.uint8)
        order = rng.permutation(np.repeat(np.arange(n_fam), 12))
        spacing = size // len(order)
        for j, fam in enumerate(order):
            copy = fams[fam].copy()
            hit = rng.random(fam_len) < 0.001
            copy[hit] = rng.integers(0, 4, size=int(hit.sum()), dtype=np.uint8)
            at = j * spacing + int(rng.integers(0, spacing - fam_len))
            seq[at : at + fam_len] = copy
        seq = acgt[seq]
        if f == 5:
            seq[1000:6000] = ord("A")
        for at in rng.integers(0, size - 50, size=3):
            seq[at : at + int(rng.integers(5, 50))] = ord("N")
        cuts = np.sort(rng.choice(np.arange(1, size), 19, replace=False))
        path = folder / f"sample{f:02d}.fna"
        with open(path, "wb") as fh:
            for r, rec in enumerate(np.split(seq, cuts)):
                fh.write(f">s{f:02d}_rec{r} synthetic contig\n".encode())
                full = rec[: len(rec) // 80 * 80].reshape(-1, 80)
                lines = np.concatenate(
                    [full, np.full((full.shape[0], 1), ord("\n"), np.uint8)], axis=1)
                fh.write(lines.tobytes())
                if len(rec) % 80:
                    fh.write(rec[full.size :].tobytes() + b"\n")
        paths.append(path)
    return paths


AMINO = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
#: the 61 sense codons and the 3 stops, as bytes
SENSE = np.array([[a, b, c] for a in b"ACGT" for b in b"ACGT" for c in b"ACGT"
                  if bytes([a, b, c]) not in (b"TAA", b"TAG", b"TGA")], np.uint8)
STOPS = np.array([list(b"TAA"), list(b"TAG"), list(b"TGA")], np.uint8)
COMPLEMENT = np.zeros(256, np.uint8)
COMPLEMENT[list(b"ACGT")] = list(b"TGCA")


def write_records(path: Path, records, width: int) -> None:
    """FASTA of (name, uint8 sequence) records, ``width`` symbols a line."""
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b">" + name.encode() + b"\n")
            full = seq[: len(seq) // width * width].reshape(-1, width)
            lines = np.concatenate(
                [full, np.full((full.shape[0], 1), ord("\n"), np.uint8)], axis=1)
            fh.write(lines.tobytes())
            if len(seq) % width:
                fh.write(seq[full.size :].tobytes() + b"\n")


def write_proteomes(folder: Path, seed: int) -> list[Path]:
    """50 protein FASTA files, N_RESIDUES residues in all, made from
    ``seed``: ~4,000 proteins of 100-600 aa a file over the 20 amino
    acids with a rare X (0.1%), among them 10 paralog families of 12
    identical copies, so that each file keeps >= 10^3 k-mers at
    min-count 10 for k=5 and k=21."""
    folder.mkdir(parents=True, exist_ok=True)
    sizes = np.full(N_FILES, N_RESIDUES // N_FILES)
    sizes[0] += N_RESIDUES - sizes.sum()
    paths = []
    for f, size in enumerate(sizes):
        rng = np.random.default_rng([seed, 1000 + f])
        fams = [AMINO[rng.integers(0, 20, size=int(rng.integers(200, 400)))]
                for _ in range(10)]
        rest = int(size) - 12 * sum(len(x) for x in fams)
        body = AMINO[rng.integers(0, 20, size=rest)]
        body[rng.random(rest) < 0.001] = ord("X")
        lens = rng.integers(100, 601, size=rest // 100)
        n = int(np.searchsorted(np.cumsum(lens), rest))
        lens = lens[: n + 1]
        lens[-1] -= int(lens.sum()) - rest
        prots = np.split(body, np.cumsum(lens)[:-1]) + [x for x in fams for _ in range(12)]
        order = rng.permutation(len(prots))
        path = folder / f"proteome{f:02d}.faa"
        write_records(path, [(f"p{f:02d}_{i} synthetic protein", prots[j])
                             for i, j in enumerate(order)], 60)
        paths.append(path)
    return paths


def write_genomes(folder: Path, seed: int) -> list[Path]:
    """PIPE_FILES contig files, PIPE_BASES bp in all, made from ``seed``:
    genes (ATG, 100-600 random sense codons, a stop) on both strands
    between random spacers of 50-300 bp, 15 of them in 12 identical
    copies a file (so that the protein rounds keep rows at min-count 10),
    cut into 40 contigs with a few N runs."""
    folder.mkdir(parents=True, exist_ok=True)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    sizes = np.full(PIPE_FILES, PIPE_BASES // PIPE_FILES)
    sizes[0] += PIPE_BASES - sizes.sum()
    paths = []
    for f, size in enumerate(sizes):
        rng = np.random.default_rng([seed, 2000 + f])

        def gene():
            codons = SENSE[rng.integers(0, 61, size=int(rng.integers(100, 601)))]
            return np.concatenate([np.frombuffer(b"ATG", np.uint8), codons.ravel(),
                                   STOPS[rng.integers(0, 3)]])

        fams = [gene() for _ in range(15)]
        genes = [x for x in fams for _ in range(12)]
        total = sum(len(g) for g in genes)
        while total < size:
            genes.append(gene())
            total += len(genes[-1])
        parts = []
        for j in rng.permutation(len(genes)):
            g = genes[j]
            parts.append(acgt[rng.integers(0, 4, size=int(rng.integers(50, 301)))])
            parts.append(COMPLEMENT[g[::-1]] if rng.random() < 0.5 else g)
        seq = np.concatenate(parts)[:size]
        # records of 1-2 bp crash FragGeneScanRs: cut near even spacing,
        # and put the N runs in the middle of records
        cuts = np.arange(1, 40) * (size // 40) + rng.integers(-1000, 1000, size=39)
        for r in rng.choice(39, 5, replace=False):
            at = int(cuts[r]) + size // 80
            seq[at : at + int(rng.integers(5, 50))] = ord("N")
        path = folder / f"genome{f}.fna"
        write_records(path, [(f"g{f}_ctg{r} synthetic contig", rec)
                             for r, rec in enumerate(np.split(seq, cuts))], 80)
        paths.append(path)
    return paths


def tsv_rows(path: Path) -> int:
    with open(path, "rb") as fh:
        return sum(1 for _ in fh) - 1


def run_cli(argv: list) -> float:
    """The port's CLI, its log kept back except for the stage times (the
    whole log goes to stderr if it raises; the last run's is kept as
    ``run_cli.log``); returns the wall time."""
    from mercat2_tpu_torch import cli

    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            cli.main([str(a) for a in argv])
        torch.cuda.synchronize()
    except BaseException:
        sys.stderr.write(log.getvalue())
        raise
    wall = time.perf_counter() - t0
    run_cli.log = log.getvalue()
    for line in run_cli.log.splitlines():
        if line.startswith(("Time", "Processing", "Running")):
            print(f"    {line.strip()}")
    return wall


#: what a main path's run counts: the two kernels, and the dense route
#: (plain PyTorch, no kernel; its count shows that a round took it)
COUNTED = ("build_keys", "finalize", "dense")


def launch_counts() -> dict:
    from mercat2_tpu_torch.ops.build_keys import build_keys
    from mercat2_tpu_torch.ops.dense_hist import count_kmers_dense
    from mercat2_tpu_torch.ops.finalize_kernel import finalize_sorted

    return {"build_keys": build_keys.launches, "finalize": finalize_sorted.launches,
            "dense": count_kmers_dense.launches}


def reset_counts() -> None:
    from mercat2_tpu_torch.ops.build_keys import build_keys
    from mercat2_tpu_torch.ops.dense_hist import count_kmers_dense
    from mercat2_tpu_torch.ops.finalize_kernel import finalize_sorted

    build_keys.launches = finalize_sorted.launches = count_kmers_dense.launches = 0


@contextlib.contextmanager
def launches_by_bits():
    """Launches of the count path while the block runs, keyed by the
    codec's bits per symbol (read off each sorted ``count_kmers_packed``
    and dense ``count_kmers_dense`` call of the counter; the counts are
    read before and after it)."""
    from mercat2_tpu_torch.engine import counter

    seen: dict[int, dict[str, int]] = {}
    inner = {name: getattr(counter, name)
             for name in ("count_kmers_packed", "count_kmers_dense")}

    def spy_of(fn):
        def spy(*args, bits, **kw):
            before = launch_counts()
            out = fn(*args, bits=bits, **kw)
            by = seen.setdefault(bits, dict.fromkeys(COUNTED, 0))
            for name, n in launch_counts().items():
                by[name] += n - before[name]
            return out
        return spy

    for name, fn in inner.items():
        setattr(counter, name, spy_of(fn))
    try:
        yield seen
    finally:
        for name, fn in inner.items():
            setattr(counter, name, fn)


def drive(argv: list) -> tuple[float, dict, dict]:
    """One run of a main path through the CLI: every count is set to 0
    just before it and read just after. Returns the wall time, the
    launches, and the launches by bits per symbol."""
    reset_counts()
    with launches_by_bits() as by_bits:
        wall = run_cli(argv)
    launches = launch_counts()
    if launches != {name: sum(b[name] for b in by_bits.values()) for name in launches}:
        raise AssertionError(f"launches outside the count path: {launches} {by_bits}")
    return wall, launches, by_bits


def both_kernels(by: dict) -> bool:
    return by.get("build_keys", 0) > 0 and by.get("finalize", 0) > 0


def recount_on_cpu(tag: str, paths: list, card_tsv: Path, out: Path, argv: list) -> None:
    """Count ``paths`` again with the plain path on the CPU; their count
    TSVs must be byte-identical to the card's in ``card_tsv``."""
    t0 = time.perf_counter()
    run_cli([*argv, "-i", *paths, "-o", out, "-replace", "-device", "cpu"])
    for p in paths:
        name = p.name.removesuffix("".join(p.suffixes))
        a = (card_tsv / f"{name}_counts.tsv").read_bytes()
        b = (out / card_tsv.name / f"{name}_counts.tsv").read_bytes()
        if a != b:
            raise AssertionError(f"{tag}: {name}: card and CPU count TSVs differ")
    print(f"{tag}: CPU recount of {[p.name for p in paths]} byte-identical "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_slice(dev, seed: int) -> dict:
    """The port's CLI over the generated set on the card, then 3 files
    recounted with the plain path on the CPU; returns the launches. The
    inputs, the output tree and the CLI's log stay in ``WORK / "slice"``
    for phase 9."""
    from mercat2_tpu_torch.io.native import native_lib
    from mercat2_tpu_torch.engine.counter import KmerCounter

    work = WORK / "slice"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_inputs(work / "in", seed)
    print(f"slice: wrote {len(paths)} files, {N_BASES} bp in "
          f"{time.perf_counter() - t0:.1f} s; FASTA parser: "
          f"{'native C++' if native_lib() is not None else 'numpy'}", flush=True)

    wall, launches, _ = drive(["-k", K, "-f", work / "in", "-o", work / "out",
                               "-c", MIN_COUNT, "-replace"])
    (work / "cli.log").write_text(run_cli.log)

    tsvs = {p.stem.removesuffix("_counts"): p
            for p in (work / "out" / "tsv_nucleotide").glob("*_counts.tsv")}
    rows = {name: tsv_rows(p) for name, p in tsvs.items()}
    print(f"slice: wall {wall!r} s, {N_BASES / wall!r} bases/s, "
          f"{sum(rows.values())} rows kept over {len(rows)} files, "
          f"launches {launches}", flush=True)
    if len(rows) != N_FILES or min(rows.values()) < 10_000:
        raise AssertionError(f"expected {N_FILES} tables of >= 10^4 rows: {rows}")
    if not both_kernels(launches) or launches["dense"]:
        raise AssertionError(f"both kernels and no dense launch expected: {launches}")
    first = sum(rows[f"sample{f:02d}"] for f in range(3))
    if first <= KmerCounter._UNIFORM_CAP:
        raise AssertionError(f"launch 0 kept {first} rows: no overflow rerun")
    print(f"slice: launch 0 (sample00-02) kept {first} rows > cap "
          f"{KmerCounter._UNIFORM_CAP}: the overflow rerun ran", flush=True)

    recount_on_cpu("slice", [paths[0], paths[5], paths[-1]],
                   work / "out" / "tsv_nucleotide", work / "cpu",
                   ["-k", K, "-c", MIN_COUNT])
    return launches


def phase_protein(dev, seed: int) -> dict:
    """The port's CLI over 50 generated proteomes at k=5 and k=21 on the
    card, then 3 files recounted on the CPU; returns the launches. The
    proteomes and the k=21 tree stay in ``WORK / "protein"`` for phase 9."""
    work = WORK / "protein"
    shutil.rmtree(work, ignore_errors=True)
    total = dict.fromkeys(COUNTED, 0)
    t0 = time.perf_counter()
    paths = write_proteomes(work / "faa", seed)
    print(f"protein: wrote {len(paths)} files, {N_RESIDUES} residues in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for k in (5, 21):
        out = work / f"out{k}"
        wall, launches, by_bits = drive(["-k", k, "-f", work / "faa", "-o", out,
                                         "-c", MIN_COUNT, "-replace"])
        rows = {p.name: tsv_rows(p) for p in (out / "tsv_protein").glob("*_counts.tsv")}
        print(f"protein k={k}: wall {wall!r} s, {N_RESIDUES / wall!r} residues/s, "
              f"{sum(rows.values())} rows kept over {len(rows)} files, "
              f"launches by bits {by_bits}", flush=True)
        if len(rows) != N_FILES or min(rows.values()) < 1000:
            raise AssertionError(f"expected {N_FILES} tables of >= 10^3 rows: {rows}")
        if set(by_bits) != {5} or not both_kernels(by_bits[5]) or launches["dense"]:
            raise AssertionError(f"both kernels must launch at 5 bits: {by_bits}")
        for name in total:
            total[name] += launches[name]
        recount_on_cpu(f"protein k={k}", [paths[0], paths[7], paths[-1]],
                       out / "tsv_protein", work / f"cpu{k}",
                       ["-k", k, "-c", MIN_COUNT])
    return total


def phase_pipeline(dev, seed: int) -> dict:
    """MerCat2's documented run without -pca on 5 generated genomes;
    returns the launches."""
    work = WORK / "pipeline"
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        write_genomes(work / "nt", seed)
        print(f"pipeline: wrote {PIPE_FILES} files, {PIPE_BASES} bp in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out = work / "out"
        wall, launches, by_bits = drive(["-k", 5, "-f", work / "nt", "-o", out,
                                         "-c", MIN_COUNT, "-prod", "-fgs",
                                         "-device-metrics", "-replace"])
        rows = {sub: sum(tsv_rows(p) for p in (out / sub).glob("*_counts.tsv"))
                for sub in ("tsv_nucleotide", "tsv_prodigal", "tsv_fgs")}
        print(f"pipeline: wall {wall!r} s, {PIPE_BASES / wall!r} bases/s, rows kept "
              f"{rows}, launches by bits {by_bits}", flush=True)
        if min(rows.values()) == 0:
            raise AssertionError(f"a round kept no rows: {rows}")
        missing = [f for f in (
            "combined_Nucleotide.tsv", "combined_Nucleotide_T.tsv",
            "combined_prodigal.tsv", "combined_prodigal_T.tsv",
            "combined_fgs.tsv", "combined_fgs_T.tsv", "report/report.html",
            "report/diversity-Nucleotide.tsv", "report/diversity-prodigal.tsv",
            "report/diversity-fgs.tsv", "report/metrics-prodigal.tsv",
            "report/metrics-fgs.tsv", "report/diversity/braycurtis-Nucleotide.tsv",
            "report/beta_diversity/braycurtis-fgs.tsv") if not (out / f).is_file()]
        if missing:
            raise AssertionError(f"missing from the output tree: {missing}")
        if 5 not in by_bits or not both_kernels(by_bits[5]):
            raise AssertionError(f"the protein rounds launched no kernel: {by_bits}")
        if not by_bits.get(2, {}).get("dense"):
            raise AssertionError(f"the k=5 nucleotide round did not go dense: {by_bits}")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


#: the fastq phase: read sets of 150 bp reads, each from its own 2 Mbp
#: genome at ~15x coverage, so that -c 10 keeps rows
FQ_SETS = 4
FQ_READS = 200_000
FQ_LEN = 150
FQ_GENOME = 2_000_000
#: what a read runs into past a short insert: the TruSeq read-1 adapter,
#: an index and the P7 end
ADAPTER = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCACATCACGATCTCGTATGCCGTCTTCTGCTTG"


def write_reads(folder: Path, seed: int) -> list[Path]:
    """FQ_SETS read sets of FQ_READS reads of FQ_LEN bp, made from
    ``seed``, each from its own FQ_GENOME bp genome with 0.5% substitutions;
    10% of the reads run into ``ADAPTER`` after an insert of 87-141 bp,
    10% have a low-quality 3' tail of 20-90 bases (fastp's default filter
    drops those above 40% of the read). The last set is gzipped."""
    folder.mkdir(parents=True, exist_ok=True)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    adapter = np.frombuffer(ADAPTER, np.uint8)
    pos = np.arange(FQ_LEN)
    paths = []
    for i in range(FQ_SETS):
        rng = np.random.default_rng([seed, 3000 + i])
        genome = rng.integers(0, 4, size=FQ_GENOME, dtype=np.uint8)
        starts = rng.integers(0, FQ_GENOME - FQ_LEN, size=FQ_READS)
        codes = genome[starts[:, None] + pos]
        hit = rng.random(codes.shape) < 0.005
        codes[hit] = (codes[hit] + rng.integers(1, 4, size=int(hit.sum()))) % 4
        seq = acgt[codes]
        ad = np.flatnonzero(rng.random(FQ_READS) < 0.10)
        into = pos - rng.integers(FQ_LEN - adapter.size, FQ_LEN - 8, size=ad.size)[:, None]
        rows = seq[ad]
        rows[into >= 0] = adapter[into[into >= 0]]
        seq[ad] = rows
        qual = (rng.integers(30, 41, size=codes.shape) + 33).astype(np.uint8)
        lq = np.flatnonzero(rng.random(FQ_READS) < 0.10)
        tail = rng.integers(20, 91, size=lq.size)[:, None]
        rows = qual[lq]
        rows[pos >= FQ_LEN - tail] = ord("#")
        qual[lq] = rows
        head = np.frombuffer("".join(f"@s{i}_{r:06d} read {r:06d}\n" for r in range(FQ_READS))
                             .encode(), np.uint8).reshape(FQ_READS, -1)
        nl = np.full((FQ_READS, 1), ord("\n"), np.uint8)
        plus = np.tile(np.frombuffer(b"\n+\n", np.uint8), (FQ_READS, 1))
        data = np.concatenate([head, seq, plus, qual, nl], axis=1).tobytes()
        if i == FQ_SETS - 1:
            path = folder / f"reads{i}.fastq.gz"
            path.write_bytes(gzip.compress(data, compresslevel=1))
        else:
            path = folder / f"reads{i}.fastq"
            path.write_bytes(data)
        paths.append(path)
    return paths


def phase_fastq(dev, seed: int) -> dict:
    """Read sets through the port's CLI at -k 21 -c 10 with the QC, trim
    and fq2fa front end; one sample recounted on the CPU from its
    converted FASTA; returns the launches."""
    work = WORK / "fastq"
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths = write_reads(work / "fq", seed)
        n_bases = FQ_SETS * FQ_READS * FQ_LEN
        print(f"fastq: wrote {FQ_SETS} read sets, {FQ_SETS * FQ_READS} reads, {n_bases} bp "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        out = work / "out"
        wall, launches, by_bits = drive(["-k", K, "-f", work / "fq", "-o", out,
                                         "-c", MIN_COUNT, "-replace"])
        names = [p.name.removesuffix("".join(p.suffixes)) for p in paths]
        rows = {n: tsv_rows(out / "tsv_nucleotide" / f"{n}_counts.tsv") for n in names}
        trims = {n: json.loads((out / "clean" / f"{n}-trim.json").read_text()) for n in names}
        print(f"fastq: wall {wall!r} s, {n_bases / wall!r} bases/s, rows kept {rows}, "
              f"launches by bits {by_bits}", flush=True)
        for n, t in trims.items():
            print(f"fastq: {n}: trim kept {t['kept_reads']} of {t['input_reads']} reads, "
                  f"adapter {t['adapter']}", flush=True)
        if min(rows.values()) < 10_000:
            raise AssertionError(f"expected >= 10^4 rows a read set: {rows}")
        if not both_kernels(launches) or launches["dense"]:
            raise AssertionError(f"both kernels and no dense launch expected: {launches}")
        if any(not 0 < t["kept_reads"] < t["input_reads"] or not t["adapter"]
               for t in trims.values()):
            raise AssertionError(f"the trim dropped nothing or found no adapter: {trims}")
        missing = [f for p, n in zip(paths, names) for f in (
            f"{p.name}_qc.html", f"{p.name}_qc.json", f"{n}_trim.fastq",
            f"{n}_trim.fastq_qc.json", f"{n}-trim.json", f"{n}.fna.gz")
            if not (out / "clean" / f).is_file()]
        if missing:
            raise AssertionError(f"missing from clean/: {missing}")
        recount_on_cpu("fastq", [out / "clean" / f"{names[0]}.fna.gz"],
                       out / "tsv_nucleotide", work / "cpu",
                       ["-k", K, "-c", MIN_COUNT, "-skipclean"])
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


#: printable ASCII less ">": 93 symbols, a 7-bit codec
PRINTABLE = np.array([b for b in range(33, 127) if b != ord(">")], np.uint8)
#: 132 symbols, 39 of them >= 0x80: an 8-bit codec
WIDE = np.concatenate([PRINTABLE, np.arange(161, 200, dtype=np.uint8)])
WIDE_FILES = 4
WIDE_SYMS = 500_000


def write_wide(folder: Path, seed: int, alphabet: np.ndarray) -> list[Path]:
    """WIDE_FILES FASTA files of WIDE_SYMS symbols over ``alphabet``
    (records of 100-600), with 10 families of 300 symbols in 12 copies a
    file, so that every file keeps k-mers at min-count 2."""
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for f in range(WIDE_FILES):
        rng = np.random.default_rng([seed, 4000 + f, alphabet.size])
        seq = alphabet[rng.integers(0, alphabet.size, size=WIDE_SYMS)]
        fams = alphabet[rng.integers(0, alphabet.size, size=(10, 300))]
        for j, at in enumerate(rng.choice(WIDE_SYMS // 400, 120, replace=False) * 400):
            seq[at : at + 300] = fams[j % 10]
        cuts = np.cumsum(rng.integers(100, 601, size=WIDE_SYMS // 100))
        cuts = cuts[cuts < WIDE_SYMS]
        path = folder / f"wide{f}.faa"
        write_records(path, [(f"w{f}_{r} synthetic record", rec)
                             for r, rec in enumerate(np.split(seq, cuts))], 60)
        paths.append(path)
    return paths


def phase_wide(dev, seed: int) -> dict:
    """Codecs of 7 and 8 bits: a 7-bit printable alphabet through the CLI
    at -c 2, k=3 and k=21 (one file recounted on the CPU); an 8-bit
    alphabet with bytes >= 0x80 through the engine (the CLI stops in
    kmer_summary on such bytes, in the JAX package too), its tables
    against the same calls on the CPU. Returns the launches."""
    from mercat2_tpu_torch.engine.codec import codec_for_bytes
    from mercat2_tpu_torch.engine.counter import KmerCounter, fetch_tables
    from mercat2_tpu_torch.engine.host import source_for

    work = WORK / "wide"
    shutil.rmtree(work, ignore_errors=True)
    total = dict.fromkeys(COUNTED, 0)
    try:
        paths = write_wide(work / "7bit", seed, PRINTABLE)
        for k in (3, 21):
            out = work / f"out{k}"
            wall, launches, by_bits = drive(["-k", k, "-f", work / "7bit", "-o", out,
                                             "-c", 2, "-replace"])
            rows = {p.name: tsv_rows(p) for p in (out / "tsv_protein").glob("*_counts.tsv")}
            print(f"wide 7-bit k={k}: wall {wall!r} s, {sum(rows.values())} rows over "
                  f"{len(rows)} files, launches by bits {by_bits}", flush=True)
            if len(rows) != WIDE_FILES or min(rows.values()) == 0:
                raise AssertionError(f"expected {WIDE_FILES} tables with rows: {rows}")
            if set(by_bits) != {7} or not both_kernels(by_bits[7]):
                raise AssertionError(f"both kernels must launch at 7 bits: {by_bits}")
            for name in total:
                total[name] += launches[name]
            recount_on_cpu(f"wide 7-bit k={k}", [paths[1]], out / "tsv_protein",
                           work / f"cpu{k}", ["-k", k, "-c", 2])

        paths = write_wide(work / "8bit", seed, WIDE)
        codec = codec_for_bytes(WIDE)  # the alphabet the files are drawn from
        if codec.bits != 8 or codec.symbols.max() < 0x80:
            raise AssertionError(f"not an 8-bit codec with bytes >= 0x80: {codec}")
        for k in (4, 21):
            tables = []
            for d in (dev, torch.device("cpu")):  # the card first
                sources = [source_for(p, codec) for p in paths]
                reset_counts()
                try:
                    tables.append(fetch_tables(KmerCounter(k, codec, d)
                                               .dispatch_packed_uniform(sources, 2)))
                finally:
                    for src in sources:
                        src.close()
                if len(tables) == 1:
                    launches = launch_counts()
            same = all(np.array_equal(a.kmers, b.kmers) and np.array_equal(a.counts, b.counts)
                       for a, b in zip(*tables, strict=True))
            rows = [len(t) for t in tables[0]]
            print(f"wide 8-bit k={k}: engine on the card, {rows} rows, launches {launches}, "
                  f"tables equal to the CPU's: {same}", flush=True)
            if not same or min(rows) == 0 or not both_kernels(launches):
                raise AssertionError(f"8-bit k={k}: card {rows} vs CPU, launches {launches}")
            for name in total:
                total[name] += launches[name]
        return total
    finally:
        shutil.rmtree(work, ignore_errors=True)

#: phase 9's mesh on one card: four shards of cuda:0
MESH_SHARDS = 4
#: files of the slice that the two-process run counts
HOST_FILES = 8


@contextlib.contextmanager
def mesh_stats():
    """The stats of every ``sharded_count_sources`` call the pipeline
    makes while the block runs (batches, rows received a shard)."""
    from mercat2_tpu_torch import pipeline

    seen: list[dict] = []
    inner = pipeline.sharded_count_sources

    def spy(*args, **kw):
        seen.append({})
        return inner(*args, stats=seen[-1], **kw)

    pipeline.sharded_count_sources = spy
    try:
        yield seen
    finally:
        pipeline.sharded_count_sources = inner


def mesh_slice(devices: list, label: str) -> dict:
    """Phase 4's cleaned files through ``pipeline._count_group_mesh`` over
    ``devices``: every count TSV must be byte-identical to phase 4's, and
    each batch must launch both kernels once a shard. Returns the
    launches."""
    from mercat2_tpu_torch import pipeline
    from mercat2_tpu_torch.engine.counter import KmerCounter

    work = WORK / "slice"
    single = work / "out" / "tsv_nucleotide"
    names = sorted(p.name.removesuffix("_counts.tsv") for p in single.glob("*_counts.tsv"))
    group = {n: [work / "out" / "clean" / f"{n}_clean.fna.gz"] for n in names}
    out = work / f"mesh_{len(devices)}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir()
    reset_counts()
    t0 = time.perf_counter()
    with mesh_stats() as stats, contextlib.redirect_stdout(io.StringIO()):
        codec, handles = pipeline._group_plan(group)
        try:
            counter = KmerCounter(K, codec, devices[0])
            pipeline._count_group_mesh(group, counter, MIN_COUNT, out, None, handles,
                                       devices)
        finally:
            for nf in handles.values():
                nf.close()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rows = [(min(batch), max(batch)) for st in stats for batch in st["rows_received"]]
    single_s = [ln for ln in (work / "cli.log").read_text().splitlines()
                if ln.startswith("Time to count")]
    print(f"mesh {label}: {len(rows)} batches of {len(devices)} shards, rows received a "
          f"shard (min, max) a batch {rows}; count stage {wall!r} s, phase 4 (one "
          f"device) {single_s}; launches {launches}", flush=True)
    n_launch = len(devices) * len(rows)
    if launches["build_keys"] != n_launch or launches["finalize"] != n_launch:
        raise AssertionError(f"mesh {label}: {launches}, expected {n_launch} of each kernel")
    differ = [n for n in names if (out / f"{n}_counts.tsv").read_bytes()
              != (single / f"{n}_counts.tsv").read_bytes()]
    if differ or len(names) != N_FILES:
        raise AssertionError(f"mesh {label}: count TSVs differ from phase 4's: {differ}")
    print(f"mesh {label}: {len(names)} count TSVs byte-identical to phase 4's", flush=True)
    return launches


def stage_ms(fn, cycles: int = 200_000_000):
    """Device time of ``fn()`` on the current stream, from CUDA events
    around it after a sleep on the stream that lets the host enqueue the
    call first (up to its first sync); returns (ms, fn's result)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    a.record()
    res = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), res


def mesh_stages(devices: list) -> dict:
    """CUDA-event device times of the sharded count's three stages on the
    slice's first batch (32 cleaned files), medians of 3, and one launch
    of the same batch on one device."""
    from mercat2_tpu_torch.engine.counter import KmerCounter, to_torch_group
    from mercat2_tpu_torch.engine.codec import DNA_CODEC
    from mercat2_tpu_torch.engine.host import build_packed_group, source_for
    from mercat2_tpu_torch.ops.finalize import count_kmers_packed
    from mercat2_tpu_torch.parallel import count

    clean = sorted((WORK / "slice" / "out" / "clean").glob("*_clean.fna.gz"))[:MAIN_FILES]
    sources = [source_for(p, DNA_CODEC) for p in clean]
    try:
        group = build_packed_group(K, DNA_CODEC, sources)
    finally:
        for src in sources:
            src.close()
    counter = KmerCounter(K, DNA_CODEC, devices[0])
    times: dict[str, list] = {"presort": [], "exchange": [], "merge": [], "one_device": []}
    for _ in range(3):
        ms, shards = stage_ms(lambda: count._presort(counter, group, devices, MAIN_FILES))
        times["presort"].append(ms)
        ms, (recv, n_recv) = stage_ms(lambda: count._exchange(shards, devices))
        times["exchange"].append(ms)
        del shards
        ms, merged = stage_ms(lambda: count._merge(recv, n_recv, MIN_COUNT, 0))
        times["merge"].append(ms)
        del recv, merged
    t = to_torch_group(group, devices[0])
    for _ in range(3):
        ms, _ = stage_ms(lambda: count_kmers_packed(
            t.words, t.gap_begin, t.gap_end, t.file_starts, MIN_COUNT, k=K, bits=2,
            cap=MAIN_CAP, n_files=MAIN_FILES, n_sym=t.n_sym))
        times["one_device"].append(ms)
    med = {name: statistics.median(v) for name, v in times.items()}
    print(f"mesh stages on {len(devices)} shards, first batch ({MAIN_FILES} files, "
          f"{group.n_sym} symbols), medians of 3 (CUDA events, ms): per-shard pre-sort "
          f"and sort {med['presort']!r}, exchange incl. its host sync "
          f"{med['exchange']!r}, merge sort and finalize {med['merge']!r}; sum "
          f"{med['presort'] + med['exchange'] + med['merge']!r}; the batch as one "
          f"launch on one device {med['one_device']!r}; all {times!r}", flush=True)
    return med


def mesh_protein(devices: list) -> dict:
    """Phase 5's proteomes at k=21 (5 bits, 4 int32 key columns) through
    ``sharded_count_sources`` over ``devices``: tables equal to the
    single-device counter's. Returns the launches."""
    from mercat2_tpu_torch import pipeline
    from mercat2_tpu_torch.engine.counter import KmerCounter, fetch_tables
    from mercat2_tpu_torch.engine.host import source_for
    from mercat2_tpu_torch.parallel import sharded_count_sources

    paths = sorted((WORK / "protein" / "faa").glob("*.faa"))
    codec, handles = pipeline._group_plan({p.name: [p] for p in paths})
    for nf in handles.values():
        nf.close()
    if codec.bits != 5:
        raise AssertionError(f"not a 5-bit codec: {codec}")
    tables = {}
    for name in ("single", "mesh"):
        sources = [source_for(p, codec) for p in paths]
        reset_counts()
        try:
            if name == "single":
                tables[name] = fetch_tables(KmerCounter(21, codec, devices[0])
                                            .dispatch_packed_uniform(sources, MIN_COUNT))
            else:
                stats: dict = {}
                tables[name] = sharded_count_sources(KmerCounter(21, codec, devices[0]),
                                                     sources, MIN_COUNT, devices, stats=stats)
        finally:
            for src in sources:
                src.close()
        torch.cuda.synchronize()
        launches = launch_counts()
    same = all(np.array_equal(a.kmers, b.kmers) and np.array_equal(a.counts, b.counts)
               for a, b in zip(tables["single"], tables["mesh"], strict=True))
    rows = sum(len(t) for t in tables["mesh"])
    print(f"mesh protein k=21: {len(paths)} proteomes, {rows} rows, {stats['batches']} "
          f"batches, rows received a shard {stats['rows_received']}, launches {launches}, "
          f"tables equal to the single-device counter's: {same}", flush=True)
    n_launch = len(devices) * stats["batches"]
    if not same or rows == 0 or launches["build_keys"] != n_launch \
            or launches["finalize"] != n_launch:
        raise AssertionError(f"mesh protein k=21: equal {same}, rows {rows}, {launches}")
    return launches


def mesh_dense(dev, seed: int, devices: list) -> None:
    """``sharded_dense_histogram`` at k=5 over ``devices`` on the main
    launch (as a uint8 stream, gap symbols as the sentinel) against the
    single-device ``count_kmers_dense`` bins of the same launch."""
    from mercat2_tpu_torch.engine.counter import to_torch_group
    from mercat2_tpu_torch.ops.dense_hist import count_kmers_dense
    from mercat2_tpu_torch.parallel import shard_stream, sharded_dense_histogram

    k = 5
    group = main_path_group(np.random.default_rng([seed, 9]), MAIN_SYMS, MAIN_FILES)
    shifts = (30 - 2 * np.arange(16)).astype(np.uint32)
    codes = ((group.words[:, None] >> shifts) & 3).astype(np.uint8).reshape(-1)
    gap = np.zeros(MAIN_SYMS + 1, np.int32)
    np.add.at(gap, group.gap_begin, 1)
    np.add.at(gap, group.gap_end, -1)
    codes[np.cumsum(gap[:MAIN_SYMS]) > 0] = 4  # the sentinel of a 4-symbol codec
    t0 = time.perf_counter()
    hist = sharded_dense_histogram(shard_stream(codes, k, len(devices), 4), k=k,
                                   alphabet_size=4, devices=devices)
    wall = time.perf_counter() - t0
    t = to_torch_group(group, dev)
    bins, counts, n_out = count_kmers_dense(
        t.words, t.gap_begin, t.gap_end, torch.zeros(1, dtype=torch.int32, device=dev),
        1, k=k, bits=2, alphabet_size=4, n_files=1, n_sym=MAIN_SYMS)
    n = int(n_out)
    want = np.zeros(4**k, np.int64)
    want[bins[:n].cpu().numpy()] = counts[:n].cpu().numpy()
    print(f"mesh dense k={k}: {len(devices)} shards, {int(hist.sum())} windows binned in "
          f"{wall!r} s (host clock), equal to count_kmers_dense: "
          f"{np.array_equal(hist, want)}", flush=True)
    if not np.array_equal(hist, want) or hist.sum() == 0:
        raise AssertionError("sharded dense histogram != count_kmers_dense")


def mesh_two_hosts() -> None:
    """Two CLI processes (``WORLD_SIZE=2``, ``RANK`` 0 and 1, a free
    ``MASTER_PORT``) over 8 of the slice's files, both on cuda:0, and one
    process over the same files: the output trees must be the same (gz
    files compared decompressed; ``report/report.html`` left out, since
    rank 0 writes it with the GC plot of its own samples only)."""
    import socket

    inputs = sorted((WORK / "slice" / "in").glob("*.fna"))[:HOST_FILES]
    one, two = WORK / "slice" / "one_host", WORK / "slice" / "two_hosts"
    argv = ["-k", K, "-c", MIN_COUNT, "-i", *inputs, "-replace"]
    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    code = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\n"
            "from mercat2_tpu_torch.cli import main\n"
            f"main({[str(a) for a in argv] + ['-o', str(two)]!r})\n")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            sys.stderr.write(text)
            raise AssertionError(f"two hosts: rank {r} exited {p.returncode}")
    wall2 = time.perf_counter() - t0
    wall1 = run_cli([*argv, "-o", one])
    files = sorted(str(f.relative_to(one)) for f in one.rglob("*") if f.is_file())
    if files != sorted(str(f.relative_to(two)) for f in two.rglob("*") if f.is_file()):
        raise AssertionError("two hosts: the trees hold other files")
    differ = []
    for rel in files:
        a, b = (one / rel).read_bytes(), (two / rel).read_bytes()
        if rel.endswith(".gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        if a != b and rel != "report/report.html":
            differ.append(rel)
    counted = [sum(ln.startswith("Significant k-mers") for ln in text.splitlines())
               for text in outs]
    print(f"mesh two hosts: {len(files)} files, equal to one process's but "
          f"report/report.html: {not differ}; samples counted by rank 0 / 1: {counted}; "
          f"walls {wall2!r} s (two processes) and {wall1!r} s (one)", flush=True)
    if differ or sorted(counted) != [HOST_FILES // 2] * 2:
        raise AssertionError(f"two hosts: {differ}, counted {counted}")


def phase_mesh(dev, seed: int) -> dict:
    """Phase 9: the sharded count (``parallel/``) on the card; returns the
    launches of its main path (the slice and the protein proteomes over
    the mesh)."""
    from mercat2_tpu_torch.parallel import make_mesh

    total = dict.fromkeys(COUNTED, 0)
    one_card = [torch.device("cuda", 0)] * MESH_SHARDS
    runs = [(one_card, f"[cuda:0] x {MESH_SHARDS}")]
    if torch.cuda.device_count() > 1:
        runs.append((make_mesh(), f"every card ({torch.cuda.device_count()})"))
    else:
        print("mesh over every visible card: not run: 1 card", flush=True)
    for devices, label in runs:
        for name, n in mesh_slice(devices, label).items():
            total[name] += n
    mesh_stages(one_card)
    for name, n in mesh_protein(one_card).items():
        total[name] += n
    mesh_dense(dev, seed, one_card)
    mesh_two_hosts()
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (REPO / "mercat2_tpu_torch").is_dir():
        sys.exit(f"chip_smoke.py: no mercat2_tpu_torch/ beside it in {REPO}; "
                 "run it from the root of a mercat2-tpu checkout")

    # 1. device
    from mercat2_tpu_torch.device import require_cuda

    dev = require_cuda()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    from mercat2_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s!r} s ({_build.library_path().name})", flush=True)

    # 3. kernels against their plain twins
    print("kernels vs plain twins:", flush=True)
    kres, times = phase_kernels(dev, args.seed)
    for name, r in kres.items():
        r["bound_ms"] = bound_ms(r["bytes"])
        print(f"  {name}: kernel {r['ms']!r} ms, plain {r['plain_ms']!r} / "
              f"{r['plain_ms_2']!r} ms (median of {REPS}, CUDA events); "
              f"{r['bytes']} bytes, bound {r['bound_ms']!r} ms, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of it; library "
              f"{r.get('library_ms')!r} ms", flush=True)
    r = kres["build_keys"]
    print(f"  build_keys bits=5 k=21: kernel {r['bits5_ms']!r} ms, plain "
          f"{r['bits5_plain_ms']!r} / {r['bits5_plain_ms_2']!r} ms", flush=True)
    print(f"  main launch (k={K}, {MAIN_FILES} files, {MAIN_SYMS} symbols): pre-sort half "
          f"{times['presort_ms']!r} ms, whole launch {times['launch_ms']!r} ms", flush=True)
    print("dense route vs sorted route:", flush=True)
    phase_dense(dev, args.seed)

    # 4.-9. the main paths through the port's CLI (and the 8-bit engine),
    # then the sharded count; launches summed
    launches = dict.fromkeys(COUNTED, 0)
    try:
        for phase in (phase_slice, phase_protein, phase_pipeline, phase_fastq,
                      phase_wide, phase_mesh):
            t0 = time.perf_counter()
            for name, n in phase(dev, args.seed).items():
                launches[name] += n
            print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"dense route launches (no kernel; plain PyTorch): {launches['dense']}", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"], "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"], "bound_ms": kres[name]["bound_ms"],
         "bound_by": "bytes", "library_ms": kres[name].get("library_ms")}
        for name, meta in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
