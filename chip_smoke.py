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
   at 5-bit protein, k=5 and k=21) and edge cases (bits 3 and 6, k up to
   256, the fid word); CUDA-event medians of both.
4. slice: 50 generated contig files, 194,489,190 bp, through the port's
   CLI (``-k 21 -c 10``); both kernels must have launched; 3 files are
   recounted with the plain path on the CPU and must give byte-identical
   count TSVs.
5. protein slice: 50 generated proteomes, 64,829,730 residues, through
   the CLI at ``-k 5 -c 10`` and ``-k 21 -c 10``; both kernels must have
   launched at 5 bits in each run; 3 files recounted on the CPU.
6. pipeline: MerCat2's documented run without ``-pca`` (``-k 5 -c 10
   -prod -fgs -device-metrics``) over 5 generated contig files, 19,448,919
   bp with planted genes; the whole output tree must be there and both
   kernels must have launched in the protein rounds.

The last line is ``{"ok": true, "device": {...}}``; the line before it a
JSON object with each kernel's launches (summed over phases 4-6), error
and times. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

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
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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


def phase_kernels(dev, seed: int) -> dict:
    """Each kernel against its plain twin on the card; returns per-kernel
    results (max_abs_err over every case, main-shape times)."""
    from mercat2_tpu_torch.engine.counter import to_torch_group
    from mercat2_tpu_torch.ops.build_keys import build_keys, build_keys_plain
    from mercat2_tpu_torch.ops.finalize import (
        packed_sort_keys, packed_window_validity, sort_fused_u64, sort_words,
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

    # -- build_keys at the main shape, then edge widths ------------------
    g = to_torch_group(main_path_group(rng, MAIN_SYMS, MAIN_FILES), dev)
    for k, bits, n_sym in [(K, 2, MAIN_SYMS), (5, 2, 1 << 20), (16, 2, 1 << 20),
                           (31, 2, 1 << 20), (7, 4, 1 << 20)]:
        per = 32 // bits
        words = g.words[: n_sym // per]
        p = n_sym - k + 1
        valid = packed_window_validity(g.gap_begin, g.gap_end, k, p)
        kw = dict(k=k, bits=bits, p=p)
        check("build_keys", f"k={k} bits={bits} p={p}",
              build_keys(words, valid, **kw), build_keys_plain(words, valid, **kw))
        if n_sym == MAIN_SYMS:
            res["build_keys"]["plain_ms"] = cuda_ms(lambda: build_keys_plain(words, valid, **kw))
            res["build_keys"]["ms"] = cuda_ms(lambda: build_keys(words, valid, **kw))
            res["build_keys"]["plain_ms_2"] = cuda_ms(lambda: build_keys_plain(words, valid, **kw))

    # -- build_keys at 5-bit protein (6 symbols a word, keys straddle
    # words), then the other widths that do not divide 32 -----------------
    gp = to_torch_group(main_path_group(rng, MAIN_SYMS, MAIN_FILES, bits=5), dev)
    for k in (5, 21, 6, 1, 256):  # k=6: the fid takes a word of its own
        p = MAIN_SYMS - k + 1
        valid = packed_window_validity(gp.gap_begin, gp.gap_end, k, p)
        kw = dict(k=k, bits=5, p=p)
        check("build_keys", f"k={k} bits=5 p={p}",
              build_keys(gp.words, valid, **kw), build_keys_plain(gp.words, valid, **kw))
        if k == 21:
            res["build_keys"]["bits5_plain_ms"] = cuda_ms(
                lambda: build_keys_plain(gp.words, valid, **kw))
            res["build_keys"]["bits5_ms"] = cuda_ms(lambda: build_keys(gp.words, valid, **kw))
            res["build_keys"]["bits5_plain_ms_2"] = cuda_ms(
                lambda: build_keys_plain(gp.words, valid, **kw))
    for bits in (3, 6):
        per = 32 // bits
        n_sym = (2 << 20) // per * per
        ge = to_torch_group(main_path_group(rng, n_sym, MAIN_FILES, bits=bits), dev)
        for k in (1, 6, 130, 256):
            p = n_sym - k + 1
            valid = packed_window_validity(ge.gap_begin, ge.gap_end, k, p)
            kw = dict(k=k, bits=bits, p=p)
            check("build_keys", f"k={k} bits={bits} p={p}",
                  build_keys(ge.words, valid, **kw), build_keys_plain(ge.words, valid, **kw))

    # -- finalize at the main shape (fused u64 keys), then edge cases ----
    keyed, n_valid, _ = packed_sort_keys(
        g.words, g.gap_begin, g.gap_end, g.file_starts, k=K, bits=2,
        n_files=MAIN_FILES, n_sym=MAIN_SYMS)
    s = sort_fused_u64(keyed)
    fin = dict(min_count=MIN_COUNT, cap=MAIN_CAP)
    got = finalize_sorted((s,), n_valid, **fin)
    want = finalize_sorted_plain((s,), n_valid, **fin)
    check("finalize", f"main u64 p={s.shape[0]} n_out={int(want[2])}",
          (*got[0], got[1], got[2]), (*want[0], want[1], want[2]))
    if int(want[2]) == 0:
        raise AssertionError("main-shape finalize kept no rows: the case tests nothing")
    res["finalize"]["plain_ms"] = cuda_ms(lambda: finalize_sorted_plain((s,), n_valid, **fin))
    res["finalize"]["ms"] = cuda_ms(lambda: finalize_sorted((s,), n_valid, **fin))
    res["finalize"]["plain_ms_2"] = cuda_ms(lambda: finalize_sorted_plain((s,), n_valid, **fin))

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
    cases = [
        ("min_count=1", (s,), n_valid, 1, MAIN_CAP),
        ("n_out>cap", (s,), n_valid, MIN_COUNT, 1000),
        ("empty n_valid=0", (s,), torch.zeros((), dtype=torch.int64, device=dev), 2, 64),
        ("one run spans the column", (run,), torch.tensor(p, device=dev), 2, 16),
        ("3 words k=31", words31, nv31, MIN_COUNT, MAIN_CAP),
        ("bits=5 k=5, 1 word", *protein[5], 2, MAIN_CAP),
        ("bits=5 k=21, 4 words", *protein[21], 2, MAIN_CAP),
    ]
    for case, cols, nv, mc, cap in cases:
        got = finalize_sorted(cols, nv, min_count=mc, cap=cap)
        want = finalize_sorted_plain(cols, nv, min_count=mc, cap=cap)
        check("finalize", f"{case} n_out={int(want[2])}",
              (*got[0], got[1], got[2]), (*want[0], want[1], want[2]))
        if case == "n_out>cap" and int(want[2]) <= cap:
            raise AssertionError("the n_out > cap case did not overflow")
    torch.cuda.synchronize()
    return res


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
    whole log goes to stderr if it raises); returns the wall time."""
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
    for line in log.getvalue().splitlines():
        if line.startswith(("Time", "Processing", "Running")):
            print(f"    {line.strip()}")
    return wall


@contextlib.contextmanager
def launches_by_bits():
    """Kernel launches of the count path while the block runs, keyed by
    the codec's bits per symbol (read off each ``count_kmers_packed``
    call; the wrappers' counters are read before and after it)."""
    from mercat2_tpu_torch.engine import counter
    from mercat2_tpu_torch.ops.build_keys import build_keys
    from mercat2_tpu_torch.ops.finalize_kernel import finalize_sorted

    inner = counter.count_kmers_packed
    seen: dict[int, dict[str, int]] = {}

    def spy(*args, bits, **kw):
        before = build_keys.launches, finalize_sorted.launches
        out = inner(*args, bits=bits, **kw)
        by = seen.setdefault(bits, {"build_keys": 0, "finalize": 0})
        by["build_keys"] += build_keys.launches - before[0]
        by["finalize"] += finalize_sorted.launches - before[1]
        return out

    counter.count_kmers_packed = spy
    try:
        yield seen
    finally:
        counter.count_kmers_packed = inner


def drive(argv: list) -> tuple[float, dict, dict]:
    """One run of a main path through the CLI: every kernel's count is set
    to 0 just before it and read just after. Returns the wall time, the
    launches, and the launches by bits per symbol."""
    from mercat2_tpu_torch.ops.build_keys import build_keys
    from mercat2_tpu_torch.ops.finalize_kernel import finalize_sorted

    build_keys.launches = finalize_sorted.launches = 0
    with launches_by_bits() as by_bits:
        wall = run_cli(argv)
    launches = {"build_keys": build_keys.launches, "finalize": finalize_sorted.launches}
    if launches != {name: sum(b[name] for b in by_bits.values()) for name in launches}:
        raise AssertionError(f"launches outside the count path: {launches} {by_bits}")
    return wall, launches, by_bits


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
    recounted with the plain path on the CPU; returns the launches."""
    from mercat2_tpu.io.native import native_lib
    from mercat2_tpu_torch.engine.counter import KmerCounter

    work = REPO / "chip_smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        paths = write_inputs(work / "in", seed)
        print(f"slice: wrote {len(paths)} files, {N_BASES} bp in "
              f"{time.perf_counter() - t0:.1f} s; FASTA parser: "
              f"{'native C++' if native_lib() is not None else 'numpy'}", flush=True)

        wall, launches, _ = drive(["-k", K, "-f", work / "in", "-o", work / "out",
                                   "-c", MIN_COUNT, "-replace"])

        tsvs = {p.stem.removesuffix("_counts"): p
                for p in (work / "out" / "tsv_nucleotide").glob("*_counts.tsv")}
        rows = {name: tsv_rows(p) for name, p in tsvs.items()}
        print(f"slice: wall {wall!r} s, {N_BASES / wall!r} bases/s, "
              f"{sum(rows.values())} rows kept over {len(rows)} files, "
              f"launches {launches}", flush=True)
        if len(rows) != N_FILES or min(rows.values()) < 10_000:
            raise AssertionError(f"expected {N_FILES} tables of >= 10^4 rows: {rows}")
        if min(launches.values()) == 0:
            raise AssertionError(f"a kernel of the path never launched: {launches}")
        first = sum(rows[f"sample{f:02d}"] for f in range(3))
        if first <= KmerCounter._UNIFORM_CAP:
            raise AssertionError(f"launch 0 kept {first} rows: no overflow rerun")
        print(f"slice: launch 0 (sample00-02) kept {first} rows > cap "
              f"{KmerCounter._UNIFORM_CAP}: the overflow rerun ran", flush=True)

        recount_on_cpu("slice", [paths[0], paths[5], paths[-1]],
                       work / "out" / "tsv_nucleotide", work / "cpu",
                       ["-k", K, "-c", MIN_COUNT])
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_protein(dev, seed: int) -> dict:
    """The port's CLI over 50 generated proteomes at k=5 and k=21 on the
    card, then 3 files recounted on the CPU; returns the launches."""
    work = REPO / "chip_smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    total = {"build_keys": 0, "finalize": 0}
    try:
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
            if set(by_bits) != {5} or min(by_bits[5].values()) == 0:
                raise AssertionError(f"both kernels must launch at 5 bits: {by_bits}")
            for name in total:
                total[name] += launches[name]
            recount_on_cpu(f"protein k={k}", [paths[0], paths[7], paths[-1]],
                           out / "tsv_protein", work / f"cpu{k}",
                           ["-k", k, "-c", MIN_COUNT])
        return total
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_pipeline(dev, seed: int) -> dict:
    """MerCat2's documented run without -pca on 5 generated genomes;
    returns the launches."""
    work = REPO / "chip_smoke_work"
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
        if 5 not in by_bits or min(by_bits[5].values()) == 0:
            raise AssertionError(f"the protein rounds launched no kernel: {by_bits}")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
    kres = phase_kernels(dev, args.seed)
    for name, r in kres.items():
        print(f"  {name}: kernel {r['ms']!r} ms, plain {r['plain_ms']!r} / "
              f"{r['plain_ms_2']!r} ms (median of {REPS}, CUDA events)", flush=True)
    r = kres["build_keys"]
    print(f"  build_keys bits=5 k=21: kernel {r['bits5_ms']!r} ms, plain "
          f"{r['bits5_plain_ms']!r} / {r['bits5_plain_ms_2']!r} ms", flush=True)

    # 4.-6. the main paths through the port's CLI; launches summed
    launches = {name: 0 for name in KERNELS}
    for phase in (phase_slice, phase_protein, phase_pipeline):
        t0 = time.perf_counter()
        for name, n in phase(dev, args.seed).items():
            launches[name] += n
        print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta["source"],
         "replaces": meta["replaces"], "launches": launches[name],
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"]}
        for name, meta in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
