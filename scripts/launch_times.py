#!/usr/bin/env python3
"""Device times of one count launch of the PyTorch port at the main shape.

Run on a machine with one CUDA card, from the repository root::

    python3 scripts/launch_times.py [--tree DIR] [--seed N] [--reps N]

``--tree`` names the root of the checkout whose ``mercat2_tpu_torch`` is
timed (default: this one), so that two commits can be timed in one call,
in turns, on one card. The launch is chip_smoke.py's main shape (12,582,912
symbols of 2-bit DNA, 32 files, k=21, min-count 10, cap 2^19) from
``--seed``. Printed, as medians of ``--reps`` CUDA-event timings
(``chip_smoke.cuda_ms``: a sleep on the stream before each start event
lets the host enqueue the whole call first, so that host overhead does
not count):

- ``presort_ms``: window validity -> the int64 column that enters
  ``torch.sort`` (``packed_sort_keys``, plus the fuse and sign flip where it
  returns two int32 columns, as it did before the fused key build);
- ``launch_ms``: the whole launch, ``count_kmers_packed`` (pre-sort, sort,
  finalize, split);
- ``finalize_ms``: the finalize kernel on the sorted column;
- ``library_ms``: ``torch.unique_consecutive(s[:n_valid],
  return_counts=True)`` and the min-count mask, syncs included.

The last line is one JSON object with these numbers, the tree and the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (numpy and torch only, at import)
import numpy as np  # noqa: E402
import torch  # noqa: E402

SIGN64 = -(1 << 63)
LOW32 = 0xFFFFFFFF


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=REPO)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("launch_times.py: no CUDA card")
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    from mercat2_tpu_torch.engine.counter import to_torch_group
    from mercat2_tpu_torch.ops import finalize as fin
    from mercat2_tpu_torch.ops.finalize_kernel import finalize_sorted

    if not Path(fin.__file__).resolve().is_relative_to(tree):
        sys.exit(f"launch_times.py: imported {fin.__file__}, not from {tree}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    g = to_torch_group(chip_smoke.main_path_group(rng, chip_smoke.MAIN_SYMS,
                                                  chip_smoke.MAIN_FILES), dev)
    k, m, cap = chip_smoke.K, chip_smoke.MIN_COUNT, chip_smoke.MAIN_CAP
    kw = dict(k=k, bits=2, n_files=chip_smoke.MAIN_FILES, n_sym=chip_smoke.MAIN_SYMS)

    def presort():
        cols, n_valid, _ = fin.packed_sort_keys(g.words, g.gap_begin, g.gap_end,
                                                g.file_starts, **kw)
        if len(cols) == 2:  # two int32 columns: fuse and flip, as fuse_u64 does
            cols = [((cols[0].to(torch.int64) << 32)
                     | (cols[1].to(torch.int64) & LOW32)) ^ SIGN64]
        return cols[0], n_valid

    def launch():
        return fin.count_kmers_packed(g.words, g.gap_begin, g.gap_end, g.file_starts,
                                      m, cap=cap, **kw)

    col, n_valid = presort()
    s = torch.sort(col).values

    def library():
        nv = int(n_valid)
        u, c = torch.unique_consecutive(s[:nv], return_counts=True)
        keep = c >= m
        return u[keep], c[keep]

    res = {"tree": str(tree), "p": int(s.shape[0]), "n_valid": int(n_valid),
           "n_out": int(launch()[2])}
    if len(library()[0]) != res["n_out"]:
        raise AssertionError("unique_consecutive keeps another number of rows")
    res["presort_ms"] = chip_smoke.cuda_ms(presort, args.reps)
    res["launch_ms"] = chip_smoke.cuda_ms(launch, args.reps)
    res["finalize_ms"] = chip_smoke.cuda_ms(
        lambda: finalize_sorted((s,), n_valid, min_count=m, cap=cap), args.reps)
    res["library_ms"] = chip_smoke.cuda_ms(library, args.reps)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    res["card"] = smi.splitlines()[0]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
