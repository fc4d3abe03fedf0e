#!/usr/bin/env python3
"""Times of the sharded count's stages (``mercat2_tpu_torch/parallel/``)
against one launch of the same batch on one device.

Run on a machine with one or more CUDA cards, from the repository root::

    python3 scripts/mesh_times.py [--seed N] [--reps N]

The batch is one launch group of the slice's size (124,471,440 symbols of
2-bit DNA, 32 files, k=21, min-count 10), generated from ``--seed`` as
chip_smoke.py's main-path transport. Meshes: one shard of cuda:0, four
shards of cuda:0 and, when there are several, one shard on every card.
Each stage is timed on the host clock between synchronizations of every
card of the mesh, so work on all cards counts and so does the host's
enqueue (the pinned staging of the transport included); medians of
``--reps``:

- ``presort_ms``: per shard, the transport to its device, validity, the
  key-build kernel and the sort (``count._presort``);
- ``exchange_ms``: splitters, cuts, the one host sync and the copies
  (``count._exchange``);
- ``merge_ms``: per destination, the re-sort and the finalize kernel
  (``count._merge``);
- ``one_device_ms``: the transport to cuda:0 and one ``count_kmers_packed``
  launch of the whole batch.

The last line is one JSON object with these numbers and the cards.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (numpy and torch only, at import)
import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the slice's first batch: 32 cleaned files of phase 4
BATCH_SYMS = 124_471_440
FILES = 32
K = 21
MIN_COUNT = 10


def timed(fn, devices: list):
    """Host-clock milliseconds of ``fn()`` between synchronizations of
    every card in ``devices``, and its result."""
    cards = sorted({d.index for d in devices})
    for i in cards:
        torch.cuda.synchronize(i)
    t0 = time.perf_counter()
    res = fn()
    for i in cards:
        torch.cuda.synchronize(i)
    return (time.perf_counter() - t0) * 1e3, res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("mesh_times.py: no CUDA card")
    from mercat2_tpu_torch.engine.codec import DNA_CODEC
    from mercat2_tpu_torch.engine.counter import KmerCounter, to_torch_group
    from mercat2_tpu_torch.ops.finalize import count_kmers_packed
    from mercat2_tpu_torch.parallel import count, make_mesh

    group = chip_smoke.main_path_group(np.random.default_rng(args.seed), BATCH_SYMS, FILES)
    cuda0 = torch.device("cuda", 0)
    counter = KmerCounter(K, DNA_CODEC, cuda0)
    meshes = {"cuda:0 x 1": [cuda0], "cuda:0 x 4": [cuda0] * 4}
    if torch.cuda.device_count() > 1:
        meshes[f"{torch.cuda.device_count()} cards"] = make_mesh()
    out: dict = {}
    for name, devices in meshes.items():
        times: dict[str, list] = {"presort_ms": [], "exchange_ms": [], "merge_ms": []}
        for _ in range(args.reps + 1):  # the first grows the allocators' pools
            ms_p, shards = timed(lambda: count._presort(counter, group, devices, FILES), devices)
            ms_e, (recv, n_recv) = timed(lambda: count._exchange(shards, devices), devices)
            del shards
            ms_m, merged = timed(lambda: count._merge(recv, n_recv, MIN_COUNT, 0), devices)
            del recv, merged
            for key, ms in zip(times, (ms_p, ms_e, ms_m)):
                times[key].append(ms)
        med = {key: statistics.median(v[1:]) for key, v in times.items()}
        med["sum_ms"] = sum(med.values())
        med["rows_received"] = n_recv
        out[name] = med
        print(f"{name}: {med}", flush=True)

    def one_launch():
        t = to_torch_group(group, cuda0)
        return count_kmers_packed(t.words, t.gap_begin, t.gap_end, t.file_starts,
                                  MIN_COUNT, k=K, bits=2, cap=1 << 19, n_files=FILES,
                                  n_sym=BATCH_SYMS)

    one = [timed(one_launch, [cuda0])[0] for _ in range(args.reps + 1)]
    out["one_device_ms"] = statistics.median(one[1:])
    print(f"one device: {out['one_device_ms']!r} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps({"cards": smi, "batch_symbols": BATCH_SYMS, "reps": args.reps, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
