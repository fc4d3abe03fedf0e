"""Alpha diversity of one sample, on the host or on a torch device.

``device=None`` is ``mercat2_tpu.metrics.alpha.compute_alpha_diversity``
itself (the float64 host path, free of JAX). A torch device computes the
metrics with :func:`mercat2_tpu_torch.metrics.device.alpha_metrics_device`
and writes the same table; the JAX module is never asked for its device
path, which imports JAX.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mercat2_tpu.metrics import alpha as _host
from mercat2_tpu_torch.metrics.device import alpha_metrics_device

__all__ = ["compute_alpha_diversity"]


def compute_alpha_diversity(basename: str, counts_tsv, out_file,
                            device=None) -> Path:
    """Read the count column of a per-sample TSV and write the metric
    table (two columns, values rounded to 2 decimals, as the host path)."""
    if device is None:
        return _host.compute_alpha_diversity(basename, counts_tsv, out_file)
    counts = []
    with open(counts_tsv) as reader:
        reader.readline()
        for line in reader:
            counts.append(int(line.split()[1]))
    results = alpha_metrics_device(np.asarray(counts, dtype=np.int64), device)

    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, "w") as writer:
        print("Metric", basename, sep="\t", file=writer)
        for func in _host.ALPHA_METRICS:
            value = results[func]
            if not isinstance(value, str):
                try:
                    value = round(value, 2)
                except TypeError:
                    value = [round(x, 2) for x in value]
            print(func, value, sep="\t", file=writer)
    return out_file
