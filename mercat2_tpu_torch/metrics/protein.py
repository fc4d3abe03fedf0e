"""Per-protein metrics of one faa file, on the host or on a torch device.

``device=None`` is ``mercat2_tpu.metrics.protein.protein_metrics_table``
itself (the float64 host path, free of JAX). A torch device computes pI,
MW and hydropathy with
:func:`mercat2_tpu_torch.metrics.device.protein_metrics_device`; the JAX
module is never asked for its device path, which imports JAX.
"""

from __future__ import annotations

import numpy as np

from mercat2_tpu.metrics import protein as _host
from mercat2_tpu_torch.metrics.device import protein_metrics_device

__all__ = ["protein_metrics_table"]


def protein_metrics_table(path, device=None) -> dict:
    """Per-protein metric arrays (pI/MW/Hydro rounded to 2 decimals with
    Python ``round``, as the host path)."""
    if device is None:
        return _host.protein_metrics_table(path)
    full_names, names, seqs = _host._parse_protein_fasta(path)
    flat = np.frombuffer("".join(seqs).encode("latin-1"), dtype=np.uint8)
    lens = np.asarray([len(s) for s in seqs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    pi, mw, hyd = protein_metrics_device(flat, offsets, device)
    return dict(
        full_name=full_names,
        name=names,
        length=lens,
        pi=[None if np.isnan(x) else round(float(x), 2) for x in pi],
        mw=[round(float(x), 2) for x in mw],
        hydro=[round(float(x), 2) for x in hyd],
    )
