"""Per-sample count TSVs.

``write_counts_tsv`` copied from ``mercat2_tpu.report.tsv``, which imports
``KmerTable`` from the JAX counter. The format is MerCat2's: header
``k-mer\\t{base}_Count``, then lexicographically sorted rows
(bin/mercat2.py:130-133).
"""

from __future__ import annotations

from pathlib import Path

from mercat2_tpu_torch.engine.host import KmerTable

__all__ = ["write_counts_tsv"]


def write_counts_tsv(table: KmerTable, basename: str, out_file) -> Path | None:
    """Write one sample's sorted count table. Returns None if empty
    (MerCat2 skips the file entirely, bin/mercat2.py:128-137)."""
    if not len(table):
        return None
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    k = table.k
    flat = table.kmers.tobytes()
    counts = table.counts
    with open(out_file, "wb") as w:
        w.write(f"k-mer\t{basename}_Count\n".encode())
        parts = []
        for i in range(len(table)):
            parts.append(flat[i * k : (i + 1) * k])
            parts.append(b"\t%d\n" % counts[i])
            if len(parts) >= 8192:
                w.write(b"".join(parts))
                parts = []
        w.write(b"".join(parts))
    return out_file
