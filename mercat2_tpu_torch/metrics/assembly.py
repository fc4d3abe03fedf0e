"""Assembly statistics: contig length histogram, N50/L50 family, GC%.

Native replacement for the external ``countAssembly.py`` the reference
shells out to per contig file (MerCat2's bin/mercat2.py:277-281,
``metaomestats`` dependency). Output format mirrors the committed golden
stats files (e.g. reference results/2023-11-29/fna-5genomes-10/stats/DJ.txt).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mercat2_tpu_torch.io.fasta import parse_fasta_seq

__all__ = ["assembly_stats", "write_assembly_stats"]


def _nx(lengths_desc: np.ndarray, total: int, frac: float) -> tuple[int, int]:
    """(Nx length, Lx count): smallest prefix of descending lengths covering
    ``frac`` of ``total``; returns (length threshold, number of sequences)."""
    csum = np.cumsum(lengths_desc)
    idx = int(np.searchsorted(csum, frac * total))
    idx = min(idx, len(lengths_desc) - 1)
    return int(lengths_desc[idx]), idx + 1


def assembly_stats(path, interval: int = 100) -> str:
    seq, rec = parse_fasta_seq(path)
    if seq.size == 0:
        return "Total length of sequence:\t0 bp\n"
    lengths = np.bincount(rec - rec.min())
    lengths = lengths[lengths > 0]
    total = int(lengths.sum())
    gc = int(((seq == ord("G")) | (seq == ord("C"))).sum())

    lines = [""]  # golden stats files open with a blank line
    # histogram of contig lengths in `interval`-width bins
    bins = (lengths // interval) * interval
    for b in np.unique(bins):
        count = int((bins == b).sum())
        lines.append(f"{int(b)}:{int(b) + interval - 1}\t{count}")
    lines.append("")
    lines.append(f"Total length of sequence:\t{total} bp")
    lines.append(f"Total number of contigs:\t{len(lengths)}")
    lines.append(f"Max sequence length:\t{int(lengths.max())}")
    lines.append(f"Min sequence length:\t{int(lengths.min())}")
    lines.append("")
    desc = np.sort(lengths)[::-1]
    for frac in (25, 50, 75, 90):
        nx, lx = _nx(desc, total, frac / 100.0)
        lines.append(
            f"N{frac} stats:\t\t\t{frac}% of total sequence length is contained in "
            f"the (L{frac}) {lx} sequences >= {nx} bp"
        )
    lines.append("")
    lines.append(f"*NG Stats using genome length of {total}.")
    for frac in (25, 50, 75, 90):
        nx, lx = _nx(desc, total, frac / 100.0)
        lines.append(
            f"NG{frac} stats:\t\t\t{frac}% of total genome length is contained in "
            f"the {lx} sequences >= {nx} bp"
        )
    lines.append("")
    lines.append(f"Total GC count:\t\t\t{gc} bp")
    lines.append(f"GC %:\t\t\t\t{100.0 * gc / total:.2f} %")
    lines.append("* Without a reference genome we estimate the size using the assembled length.")
    return "\n".join(lines) + "\n"


def write_assembly_stats(path, out_file, interval: int = 100) -> Path:
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(assembly_stats(path, interval))
    return out_file
