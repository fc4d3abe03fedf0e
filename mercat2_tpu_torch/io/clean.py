"""Contig cleaning: split scaffold sequences at N-runs, compute GC%.

Reproduces the reference's ``removeN`` byte-for-byte on the cleaned output
(MerCat2's lib/mercat2_fasta.py:21-119), including its quirks:

- sub-records are named ``>{first_word}_{i} {rest_of_header}`` (note the
  trailing space when the header has no description),
- sub-sequences re-wrap at 80 columns; the untouched branch preserves the
  original line wrapping,
- in the N-split branch the GC%/length tally *includes the header lines*
  (reference lines 103-104) — a quirk we keep for stat parity,
- only uppercase ``N`` splits; ``-toupper`` uppercases written sequence
  lines but never affects the GC tally (computed pre-uppercase).
"""

from __future__ import annotations

import gzip
import re
import textwrap
from pathlib import Path

from mercat2_tpu_torch.io.fasta import read_file_bytes

__all__ = ["split_sequence_n", "remove_n"]

_N_RUN = re.compile(r"(N+)")


def split_sequence_n(header: str, sequence: str) -> tuple[list[str], list[int]]:
    """Split one sequence at N-runs into 80-col-wrapped sub-records."""
    n_lengths = [len(m.group(1)) for m in _N_RUN.finditer(sequence)]
    pieces = _N_RUN.sub("\n", sequence).split("\n")
    words = header.split()
    name = words[0] if words else ""
    info = " ".join(words[1:])
    out: list[str] = []
    for i, piece in enumerate(pieces, 1):
        out.append(f">{name}_{i} {info}")
        out += textwrap.wrap(piece, 80)
    return out, n_lengths


def remove_n(fasta, outpath, toupper: bool = False) -> tuple[Path, dict]:
    """Clean one nucleotide FASTA -> ``{base}_clean.fna.gz`` + GC stats."""
    outpath = Path(outpath)
    outpath.mkdir(parents=True, exist_ok=True)
    fasta = Path(fasta)
    basename = fasta.stem.split(".")[0]
    out_fasta = outpath / f"{basename}_clean.fna.gz"

    gc_count = 0
    total_length = 0

    text = read_file_bytes(fasta).decode("latin-1")
    if text.endswith("\n"):  # avoid a phantom final empty line vs readline()
        text = text[:-1]
    lines = [ln.strip() for ln in text.split("\n")]

    # level-1 deflate: the decompressed content is what downstream stages
    # and parity care about, and level 9 made this write the single
    # slowest stage of the whole pipeline (~10 s for 5 genomes; level 1
    # is ~6x faster for ~10% larger files). Output is accumulated and
    # compressed in large chunks — per-line writes through the gzip
    # TextIOWrapper cost more than the deflate itself.
    out_lines: list[str] = []
    i = 0
    n_lines = len(lines)
    while i < n_lines:
        line = lines[i]
        if not line.startswith(">"):
            i += 1
            continue
        name = line[1:]
        seq_lines: list[str] = []
        i += 1
        while i < n_lines and not lines[i].startswith(">"):
            seq_lines.append(lines[i])
            i += 1
        sequence = "".join(seq_lines)
        if "N" in sequence:
            for piece in split_sequence_n(name, sequence)[0]:
                if piece.startswith(">"):
                    out_lines.append(piece)
                else:
                    out_lines.append(piece.upper() if toupper else piece)
                # reference quirk: headers are included in the GC tally
                gc_count += piece.count("G") + piece.count("C")
                total_length += len(piece)
        else:
            out_lines.append(">" + name)
            for seq_line in seq_lines:
                out_lines.append(seq_line.upper() if toupper else seq_line)
            gc_count += sequence.count("G") + sequence.count("C")
            total_length += len(sequence)
    out_lines.append("")  # trailing newline
    with gzip.open(out_fasta, "wb", compresslevel=1) as writer:
        writer.write("\n".join(out_lines).encode("latin-1"))

    stats = {"GC Content": 100.0 * gc_count / total_length if total_length else 0.0}
    return out_fasta.absolute(), stats
