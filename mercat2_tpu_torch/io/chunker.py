"""Record-boundary file chunking (shard generator).

Equivalent of the reference's Chunker (MerCat2's lib/mercat2_Chunker.py:14-79):
splits a FASTA/FASTQ into ~chunk-size pieces, starting a new piece only at a
line containing the record delimiter so records stay contiguous. Chunk
naming matches the reference: ``{stem}.%05d{inner_ext}`` (gz suffix dropped,
chunks written as plain text).

Note the inherited semantic (documented at MerCat2's README.md:207 and
SURVEY.md §3.2): the min-count filter runs per chunk before merging, so
chunked samples can undercount low-abundance k-mers. The engine reproduces
this for parity; pass ``chunk_size=0`` to disable chunking entirely.
"""

from __future__ import annotations

import gzip
from pathlib import Path

__all__ = ["chunk_file", "maybe_chunk", "human2bytes"]

#: unit spellings accepted by :func:`human2bytes` — the reference's exact
#: case-sensitive table (MerCat2's lib/mercat2_Chunker.py:82-139):
#: uppercase single letters, IEC "Ki"-style, lowercase spelled-out
#: decimal/IEC names, plus the lone lowercase "k" alias for "K". All are
#: powers of 1024.
_UNIT_SPELLINGS = {
    0: ("B", "byte", "Bi"),
    1: ("K", "kilo", "Ki", "kibi", "k"),
    2: ("M", "mega", "Mi", "mebi"),
    3: ("G", "giga", "Gi", "gibi"),
    4: ("T", "tera", "Ti", "tebi"),
    5: ("P", "peta", "Pi", "pebi"),
    6: ("E", "exa", "Ei", "exbi"),
    7: ("Z", "zetta", "Zi", "zebi"),
    8: ("Y", "iotta", "Yi", "yobi"),
}
_UNIT_EXP = {
    spelling: exp for exp, names in _UNIT_SPELLINGS.items() for spelling in names
}


def human2bytes(s: str) -> int:
    """'1 M' / '0.5kilo' / '2Gi' -> bytes (powers of 1024).

    Same accepted grammar as the reference's Chunker sizes
    (MerCat2's lib/mercat2_Chunker.py:82-139): a decimal number
    followed by an optional unit; raises ValueError on unknown units.
    """
    text = str(s)
    i = 0
    while i < len(text) and (text[i].isdigit() or text[i] == "."):
        i += 1
    if i == 0:
        raise ValueError(f"can't interpret {s!r}")
    num = float(text[:i])
    unit = text[i:].strip()
    if not unit:
        return int(num)
    exp = _UNIT_EXP.get(unit)
    if exp is None:
        raise ValueError(f"can't interpret {s!r}")
    return int(num * (1 << (10 * exp)))


def chunk_file(path, dest, chunk_bytes: int, delim: str | None = ">",
               lines: int | None = None) -> list[Path]:
    """Split `path` into ~chunk_bytes pieces.

    ``delim`` mode starts a new chunk only at a line containing the record
    delimiter; ``lines`` mode (reference ``stream_lines``,
    MerCat2's lib/mercat2_Chunker.py:61-79) only at every
    ``lines``-th line (e.g. 4 for FASTQ records). Exactly one must be set.
    """
    if (delim is None) == (lines is None):
        raise ValueError("exactly one of delim/lines must be set")
    path = Path(path)
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    name = path.stem.split(".")[0]
    ext = "".join(path.suffixes[:-1])  # reference drops the last suffix
    delim_b = delim.encode() if delim is not None else None

    opener = gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")
    files: list[Path] = []
    i = 0
    out_path = dest / f"{name}.{i:05d}{ext}"
    files.append(out_path)
    out = open(out_path, "wb")
    written = 0
    with opener as inf:
        for j, line in enumerate(inf):
            boundary = (
                delim_b in line if delim_b is not None else j % lines == 0
            )
            if boundary and written >= chunk_bytes:
                out.close()
                i += 1
                out_path = dest / f"{name}.{i:05d}{ext}"
                files.append(out_path)
                out = open(out_path, "wb")
                written = 0
            out.write(line)
            written += len(line)
    out.close()
    return files


def maybe_chunk(name: str, filename, chunk_size_mb: int, outpath) -> tuple[str, list[Path]]:
    """Chunk only when the file is at least chunk_size_mb (reference
    semantics, MerCat2's bin/mercat2.py:101-105)."""
    filename = Path(filename)
    if chunk_size_mb > 0 and filename.stat().st_size >= chunk_size_mb * 1024 * 1024:
        chunks = chunk_file(filename, outpath, chunk_size_mb * 1024 * 1024)
        return name, sorted(chunks)
    return name, [filename]


def _main(argv=None) -> int:
    """Standalone CLI, mirroring the reference Chunker's own entry point
    (MerCat2's lib/mercat2_Chunker.py:142-159)."""
    import argparse

    p = argparse.ArgumentParser(prog="mercat2-tpu-chunker",
                                description="Split FASTA/FASTQ into chunks "
                                "at record boundaries")
    p.add_argument("file", help="input file (.gz ok)")
    p.add_argument("outdir", help="output directory")
    p.add_argument("-c", "--chunksize", default="100M",
                   help="target chunk size, human units ok [100M]")
    group = p.add_mutually_exclusive_group()
    group.add_argument("-d", "--delim", default=None,
                       help="record delimiter ['>'; use '@' for FASTQ]")
    group.add_argument("-l", "--lines", type=int, default=None,
                       help="lines per record group (e.g. 4 for FASTQ)")
    args = p.parse_args(argv)
    delim = args.delim if args.lines is None else None
    if delim is None and args.lines is None:
        delim = ">"
    files = chunk_file(args.file, args.outdir, human2bytes(args.chunksize),
                       delim, args.lines)
    for f in files:
        print(f)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
