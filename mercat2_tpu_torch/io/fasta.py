"""Host-side FASTA ingestion: bytes -> (sequence bytes, record ids).

The parser reproduces the reference counter's exact framing semantics
(MerCat2's lib/mercat2_kmers.py:47-69):

- a file is a sequence of lines; lines are ``.strip()``-ed,
- a (stripped) line starting with ``>`` begins a new record,
- other lines are concatenated into the current record's sequence with all
  ``*`` characters removed,
- bytes before the first header belong to an implicit record 0,
- gzip is detected by the ``.gz`` suffix.

The fast path is fully vectorized numpy (no per-line Python loop) and is
taken whenever the file contains none of the whitespace bytes that
``str.strip`` would remove mid-stream (space, tab, \\v, \\f, \\r); real FASTA
essentially always qualifies. Otherwise an exact line-by-line fallback runs.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Iterator

import numpy as np

__all__ = ["read_file_bytes", "parse_fasta_seq", "parse_fasta_seq_bytes", "iter_fasta_records"]

_WS_BYTES = (9, 11, 12, 13, 32)  # tab, \v, \f, \r, space
_NL = 10
_GT = 62  # '>'
_STAR = 42  # '*'


def read_file_bytes(path) -> bytes:
    """Read a file fully, transparently gunzipping ``*.gz``."""
    path = Path(path)
    if path.suffix == ".gz":
        with gzip.open(path, "rb") as f:
            return f.read()
    return path.read_bytes()


def parse_fasta_seq(path) -> tuple[np.ndarray, np.ndarray]:
    """Parse a FASTA file into (seq uint8[N], rec int64[N]).

    Uses the native C++ single-pass parser when built (native/, via
    mercat2_tpu_torch.io.native); falls back to the vectorized numpy path.
    Both produce identical output (tests/test_native.py).
    """
    from mercat2_tpu_torch.io.native import parse_fasta_native

    try:
        out = parse_fasta_native(path)
    except OSError:
        out = None
    if out is not None:
        return out
    return parse_fasta_seq_bytes(read_file_bytes(path))


def parse_fasta_seq_bytes(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Parse FASTA bytes into concatenated sequence bytes + record ids.

    Returns:
        seq: uint8[N] sequence bytes ('*' removed, newlines removed).
        rec: int64[N] record index of each byte (0 for pre-header bytes,
             then 1, 2, ... in file order).
    """
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)

    for ws in _WS_BYTES:
        if np.any(arr == ws):
            return _parse_fallback(data)

    is_nl = arr == _NL
    # line index of each byte (newline byte belongs to the line it ends)
    line_id = np.empty(arr.size, dtype=np.int64)
    line_id[0] = 0
    np.cumsum(is_nl[:-1], out=line_id[1:])

    line_starts = np.flatnonzero(is_nl) + 1
    line_starts = np.concatenate([[0], line_starts])
    if line_starts[-1] == arr.size:  # file ends with newline -> no last line
        line_starts = line_starts[:-1]

    header_line = arr[line_starts] == _GT
    rec_of_line = np.cumsum(header_line)

    keep = ~header_line[line_id]
    keep &= ~is_nl
    keep &= arr != _STAR

    seq = arr[keep]
    rec = rec_of_line[line_id[keep]]
    return seq, rec


def _parse_fallback(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Exact replica of the reference's line loop (slow path)."""
    seqs: list[bytes] = []
    recs: list[int] = []
    rec = 0
    for raw in data.split(b"\n"):
        line = raw.strip()
        if line.startswith(b">"):
            rec += 1
        elif line:
            s = line.replace(b"*", b"")
            if s:
                seqs.append(s)
                recs.append(rec)
    if not seqs:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    seq = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    rec_arr = np.repeat(
        np.asarray(recs, dtype=np.int64),
        np.asarray([len(s) for s in seqs], dtype=np.int64),
    )
    return seq, rec_arr


def iter_fasta_records(path) -> Iterator[tuple[str, str]]:
    """Yield (header_without_gt, concatenated_sequence) per record.

    Lines are stripped; '*' is NOT removed here (callers that need the
    counter's '*' semantics use parse_fasta_seq; callers like the protein
    metrics path apply their own ``rstrip('*')`` semantics,
    MerCat2's lib/mercat2_figures.py:157-183).
    """
    data = read_file_bytes(path)
    header: str | None = None
    parts: list[str] = []
    for raw in data.decode("latin-1").split("\n"):
        line = raw.strip()
        if line.startswith(">"):
            if header is not None:
                yield header, "".join(parts)
            header = line[1:]
            parts = []
        else:
            parts.append(line)
    if header is not None:
        yield header, "".join(parts)
