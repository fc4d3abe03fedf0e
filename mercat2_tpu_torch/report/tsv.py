"""TSV emission: per-sample count tables and combined merges.

Copied from ``mercat2_tpu.report.tsv``, which imports ``KmerTable`` from
the JAX counter (here both merges share one union fill). The formats are
MerCat2's:

- per-sample ``{base}_counts.tsv``: header ``k-mer\\t{base}_Count`` then
  lexicographically sorted rows (bin/mercat2.py:130-133);
- ``combined_{type}.tsv``: first header cell taken from the per-sample
  header's first cell, then sorted sample names; union of k-mers
  ascending, zeros filled (lib/mercat2_report.py:98-156), without the
  reference's merge bug on sparse tables (see the JAX module's docstring);
- ``combined_{type}_T.tsv``: the transposed matrix, columns in sorted
  k-mer order.
"""

from __future__ import annotations

from pathlib import Path

from mercat2_tpu_torch.engine.host import KmerTable

__all__ = ["write_counts_tsv", "merge_tsv", "merge_tsv_T"]


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


def _read_header_cell(path) -> str:
    with open(path, "rb") as f:
        return f.readline().split(b"\t")[0].decode()


def _read_columns(path):
    """One counts TSV -> (keys S-array, values S-array), file order.

    Values stay raw bytes (counts are ints, but the same merge serves the
    diversity TSVs whose values are floats — byte-preserving fill keeps
    both parities).
    """
    import numpy as np

    with open(path, "rb") as f:
        f.readline()
        body = f.read()
    rows = [ln.split(b"\t", 1) for ln in body.split(b"\n") if b"\t" in ln]
    keys = np.array([r[0] for r in rows], dtype=bytes)
    vals = np.array([r[1] for r in rows], dtype=bytes)
    return keys, vals


def _union_fill(cols: list):
    """(union keys, value matrix S-bytes[U, n]) of n (keys, values)
    columns; a key a sample lacks is filled with ``0``."""
    import numpy as np

    union = np.unique(np.concatenate([k for k, _ in cols]))
    width = max((v.dtype.itemsize for _, v in cols), default=1)
    mat = np.full((len(union), len(cols)), b"0", dtype=f"S{max(width, 1)}")
    for j, (keys, vals) in enumerate(cols):
        mat[np.searchsorted(union, keys), j] = vals
    return union, mat


def merge_tsv(tsv_list: dict, out_file) -> Path:
    """K-way merge of per-sample TSVs into a combined matrix.

    ``tsv_list`` maps sample name -> counts TSV path. Samples are column-
    ordered by sorted name; missing k-mers are zero-filled. Matches the
    reference's output (MerCat2's lib/mercat2_report.py:98-156),
    modulo its merge bug on sparse tables (see module docstring).

    Sorted inputs (count tables) take the vectorized union+fill path;
    unsorted inputs (per-metric diversity TSVs, merged in file order by
    the reference's heads-min loop) take the row-by-row merge. Sortedness
    is checked per file as it is read, so the union/matrix is never built
    (and remaining files never loaded) on the unsorted path.
    """
    import numpy as np

    names = sorted(tsv_list)
    header_cell = _read_header_cell(tsv_list[names[0]])
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    cols = []
    for n in names:
        keys, vals = _read_columns(tsv_list[n])
        if not bool(np.all(keys[1:] > keys[:-1])):
            return _merge_tsv_headsmin(tsv_list, out_file, names, header_cell)
        cols.append((keys, vals))
    union, mat = _union_fill(cols)
    with open(out_file, "wb") as w:
        w.write(("\t".join([header_cell] + names) + "\n").encode())
        parts = []
        for i in range(len(union)):
            parts.append(union[i] + b"\t" + b"\t".join(mat[i]) + b"\n")
            if len(parts) >= 8192:
                w.write(b"".join(parts))
                parts = []
        w.write(b"".join(parts))
    return out_file


def _merge_tsv_headsmin(tsv_list: dict, out_file: Path, names, header_cell):
    """Reference-style heads-min k-way merge (emission order follows the
    files when they agree; MerCat2's lib/mercat2_report.py:116-152
    minus its candidate-set bug)."""

    def rows(path):
        with open(path, "rb") as f:
            f.readline()
            for line in f:
                cols = line.rstrip(b"\n").split(b"\t")
                if len(cols) >= 2:
                    yield cols[0], cols[1]

    iters = {n: rows(tsv_list[n]) for n in names}
    current = {n: next(iters[n], None) for n in names}
    with open(out_file, "wb") as w:
        w.write(("\t".join([header_cell] + names) + "\n").encode())
        while True:
            live = [row[0] for row in current.values() if row]
            if not live:
                break
            kmer = min(live)
            cells = [kmer]
            for n in names:
                row = current[n]
                if row and row[0] == kmer:
                    cells.append(row[1])
                    current[n] = next(iters[n], None)
                else:
                    cells.append(b"0")
            w.write(b"\t".join(cells) + b"\n")
    return out_file


def merge_tsv_T(tsv_list: dict, out_file) -> Path:
    """Transposed combined matrix (samples x k-mers), deterministic columns."""
    names = sorted(tsv_list)
    union, mat = _union_fill([_read_columns(tsv_list[n]) for n in names])
    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, "wb") as w:
        w.write(b"\t".join([b"sample"] + list(union)) + b"\n")
        for j, n in enumerate(names):
            w.write(n.encode() + b"\t" + b"\t".join(mat[:, j]) + b"\n")
    return out_file
