"""Native six-frame ORF finder + translator (vectorized numpy).

Replaces the reference's external gene callers when they are unavailable:
pyrodigal (C extension, MerCat2's lib/mercat2_fasta.py:202-244) and
the bundled FragGeneScanRs Rust binary (:248-290). This is a deliberately
simple maximal-ORF caller (stop-to-stop segments, first ATG/GTG/TTG start,
minimum length), not a trained gene model — it provides the ORF->protein
capability of the pipeline natively; when pyrodigal or FragGeneScanRs are
installed they are preferred for model parity (see orf.caller).

Translation uses the standard bacterial code (NCBI table 11 coding
equivalent); codons containing non-ACGT bases translate to 'X'.
"""

from __future__ import annotations

import numpy as np

__all__ = ["find_orfs", "CODON_TABLE", "translate_codons"]

_BASE_LUT = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _BASE_LUT[b] = i
for i, b in enumerate(b"acgt"):
    _BASE_LUT[b] = i

_COMP = {0: 3, 1: 2, 2: 1, 3: 0, 4: 4}
_COMP_LUT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)

# standard genetic code, indexed by 16*b0 + 4*b1 + b2 with A,C,G,T = 0..3
_AA = "KNKNTTTTRSRSIIMIQHQHPPPPRRRRLLLLEDEDAAAAGGGGVVVV*Y*YSSSS*CWCLFLF"
CODON_TABLE = np.frombuffer(_AA.encode(), dtype=np.uint8)

_STARTS = np.array([14, 46, 62], dtype=np.int16)  # ATG, GTG, TTG
_STOPS = np.array([48, 50, 56], dtype=np.int16)  # TAA, TAG, TGA


def translate_codons(codons: np.ndarray, invalid: np.ndarray) -> np.ndarray:
    """int16 codon indices (+invalid mask) -> uint8 amino-acid ASCII."""
    aa = CODON_TABLE[np.clip(codons, 0, 63)]
    return np.where(invalid, np.uint8(ord("X")), aa)


def _frame_codons(codes: np.ndarray, frame: int) -> tuple[np.ndarray, np.ndarray]:
    n = (codes.shape[0] - frame) // 3
    if n <= 0:
        return np.zeros(0, np.int16), np.zeros(0, bool)
    c = codes[frame : frame + 3 * n].reshape(n, 3).astype(np.int16)
    invalid = (c >= 4).any(axis=1)
    idx = c[:, 0] * 16 + c[:, 1] * 4 + c[:, 2]
    return idx, invalid


def find_orfs(seq_bytes: np.ndarray, min_nt: int = 90, require_start: bool = True):
    """Find ORFs on both strands of one sequence.

    Returns a list of dicts: start/end (1-based, forward-strand coords,
    inclusive, like gene callers emit), strand (+1/-1), frame, and the
    translated protein (bytes, stop codon excluded).
    """
    n = seq_bytes.shape[0]
    fwd = _BASE_LUT[seq_bytes]
    rev = _COMP_LUT[fwd[::-1]]
    orfs = []
    for strand, codes in ((1, fwd), (-1, rev)):
        for frame in range(3):
            codons, invalid = _frame_codons(codes, frame)
            m = codons.shape[0]
            if m == 0:
                continue
            is_stop = np.isin(codons, _STOPS) & ~invalid
            is_start = np.isin(codons, _STARTS) & ~invalid
            stop_pos = np.flatnonzero(is_stop)
            # segments: [seg_begin, stop] for each stop, plus the tail
            seg_begins = np.concatenate([[0], stop_pos + 1])
            seg_ends = np.concatenate([stop_pos, [m - 1]])  # inclusive codon idx
            has_stop = np.concatenate([np.ones(len(stop_pos), bool), [False]])
            start_pos = np.flatnonzero(is_start)
            if start_pos.size == 0 and require_start:
                continue
            # first start codon in each segment
            seg_of_start = np.searchsorted(seg_begins, start_pos, side="right") - 1
            first_start = np.full(len(seg_begins), -1, dtype=np.int64)
            # reversed so earlier starts win
            first_start[seg_of_start[::-1]] = start_pos[::-1]
            for s in range(len(seg_begins)):
                begin = first_start[s] if require_start else seg_begins[s]
                if begin < 0 or begin > seg_ends[s]:
                    continue
                end = seg_ends[s]  # inclusive; == stop codon when has_stop
                aa_end = end if not has_stop[s] else end - 1  # drop stop from protein
                nt_len = (end - begin + 1) * 3
                if nt_len < min_nt:
                    continue
                if aa_end < begin:
                    continue
                prot = translate_codons(
                    codons[begin : aa_end + 1], invalid[begin : aa_end + 1]
                ).tobytes()
                # map codon coords to forward-strand 1-based nt coords
                c0 = frame + 3 * begin
                c1 = frame + 3 * end + 2
                if strand == 1:
                    start_nt, end_nt = c0 + 1, c1 + 1
                else:
                    start_nt, end_nt = n - c1, n - c0
                orfs.append(
                    dict(start=int(start_nt), end=int(end_nt), strand=strand,
                         frame=frame, protein=prot)
                )
    orfs.sort(key=lambda o: (o["start"], o["end"]))
    return orfs
