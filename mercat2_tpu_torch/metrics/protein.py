"""Protein metrics: isoelectric point, molecular weight, hydropathy.

Vectorized (whole-file batch) equivalents of the reference's per-sequence
Python loops (MerCat2's lib/mercat2_metrics.py). Constants are the
published tables the reference also uses:

- ProMoST pKa values (Kozlowski, "IPC — Isoelectric Point Calculator",
  Biology Direct 2016, DOI 10.1186/s13062-016-0159-9),
- average amino-acid residue masses,
- Kyte-Doolittle hydropathy scores (J Mol Biol 1982).

The pI solver reproduces the reference's exact bisection schedule
(pH0=6.51, bounds [0,14], epsilon 0.01, terminal check after the update,
MerCat2's lib/mercat2_metrics.py:57-101) but runs it as a batched
float64 numpy iteration over every protein in a file at once — the same
arithmetic per lane, so results match to the bit. The torch variant of the
batched solver lives in :mod:`mercat2_tpu_torch.metrics.device`
(``protein_metrics_table(..., device=<torch device>)`` / the
``-device-metrics`` pipeline flag) for on-device computation at scale.

MW/hydropathy use ``np.add.reduceat`` over a per-residue lookup, which sums
left-to-right exactly like the reference's character loop (unknown residues
contribute +0.0, which is an IEEE no-op), so rounded outputs are identical.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from mercat2_tpu_torch.io.fasta import read_file_bytes

__all__ = [
    "isoelectric_point_batch",
    "molecular_weight_batch",
    "hydropathy_batch",
    "protein_metrics_table",
]

# ProMoST pKa: residue -> (N-terminal pKa, middle pKa, C-terminal pKa)
_PKA_TERMINAL = {
    "K": (10.00, 9.80, 10.30),
    "R": (11.50, 12.50, 11.50),
    "H": (4.89, 6.08, 6.89),
    "D": (3.57, 4.07, 4.57),
    "E": (4.15, 4.45, 4.75),
    "C": (8.00, 8.28, 9.00),
    "Y": (9.34, 9.84, 10.34),
    "U": (5.20, 5.43, 5.60),
}

# ProMoST: residue -> (N-terminus pKa, C-terminus pKa) for non-charged residues
_PKA_MID = {
    "G": (7.50, 3.70), "A": (7.58, 3.75), "S": (6.86, 3.61), "P": (8.36, 3.40),
    "V": (7.44, 3.69), "T": (7.02, 3.57), "C": (8.12, 3.10), "I": (7.48, 3.72),
    "L": (7.46, 3.73), "J": (7.46, 3.73), "N": (7.22, 3.64), "D": (7.70, 3.50),
    "Q": (6.73, 3.57), "K": (6.67, 3.40), "E": (7.19, 3.50), "M": (6.98, 3.68),
    "H": (7.18, 3.17), "F": (6.96, 3.98), "R": (6.76, 3.41), "Y": (6.83, 3.60),
    "W": (7.11, 3.78), "X": (7.26, 3.57), "Z": (6.96, 3.535), "B": (7.46, 3.57),
    "U": (5.20, 5.60), "O": (7.00, 3.50),
}

# Average residue masses (Da); water (18.01524) added per chain.
_MASS = {
    "A": 71.0788, "B": 114.6686, "C": 103.1388, "D": 115.0886, "E": 129.1155,
    "F": 147.1766, "G": 57.0519, "H": 137.1411, "I": 113.1594, "K": 128.1741,
    "L": 113.1594, "M": 131.1926, "N": 114.1038, "O": 237.3018, "P": 97.1167,
    "Q": 128.1307, "R": 156.1875, "S": 87.0782, "T": 101.1051, "U": 150.0388,
    "V": 99.1326, "W": 186.2132, "X": 111.1138, "Y": 163.176, "Z": 128.7531,
}
_WATER = 18.01524

# Kyte-Doolittle hydropathy
_HYDRO = {
    "A": 1.8, "R": -4.5, "N": -3.5, "D": -3.5, "C": 2.5, "Q": -3.5, "E": -3.5,
    "G": -0.4, "H": -3.2, "I": 4.5, "L": 3.8, "K": -3.9, "M": 1.9, "F": 2.8,
    "P": -1.6, "S": -0.8, "T": -0.7, "W": -0.9, "Y": -1.3, "V": 4.2,
}


def _lut(mapping: dict[str, float], default=0.0) -> np.ndarray:
    lut = np.full(256, default, dtype=np.float64)
    for ch, v in mapping.items():
        lut[ord(ch)] = v
    return lut


# first-residue pKa used in the acidic QN1 term: ProMoST C-terminal value if
# the residue is charged, else the mid-table C value. (The reference applies
# the C-table to seq[0] and the N-table to seq[-1]; we reproduce that.)
_LUT_QN1 = _lut(
    {**{ch: v[1] for ch, v in _PKA_MID.items()},
     **{ch: v[2] for ch, v in _PKA_TERMINAL.items()}},
    default=np.nan,
)
# last-residue pKa for the basic QP2 term
_LUT_QP2 = _lut(
    {**{ch: v[0] for ch, v in _PKA_MID.items()},
     **{ch: v[0] for ch, v in _PKA_TERMINAL.items()}},
    default=np.nan,
)
_LUT_MASS = _lut(_MASS)
_LUT_HYDRO = _lut(_HYDRO)

# middle pKa of the 7 charge-carrying residues
_PKA_D = _PKA_TERMINAL["D"][1]
_PKA_E = _PKA_TERMINAL["E"][1]
_PKA_C = _PKA_TERMINAL["C"][1]
_PKA_Y = _PKA_TERMINAL["Y"][1]
_PKA_H = _PKA_TERMINAL["H"][1]
_PKA_K = _PKA_TERMINAL["K"][1]
_PKA_R = _PKA_TERMINAL["R"][1]


def _residue_counts(seq: np.ndarray, offsets: np.ndarray, ch: str) -> np.ndarray:
    ind = (seq == ord(ch)).astype(np.float64)
    return np.add.reduceat(ind, offsets[:-1]) if offsets.size > 1 else np.zeros(0)


def isoelectric_point_batch(seq: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Batched ProMoST pI. NaN where the last residue has no pKa entry
    (the reference returns None there)."""
    n = offsets.size - 1
    if n == 0:
        return np.zeros(0)
    first = seq[offsets[:-1]]
    last = seq[offsets[1:] - 1]
    pka_first = _LUT_QN1[first]
    pka_last = _LUT_QP2[last]

    c_d = _residue_counts(seq, offsets, "D")
    c_e = _residue_counts(seq, offsets, "E")
    c_c = _residue_counts(seq, offsets, "C")
    c_y = _residue_counts(seq, offsets, "Y")
    c_h = _residue_counts(seq, offsets, "H")
    c_k = _residue_counts(seq, offsets, "K")
    c_r = _residue_counts(seq, offsets, "R")

    ph = np.full(n, 6.51)
    ph_prev = np.zeros(n)
    ph_next = np.full(n, 14.0)
    eps = 0.01
    result = np.full(n, np.nan)
    done = np.isnan(pka_last)  # invalid last residue -> stays NaN

    for _ in range(64):
        if done.all():
            break
        qn1 = -1.0 / (1.0 + 10.0 ** (pka_first - ph))
        qp2 = 1.0 / (1.0 + 10.0 ** (ph - pka_last))
        qn2 = -c_d / (1.0 + 10.0 ** (_PKA_D - ph))
        qn3 = -c_e / (1.0 + 10.0 ** (_PKA_E - ph))
        qn4 = -c_c / (1.0 + 10.0 ** (_PKA_C - ph))
        qn5 = -c_y / (1.0 + 10.0 ** (_PKA_Y - ph))
        qp1 = c_h / (1.0 + 10.0 ** (ph - _PKA_H))
        qp3 = c_k / (1.0 + 10.0 ** (ph - _PKA_K))
        qp4 = c_r / (1.0 + 10.0 ** (ph - _PKA_R))
        nq = qn1 + qn2 + qn3 + qn4 + qn5 + qp1 + qp2 + qp3 + qp4

        neg = nq < 0.0
        temp = ph.copy()
        ph = np.where(neg, ph - (ph - ph_prev) / 2.0, ph + (ph_next - ph) / 2.0)
        ph_next = np.where(neg, temp, ph_next)
        ph_prev = np.where(neg, ph_prev, temp)

        conv = (~done) & (ph - ph_prev < eps) & (ph_next - ph < eps)
        result[conv] = ph[conv]
        done |= conv
    return result


def molecular_weight_batch(seq: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    if offsets.size <= 1:
        return np.zeros(0)
    return np.add.reduceat(_LUT_MASS[seq], offsets[:-1]) + _WATER


def hydropathy_batch(seq: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    if offsets.size <= 1:
        return np.zeros(0)
    return np.add.reduceat(_LUT_HYDRO[seq], offsets[:-1])


def _parse_protein_fasta(path):
    """Metrics-path parsing: lines stripped then ``rstrip('*')``
    (MerCat2's lib/mercat2_figures.py:157-183), empty records skipped
    with a warning."""
    text = read_file_bytes(path).decode("latin-1")
    full_names: list[str] = []
    names: list[str] = []
    seqs: list[str] = []
    header = None
    parts: list[str] = []

    def flush():
        if header is None:
            return
        s = "".join(parts)
        if s:
            full_names.append(header)
            names.append(header.split()[0] if header.split() else "")
            seqs.append(s)
        else:
            print("WARNING: Empty Sequence:", header)

    for raw in text.split("\n"):
        line = raw.strip().rstrip("*")
        if line.startswith(">"):
            flush()
            header = line[1:]
            parts = []
        else:
            parts.append(line)
    flush()
    return full_names, names, seqs


def protein_metrics_table(path, device=None) -> dict:
    """Per-protein metric arrays for one faa file (pI/MW/Hydro rounded to 2dp
    with Python round(), matching the reference's output values).

    A torch ``device`` batches the three metrics there
    (mercat2_tpu_torch.metrics.device, float64: the same rounded values as
    this host path); the default ``None`` is the host path."""
    full_names, names, seqs = _parse_protein_fasta(path)
    flat = np.frombuffer("".join(seqs).encode("latin-1"), dtype=np.uint8)
    lens = np.asarray([len(s) for s in seqs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)])

    if device is not None:
        from mercat2_tpu_torch.metrics.device import protein_metrics_device

        pi, mw, hyd = protein_metrics_device(flat, offsets, device)
    else:
        pi = isoelectric_point_batch(flat, offsets)
        mw = molecular_weight_batch(flat, offsets)
        hyd = hydropathy_batch(flat, offsets)
    return dict(
        full_name=full_names,
        name=names,
        length=lens,
        pi=[None if np.isnan(x) else round(float(x), 2) for x in pi],
        mw=[round(float(x), 2) for x in mw],
        hydro=[round(float(x), 2) for x in hyd],
    )
