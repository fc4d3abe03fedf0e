"""Protein and alpha-diversity metrics as PyTorch ops on an explicit device.

The port of ``mercat2_tpu.metrics.device`` (``-device-metrics``): every
protein of a file goes through per-protein residue counts and a batched
64-step pI bisection, and the nine alpha metrics come out of reductions
over one count vector, instead of per-sequence and per-metric host code.
No Pallas kernel sits behind the JAX version, so none is owed here: these
are plain torch functions, run on whatever device they are given.

Numerics: float64 throughout. The JAX version is float32 only because
TPUs lack f64; on the H100 (and the CPU) the port follows the host path
of ``mercat2_tpu.metrics.{protein,alpha}`` term by term, so its rounded
outputs are the host path's. Sums are taken in another order than numpy's,
so raw MW, hydropathy and Shannon values may differ from the host's in
the last bits; the pI bisection makes the same decisions and gives the
same values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mercat2_tpu.metrics import protein as _p

__all__ = ["alpha_metrics_device", "protein_metrics_device"]

_F64 = torch.float64
#: residue letters 'A'..'Z' get columns 0..25 of the count matrix; any
#: other byte column 26, which has no mass, hydropathy or charge
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_OTHER = len(_LETTERS)


def _letter_table(mapping: dict) -> list[float]:
    return [mapping.get(ch, 0.0) for ch in _LETTERS] + [0.0]


def _residue_counts(flat: torch.Tensor, lens: torch.Tensor, n: int) -> torch.Tensor:
    """float64[n, 27] exact per-protein counts of each letter column."""
    col = torch.full((256,), _OTHER, dtype=torch.int64, device=flat.device)
    col[ord("A") : ord("Z") + 1] = torch.arange(_OTHER, device=flat.device)
    seg = torch.repeat_interleave(torch.arange(n, device=flat.device), lens)
    idx = seg * (_OTHER + 1) + col[flat.to(torch.int64)]
    counts = torch.bincount(idx, minlength=n * (_OTHER + 1))
    return counts.view(n, _OTHER + 1).to(_F64)


def protein_metrics_device(flat: np.ndarray, offsets: np.ndarray, device):
    """(pI, MW, hydropathy) float64 arrays for a batch of proteins.

    ``flat`` is the concatenated ASCII residue bytes, ``offsets`` the
    int64[n+1] chain boundaries (the layout of the host batch API). pI is
    NaN where the last residue has no pKa entry, as on the host.
    """
    n = offsets.size - 1
    if n == 0:
        z = np.zeros(0, np.float64)
        return z, z, z
    dev = torch.device(device)
    seq = torch.from_numpy(np.array(flat, np.uint8)).to(dev)  # a writable copy
    off = torch.from_numpy(np.asarray(offsets, np.int64)).to(dev)
    c = _residue_counts(seq, off[1:] - off[:-1], n)

    mass = torch.tensor(_letter_table(_p._MASS), dtype=_F64, device=dev)
    hydro = torch.tensor(_letter_table(_p._HYDRO), dtype=_F64, device=dev)
    mw = (c * mass).sum(1) + _p._WATER
    hyd = (c * hydro).sum(1)

    first = seq[off[:-1]].to(torch.int64)
    last = seq[off[1:] - 1].to(torch.int64)
    pka_first = torch.from_numpy(_p._LUT_QN1).to(dev)[first]
    pka_last = torch.from_numpy(_p._LUT_QP2).to(dev)[last]

    def col(ch: str) -> torch.Tensor:
        return c[:, ord(ch) - ord("A")]

    c_d, c_e, c_c, c_y = col("D"), col("E"), col("C"), col("Y")
    c_h, c_k, c_r = col("H"), col("K"), col("R")

    # the host's bisection (metrics/protein.py:140-169), term for term and
    # in its order of summation; all 64 steps run, which changes nothing
    # for a converged lane since ``done`` freezes its result
    ph = torch.full((n,), 6.51, dtype=_F64, device=dev)
    ph_prev = torch.zeros(n, dtype=_F64, device=dev)
    ph_next = torch.full((n,), 14.0, dtype=_F64, device=dev)
    result = torch.full((n,), math.nan, dtype=_F64, device=dev)
    done = torch.isnan(pka_last)
    for _ in range(64):
        qn1 = -1.0 / (1.0 + 10.0 ** (pka_first - ph))
        qp2 = 1.0 / (1.0 + 10.0 ** (ph - pka_last))
        qn2 = -c_d / (1.0 + 10.0 ** (_p._PKA_D - ph))
        qn3 = -c_e / (1.0 + 10.0 ** (_p._PKA_E - ph))
        qn4 = -c_c / (1.0 + 10.0 ** (_p._PKA_C - ph))
        qn5 = -c_y / (1.0 + 10.0 ** (_p._PKA_Y - ph))
        qp1 = c_h / (1.0 + 10.0 ** (ph - _p._PKA_H))
        qp3 = c_k / (1.0 + 10.0 ** (ph - _p._PKA_K))
        qp4 = c_r / (1.0 + 10.0 ** (ph - _p._PKA_R))
        nq = qn1 + qn2 + qn3 + qn4 + qn5 + qp1 + qp2 + qp3 + qp4

        neg = nq < 0.0
        temp = ph
        ph = torch.where(neg, ph - (ph - ph_prev) / 2.0, ph + (ph_next - ph) / 2.0)
        ph_next = torch.where(neg, temp, ph_next)
        ph_prev = torch.where(neg, ph_prev, temp)
        conv = ~done & (ph - ph_prev < 0.01) & (ph_next - ph < 0.01)
        result = torch.where(conv, ph, result)
        done = done | conv
    host = torch.stack([result, mw, hyd]).cpu().numpy()
    return host[0], host[1], host[2]


#: the host's Fisher search doubles hi from 1 and gives up once hi > 1e12,
#: so it solves only when g(2**39) >= 0 (metrics/alpha.py:87-91)
_FISHER_HI = 2.0 ** 39
_FISHER_STEPS = 128  # bisection halvings: 2**39 / 2**128 is far below an ulp


def alpha_metrics_device(counts: np.ndarray, device) -> dict:
    """All nine alpha metrics of one count vector, 'NA' where undefined.

    The values, and their Python types, are those of the host path
    (``mercat2_tpu.metrics.alpha``): where the host returns an int (the
    observed count of an exact Chao1 interval, ACE without rare k-mers)
    so does this, so that both print alike.
    """
    dev = torch.device(device)
    c = torch.from_numpy(np.asarray(counts, np.int64)).to(dev).to(_F64)
    n = c.sum()
    obs = (c > 0).sum().to(_F64)
    f1 = (c == 1).sum().to(_F64)
    f2 = (c == 2).sum().to(_F64)

    freqs = c / n
    nz = torch.where(c > 0, freqs, 1.0)
    shannon = -(nz * torch.log(nz)).sum() / math.log(2.0)
    dominance = (freqs ** 2).sum()
    simpson = 1.0 - dominance
    simpson_e = (1.0 / dominance) / obs
    goods = 1.0 - f1 / n

    # Fisher's alpha: bisection on g(a) = a*log(1 + n/a) - obs, increasing
    def g(a):
        return a * torch.log(1 + n / a) - obs

    lo = torch.tensor(1e-9, dtype=_F64, device=dev)
    hi = torch.tensor(_FISHER_HI, dtype=_F64, device=dev)
    solvable = (n > 0) & (obs > 0) & (obs != n) & (g(hi) >= 0)
    for _ in range(_FISHER_STEPS):
        mid = 0.5 * (lo + hi)
        below = g(mid) < 0
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    fisher = torch.where(solvable, 0.5 * (lo + hi), math.nan)

    chao1 = obs + f1 * (f1 - 1) / (2.0 * (f2 + 1))

    # Chao1 interval, bias-corrected (the host's three branches)
    var_12 = (
        f1 * (f1 - 1) / (2 * (f2 + 1))
        + f1 * (2 * f1 - 1) ** 2 / (4 * (f2 + 1) ** 2)
        + f1**2 * f2 * (f1 - 1) ** 2 / (4 * (f2 + 1) ** 4)
    )
    var_1 = f1 * (f1 - 1) / 2.0 + f1 * (2 * f1 - 1) ** 2 / 4.0 - f1**4 / (4.0 * chao1)
    var = torch.where(f2 > 0, var_12, var_1)
    t = chao1 - obs
    k = torch.exp(torch.abs(1.96 * torch.sqrt(torch.log(1 + var / t**2))))
    p0 = torch.exp(-n / obs)
    term = 1.96 * torch.sqrt(obs * p0 / (1 - p0))
    lo_ci = torch.where(f1 > 0, obs + t / k, torch.maximum(obs, obs / (1 - p0) - term))
    hi_ci = torch.where(f1 > 0, obs + t * k, obs / (1 - p0) + term)

    # ACE, rare threshold 10
    rare = (c > 0) & (c <= 10)
    s_abun = (c > 10).sum().to(_F64)
    s_rare = rare.sum().to(_F64)
    n_rare = torch.where(rare, c, 0.0).sum()
    c_ace = 1 - f1 / n_rare
    i = torch.arange(1, 11, dtype=_F64, device=dev)
    fi = (c[None, :] == i[:, None]).sum(1).to(_F64)
    top = (i * (i - 1) * fi).sum()
    gamma = torch.clamp((s_rare / c_ace) * top / (n_rare * (n_rare - 1)) - 1, min=0.0)
    ace = s_abun + s_rare / c_ace + (f1 / c_ace) * gamma

    v = torch.stack([
        shannon, simpson, simpson_e, goods, fisher, dominance, chao1,
        lo_ci, hi_ci, ace, obs, f1, t, s_abun, s_rare, n_rare,
    ]).cpu().tolist()
    (shannon, simpson, simpson_e, goods, fisher, dominance, chao1,
     lo_ci, hi_ci, ace, obs, f1, t, s_abun, s_rare, n_rare) = v

    def val(x):
        return "NA" if not math.isfinite(x) else x

    o = int(obs)
    if f1 > 0 and t == 0:
        ci = (o, o)
    elif not (math.isfinite(lo_ci) and math.isfinite(hi_ci)):
        ci = "NA"
    else:  # max(o, ...) keeps the int where the host's does
        ci = (o if f1 == 0 and lo_ci == o else lo_ci, hi_ci)
    if s_rare == 0:
        ace = int(s_abun)
    elif f1 == n_rare:
        ace = "NA"
    else:
        ace = val(ace)
    return {
        "shannon": val(shannon),
        "simpson": val(simpson),
        "simpson_e": val(simpson_e),
        "goods_coverage": val(goods),
        "fisher_alpha": val(fisher),
        "dominance": val(dominance),
        "chao1": val(chao1),
        "chao1_ci": ci,
        "ace": ace,
    }
