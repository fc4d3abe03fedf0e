"""Alpha diversity metrics, skbio-parity implementations.

The reference fans each metric out as a Ray task over skbio
(MerCat2's lib/mercat2_diversity.py:13-53). skbio is not a dependency
here; the nine metrics are implemented directly (classic estimators —
Shannon base 2, Simpson/dominance, Good's coverage, Fisher's alpha, Chao1
with bias correction + log-normal CI, ACE with rare-threshold 10) and are
validated numerically against the reference's committed golden outputs in
tests/test_alpha.py. Failures produce 'NA' exactly like the reference's
per-metric try/except.

Output TSV format matches MerCat2's lib/mercat2_diversity.py:40-52:
two columns (Metric, value), values rounded to 2 decimals, chao1_ci printed
as a Python list.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

__all__ = ["ALPHA_METRICS", "alpha_metric", "compute_alpha_diversity"]

ALPHA_METRICS = [
    "shannon",
    "simpson",
    "simpson_e",
    "goods_coverage",
    "fisher_alpha",
    "dominance",
    "chao1",
    "chao1_ci",
    "ace",
]


def _osd(counts: np.ndarray) -> tuple[int, int, int]:
    """(observed species, singletons, doubletons)."""
    return int((counts > 0).sum()), int((counts == 1).sum()), int((counts == 2).sum())


def shannon(counts: np.ndarray, base: float = 2.0) -> float:
    n = counts.sum()
    freqs = counts / n
    nz = freqs[freqs > 0]
    return float(-(nz * np.log(nz)).sum() / np.log(base))


def dominance(counts: np.ndarray) -> float:
    n = counts.sum()
    return float(((counts / n) ** 2).sum())


def simpson(counts: np.ndarray) -> float:
    return 1.0 - dominance(counts)


def enspie(counts: np.ndarray) -> float:
    return 1.0 / dominance(counts)


def simpson_e(counts: np.ndarray) -> float:
    return enspie(counts) / _osd(counts)[0]


def goods_coverage(counts: np.ndarray) -> float:
    f1 = (counts == 1).sum()
    n = counts.sum()
    return float(1.0 - f1 / n)


def fisher_alpha(counts: np.ndarray) -> float:
    """Solve S = alpha * ln(1 + N/alpha) for alpha."""
    n = int(counts.sum())
    s = _osd(counts)[0]
    if n <= 0 or s <= 0:
        raise ValueError("fisher_alpha undefined")
    if s == n:
        # all singletons: alpha -> infinity; mirror skbio's failure
        raise ValueError("no solution")

    def f(alpha: float) -> float:
        return alpha * math.log(1 + n / alpha) - s

    lo, hi = 1e-9, 1.0
    while f(hi) < 0:
        hi *= 2.0
        if hi > 1e12:
            raise ValueError("no solution")
    from scipy.optimize import brentq

    return float(brentq(f, lo, hi, xtol=1e-12, rtol=1e-12))


def chao1(counts: np.ndarray, bias_corrected: bool = True) -> float:
    o, f1, f2 = _osd(counts)
    if not bias_corrected and f1 and f2:
        return o + f1**2 / (2.0 * f2)
    return o + f1 * (f1 - 1) / (2.0 * (f2 + 1))


def chao1_ci(counts: np.ndarray, bias_corrected: bool = True, zscore: float = 1.96):
    """Log-normal confidence interval around Chao1 (EstimateS formulas)."""
    o, f1, f2 = _osd(counts)
    if f1 > 0 and f2 > 0:
        estimate = chao1(counts, bias_corrected)
        if bias_corrected:
            var = (
                f1 * (f1 - 1) / (2 * (f2 + 1))
                + f1 * (2 * f1 - 1) ** 2 / (4 * (f2 + 1) ** 2)
                + f1**2 * f2 * (f1 - 1) ** 2 / (4 * (f2 + 1) ** 4)
            )
        else:
            r = f1 / f2
            var = f2 * (0.5 * r**2 + r**3 + 0.25 * r**4)
        t = estimate - o
        if t == 0:
            return o, o
        k = math.exp(abs(zscore * math.sqrt(math.log(1 + var / t**2))))
        return o + t / k, o + t * k
    # no doubletons / no singletons branches
    n = int(counts.sum())
    if f1 > 0:  # singletons but no doubletons
        estimate = chao1(counts, bias_corrected)
        var = (
            f1 * (f1 - 1) / 2.0
            + f1 * (2 * f1 - 1) ** 2 / 4.0
            - f1**4 / (4.0 * estimate)
        )
        t = estimate - o
        if t == 0:
            return o, o
        k = math.exp(abs(zscore * math.sqrt(math.log(1 + var / t**2))))
        return o + t / k, o + t * k
    # no singletons at all
    p = math.exp(-n / o)
    term = zscore * math.sqrt(o * p / (1 - p))
    return max(o, o / (1 - p) - term), o / (1 - p) + term


def ace(counts: np.ndarray, rare_threshold: int = 10) -> float:
    counts = counts[counts > 0]
    rare = counts[counts <= rare_threshold]
    s_abun = int((counts > rare_threshold).sum())
    s_rare = int(rare.shape[0])
    if s_rare == 0:
        return s_abun
    f1 = int((counts == 1).sum())
    n_rare = int(rare.sum())
    if f1 == n_rare:
        raise ValueError("ace undefined when all rare species are singletons")
    c_ace = 1 - f1 / n_rare
    top = 0.0
    for i in range(1, rare_threshold + 1):
        top += i * (i - 1) * int((counts == i).sum())
    gamma = max((s_rare / c_ace) * top / (n_rare * (n_rare - 1)) - 1, 0.0)
    return s_abun + s_rare / c_ace + (f1 / c_ace) * gamma


_FUNCS = {
    "shannon": shannon,
    "simpson": simpson,
    "simpson_e": simpson_e,
    "goods_coverage": goods_coverage,
    "fisher_alpha": fisher_alpha,
    "dominance": dominance,
    "chao1": chao1,
    "chao1_ci": chao1_ci,
    "ace": ace,
}


def alpha_metric(name: str, counts: np.ndarray):
    """Compute one metric; 'NA' on any failure (reference behavior)."""
    try:
        return _FUNCS[name](np.asarray(counts))
    except Exception:
        return "NA"


def compute_alpha_diversity(basename: str, counts_tsv, out_file,
                            device=None) -> Path:
    """Read the count column of a per-sample TSV and write the metric table.

    A torch ``device`` evaluates all nine metrics there
    (mercat2_tpu_torch.metrics.device, float64, the same rounded values);
    the default ``None`` is the host float64 bit-parity implementation."""
    counts = []
    with open(counts_tsv) as reader:
        reader.readline()
        for line in reader:
            counts.append(int(line.split()[1]))
    counts = np.asarray(counts, dtype=np.int64)

    if device is not None:
        from mercat2_tpu_torch.metrics.device import alpha_metrics_device

        results = alpha_metrics_device(counts, device)
    else:
        results = {name: alpha_metric(name, counts) for name in ALPHA_METRICS}

    out_file = Path(out_file)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, "w") as writer:
        print("Metric", basename, sep="\t", file=writer)
        for func in ALPHA_METRICS:
            value = results[func]
            if not isinstance(value, str):
                try:
                    value = round(value, 2)
                except TypeError:
                    value = [round(x, 2) for x in value]
            print(func, value, sep="\t", file=writer)
    return out_file
