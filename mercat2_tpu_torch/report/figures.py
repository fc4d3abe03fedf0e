"""Domain figures: k-mer summary, GC bars, protein metrics, PCA.

Functional equivalents of MerCat2's lib/mercat2_figures.py built on
the dependency-free plotly-JSON layer (report.plotlyjson). Selection logic
(top-5 by across-sample mean, 3-component PCA with the 2D fallback when PC3
explains <1%) matches the reference exactly; styling is equivalent.

A copy of ``mercat2_tpu.report.figures`` (see ``report/plotlyjson.py`` for
why the port keeps copies). ``plot_sample_metrics`` takes the torch device
of the port's metrics instead of a flag: None for the host path.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np

from mercat2_tpu_torch.report.plotlyjson import (
    PlotlyFigure,
    bar,
    facet_bars,
    scatter2d,
    scatter3d,
    table,
)

__all__ = [
    "kmer_summary",
    "gc_plot_sample",
    "plot_sample_metrics",
    "plot_pca",
    "quality_curve_svg",
]


def kmer_summary(tsv_file) -> tuple[PlotlyFigure, PlotlyFigure]:
    """Top-5 k-mers by across-sample mean: faceted bars + label table.

    Mirrors MerCat2's lib/mercat2_figures.py:40-88 (top-5 maintained
    by strict > on the mean, so earliest rows win ties).
    """
    num_kmers = 5
    with open(tsv_file) as reader:
        header = reader.readline().rstrip("\n").split("\t")
        samples = header[1:]
        kmers: list[str] = []
        means: list[float] = []
        rows: list[list[int]] = []
        for line in reader:
            cols = line.rstrip("\n").split("\t")
            counts = [int(x) for x in cols[1:]]
            kmers.append(cols[0])
            rows.append(counts)
            means.append(sum(counts) / len(counts))
    order = sorted(range(len(kmers)), key=lambda i: (-means[i], i))[:num_kmers]
    # labels assigned by alphabetical k-mer order, as pd.Categorical codes do
    chosen = sorted(order, key=lambda i: kmers[i])
    labels = {i: f"k-mer-{j + 1}" for j, i in enumerate(chosen)}

    facet_rows = []
    for i in chosen:
        # within a facet, samples sorted by descending count (reference
        # sorts by ['label','count'] ascending/descending)
        sample_order = sorted(range(len(samples)), key=lambda s: -rows[i][s])
        traces = [
            bar([samples[s]], [rows[i][s]], name=samples[s], text=[rows[i][s]])
            for s in sample_order
        ]
        facet_rows.append((labels[i], traces))
    fig = facet_bars(facet_rows)
    fig_table = table(
        [[labels[i] for i in chosen], [kmers[i] for i in chosen]]
    )
    return fig, fig_table


def gc_plot_sample(gc_content: dict) -> PlotlyFigure:
    """Bar chart of per-sample GC% (ref lib/mercat2_figures.py:122-136)."""
    names = list(gc_content)
    return PlotlyFigure(
        [bar(names, [gc_content[n] for n in names], name="GC Content")],
        {"xaxis": {"title": {"text": "Sample"}}, "yaxis": {"title": {"text": "GC percent"}}},
    )


def plot_sample_metrics(protein_samples: dict, tsv_out, device=None) -> dict:
    """Per-protein length/pI/MW/hydropathy TSV + bar figures per sample.

    Equivalent of MerCat2's lib/mercat2_figures.py:140-202: re-reads
    each protein faa, computes the metrics (vectorized, see
    mercat2_tpu.metrics.protein), writes the combined TSV (sorted by length
    descending per sample) and emits PI/MW/Hydro bar charts keyed like the
    reference ("{base}_PI" etc.). ``device`` is a torch device for the
    port's device metrics, or None for the host path.
    """
    from mercat2_tpu_torch.metrics.protein import protein_metrics_table

    tsv_out = Path(tsv_out)
    tsv_out.parent.mkdir(parents=True, exist_ok=True)
    with open(tsv_out, "w") as w:
        print("Sample", "seq_name", "length", "PI", "MW", "Hydro", sep="\t", file=w)

    figures: dict[str, PlotlyFigure] = {}
    for basename, files in protein_samples.items():
        for file in files:
            tbl = protein_metrics_table(file, device=device)
            order = np.argsort(-tbl["length"], kind="stable")
            with open(tsv_out, "a") as w:
                for i in order:
                    print(
                        tbl["full_name"][i],
                        tbl["name"][i],
                        float(tbl["length"][i]),
                        tbl["pi"][i],
                        tbl["mw"][i],
                        tbl["hydro"][i],
                        sep="\t",
                        file=w,
                    )
            lengths = tbl["length"][order].tolist()
            for metric, key in (("pi", "PI"), ("mw", "MW"), ("hydro", "Hydro")):
                vals = [tbl[metric][i] for i in order]
                figures[f"{basename}_{key}"] = PlotlyFigure(
                    [bar(lengths, vals)],
                    {
                        "xaxis": {"title": {"text": "Length"}},
                        "yaxis": {"title": {"text": key}},
                    },
                )
    return figures


def plot_pca(tsv_file, out_path, lowmem=None, class_file=None, debug=False):
    """3-component PCA of the transposed combined matrix.

    Matches MerCat2's lib/mercat2_figures.py:206-352: IncrementalPCA
    when lowmem (auto when >1000 samples), pca.tsv output, 3D scatter, and a
    2D fallback figure when PC3 explains <1% variance. PNGs via matplotlib.
    """
    import pandas as pd
    from sklearn.decomposition import PCA
    from sklearn.decomposition import IncrementalPCA as iPCA

    out_path = Path(out_path)
    out_path.mkdir(parents=True, exist_ok=True)
    pca_tsv = out_path / "pca.tsv"
    chunk_size = 1000

    names = []
    with open(tsv_file) as reader:
        reader.readline()
        for line in reader:
            names.append(re.sub(r"_protein", "", line.split()[0]))

    if lowmem is None:
        lowmem = len(names) > chunk_size

    if lowmem:
        pca = iPCA(n_components=3, batch_size=100)
        for chunk in pd.read_csv(tsv_file, sep="\t", index_col=0, chunksize=chunk_size):
            pca.partial_fit(chunk)
        rows = []
        for chunk in pd.read_csv(tsv_file, sep="\t", index_col=0, chunksize=chunk_size):
            rows.append(pca.transform(chunk))
        comps = np.concatenate(rows, axis=0)
    else:
        pca = PCA(n_components=3)
        df = pd.read_csv(tsv_file, sep="\t", index_col=0)
        comps = pca.fit_transform(df)

    with open(pca_tsv, "w") as w:
        print("sample", "PC1", "PC2", "PC3", sep="\t", file=w)
        for name, row in zip(names, comps):
            w.write(name)
            for c in row:
                w.write(f"\t{c}")
            w.write("\n")

    var = pca.explained_variance_ratio_ * 100
    axis_titles = [f"PC {i} ({v:.1f}%)" for i, v in enumerate(var, start=1)]

    classes = None
    if class_file:
        df_tax = pd.read_csv(class_file, sep="\t", index_col=0, names=["class"])
        classes = [str(df_tax["class"].get(n, "NA")) for n in names]

    fig3d = PlotlyFigure(
        [scatter3d(comps[:, 0], comps[:, 1], comps[:, 2], classes or names)],
        {
            "scene": {
                "xaxis": {"title": {"text": axis_titles[0]}},
                "yaxis": {"title": {"text": axis_titles[1]}},
                "zaxis": {"title": {"text": axis_titles[2]}},
            },
            "margin": {"l": 0, "r": 0, "t": 0, "b": 0},
        },
    )
    _pca_png(comps, names, out_path / f"pca{'_incremental' if lowmem else ''}.png", three_d=True)

    fig2d = None
    if var[2] < 1:
        fig2d = PlotlyFigure(
            [scatter2d(comps[:, 0], comps[:, 1], classes or names)],
            {
                "xaxis": {"title": {"text": axis_titles[0]}},
                "yaxis": {"title": {"text": axis_titles[1]}},
                "margin": {"l": 0, "r": 0, "t": 0, "b": 0},
            },
        )
        _pca_png(comps, names, out_path / f"pca2D{'_incremental' if lowmem else ''}.png", three_d=False)
    return fig3d, fig2d


def _pca_png(comps, names, path, three_d: bool):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 6))
    if three_d:
        ax = fig.add_subplot(projection="3d")
        ax.scatter(comps[:, 0], comps[:, 1], comps[:, 2])
        for n, (x, y, z) in zip(names, comps[:, :3]):
            ax.text(x, y, z, n, fontsize=7)
    else:
        ax = fig.add_subplot()
        ax.scatter(comps[:, 0], comps[:, 1])
        for n, (x, y) in zip(names, comps[:, :2]):
            ax.annotate(n, (x, y), fontsize=7)
    fig.savefig(path, dpi=120)
    plt.close(fig)


def quality_curve_svg(per_position: list[dict], width=640, height=240) -> str:
    """Tiny inline-SVG per-position quality curve for the QC HTML report."""
    if not per_position:
        return "<p>(no reads)</p>"
    max_pos = max(p["pos"] for p in per_position)
    max_q = 45.0

    def pt(pos, q):
        x = 40 + (pos - 1) / max(max_pos - 1, 1) * (width - 60)
        y = height - 20 - (q / max_q) * (height - 40)
        return f"{x:.1f},{y:.1f}"

    mean_pts = " ".join(pt(p["pos"], p["mean"]) for p in per_position)
    q25_pts = " ".join(pt(p["pos"], p["q25"]) for p in per_position)
    q75_pts = " ".join(pt(p["pos"], p["q75"]) for p in per_position)
    return (
        f'<svg width="{width}" height="{height}" xmlns="http://www.w3.org/2000/svg">'
        f'<rect width="{width}" height="{height}" fill="#fafafa"/>'
        f'<polyline points="{q25_pts}" fill="none" stroke="#ccc"/>'
        f'<polyline points="{q75_pts}" fill="none" stroke="#ccc"/>'
        f'<polyline points="{mean_pts}" fill="none" stroke="#636efa" stroke-width="2"/>'
        f'<text x="40" y="14" font-size="11">Per-position quality (mean, IQR)</text>'
        "</svg>"
    )
