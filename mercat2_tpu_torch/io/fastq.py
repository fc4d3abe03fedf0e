"""FASTQ QC report of the port.

A copy of ``mercat2_tpu.io.fastq.qc``: its HTML writer imports
``mercat2_tpu.report.figures``, whose package imports the JAX counter, so
the port writes the same report with its own copy of
``quality_curve_svg``. The statistics, ``trim`` and ``fq2fa`` are the JAX
package's host code, reused as they are (``mercat2_tpu.io.fastq`` itself
imports only numpy and ``mercat2_tpu.io.fasta``).
"""

from __future__ import annotations

import json
from pathlib import Path

from mercat2_tpu.io.fastq import _qc_stats, read_fastq
from mercat2_tpu_torch.report.figures import quality_curve_svg

__all__ = ["qc"]


def qc(fq_file, outpath, f_name: str) -> Path:
    """Write a QC report (HTML + JSON) for one FASTQ file."""
    outpath = Path(outpath)
    outpath.mkdir(parents=True, exist_ok=True)
    fq = read_fastq(fq_file)
    stats = _qc_stats(fq)
    stem = Path(str(fq_file)).name
    json_out = outpath / f"{stem}_qc.json"
    json_out.write_text(json.dumps(stats, indent=1))

    html_out = outpath / f"{stem}_qc.html"
    scalar = {
        k: v for k, v in stats.items()
        if k not in ("per_position", "per_base_content", "duplication",
                     "overrepresented")
    }
    rows = "".join(
        f"<tr><td>{k}</td><td>{v}</td></tr>" for k, v in scalar.items()
    )
    dup = stats["duplication"]
    dup_rows = "".join(
        f"<tr><td>{d['level']}</td><td>{d['pct_of_total']}</td>"
        f"<td>{d['pct_of_distinct']}</td></tr>"
        for d in dup.get("levels", [])
    )
    over_rows = "".join(
        f"<tr><td><code>{o['sequence']}</code></td><td>{o['count']}</td>"
        f"<td>{o['percentage']}</td><td>{o['possible_source']}</td></tr>"
        for o in stats["overrepresented"]
    ) or "<tr><td colspan='4'>none over 0.1%</td></tr>"
    html_out.write_text(
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>QC {stem}</title></head><body><h1>Read QC: {stem}</h1>"
        f"<table border='1'>{rows}</table>"
        f"{quality_curve_svg(stats['per_position'])}"
        "<h2>Sequence duplication levels</h2>"
        f"<p>Reads remaining if deduplicated: "
        f"{dup['pct_remaining_if_dedup']}%</p>"
        "<table border='1'><tr><th>level</th><th>% of total</th>"
        f"<th>% of distinct</th></tr>{dup_rows}</table>"
        "<h2>Overrepresented sequences</h2>"
        "<table border='1'><tr><th>sequence (50bp)</th><th>count</th>"
        f"<th>%</th><th>possible source</th></tr>{over_rows}</table>"
        "</body></html>"
    )
    return html_out
