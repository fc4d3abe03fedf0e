"""Standalone HTML report (dependency-free equivalent of the reference's
dominate-based writer, MerCat2's lib/mercat2_report.py:35-94):
title bar, table of contents, one section per figure, downloads section.

A copy of ``mercat2_tpu.report.html`` (see ``report/plotlyjson.py`` for
why the port keeps copies)."""

from __future__ import annotations

import base64
import time
from html import escape
from pathlib import Path

__all__ = ["write_html"]

_CSS = """
body { font-family: 'Helvetica Neue', Arial, sans-serif; margin: 0; color: #222; }
h1.title { background: #1a2a45; color: #fff; padding: 14px 24px; margin: 0;
           font-size: 22px; }
h1.title a { color: #7fd1ff; text-decoration: none; }
div.contents { float: left; width: 230px; padding: 12px; font-size: 14px; }
div.contents ul { list-style: none; padding-left: 12px; }
div.contents a { color: #174a7c; text-decoration: none; }
div.main { margin-left: 260px; padding: 12px 24px; }
div.section { margin-bottom: 28px; border-bottom: 1px solid #eee; }
#metadata { color: #888; font-size: 12px; padding: 12px 24px; }
"""


def write_html(outfile, fig_plots: dict, tsv_stats: dict) -> Path:
    """Render the report. ``fig_plots`` maps section title -> figure or
    iterable of figures (anything with ``.to_html(full_html, include_plotlyjs)``);
    ``tsv_stats`` maps name -> base64 TSV content for the downloads section."""
    outfile = Path(outfile)
    outfile.parent.mkdir(parents=True, exist_ok=True)

    toc = "".join(
        f'<li><a class="reference internal" href="#{escape(key)}">{escape(key)}</a></li>'
        for key in fig_plots
    )
    sections = []
    first = True
    for key, figures in fig_plots.items():
        try:
            body = figures.to_html(full_html=False, include_plotlyjs="cdn" if first else False)
            first = False
        except AttributeError:
            parts = []
            for fig in figures:
                parts.append(fig.to_html(full_html=False, include_plotlyjs="cdn" if first else False))
                first = False
            body = "".join(parts)
        sections.append(
            f'<div class="section" id="{escape(key)}"><h2>{escape(key)}</h2>{body}</div>'
        )

    downloads = "".join(
        f'<dt>{escape(key)}</dt><dd><a href="data:text/tab-separated-values;base64,{value}" '
        f'download="{escape(key)}.tsv">{escape(key)}.tsv</a></dd>'
        for key, value in tsv_stats.items()
    )

    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>K-Mer Report</title>
<style>{_CSS}</style></head>
<body>
<h1 class="title"><a class="reference external"
 href="https://github.com/raw-lab/mercat2">MERCAT2-TPU</a> - Summary</h1>
<div class="contents topic" id="contents"><ul class="simple">
<li><a class="reference internal" href="#summary">Summary</a></li>
<ul>{toc}</ul>
<li><a class="reference internal" href="#downloads">Downloads</a></li>
</ul></div>
<div class="main">
<div class="section" id="summary"><h1>Summary</h1>{"".join(sections)}</div>
<div class="section" id="downloads"><h1>Downloads</h1><dl>{downloads}</dl></div>
</div>
<div id="metadata">{time.strftime("%Y-%m-%d", time.localtime())}</div>
</body></html>"""
    outfile.write_text(doc)
    return outfile
