"""Minimal plotly-compatible figure model (no plotly dependency).

A copy of ``mercat2_tpu.report.plotlyjson``: that module is free of JAX,
but ``mercat2_tpu/report/__init__`` imports ``report/tsv.py``, which imports
the JAX counter, so the port keeps its own copy.

A plotly figure is just JSON (``data`` traces + ``layout``). The reference
embeds ``fig.to_html(full_html=False, include_plotlyjs='cdn')`` output into
its report (MerCat2's lib/mercat2_report.py:75); this module produces
the same kind of embeddable div + ``Plotly.newPlot`` script from hand-built
JSON, so the interactive HTML report works without plotly installed.
"""

from __future__ import annotations

import json
import uuid

__all__ = ["PlotlyFigure", "bar", "scatter3d", "scatter2d", "table", "facet_bars"]

_CDN = "https://cdn.plot.ly/plotly-2.27.0.min.js"

_COLORWAY = [
    "#636efa", "#EF553B", "#00cc96", "#ab63fa", "#FFA15A",
    "#19d3f3", "#FF6692", "#B6E880", "#FF97FF", "#FECB52",
]


class PlotlyFigure:
    def __init__(self, data: list[dict], layout: dict | None = None):
        self.data = data
        self.layout = dict(layout or {})
        self.layout.setdefault("template", None)
        self.layout.setdefault("font", {"color": "Black"})
        self.layout.setdefault("colorway", _COLORWAY)
        self.layout.setdefault("plot_bgcolor", "white")
        self.layout.setdefault("paper_bgcolor", "white")

    def to_json(self) -> str:
        return json.dumps({"data": self.data, "layout": self.layout})

    def to_html(self, full_html: bool = False, include_plotlyjs="cdn") -> str:
        div_id = f"mercat2tpu-{uuid.uuid4().hex}"
        spec = self.to_json()
        script_tag = f'<script src="{_CDN}"></script>' if include_plotlyjs == "cdn" else ""
        body = (
            f'{script_tag}<div id="{div_id}" class="plotly-graph-div" '
            'style="height:450px; width:100%;"></div>'
            f'<script type="text/javascript">'
            f'var spec = {spec};'
            f'Plotly.newPlot("{div_id}", spec.data, spec.layout, {{responsive: true}});'
            "</script>"
        )
        if full_html:
            return (
                "<!DOCTYPE html><html><head><meta charset='utf-8'></head>"
                f"<body>{body}</body></html>"
            )
        return body

    def write_png(self, path, mpl_render=None) -> None:
        """Rasterize via matplotlib. ``mpl_render(ax_or_fig)`` draws; default
        renders bar/scatter traces approximately."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if mpl_render is not None:
            fig = mpl_render()
            fig.savefig(path, dpi=120)
            plt.close(fig)
            return
        fig, ax = plt.subplots(figsize=(8, 5))
        for i, tr in enumerate(self.data):
            color = _COLORWAY[i % len(_COLORWAY)]
            x = tr.get("x", [])
            y = tr.get("y", [])
            if tr.get("type") == "bar":
                ax.bar(x, y, label=tr.get("name"), color=color)
            else:
                ax.plot(x, y, "o-", label=tr.get("name"), color=color)
        if any(tr.get("name") for tr in self.data):
            ax.legend(fontsize=7)
        fig.savefig(path, dpi=120)
        plt.close(fig)


def bar(x, y, name=None, text=None, color=None, orientation=None) -> dict:
    tr = {"type": "bar", "x": list(x), "y": list(y)}
    if name is not None:
        tr["name"] = str(name)
    if text is not None:
        tr["text"] = [str(t) for t in text]
        tr["textposition"] = "auto"
    if color is not None:
        tr["marker"] = {"color": color}
    if orientation:
        tr["orientation"] = orientation
    return tr


def scatter3d(x, y, z, labels, colors=None) -> dict:
    return {
        "type": "scatter3d",
        "mode": "markers",
        "x": list(x),
        "y": list(y),
        "z": list(z),
        "text": [str(l) for l in labels],
        "marker": {"size": 5, "color": colors or _COLORWAY[: len(list(x))]},
    }


def scatter2d(x, y, labels, colors=None, mode="markers") -> dict:
    return {
        "type": "scatter",
        "mode": mode,
        "x": list(x),
        "y": list(y),
        "text": [str(l) for l in labels],
        "marker": {"size": 9, "color": colors or _COLORWAY[: len(list(x))]},
    }


def table(columns: list[list]) -> PlotlyFigure:
    return PlotlyFigure(
        [{"type": "table", "cells": {"values": [[str(v) for v in col] for col in columns]}}],
        {"height": 100, "margin": {"l": 0, "r": 0, "b": 0, "t": 0}},
    )


def facet_bars(rows: list[tuple[str, list[dict]]], shared_legend=True) -> PlotlyFigure:
    """Vertically stacked subplot rows; ``rows`` is [(row_title, traces)]."""
    n = len(rows)
    data: list[dict] = []
    layout: dict = {"height": max(450, 220 * n), "annotations": []}
    seen_names: set[str] = set()
    for i, (title, traces) in enumerate(rows):
        axis_suffix = "" if i == 0 else str(i + 1)
        frac0 = 1.0 - (i + 1) / n
        frac1 = 1.0 - i / n - (0.06 if n > 1 else 0.0)
        layout[f"xaxis{axis_suffix}"] = {"anchor": f"y{axis_suffix}"}
        layout[f"yaxis{axis_suffix}"] = {"domain": [frac0, max(frac0, frac1)]}
        for tr in traces:
            tr = dict(tr)
            tr["xaxis"] = f"x{axis_suffix}"
            tr["yaxis"] = f"y{axis_suffix}"
            name = tr.get("name")
            if shared_legend and name is not None:
                tr["legendgroup"] = name
                tr["showlegend"] = name not in seen_names
                seen_names.add(name)
            data.append(tr)
        layout["annotations"].append(
            {
                "text": title,
                "showarrow": False,
                "xref": "paper",
                "yref": "paper",
                "x": 1.0,
                "y": (frac0 + frac1) / 2,
                "xanchor": "left",
                "textangle": 90,
            }
        )
    return PlotlyFigure(data, layout)
