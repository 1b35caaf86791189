"""Standalone chart/table/decorator component DSL rendering to HTML+SVG
(port of ``ui/components.py``, host code: the same HTML and the same
``@class``-tagged JSON as the JAX package's, through the port's
``utils/serde``).

Reference ``deeplearning4j-ui-components`` (the chart/table/decorator
object model under ``org/deeplearning4j/ui/components/`` with its Style
classes, JSON serialization — ``TestComponentSerialization.java`` — and
standalone static-page rendering, ``standalone/StaticPageUtil.java``).

TPU-era redesign of the same capability: components are plain dataclasses
that (a) render self-contained HTML snippets with inline SVG — no external
JS deps, usable anywhere (reports, emails, the training server's pages) —
and (b) round-trip through the framework's tagged-JSON serde, so a
component built on a training host can be shipped to and rendered by a
dashboard elsewhere, the role the reference's component JSON plays between
its Java builders and its JS renderer.

Component tree:
  ComponentText / ComponentTable / ComponentDiv / DecoratorAccordion
  ChartLine / ChartScatter / ChartHistogram / ChartStackedArea /
  ChartTimeline / ChartHorizontalBar
Styles: StyleText / StyleTable / StyleDiv / StyleAccordion / StyleChart.
``render_page`` composes components into one standalone HTML page;
``component_to_json`` / ``component_from_json`` are the wire format.
"""
from __future__ import annotations

import html
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..utils.serde import from_jsonable, register_serde, to_jsonable

__all__ = ["ChartLine", "ChartScatter", "ChartHistogram", "ChartStackedArea",
           "ChartTimeline", "ChartHorizontalBar", "ComponentTable",
           "ComponentText", "ComponentDiv", "DecoratorAccordion",
           "StyleChart", "StyleTable", "StyleText", "StyleDiv",
           "StyleAccordion", "render_page", "component_to_json",
           "component_from_json"]


# ------------------------------------------------------------------- styles
@register_serde
@dataclass
class StyleText:
    """Reference ``style/StyleText.java``: font styling for text blocks."""
    font_size: int = 14
    bold: bool = False
    color: str = "#000000"
    font: str = "sans-serif"


@register_serde
@dataclass
class StyleTable:
    """Reference ``table/style/StyleTable.java``."""
    border_width: int = 1
    header_color: str = "#eeeeee"
    background_color: str = "#ffffff"
    column_widths: Optional[List[int]] = None    # px per column


@register_serde
@dataclass
class StyleDiv:
    """Reference ``component/style/StyleDiv.java``: container layout."""
    width: Optional[int] = None                  # px
    height: Optional[int] = None
    float_value: str = ""                        # "left" | "right" | ""
    margin_px: int = 0


@register_serde
@dataclass
class StyleAccordion:
    """Reference ``decorator/style/StyleAccordion.java``."""
    title_color: str = "#000000"
    background_color: str = "#f5f5f5"


@register_serde
@dataclass
class StyleChart:
    """Reference ``chart/style/StyleChart.java``: chart geometry + marks."""
    width: int = 540
    height: int = 300
    pad: int = 40
    stroke_width: float = 1.5
    point_size: float = 2.5
    series_colors: Optional[List[str]] = None
    axis_stroke: str = "#000000"
    title_size: int = 13


_COLORS = ("#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e")


def _esc(v) -> str:
    """Attribute-escape a style-sourced string.  Components travel over the
    ``component_from_json`` wire between hosts, so style fields (colors,
    fonts) are untrusted input — unescaped they are an injection vector
    into the rendered page's attributes."""
    return html.escape(str(v), quote=True)


# --------------------------------------------------------------- base class
class _Component:
    def render(self) -> str:
        raise NotImplementedError


def component_to_json(component: _Component) -> str:
    """Tagged-JSON wire format (the reference serializes every component
    via Jackson for its JS renderer — ``TestComponentSerialization.java``)."""
    return json.dumps(to_jsonable(component))


def component_from_json(s: str) -> _Component:
    """Inverse of :func:`component_to_json` (unknown fields tolerated)."""
    return from_jsonable(json.loads(s))


# --------------------------------------------------------------- components
@register_serde
@dataclass
class ComponentText(_Component):
    """Styled text block (reference ``ComponentText``)."""
    text: str = ""
    size: int = 14
    bold: bool = False
    style: Optional[StyleText] = None

    def render(self) -> str:
        st = self.style or StyleText(font_size=self.size, bold=self.bold)
        weight = "bold" if st.bold else "normal"
        return (f'<div style="font-size:{_esc(st.font_size)}px;'
                f"font-weight:{weight};color:{_esc(st.color)};"
                f'font-family:{_esc(st.font)};margin:4px 0">'
                f"{html.escape(self.text)}</div>")


@register_serde
@dataclass
class ComponentTable(_Component):
    """Header + rows table (reference ``ComponentTable``)."""
    header: List = field(default_factory=list)
    rows: List = field(default_factory=list)
    title: str = ""
    style: Optional[StyleTable] = None

    def __post_init__(self):
        self.header = list(self.header)
        self.rows = [list(r) for r in self.rows]

    def render(self) -> str:
        st = self.style or StyleTable()
        widths = st.column_widths or []
        h = "".join(
            f'<th style="background:{_esc(st.header_color)}"'
            + (f' width="{_esc(widths[i])}"' if i < len(widths) else "")
            + f">{html.escape(str(c))}</th>"
            for i, c in enumerate(self.header))
        body = "".join(
            "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in r)
            + "</tr>" for r in self.rows)
        cap = (f"<caption>{html.escape(self.title)}</caption>"
               if self.title else "")
        return (f'<table border="{_esc(st.border_width)}" cellpadding="4" '
                f'style="border-collapse:collapse;margin:8px 0;'
                f'background:{_esc(st.background_color)}">{cap}'
                f"<tr>{h}</tr>{body}</table>")


@register_serde
@dataclass
class ComponentDiv(_Component):
    """Container with layout style (reference ``ComponentDiv``): groups
    child components; the composition primitive for dashboards."""
    children: List = field(default_factory=list)
    style: Optional[StyleDiv] = None

    def add(self, *components: _Component) -> "ComponentDiv":
        self.children.extend(components)
        return self

    def render(self) -> str:
        st = self.style or StyleDiv()
        # _esc on every wire-sourced field, including declared-numeric
        # ones: from_jsonable does not type-check, so a string can ride
        # in where an int is expected
        css = [f"margin:{_esc(st.margin_px)}px"]
        if st.width is not None:
            css.append(f"width:{_esc(st.width)}px")
        if st.height is not None:
            css.append(f"height:{_esc(st.height)}px")
        if st.float_value:
            css.append(f"float:{_esc(st.float_value)}")
        inner = "".join(c.render() for c in self.children)
        return f'<div style="{";".join(css)}">{inner}</div>'


@register_serde
@dataclass
class DecoratorAccordion(_Component):
    """Collapsible section (reference ``DecoratorAccordion``).  Rendered
    as ``<details>/<summary>`` — the no-JS HTML disclosure widget, keeping
    standalone output dependency-free where the reference emits jQuery UI."""
    title: str = ""
    children: List = field(default_factory=list)
    default_collapsed: bool = False
    style: Optional[StyleAccordion] = None

    def add(self, *components: _Component) -> "DecoratorAccordion":
        self.children.extend(components)
        return self

    def render(self) -> str:
        st = self.style or StyleAccordion()
        inner = "".join(c.render() for c in self.children)
        open_attr = "" if self.default_collapsed else " open"
        return (f"<details{open_attr} style='background:"
                f"{_esc(st.background_color)};margin:6px 0;padding:4px'>"
                f"<summary style='color:{_esc(st.title_color)};cursor:pointer'>"
                f"{html.escape(self.title)}</summary>{inner}</details>")


# ------------------------------------------------------------------- charts
class _Chart(_Component):
    """Shared SVG frame: axes, corner extents, title, axis labels."""

    def _dims(self):
        st = getattr(self, "style", None) or StyleChart()
        return st.width, st.height, st.pad, st

    def _frame(self, inner: str, x_min, x_max, y_min, y_max) -> str:
        w, h, p, st = self._dims()
        axes = (f'<line x1="{p}" y1="{h-p}" x2="{w-p}" y2="{h-p}" '
                f'stroke="{_esc(st.axis_stroke)}"/>'
                f'<line x1="{p}" y1="{p}" x2="{p}" y2="{h-p}" '
                f'stroke="{_esc(st.axis_stroke)}"/>'
                f'<text x="{p}" y="{h-p+16}" font-size="10">'
                f"{x_min:.3g}</text>"
                f'<text x="{w-p-30}" y="{h-p+16}" font-size="10">'
                f"{x_max:.3g}</text>"
                f'<text x="2" y="{h-p}" font-size="10">{y_min:.3g}</text>'
                f'<text x="2" y="{p+8}" font-size="10">{y_max:.3g}</text>')
        t = (f'<text x="{w//2}" y="16" text-anchor="middle" '
             f'font-size="{_esc(st.title_size)}">{html.escape(self.title)}'
             "</text>"
             if self.title else "")
        xl = (f'<text x="{w//2}" y="{h-4}" text-anchor="middle" '
              f'font-size="11">{html.escape(self.x_label)}</text>'
              if getattr(self, "x_label", "") else "")
        yl = (f'<text x="10" y="{h//2}" text-anchor="middle" '
              f'font-size="11" transform="rotate(-90 10 {h//2})">'
              f"{html.escape(self.y_label)}</text>"
              if getattr(self, "y_label", "") else "")
        return (f'<svg width="{w}" height="{h}" '
                'xmlns="http://www.w3.org/2000/svg" '
                'style="background:#fff;margin:8px 0">'
                f"{t}{xl}{yl}{axes}{inner}</svg>")

    def _scale(self, xs, ys, x_min, x_max, y_min, y_max):
        w, h, p, _ = self._dims()
        sx = lambda v: p + (v - x_min) / max(x_max - x_min, 1e-12) * (w - 2 * p)
        sy = lambda v: h - p - (v - y_min) / max(y_max - y_min, 1e-12) * (h - 2 * p)
        return [sx(v) for v in xs], [sy(v) for v in ys]

    def _color(self, i: int) -> str:
        st = getattr(self, "style", None) or StyleChart()
        colors = st.series_colors or _COLORS
        return _esc(colors[i % len(colors)])


@register_serde
@dataclass
class ChartLine(_Chart):
    """Multi-series line chart (reference ``ChartLine``)."""
    title: str = ""
    x_label: str = ""
    y_label: str = ""
    style: Optional[StyleChart] = None
    series: List = field(default_factory=list)   # [name, [x...], [y...]]

    def add_series(self, name: str, x, y) -> "ChartLine":
        self.series.append([name, np.asarray(x, float).tolist(),
                            np.asarray(y, float).tolist()])
        return self

    def _marks(self, px, py, color) -> str:
        _, _, _, st = self._dims()
        pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px, py))
        return (f'<polyline points="{pts}" fill="none" '
                f'stroke="{color}" stroke-width="{_esc(st.stroke_width)}"/>')

    def render(self) -> str:
        if not self.series:
            return self._frame("", 0, 1, 0, 1)
        w, h, p, _ = self._dims()
        arrs = [(n, np.asarray(xs, float), np.asarray(ys, float))
                for n, xs, ys in self.series]
        x_min = min(s[1].min() for s in arrs)
        x_max = max(s[1].max() for s in arrs)
        y_min = min(s[2].min() for s in arrs)
        y_max = max(s[2].max() for s in arrs)
        inner = []
        for i, (name, xs, ys) in enumerate(arrs):
            px, py = self._scale(xs, ys, x_min, x_max, y_min, y_max)
            color = self._color(i)
            inner.append(self._marks(px, py, color))
            inner.append(f'<text x="{w-p+2}" '
                         f'y="{p + 14 * i}" font-size="10" '
                         f'fill="{color}">{html.escape(name)}</text>')
        return self._frame("".join(inner), x_min, x_max, y_min, y_max)


@register_serde
@dataclass
class ChartScatter(ChartLine):
    """Scatter chart (reference ``ChartScatter``): point marks, shared
    frame/legend from ChartLine."""

    def _marks(self, px, py, color) -> str:
        _, _, _, st = self._dims()
        return "".join(f'<circle cx="{a:.1f}" cy="{b:.1f}" '
                       f'r="{_esc(st.point_size)}" fill="{color}"/>'
                       for a, b in zip(px, py))


@register_serde
@dataclass
class ChartHistogram(_Chart):
    """Binned histogram (reference ``ChartHistogram``)."""
    title: str = ""
    x_label: str = ""
    y_label: str = ""
    style: Optional[StyleChart] = None
    bins: List = field(default_factory=list)     # [lo, hi, count]

    def add_bin(self, lo: float, hi: float, count: float) -> "ChartHistogram":
        self.bins.append([float(lo), float(hi), float(count)])
        return self

    @staticmethod
    def of(values, n_bins: int = 20, title: str = "") -> "ChartHistogram":
        counts, edges = np.histogram(np.asarray(values, float), bins=n_bins)
        ch = ChartHistogram(title=title)
        for i, c in enumerate(counts):
            ch.add_bin(edges[i], edges[i + 1], float(c))
        return ch

    def render(self) -> str:
        if not self.bins:
            return self._frame("", 0, 1, 0, 1)
        x_min = min(b[0] for b in self.bins)
        x_max = max(b[1] for b in self.bins)
        y_max = max(b[2] for b in self.bins) or 1.0
        w, h, p, _ = self._dims()
        sx = lambda v: p + (v - x_min) / max(x_max - x_min, 1e-12) * (w - 2 * p)
        inner = []
        for lo, hi, c in self.bins:
            bh = c / y_max * (h - 2 * p)
            inner.append(
                f'<rect x="{sx(lo):.1f}" y="{h - p - bh:.1f}" '
                f'width="{max(sx(hi) - sx(lo) - 1, 1):.1f}" '
                f'height="{bh:.1f}" fill="{self._color(0)}"/>')
        return self._frame("".join(inner), x_min, x_max, 0, y_max)


@register_serde
@dataclass
class ChartStackedArea(_Chart):
    """Stacked area chart (reference ``ChartStackedArea``): series share an
    x axis and stack cumulatively — layer composition over time."""
    title: str = ""
    x_label: str = ""
    y_label: str = ""
    style: Optional[StyleChart] = None
    x: List = field(default_factory=list)
    series: List = field(default_factory=list)   # [name, [y...]]

    def set_x(self, x) -> "ChartStackedArea":
        self.x = np.asarray(x, float).tolist()
        return self

    def add_series(self, name: str, y) -> "ChartStackedArea":
        y = np.asarray(y, float).tolist()
        if len(y) != len(self.x):
            raise ValueError(f"series {name!r} has {len(y)} points; "
                             f"x has {len(self.x)} — call set_x first")
        self.series.append([name, y])
        return self

    def render(self) -> str:
        if not self.series or not self.x:
            return self._frame("", 0, 1, 0, 1)
        xs = np.asarray(self.x, float)
        ys = np.asarray([s[1] for s in self.series], float)  # (S, N)
        if (ys < 0).any():
            raise ValueError("stacked areas require non-negative series")
        cum = np.cumsum(ys, axis=0)
        x_min, x_max = float(xs.min()), float(xs.max())
        y_max = float(cum[-1].max()) or 1.0
        w, h, p, _ = self._dims()
        inner = []
        lower = np.zeros_like(xs)
        for i, (name, _) in enumerate(self.series):
            upper = cum[i]
            px_u, py_u = self._scale(xs, upper, x_min, x_max, 0, y_max)
            px_l, py_l = self._scale(xs[::-1], lower[::-1],
                                     x_min, x_max, 0, y_max)
            pts = " ".join(f"{a:.1f},{b:.1f}"
                           for a, b in list(zip(px_u, py_u))
                           + list(zip(px_l, py_l)))
            color = self._color(i)
            inner.append(f'<polygon points="{pts}" fill="{color}" '
                         'fill-opacity="0.7"/>')
            inner.append(f'<text x="{w-p+2}" y="{p + 14 * i}" '
                         f'font-size="10" fill="{color}">'
                         f"{html.escape(name)}</text>")
            lower = upper
        return self._frame("".join(inner), x_min, x_max, 0, y_max)


@register_serde
@dataclass
class ChartTimeline(_Chart):
    """Swimlane timeline (reference ``ChartTimeline``): per-lane [start,
    end, label] entries — ETL/train/eval phase visualization."""
    title: str = ""
    x_label: str = ""
    style: Optional[StyleChart] = None
    lanes: List = field(default_factory=list)    # [name, [[t0, t1, label]]]

    def add_lane(self, name: str, entries) -> "ChartTimeline":
        self.lanes.append(
            [name, [[float(a), float(b), str(lbl)] for a, b, lbl in entries]])
        return self

    def render(self) -> str:
        if not self.lanes or not any(es for _, es in self.lanes):
            return self._frame("", 0, 1, 0, 1)
        t_min = min(e[0] for _, es in self.lanes for e in es)
        t_max = max(e[1] for _, es in self.lanes for e in es)
        w, h, p, _ = self._dims()
        lane_h = (h - 2 * p) / len(self.lanes)
        sx = lambda v: p + (v - t_min) / max(t_max - t_min, 1e-12) * (w - 2 * p)
        inner = []
        for i, (name, entries) in enumerate(self.lanes):
            y0 = p + i * lane_h
            inner.append(f'<text x="{p-4}" y="{y0 + lane_h/2:.1f}" '
                         'font-size="10" text-anchor="end">'
                         f"{html.escape(name)}</text>")
            for j, (a, b, lbl) in enumerate(entries):
                color = self._color(i + j)
                inner.append(
                    f'<rect x="{sx(a):.1f}" y="{y0 + 2:.1f}" '
                    f'width="{max(sx(b) - sx(a), 1):.1f}" '
                    f'height="{lane_h - 4:.1f}" fill="{color}" '
                    'fill-opacity="0.8"/>')
                if lbl:
                    inner.append(
                        f'<text x="{sx(a) + 2:.1f}" '
                        f'y="{y0 + lane_h/2 + 3:.1f}" font-size="9" '
                        f'fill="#fff">{html.escape(lbl)}</text>')
        return self._frame("".join(inner), t_min, t_max, 0, len(self.lanes))


@register_serde
@dataclass
class ChartHorizontalBar(_Chart):
    """Horizontal bar chart (reference ``ChartHorizontalBar``): named
    categories with values — per-class metrics, feature importances."""
    title: str = ""
    x_label: str = ""
    style: Optional[StyleChart] = None
    categories: List = field(default_factory=list)   # [name, value]

    def add_bar(self, name: str, value: float) -> "ChartHorizontalBar":
        self.categories.append([str(name), float(value)])
        return self

    def render(self) -> str:
        if not self.categories:
            return self._frame("", 0, 1, 0, 1)
        # both extremes clamp to the zero baseline so all-negative (and
        # all-positive) inputs keep the baseline and labels inside the
        # frame; the `or` guard covers the all-zero degenerate span
        v_min = min(0.0, min(v for _, v in self.categories))
        v_max = max(0.0, max(v for _, v in self.categories))
        span = (v_max - v_min) or 1.0
        w, h, p, _ = self._dims()
        bar_h = (h - 2 * p) / len(self.categories)
        sx = lambda v: p + (v - v_min) / span * (w - 2 * p)
        inner = []
        for i, (name, v) in enumerate(self.categories):
            y0 = p + i * bar_h
            x0, x1 = sorted((sx(0.0), sx(v)))
            inner.append(
                f'<rect x="{x0:.1f}" y="{y0 + 2:.1f}" '
                f'width="{max(x1 - x0, 1):.1f}" '
                f'height="{bar_h - 4:.1f}" fill="{self._color(i)}"/>')
            inner.append(f'<text x="{p-4}" y="{y0 + bar_h/2 + 3:.1f}" '
                         'font-size="10" text-anchor="end">'
                         f"{html.escape(name)}</text>")
            inner.append(f'<text x="{x1 + 3:.1f}" '
                         f'y="{y0 + bar_h/2 + 3:.1f}" font-size="9">'
                         f"{v:.4g}</text>")
        return self._frame("".join(inner), v_min, v_max, 0,
                           len(self.categories))


def render_page(components: Sequence[_Component], title: str = "Report"
                ) -> str:
    """Compose components into one standalone HTML page (the reference's
    ``StaticPageUtil.renderHTML`` role)."""
    body = "\n".join(c.render() for c in components)
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{html.escape(title)}</title></head>"
            f"<body style='font-family:sans-serif'>{body}</body></html>")


def activation_grid_svg(activations, max_maps: int = 16,
                        cell: int = 56) -> str:
    """[h, w, c] (or [b, h, w, c] — first example) activation maps as an
    SVG grid of grayscale cells (reference
    ``ConvolutionalIterationListener`` rendering)."""
    a = np.asarray(activations, np.float32)
    if a.ndim == 4:
        a = a[0]
    if a.ndim != 3:
        raise ValueError(f"expected [h,w,c] activations, got {a.shape}")
    c = min(a.shape[-1], max_maps)
    cols = int(np.ceil(np.sqrt(c)))
    rows = int(np.ceil(c / cols))
    h, w = a.shape[:2]
    parts = []
    for m in range(c):
        fmap = a[:, :, m]
        lo, hi = float(fmap.min()), float(fmap.max())
        norm = (fmap - lo) / max(hi - lo, 1e-9)
        ox = (m % cols) * (cell + 4)
        oy = (m // cols) * (cell + 4)
        px = cell / max(h, w)
        for r in range(h):
            for cc_ in range(w):
                g = int(norm[r, cc_] * 255)
                parts.append(
                    f'<rect x="{ox + cc_ * px:.1f}" y="{oy + r * px:.1f}" '
                    f'width="{px:.2f}" height="{px:.2f}" '
                    f'fill="rgb({g},{g},{g})"/>')
    width = cols * (cell + 4)
    height = rows * (cell + 4)
    return (f'<svg width="{width}" height="{height}" '
            f'xmlns="http://www.w3.org/2000/svg">{"".join(parts)}</svg>')
