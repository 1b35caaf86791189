"""Prometheus text-format exposition (version 0.0.4) for a
:class:`~.registry.MetricsRegistry` (port of
``observability/exposition.py``: byte-for-byte the same text for the
same registry state).

Deterministic output: metric families sort by name, children by label
values, histogram buckets ascend, and the ``le`` label renders last —
so two renders of the same registry state are byte-identical (scrape
diffing and golden tests rely on this).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from .registry import MetricsRegistry

__all__ = ["render_text", "escape_label_value", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def escape_label_value(value: str) -> str:
    """Escape per the exposition spec: backslash, double-quote, newline."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    """Sample-value formatting: integral floats render as integers
    (Prometheus parses either; the short form keeps counters readable)."""
    if value != value:
        return "NaN"
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _labels_str(labels: Dict[str, str], le: Optional[str] = None) -> str:
    parts = [f'{k}="{escape_label_value(str(v))}"'
             for k, v in sorted(labels.items())]
    if le is not None:
        parts.append(f'le="{le}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def render_text(registry: MetricsRegistry) -> str:
    """Render every family in the registry as Prometheus exposition text."""
    lines = []
    for m in registry.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for values, child in m.samples():
            labels = dict(zip(m.labelnames, values))
            if m.kind == "histogram":
                for bound, count in child.cumulative_buckets():
                    le = "+Inf" if bound == math.inf else _fmt(bound)
                    lines.append(f"{m.name}_bucket"
                                 f"{_labels_str(labels, le=le)} {count}")
                lines.append(f"{m.name}_sum{_labels_str(labels)} "
                             f"{_fmt(child.sum)}")
                lines.append(f"{m.name}_count{_labels_str(labels)} "
                             f"{child.count}")
            else:
                lines.append(f"{m.name}{_labels_str(labels)} "
                             f"{_fmt(child.value)}")
    return "\n".join(lines) + ("\n" if lines else "")
