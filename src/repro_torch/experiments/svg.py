"""Dependency-free SVG chart primitives for the results gallery.

The container has no matplotlib (and the repo adds no dependencies), so
the gallery renders charts as hand-built SVG: a light surface, recessive
grid, thin 2px series lines, rounded-top bars anchored to the baseline,
and a legend row whose text stays in ink (color only on the swatch).
Categorical colors are assigned per policy *entity* by the caller
(`figures.POLICY_COLORS`), never by series rank, following the validated
8-slot palette ordering documented there.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Sequence

__all__ = ["Series", "line_chart", "bar_chart"]

SURFACE = "#fcfcfb"
INK = "#0b0b0b"
INK_2 = "#52514e"
GRID = "#e9e8e4"
AXIS = "#c9c8c2"
FONT = "system-ui, -apple-system, 'Segoe UI', Helvetica, Arial, sans-serif"


@dataclasses.dataclass(frozen=True)
class Series:
    """One named polyline: x/y samples plus its entity color."""

    name: str
    x: Sequence[float]
    y: Sequence[float]
    color: str
    step: bool = False     # render as a post-step line (CDFs)


def _nice_ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    """~n ticks at 1/2/2.5/5 x 10^k steps covering [lo, hi]."""
    if not math.isfinite(lo) or not math.isfinite(hi):
        return [0.0, 1.0]
    if hi <= lo:
        hi = lo + (abs(lo) or 1.0)
    raw = (hi - lo) / max(n, 1)
    mag = 10 ** math.floor(math.log10(raw))
    step = next(s * mag for s in (1, 2, 2.5, 5, 10) if s * mag >= raw)
    t0 = math.ceil(lo / step) * step
    ticks, t = [], t0
    while t <= hi + 1e-12 * step:
        ticks.append(round(t, 10))
        t += step
    return ticks or [lo, hi]


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000 or abs(v) < 0.01:
        return f"{v:.1e}"
    return f"{v:g}" if abs(v) >= 1 else f"{v:.3g}"


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;"))


class _Doc:
    def __init__(self, w: int, h: int, title: str):
        self.w, self.h = w, h
        self.parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}"'
            f' viewBox="0 0 {w} {h}" role="img" aria-label="{_esc(title)}">',
            f'<rect width="{w}" height="{h}" fill="{SURFACE}"/>',
        ]

    def text(self, x, y, s, *, size=11, color=INK_2, anchor="start",
             weight="normal"):
        self.parts.append(
            f'<text x="{x:.1f}" y="{y:.1f}" font-family="{FONT}" '
            f'font-size="{size}" font-weight="{weight}" fill="{color}" '
            f'text-anchor="{anchor}">{_esc(s)}</text>')

    def line(self, x1, y1, x2, y2, color, width=1.0):
        self.parts.append(
            f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" '
            f'stroke="{color}" stroke-width="{width}"/>')

    def poly(self, pts, color, width=2.0, title=None):
        d = " ".join(f"{x:.1f},{y:.1f}" for x, y in pts)
        t = f"<title>{_esc(title)}</title>" if title else ""
        self.parts.append(
            f'<polyline points="{d}" fill="none" stroke="{color}" '
            f'stroke-width="{width}" stroke-linejoin="round" '
            f'stroke-linecap="round">{t}</polyline>')

    def raw(self, s: str):
        self.parts.append(s)

    def write(self, path: str | Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self.parts.append("</svg>")
        path.write_text("\n".join(self.parts) + "\n")
        return path


def _frame(doc: _Doc, box, xticks, yticks, xlim, ylim, xlabel, ylabel):
    """Grid, axes, and tick labels for a plot box (x0, y0, x1, y1)."""
    x0, y0, x1, y1 = box

    def sx(v):
        return x0 + (v - xlim[0]) / (xlim[1] - xlim[0]) * (x1 - x0)

    def sy(v):
        return y1 - (v - ylim[0]) / (ylim[1] - ylim[0]) * (y1 - y0)

    for t in yticks:
        doc.line(x0, sy(t), x1, sy(t), GRID, 1)
        doc.text(x0 - 8, sy(t) + 3.5, _fmt(t), anchor="end")
    for t in xticks:
        doc.line(sx(t), y1, sx(t), y1 + 4, AXIS, 1)
        doc.text(sx(t), y1 + 16, _fmt(t), anchor="middle")
    doc.line(x0, y1, x1, y1, AXIS, 1)          # baseline
    doc.text((x0 + x1) / 2, doc.h - 8, xlabel, size=12, anchor="middle")
    doc.raw(f'<text x="14" y="{(y0 + y1) / 2:.1f}" font-family="{FONT}" '
            f'font-size="12" fill="{INK_2}" text-anchor="middle" '
            f'transform="rotate(-90 14 {(y0 + y1) / 2:.1f})">'
            f'{_esc(ylabel)}</text>')
    return sx, sy


def _legend(doc: _Doc, x0: float, y: float, entries) -> None:
    x = x0
    for name, color in entries:
        doc.raw(f'<rect x="{x:.1f}" y="{y - 9:.1f}" width="12" height="12" '
                f'rx="3" fill="{color}"/>')
        doc.text(x + 17, y + 1, name, color=INK)
        x += 17 + 7 * len(name) + 26


def line_chart(series: Sequence[Series], path: str | Path, *, title: str,
               xlabel: str, ylabel: str, w: int = 720, h: int = 430,
               ylim: tuple[float, float] | None = None) -> Path:
    """Multi-series line (or step) chart with legend; writes `path`."""
    xs = [v for s in series for v in s.x]
    ys = [v for s in series for v in s.y]
    xlim = (min(xs), max(xs) if max(xs) > min(xs) else min(xs) + 1)
    if ylim is None:
        pad = (max(ys) - min(ys)) * 0.06 or abs(max(ys)) * 0.06 or 1.0
        ylim = (min(ys) - pad, max(ys) + pad)
    doc = _Doc(w, h, title)
    doc.text(16, 26, title, size=14, color=INK, weight="600")
    _legend(doc, 16, 48, [(s.name, s.color) for s in series])
    box = (64, 64, w - 20, h - 46)
    sx, sy = _frame(doc, box, _nice_ticks(*xlim, 6), _nice_ticks(*ylim, 5),
                    xlim, ylim, xlabel, ylabel)
    for s in series:
        pts = []
        prev = None
        for x, y in zip(s.x, s.y):
            if s.step and prev is not None:
                pts.append((sx(x), prev))
            pts.append((sx(x), sy(y)))
            prev = sy(y)
        doc.poly(pts, s.color, 2.0, title=s.name)
    return doc.write(path)


def bar_chart(labels: Sequence[str], values: Sequence[float],
              colors: Sequence[str], path: str | Path, *, title: str,
              ylabel: str, w: int = 720, h: int = 430,
              value_fmt=lambda v: _fmt(v)) -> Path:
    """Rounded-top bars anchored at the baseline, direct value labels."""
    doc = _Doc(w, h, title)
    doc.text(16, 26, title, size=14, color=INK, weight="600")
    vmax = max(max(values), 0) or 1.0
    ylim = (0.0, vmax * 1.12)
    box = (64, 52, w - 20, h - 46)
    x0, y0, x1, y1 = box
    sx_w = (x1 - x0) / len(values)
    _, sy = _frame(doc, box, [], _nice_ticks(*ylim, 5), (0, 1), ylim,
                   "", ylabel)
    bar_w = min(72.0, sx_w * 0.6)
    r = 4.0
    for i, (lab, v, color) in enumerate(zip(labels, values, colors)):
        cx = x0 + (i + 0.5) * sx_w
        top, base = sy(v), y1
        bx = cx - bar_w / 2
        height = max(base - top, 0.0)
        rr = min(r, height)
        doc.raw(
            f'<path d="M {bx:.1f} {base:.1f} V {top + rr:.1f} '
            f'Q {bx:.1f} {top:.1f} {bx + rr:.1f} {top:.1f} '
            f'H {bx + bar_w - rr:.1f} '
            f'Q {bx + bar_w:.1f} {top:.1f} {bx + bar_w:.1f} {top + rr:.1f} '
            f'V {base:.1f} Z" fill="{color}">'
            f'<title>{_esc(f"{lab}: {value_fmt(v)}")}</title></path>')
        doc.text(cx, top - 6, value_fmt(v), anchor="middle", color=INK)
        doc.text(cx, y1 + 16, lab, anchor="middle")
    return doc.write(path)
