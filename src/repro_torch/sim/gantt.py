"""Gantt rendering for :class:`~repro_torch.sim.events.SimTrace`.

Two dependency-free renderers over the trace's per-resource segments:

* :func:`ascii_gantt` — terminal view, one row per resource, one glyph per
  time bucket (the actor's letter, uppercase on even iterations so the
  periodic steady state is visible by eye);
* :func:`svg_gantt` / :func:`save_svg` — a standalone SVG with one lane
  per resource and one rect per segment, colored per actor (CI uploads one
  rendered trace as an artifact).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from .events import Segment, SimTrace

__all__ = ["ascii_gantt", "svg_gantt", "save_svg"]


def _actor_glyphs(actors: Sequence[str]) -> Dict[str, str]:
    glyphs: Dict[str, str] = {}
    used = set()
    for a in sorted(actors):
        ch = next((c for c in a.lower() if c.isalnum() and c not in used), None)
        if ch is None:
            ch = "abcdefghijklmnopqrstuvwxyz0123456789"[len(glyphs) % 36]
        used.add(ch)
        glyphs[a] = ch
    return glyphs


def _window(trace: SimTrace, start: Optional[int], end: Optional[int]):
    segs = trace.segments
    t0 = start if start is not None else min((s.start for s in segs), default=0)
    t1 = end if end is not None else max((s.end for s in segs), default=1)
    return [s for s in segs if s.end > t0 and s.start < t1], t0, max(t1, t0 + 1)


def ascii_gantt(
    trace: SimTrace,
    *,
    width: int = 100,
    start: Optional[int] = None,
    end: Optional[int] = None,
) -> str:
    """Render the trace as fixed-width ASCII rows, one per resource."""
    segs, t0, t1 = _window(trace, start, end)
    if not segs:
        return "(empty trace)"
    glyphs = _actor_glyphs({s.actor for s in segs})
    scale = (t1 - t0) / width
    lines: List[str] = []
    label_w = max(len(r) for r in trace.resources()) + 1
    header = " " * label_w + f"t = [{t0}, {t1})  ·=idle  letter=actor (uppercase: even iteration)"
    lines.append(header)
    for r in trace.resources():
        row = ["·"] * width
        for s in segs:
            if s.resource != r:
                continue
            b = int((s.start - t0) / scale)
            e = max(b + 1, int((s.end - t0) / scale + 0.999))
            g = glyphs[s.actor]
            if s.iteration % 2 == 0:
                g = g.upper()
            for i in range(max(0, b), min(width, e)):
                row[i] = g
        lines.append(f"{r:<{label_w}}" + "".join(row))
    legend = "  ".join(f"{g}={a}" for a, g in sorted(glyphs.items(), key=lambda kv: kv[1]))
    period = trace.period
    tail = f"period={period}" if period is not None else "period=?"
    lines.append(" " * label_w + f"{tail}  {legend}")
    return "\n".join(lines)


_PALETTE = (
    "#4269d0", "#efb118", "#ff725c", "#6cc5b0", "#3ca951",
    "#ff8ab7", "#a463f2", "#97bbf5", "#9c6b4e", "#9498a0",
)


def svg_gantt(
    trace: SimTrace,
    *,
    px_per_unit: Optional[float] = None,
    row_h: int = 22,
    start: Optional[int] = None,
    end: Optional[int] = None,
) -> str:
    """Render the trace as a standalone SVG document (string)."""
    segs, t0, t1 = _window(trace, start, end)
    resources = trace.resources()
    actors = sorted({s.actor for s in segs})
    color = {a: _PALETTE[i % len(_PALETTE)] for i, a in enumerate(actors)}
    label_w = 120
    width_px = 960
    ppu = px_per_unit if px_per_unit is not None else (width_px - label_w) / (t1 - t0)
    h = row_h * (len(resources) + 2)
    w = label_w + int((t1 - t0) * ppu) + 10
    out: List[str] = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
        f'font-family="monospace" font-size="11">',
        f'<text x="4" y="14">{trace.app} on {trace.arch} — '
        f'period {trace.period}, horizon {trace.horizon}</text>',
    ]
    for ri, r in enumerate(resources):
        y = row_h * (ri + 1)
        out.append(
            f'<text x="4" y="{y + row_h - 8}" fill="#333">{r}</text>'
        )
        out.append(
            f'<line x1="{label_w}" y1="{y + row_h - 2}" x2="{w - 4}" '
            f'y2="{y + row_h - 2}" stroke="#ddd"/>'
        )
        for s in segs:
            if s.resource != r:
                continue
            x = label_w + (s.start - t0) * ppu
            sw = max(1.0, (s.end - s.start) * ppu - 0.5)
            out.append(
                f'<rect x="{x:.1f}" y="{y + 3}" width="{sw:.1f}" '
                f'height="{row_h - 8}" fill="{color[s.actor]}" '
                f'fill-opacity="{0.95 if s.iteration % 2 == 0 else 0.55}">'
                f"<title>{s.actor} {s.task} it={s.iteration} "
                f"[{s.start},{s.end})</title></rect>"
            )
    y = row_h * (len(resources) + 1)
    x = 4.0
    for a in actors:
        out.append(f'<rect x="{x:.0f}" y="{y + 6}" width="10" height="10" fill="{color[a]}"/>')
        out.append(f'<text x="{x + 14:.0f}" y="{y + 15}">{a}</text>')
        x += 14 + 7 * len(a) + 16
    out.append("</svg>")
    return "\n".join(out)


def save_svg(trace: SimTrace, path: str, **kw) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(svg_gantt(trace, **kw))
    return path
