"""Server-agnostic UI component DSL rendered to standalone HTML/JS.

Counterpart of ``deeplearning4j_tpu/ui/components.py``, standard library
only and copied as it is. Its reference is deeplearning4j-ui-components
(ui/components/{chart,component,decorator,table,text} + api/Component,
api/Style, standalone/StaticPageUtil): declarative chart/table/text
components that serialize to JSON and render to a self-contained HTML page
— no server required, no external assets (zero-egress friendly; the
reference renders through its bundled dl4j-ui.js, here a small inline
canvas renderer fills that role).

Components: ChartLine, ChartScatter, ChartHistogram, ChartHorizontalBar,
ChartStackedArea, ChartTimeline, ComponentTable, ComponentText,
ComponentDiv, DecoratorAccordion. Each takes an optional Style.
`render_page(components)` is StaticPageUtil.renderHTML's role;
EvaluationTools and the training-stats HTML exports build on it.
"""

from __future__ import annotations

import html as _html
import json
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

__all__ = [
    "Style", "Component", "ChartLine", "ChartScatter", "ChartHistogram",
    "ChartHorizontalBar", "ChartStackedArea", "ChartTimeline",
    "ComponentTable", "ComponentText", "ComponentDiv",
    "DecoratorAccordion", "render_page",
]


@dataclass
class Style:
    """Visual style (ref: api/Style.java + chart/style/StyleChart.java —
    width/height in px, margins, colors, stroke width)."""

    width: int = 700
    height: int = 300
    margin_top: int = 24
    margin_bottom: int = 32
    margin_left: int = 48
    margin_right: int = 16
    series_colors: Sequence[str] = ("#1976d2", "#e53935", "#43a047",
                                    "#fb8c00", "#8e24aa", "#00897b")
    stroke_width: float = 1.5
    background: str = "#ffffff"

    def to_dict(self) -> dict:
        return {"width": self.width, "height": self.height,
                "marginTop": self.margin_top,
                "marginBottom": self.margin_bottom,
                "marginLeft": self.margin_left,
                "marginRight": self.margin_right,
                "seriesColors": list(self.series_colors),
                "strokeWidth": self.stroke_width,
                "background": self.background}


class Component:
    """Base component (ref: api/Component.java — type tag + JSON)."""

    type_name = "Component"

    def __init__(self, style: Optional[Style] = None, title: str = ""):
        self.style = style or Style()
        self.title = title

    def to_dict(self) -> dict:
        return {"componentType": self.type_name, "title": self.title,
                "style": self.style.to_dict()}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    # each component renders itself into an HTML fragment
    def render(self, cid: str) -> str:
        raise NotImplementedError

    def _render_canvas(self, cid: str, js_fn: str, payload: dict) -> str:
        st = self.style
        # escape '</' so data-driven strings can't terminate the <script>
        data = json.dumps(payload).replace("</", "<\\/")
        return f"""
<div class="dl4j-component">
  <h3>{_html.escape(self.title)}</h3>
  <canvas id="{cid}" width="{st.width}" height="{st.height}"
          style="background:{st.background};border:1px solid #ccc"></canvas>
  <script>{js_fn}(document.getElementById("{cid}"), {data});</script>
</div>"""


class _SeriesChart(Component):
    """Common base for x/y-series charts."""

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(style, title)
        self.series: List[Tuple[str, List[float], List[float]]] = []

    def add_series(self, name: str, x: Sequence[float],
                   y: Sequence[float]) -> "_SeriesChart":
        if len(x) != len(y):
            raise ValueError(f"series {name!r}: len(x) {len(x)} != "
                             f"len(y) {len(y)}")
        self.series.append((name, [float(v) for v in x],
                            [float(v) for v in y]))
        return self

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["series"] = [{"name": n, "x": x, "y": y}
                       for n, x, y in self.series]
        return d

    _MODE = "line"

    def render(self, cid: str) -> str:
        return self._render_canvas(cid, "dl4jChart", {
            "series": [{"name": n, "x": x, "y": y}
                       for n, x, y in self.series],
            "mode": self._MODE, "style": self.style.to_dict()})


class ChartLine(_SeriesChart):
    """ref: chart/ChartLine.java."""

    type_name = "ChartLine"
    _MODE = "line"


class ChartScatter(_SeriesChart):
    """ref: chart/ChartScatter.java."""

    type_name = "ChartScatter"
    _MODE = "scatter"


class ChartStackedArea(_SeriesChart):
    """ref: chart/ChartStackedArea.java (rendered as cumulative lines)."""

    type_name = "ChartStackedArea"
    _MODE = "stacked"


class ChartHistogram(Component):
    """ref: chart/ChartHistogram.java — explicit bin edges + counts."""

    type_name = "ChartHistogram"

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(style, title)
        self.bins: List[Tuple[float, float, float]] = []  # (low, high, y)

    def add_bin(self, low: float, high: float, y: float) -> "ChartHistogram":
        self.bins.append((float(low), float(high), float(y)))
        return self

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["bins"] = [{"low": lo, "high": hi, "y": y}
                     for lo, hi, y in self.bins]
        return d

    def render(self, cid: str) -> str:
        return self._render_canvas(cid, "dl4jHistogram",
                                   {"bins": [list(b) for b in self.bins],
                                    "style": self.style.to_dict()})


class ChartHorizontalBar(Component):
    """ref: chart/ChartHorizontalBar.java — named horizontal bars."""

    type_name = "ChartHorizontalBar"

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(style, title)
        self.bars: List[Tuple[str, float]] = []

    def add_bar(self, name: str, value: float) -> "ChartHorizontalBar":
        self.bars.append((name, float(value)))
        return self

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["bars"] = [{"name": n, "value": v} for n, v in self.bars]
        return d

    def render(self, cid: str) -> str:
        return self._render_canvas(cid, "dl4jHBar",
                                   {"bars": [list(b) for b in self.bars],
                                    "style": self.style.to_dict()})


class ChartTimeline(Component):
    """ref: chart/ChartTimeline.java — lanes of [start, end, label] spans
    (used by the Spark training-stats timeline export)."""

    type_name = "ChartTimeline"

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(style, title)
        self.lanes: List[Tuple[str, List[Tuple[float, float, str]]]] = []

    def add_lane(self, name: str,
                 spans: Sequence[Tuple[float, float, str]]) -> "ChartTimeline":
        self.lanes.append((name, [(float(a), float(b), str(lb))
                                  for a, b, lb in spans]))
        return self

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["lanes"] = [{"name": n,
                       "spans": [{"start": a, "end": b, "label": lb}
                                 for a, b, lb in spans]}
                      for n, spans in self.lanes]
        return d

    def render(self, cid: str) -> str:
        return self._render_canvas(
            cid, "dl4jTimeline",
            {"lanes": [[n, [list(s) for s in spans]]
                       for n, spans in self.lanes],
             "style": self.style.to_dict()})


class ComponentTable(Component):
    """ref: table/ComponentTable.java."""

    type_name = "ComponentTable"

    def __init__(self, header: Sequence[str] = (),
                 rows: Sequence[Sequence] = (), title: str = "",
                 style: Optional[Style] = None):
        super().__init__(style, title)
        self.header = [str(h) for h in header]
        self.rows = [[str(c) for c in r] for r in rows]

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["header"] = self.header
        d["rows"] = self.rows
        return d

    def render(self, cid: str) -> str:
        head = "".join(f"<th>{_html.escape(h)}</th>" for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{_html.escape(c)}</td>" for c in r) +
            "</tr>" for r in self.rows)
        return f"""
<div class="dl4j-component">
  <h3>{_html.escape(self.title)}</h3>
  <table id="{cid}" class="dl4j-table">
    <thead><tr>{head}</tr></thead><tbody>{body}</tbody>
  </table>
</div>"""


class ComponentText(Component):
    """ref: text/ComponentText.java."""

    type_name = "ComponentText"

    def __init__(self, text: str = "", title: str = "",
                 style: Optional[Style] = None):
        super().__init__(style, title)
        self.text = text

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["text"] = self.text
        return d

    def render(self, cid: str) -> str:
        t = f"<h3>{_html.escape(self.title)}</h3>" if self.title else ""
        return (f'<div class="dl4j-component" id="{cid}">{t}'
                f"<p>{_html.escape(self.text)}</p></div>")


class ComponentDiv(Component):
    """ref: component/ComponentDiv.java — container of child components."""

    type_name = "ComponentDiv"

    def __init__(self, children: Sequence[Component] = (), title: str = "",
                 style: Optional[Style] = None):
        super().__init__(style, title)
        self.children = list(children)

    def add(self, c: Component) -> "ComponentDiv":
        self.children.append(c)
        return self

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["children"] = [c.to_dict() for c in self.children]
        return d

    def render(self, cid: str) -> str:
        inner = "".join(c.render(f"{cid}_{i}")
                        for i, c in enumerate(self.children))
        t = f"<h3>{_html.escape(self.title)}</h3>" if self.title else ""
        return f'<div class="dl4j-div" id="{cid}">{t}{inner}</div>'


class DecoratorAccordion(Component):
    """ref: decorator/DecoratorAccordion.java — collapsible section."""

    type_name = "DecoratorAccordion"

    def __init__(self, title: str = "", children: Sequence[Component] = (),
                 default_collapsed: bool = False,
                 style: Optional[Style] = None):
        super().__init__(style, title)
        self.children = list(children)
        self.default_collapsed = default_collapsed

    def add(self, c: Component) -> "DecoratorAccordion":
        self.children.append(c)
        return self

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["children"] = [c.to_dict() for c in self.children]
        d["defaultCollapsed"] = self.default_collapsed
        return d

    def render(self, cid: str) -> str:
        inner = "".join(c.render(f"{cid}_{i}")
                        for i, c in enumerate(self.children))
        open_attr = "" if self.default_collapsed else " open"
        return (f'<details class="dl4j-accordion" id="{cid}"{open_attr}>'
                f"<summary>{_html.escape(self.title)}</summary>"
                f"{inner}</details>")


_RENDER_JS = """
function dl4jAxes(ctx, st, xmin, xmax, ymin, ymax){
  const W=ctx.canvas.width, H=ctx.canvas.height;
  const L=st.marginLeft, R=W-st.marginRight, T=st.marginTop,
        B=H-st.marginBottom;
  ctx.strokeStyle='#999'; ctx.strokeRect(L, T, R-L, B-T);
  ctx.fillStyle='#333'; ctx.font='11px sans-serif';
  ctx.fillText(ymax.toPrecision(4), 2, T+5);
  ctx.fillText(ymin.toPrecision(4), 2, B);
  ctx.fillText(xmin.toPrecision(4), L, H-6);
  ctx.fillText(xmax.toPrecision(4), R-30, H-6);
  return [x=>L+(x-xmin)/((xmax-xmin)||1)*(R-L),
          y=>B-(y-ymin)/((ymax-ymin)||1)*(B-T)];
}
function dl4jChart(cv, d){
  const ctx=cv.getContext('2d'), st=d.style;
  let xs=[], ys=[];
  if(d.mode==='stacked'){
    const acc={};
    d.series.forEach(s=>{s.y=s.y.map((v,i)=>{
      const k=s.x[i]; acc[k]=(acc[k]||0)+v; return acc[k];});});
  }
  d.series.forEach(s=>{xs.push(...s.x); ys.push(...s.y);});
  if(!xs.length) return;
  const [X,Y]=dl4jAxes(ctx, st, Math.min(...xs), Math.max(...xs),
                       Math.min(0,...ys), Math.max(...ys));
  d.series.forEach((s,i)=>{
    const c=st.seriesColors[i%st.seriesColors.length];
    ctx.strokeStyle=c; ctx.fillStyle=c; ctx.lineWidth=st.strokeWidth;
    if(d.mode==='scatter'){
      s.x.forEach((x,j)=>{ctx.beginPath();
        ctx.arc(X(x),Y(s.y[j]),2.5,0,6.3); ctx.fill();});
    } else {
      ctx.beginPath();
      s.x.forEach((x,j)=>{j?ctx.lineTo(X(x),Y(s.y[j]))
                           :ctx.moveTo(X(x),Y(s.y[j]))});
      ctx.stroke();
    }
    ctx.fillText(s.name, st.marginLeft+8+i*120, 14);
  });
}
function dl4jHistogram(cv, d){
  const ctx=cv.getContext('2d'), st=d.style;
  if(!d.bins.length) return;
  const xmin=Math.min(...d.bins.map(b=>b[0]));
  const xmax=Math.max(...d.bins.map(b=>b[1]));
  const ymax=Math.max(...d.bins.map(b=>b[2]));
  const [X,Y]=dl4jAxes(ctx, st, xmin, xmax, 0, ymax);
  ctx.fillStyle=st.seriesColors[0];
  d.bins.forEach(b=>{
    ctx.fillRect(X(b[0]), Y(b[2]), Math.max(1,X(b[1])-X(b[0])-1),
                 Y(0)-Y(b[2]));});
}
function dl4jHBar(cv, d){
  const ctx=cv.getContext('2d'), st=d.style;
  if(!d.bars.length) return;
  const vmax=Math.max(...d.bars.map(b=>b[1]), 0);
  const H=cv.height, L=st.marginLeft+60, R=cv.width-st.marginRight;
  const bh=(H-st.marginTop-st.marginBottom)/d.bars.length;
  ctx.font='11px sans-serif';
  d.bars.forEach((b,i)=>{
    const y=st.marginTop+i*bh;
    ctx.fillStyle='#333'; ctx.fillText(b[0], 4, y+bh/2+4);
    ctx.fillStyle=st.seriesColors[i%st.seriesColors.length];
    ctx.fillRect(L, y+2, (R-L)*(b[1]/(vmax||1)), bh-4);
    ctx.fillStyle='#333';
    ctx.fillText(b[1].toPrecision(4), L+4, y+bh/2+4);});
}
function dl4jTimeline(cv, d){
  const ctx=cv.getContext('2d'), st=d.style;
  if(!d.lanes.length) return;
  let tmin=Infinity, tmax=-Infinity;
  d.lanes.forEach(l=>l[1].forEach(s=>{
    tmin=Math.min(tmin,s[0]); tmax=Math.max(tmax,s[1]);}));
  const L=st.marginLeft+60, R=cv.width-st.marginRight;
  const lh=(cv.height-st.marginTop-st.marginBottom)/d.lanes.length;
  const X=t=>L+(t-tmin)/((tmax-tmin)||1)*(R-L);
  ctx.font='11px sans-serif';
  d.lanes.forEach((l,i)=>{
    const y=st.marginTop+i*lh;
    ctx.fillStyle='#333'; ctx.fillText(l[0], 4, y+lh/2+4);
    l[1].forEach((s,j)=>{
      ctx.fillStyle=st.seriesColors[j%st.seriesColors.length];
      ctx.fillRect(X(s[0]), y+2, Math.max(1,X(s[1])-X(s[0])), lh-4);
      if(s[2]) {ctx.fillStyle='#fff'; ctx.fillText(s[2], X(s[0])+3, y+lh/2+4);}
    });});
}
"""


def render_page(components: Sequence[Component],
                title: str = "deeplearning4j_tpu report") -> str:
    """Standalone HTML page embedding every component
    (ref: standalone/StaticPageUtil.renderHTML)."""
    body = "".join(c.render(f"c{i}") for i, c in enumerate(components))
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{_html.escape(title)}</title>
<style>
body{{font-family:sans-serif;margin:20px;background:#fafafa}}
h3{{font-size:15px;margin:16px 0 6px}}
.dl4j-table{{border-collapse:collapse;font-size:13px}}
.dl4j-table td,.dl4j-table th{{border:1px solid #ddd;padding:4px 8px}}
.dl4j-accordion{{margin:8px 0;border:1px solid #ddd;padding:6px;
background:#fff}}
</style>
<script>{_RENDER_JS}</script>
</head><body>
<h1 style="font-size:20px">{_html.escape(title)}</h1>
{body}
</body></html>"""
