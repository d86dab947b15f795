"""EvaluationTools: self-contained HTML exports of evaluation results.

Counterpart of ``deeplearning4j_tpu/eval/tools.py``: the same bytes for
the same evaluations. Equivalent of deeplearning4j-core evaluation/EvaluationTools.java:329
(exportRocChartsToHtmlFile, exportConfusionMatrixToHtmlFile) — renders
ROC curves and confusion matrices as standalone HTML (inline SVG, no
external assets; the reference embeds its ui-components JS the same way).
"""

from __future__ import annotations

import html
from typing import Optional, Sequence

import numpy as np

_STYLE = """
body{font-family:sans-serif;margin:24px;color:#222}
h1{font-size:20px} h2{font-size:16px;margin-top:28px}
table{border-collapse:collapse;font-size:13px;margin:10px 0}
td,th{border:1px solid #ccc;padding:4px 10px;text-align:right}
th{background:#f0f0f0}
td.diag{background:#e3f2e3;font-weight:bold}
.meta{color:#555;font-size:13px}
"""


def _svg_roc(points: Sequence[tuple], auc: float, title: str,
             size: int = 380) -> str:
    """Inline-SVG ROC curve from (fpr, tpr) points."""
    pad = 40
    w = h = size
    inner = size - 2 * pad

    def X(x):
        return pad + x * inner

    def Y(y):
        return h - pad - y * inner

    pts = sorted(points)
    path = " ".join(f"{'M' if i == 0 else 'L'}{X(p[0]):.1f},{Y(p[1]):.1f}"
                    for i, p in enumerate(pts))
    return f"""<svg width="{w}" height="{h}" viewBox="0 0 {w} {h}">
<rect x="{pad}" y="{pad}" width="{inner}" height="{inner}"
 fill="#fff" stroke="#999"/>
<line x1="{X(0)}" y1="{Y(0)}" x2="{X(1)}" y2="{Y(1)}"
 stroke="#bbb" stroke-dasharray="4"/>
<path d="{path}" fill="none" stroke="#1976d2" stroke-width="2"/>
<text x="{w/2}" y="16" text-anchor="middle" font-size="13">{html.escape(title)}
 (AUC={auc:.4f})</text>
<text x="{w/2}" y="{h-6}" text-anchor="middle" font-size="11">FPR</text>
<text x="12" y="{h/2}" font-size="11" transform="rotate(-90 12 {h/2})">TPR</text>
<text x="{pad}" y="{h-pad+14}" font-size="10">0</text>
<text x="{X(1)}" y="{h-pad+14}" font-size="10">1</text>
<text x="{pad-14}" y="{Y(1)+4}" font-size="10">1</text>
</svg>"""


def roc_chart_html(roc, title: str = "ROC") -> str:
    """HTML fragment for one fitted ROC object (eval/roc.py)."""
    _, fpr, tpr = roc.get_roc_curve()
    return _svg_roc(list(zip(fpr, tpr)), roc.calculate_auc(), title)


def confusion_matrix_html(evaluation, class_names: Optional[Sequence[str]]
                          = None) -> str:
    """HTML fragment: confusion matrix table + summary stats."""
    cm = evaluation.confusion.matrix
    n = cm.shape[0]
    names = class_names or [str(i) for i in range(n)]
    rows = ["<table><tr><th>actual \\ predicted</th>" +
            "".join(f"<th>{html.escape(str(names[j]))}</th>"
                    for j in range(n)) + "</tr>"]
    for i in range(n):
        cells = "".join(
            f'<td class="{"diag" if i == j else ""}">{int(cm[i, j])}</td>'
            for j in range(n))
        rows.append(f"<tr><th>{html.escape(str(names[i]))}</th>{cells}</tr>")
    rows.append("</table>")
    stats = (f'<p class="meta">accuracy {evaluation.accuracy():.4f} · '
             f'precision {evaluation.precision():.4f} · '
             f'recall {evaluation.recall():.4f} · '
             f'F1 {evaluation.f1():.4f}</p>')
    return "".join(rows) + stats


def export_roc_charts_to_html_file(path: str, rocs, titles=None) -> None:
    """ref: EvaluationTools.exportRocChartsToHtmlFile. ``rocs`` is one ROC
    or a list (e.g. ROCMultiClass per-class curves)."""
    if not isinstance(rocs, (list, tuple)):
        rocs = [rocs]
    titles = list(titles) if titles else []
    titles += [f"class {i}" for i in range(len(titles), len(rocs))]
    body = "".join(roc_chart_html(r, t) for r, t in zip(rocs, titles))
    _write(path, "ROC", body)


def export_evaluation_to_html_file(path: str, evaluation,
                                   class_names=None) -> None:
    """ref: EvaluationTools confusion-matrix export."""
    _write(path, "Evaluation", confusion_matrix_html(evaluation,
                                                     class_names))


def _write(path: str, title: str, body: str) -> None:
    with open(path, "w") as f:
        f.write(f"<!DOCTYPE html><html><head><title>{title}</title>"
                f"<style>{_STYLE}</style></head><body><h1>{title}</h1>"
                f"{body}</body></html>")


def evaluation_report_components(evaluation=None, rocs=None, roc_titles=None,
                                 scores=None, class_names=None):
    """Build a ui-components report for evaluation results (the DSL from
    ui/components.py — ref: the reference renders its eval exports through
    the ui-components chart classes). Returns a list of Components; pass
    to ui.components.render_page for a standalone HTML page.

    evaluation: eval/Evaluation -> confusion table + per-class F1 bars
    rocs: ROC or list of ROCs -> one scatter/line chart per curve
    scores: [(iteration, score)] -> training-score line chart
    """
    from deeplearning4j_tpu_torch.ui.components import (
        ChartHorizontalBar, ChartLine, ComponentTable, ComponentText,
    )
    comps = []
    if scores:
        chart = ChartLine("Training score")
        chart.add_series("score", [s[0] for s in scores],
                         [s[1] for s in scores])
        comps.append(chart)
    if evaluation is not None:
        cm = evaluation.confusion.matrix
        n = cm.shape[0]
        names = [str(c) for c in (class_names or range(n))]
        comps.append(ComponentTable(
            header=["actual \\ predicted"] + names,
            rows=[[names[i]] + [int(cm[i, j]) for j in range(n)]
                  for i in range(n)],
            title="Confusion matrix"))
        bars = ChartHorizontalBar("Per-class F1")
        for i in range(n):
            bars.add_bar(names[i], float(evaluation.f1(i)))
        comps.append(bars)
        comps.append(ComponentText(
            f"accuracy {evaluation.accuracy():.4f}, "
            f"precision {evaluation.precision():.4f}, "
            f"recall {evaluation.recall():.4f}, "
            f"F1 {evaluation.f1():.4f}", title="Summary"))
    if rocs is not None:
        if not isinstance(rocs, (list, tuple)):
            rocs = [rocs]
        titles = list(roc_titles or [])
        titles += [f"class {i}" for i in range(len(titles), len(rocs))]
        for roc, title in zip(rocs, titles):
            _, fpr, tpr = roc.get_roc_curve()
            chart = ChartLine(f"ROC — {title} "
                              f"(AUC {roc.calculate_auc():.4f})")
            chart.add_series("roc", [float(v) for v in fpr],
                             [float(v) for v in tpr])
            chart.add_series("chance", [0.0, 1.0], [0.0, 1.0])
            comps.append(chart)
    return comps


def export_report_to_html_file(path: str, **kwargs) -> None:
    """One-call evaluation report through the ui-components DSL
    (kwargs = evaluation_report_components arguments)."""
    from deeplearning4j_tpu_torch.ui.components import render_page
    with open(path, "w") as f:
        f.write(render_page(evaluation_report_components(**kwargs),
                            title="Evaluation report"))
