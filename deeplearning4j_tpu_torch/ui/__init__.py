"""Training observability, for now its component DSL only.

Counterpart of ``deeplearning4j_tpu/ui/``. Ported: ``components.py``
(the chart, table and text components rendered to standalone HTML,
standard library only), which the evaluation exports build on
(``eval/tools.py``). The stats listener, the stats storages and the UI
server (``stats.py``, ``storage.py``, ``server.py``,
``convolutional.py``) are not ported yet (ROADMAP.md A11).
"""

from deeplearning4j_tpu_torch.ui.components import (  # noqa: F401
    ChartHistogram, ChartHorizontalBar, ChartLine, ChartScatter,
    ChartStackedArea, ChartTimeline, Component, ComponentDiv,
    ComponentTable, ComponentText, DecoratorAccordion, Style, render_page,
)
