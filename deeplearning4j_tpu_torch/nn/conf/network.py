"""Network-level configuration: the builder DSL for DAG networks.

Counterpart of ``deeplearning4j_tpu/nn/conf/network.py``:
``NeuralNetConfiguration.Builder`` global defaults (weight init, L1/L2)
cascade into the layer confs, the updater and gradient normalization
go to the network, and ``graph_builder()`` yields a
``ComputationGraphConfiguration``, whose ``use_cnn_data_format``
switches the CNN stack's internal layout. The other global defaults
(activation, bias init, dropout), the sequential ``list()`` builder and
JSON round trips come with the formats (ROADMAP.md A1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConf
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor)
from deeplearning4j_tpu_torch.nn.updater import Sgd, Updater

__all__ = ["ComputationGraphConfiguration", "NeuralNetConfiguration",
           "apply_global_defaults"]


def apply_global_defaults(layer: LayerConf, defaults: Dict[str, Any]) -> None:
    """Cascade builder-level defaults into a layer conf, DL4J-style: a
    global value applies unless the layer set the field explicitly
    (detected as the field differing from its dataclass default)."""
    cls_defaults = {f.name: f.default for f in dataclasses.fields(layer)
                    if f.default is not dataclasses.MISSING}
    for k, v in defaults.items():
        if v is None or not hasattr(layer, k):
            continue
        if getattr(layer, k) == cls_defaults.get(k):
            setattr(layer, k, v)


class NeuralNetConfiguration:
    """Namespace matching the reference's entry point."""

    class Builder:
        def __init__(self):
            self._seed = 12345
            self._updater: Updater = Sgd(0.1)
            self._defaults: Dict[str, Any] = {}
            self._grad_norm: Optional[str] = None
            self._grad_norm_threshold = 1.0

        def seed(self, s: int):
            self._seed = int(s)
            return self

        def updater(self, u: Updater):
            self._updater = u
            return self

        def weight_init(self, w: str):
            self._defaults["weight_init"] = w
            return self

        def l1(self, v: float):
            self._defaults["l1"] = v
            return self

        def l2(self, v: float):
            self._defaults["l2"] = v
            return self

        def gradient_normalization(self, method: str,
                                   threshold: float = 1.0):
            self._grad_norm = method
            self._grad_norm_threshold = threshold
            return self

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
                GraphBuilder)
            return GraphBuilder(self)


@dataclass
class ComputationGraphConfiguration:
    """DAG net config, built through
    ``NeuralNetConfiguration.Builder().graph_builder()``. ``dtype``
    selects the compute policy (``"float32"`` or ``"bfloat16"``,
    ``nn/compute.py``); ``updater`` and the gradient normalization drive
    ``ComputationGraph.fit``."""

    vertices: Dict[str, Any] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    input_types: Dict[str, InputType] = field(default_factory=dict)
    seed: int = 12345
    updater: Updater = field(default_factory=lambda: Sgd(0.1))
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    dtype: str = "float32"

    def topological_order(self) -> List[str]:
        """Kahn topological sort, ties broken by name."""
        indeg = {name: 0 for name in self.vertices}
        for name, ins in self.vertex_inputs.items():
            indeg[name] = sum(1 for i in ins if i in self.vertices)
        ready = sorted([n for n, d in indeg.items() if d == 0])
        order: List[str] = []
        children: Dict[str, List[str]] = {n: [] for n in self.vertices}
        for name, ins in self.vertex_inputs.items():
            for i in ins:
                if i in children:
                    children[i].append(name)
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(order) != len(self.vertices):
            raise ValueError("Graph has a cycle or disconnected vertex "
                             "inputs")
        return order

    def use_cnn_data_format(self, fmt: str = "NHWC"
                            ) -> "ComputationGraphConfiguration":
        """Switch the INTERNAL activation layout of the CNN stack: every
        layer and preprocessor with a ``data_format`` takes ``fmt``. Under
        NHWC each layer vertex fed by a CNN network input gets a
        FeedForwardToCnn preprocessor doing the one NCHW -> NHWC
        transpose at the graph boundary (public inputs stay NCHW)."""
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import LayerVertex
        for v in self.vertices.values():
            objs = [v.layer, v.preprocessor] if isinstance(v, LayerVertex) \
                else [v]
            for obj in objs:
                if obj is not None and hasattr(obj, "data_format"):
                    obj.data_format = fmt
        if fmt != "NHWC":
            return self
        cnn_inputs = {n for n in self.network_inputs
                      if n in self.input_types
                      and self.input_types[n].kind == "cnn"}
        for name, ins in self.vertex_inputs.items():
            hit = [i for i in ins if i in cnn_inputs]
            if not hit:
                continue
            v = self.vertices[name]
            if not isinstance(v, LayerVertex):
                raise ValueError(
                    f"use_cnn_data_format: vertex {name!r} consumes CNN "
                    f"network input {hit[0]!r} directly; only layer "
                    "vertices can host the entry transpose")
            if v.preprocessor is None:
                it = self.input_types[hit[0]]
                v.preprocessor = FeedForwardToCnnPreProcessor(
                    height=it.height, width=it.width, channels=it.channels,
                    data_format=fmt)
            elif isinstance(v.preprocessor, CnnToFeedForwardPreProcessor):
                # an entry flatten reads the PUBLIC NCHW input directly
                v.preprocessor.data_format = "NCHW"
        return self
