"""Graph vertices and the GraphBuilder for DAG networks.

Counterpart of ``deeplearning4j_tpu/nn/conf/graph_conf.py``, with the
vertices the ported graphs need: ``LayerVertex`` (a layer conf, with an
optional input preprocessor), ``ElementWiseVertex`` (the residual adds,
over RNN or CNN activations) and ``MergeVertex`` (concatenation on the
feature axis, as in the recurrent regression graph), and their JSON
form (:func:`vertex_to_dict`, :func:`vertex_from_dict`: the JAX
package's ``{"@class": name, field: value}``, a layer vertex's layer and
preprocessor nested in their own forms). The other vertices port with
the breadth modules (ROADMAP.md A11).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LayerConf, layer_from_dict, layer_to_dict)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    Preprocessor, preprocessor_from_dict, preprocessor_to_dict)

__all__ = ["ElementWiseVertex", "GraphBuilder", "GraphVertexConf",
           "LayerVertex", "MergeVertex", "VERTEX_REGISTRY",
           "vertex_from_dict", "vertex_to_dict"]


@dataclass
class GraphVertexConf:
    """Base vertex: a function of its input activation list."""

    def output_type(self, its: List[InputType]) -> InputType:
        return its[0]

    def init(self, gen: torch.Generator, its: List[InputType], device):
        return {}, {}

    def apply(self, params, xs: List, state, *, train=False, gen=None):
        """Return (y, new_state); ``train`` and the generator ``gen``
        reach the layers."""
        raise NotImplementedError


@dataclass
class LayerVertex(GraphVertexConf):
    """Wraps a layer conf and an optional input preprocessor (for
    example the entry transpose of ``use_cnn_data_format``)."""

    layer: Any = None
    preprocessor: Any = None

    def _input_type(self, its):
        it = its[0]
        return it if self.preprocessor is None else \
            self.preprocessor.output_type(it)

    def output_type(self, its):
        return self.layer.output_type(self._input_type(its))

    def init(self, gen, its, device):
        return self.layer.init(gen, self._input_type(its), device)

    @property
    def supports_streaming(self):
        return getattr(self.layer, "supports_streaming", False)

    def apply(self, params, xs, state, *, train=False, gen=None, **extra):
        x = xs[0]
        if self.preprocessor is not None:
            x = self.preprocessor.apply(x)
        return self.layer.apply(params, x, state, train=train, gen=gen,
                                **extra)


@dataclass
class ElementWiseVertex(GraphVertexConf):
    """Element-wise sum of the inputs (the residual adds). The other ops
    port with the breadth modules (ROADMAP.md A11)."""

    op: str = "add"

    def __post_init__(self):
        if self.op.lower() != "add":
            raise NotImplementedError(
                f"ElementWiseVertex op {self.op!r} is not ported yet "
                f"(ROADMAP.md A11); ported: add")

    def apply(self, params, xs, state, *, train=False, gen=None):
        y = xs[0]
        for x in xs[1:]:
            y = y + x
        return y, state


@dataclass
class MergeVertex(GraphVertexConf):
    """Concatenate the inputs on the feature axis: axis 1 of ``[N, F]``,
    ``[N, F, T]`` and NCHW ``[N, C, H, W]``; under internal NHWC the
    4-D inputs carry channels on the last axis."""

    data_format: str = "NCHW"

    def output_type(self, its):
        first = its[0]
        if first.kind == "cnn":
            return InputType.convolutional(
                first.height, first.width, sum(it.channels for it in its))
        if first.kind == "rnn":
            return InputType.recurrent(sum(it.size for it in its),
                                       first.timesteps)
        return InputType.feed_forward(sum(it.flat_size() for it in its))

    def apply(self, params, xs, state, *, train=False, gen=None):
        axis = 3 if (self.data_format == "NHWC" and xs[0].dim() == 4) else 1
        return torch.cat(xs, dim=axis), state


VERTEX_REGISTRY: Dict[str, type] = {c.__name__: c for c in (
    LayerVertex, ElementWiseVertex, MergeVertex)}


def vertex_to_dict(v: GraphVertexConf) -> dict:
    """The JAX package's JSON form of a vertex: ``{"@class": name}`` and
    its fields, a layer and a preprocessor in their own forms."""
    d = {"@class": type(v).__name__}
    for f in dataclasses.fields(v):
        val = getattr(v, f.name)
        if isinstance(val, LayerConf):
            val = layer_to_dict(val)
        elif isinstance(val, Preprocessor):
            val = preprocessor_to_dict(val)
        elif isinstance(val, tuple):
            val = list(val)
        d[f.name] = val
    return d


def vertex_from_dict(d: dict) -> GraphVertexConf:
    """The inverse of :func:`vertex_to_dict`; the vertices the port does
    not have are refused."""
    d = dict(d)
    name = d.pop("@class")
    cls = VERTEX_REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(f"vertex {name!r} is not ported yet "
                                  "(ROADMAP.md A11)")
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in d.items() if k in names}
    if isinstance(kwargs.get("layer"), dict):
        kwargs["layer"] = layer_from_dict(kwargs["layer"])
    if isinstance(kwargs.get("preprocessor"), dict):
        kwargs["preprocessor"] = preprocessor_from_dict(
            kwargs["preprocessor"])
    return cls(**kwargs)


class GraphBuilder:
    """Fluent DAG builder (add_inputs / add_layer / add_vertex /
    set_outputs)."""

    def __init__(self, parent=None):
        from deeplearning4j_tpu_torch.nn.conf.network import (
            ComputationGraphConfiguration, NeuralNetConfiguration)
        if parent is None:
            parent = NeuralNetConfiguration.Builder()
        self._conf = ComputationGraphConfiguration(
            seed=parent._seed, updater=parent._updater,
            gradient_normalization=parent._grad_norm,
            gradient_normalization_threshold=parent._grad_norm_threshold)
        self._defaults = parent._defaults

    def add_inputs(self, *names: str):
        self._conf.network_inputs.extend(names)
        return self

    def set_input_types(self, *its: InputType):
        for name, it in zip(self._conf.network_inputs, its):
            self._conf.input_types[name] = it
        return self

    def add_layer(self, name: str, layer: LayerConf, *inputs: str,
                  preprocessor=None):
        from deeplearning4j_tpu_torch.nn.conf.network import (
            apply_global_defaults)
        apply_global_defaults(layer, self._defaults)
        layer.name = name
        self._conf.vertices[name] = LayerVertex(layer=layer,
                                                preprocessor=preprocessor)
        self._conf.vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertexConf, *inputs: str):
        self._conf.vertices[name] = vertex
        self._conf.vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str):
        self._conf.network_outputs = list(names)
        return self

    def build(self):
        conf = self._conf
        if not conf.network_inputs:
            raise ValueError("graph has no inputs")
        if not conf.network_outputs:
            raise ValueError("graph has no outputs")
        for name in conf.vertices:
            for i in conf.vertex_inputs.get(name, []):
                if i not in conf.vertices and i not in conf.network_inputs:
                    raise ValueError(
                        f"vertex '{name}' input '{i}' is undefined")
        conf.topological_order()  # validates acyclicity
        return conf
