"""Network-level configuration: the builder DSL.

Counterpart of ``deeplearning4j_tpu/nn/conf/network.py``:
``NeuralNetConfiguration.Builder`` global defaults (weight init, L1/L2)
cascade into the layer confs, the updater and gradient normalization
go to the network; ``graph_builder()`` yields a
``ComputationGraphConfiguration``, whose ``use_cnn_data_format``
switches the CNN stack's internal layout, and ``list()`` a
``ListBuilder`` for a sequential ``MultiLayerConfiguration`` (with
truncated BPTT, ``tbptt``). Building a list with an input type walks
the layers once (:func:`_infer_shapes_and_preprocessors`): a layer
whose input kind differs from the one it expects gets a shape adapter
(:func:`infer_preprocessor`, the JAX package's rule: CNN to feed-forward
and RNN to feed-forward are inserted, feed-forward to CNN must be given
with ``input_preprocessor``), and each layer's ``n_in`` is filled from
the type reaching it. The builder's global defaults are the JAX package's:
weight init, its ``dist``, activation (parameterized layers only), L1 /
L2, bias init and dropout; ``learning_rate`` sets the updater's.

Both configurations read and write the JAX package's JSON (``to_dict``
/ ``to_json``, ``from_dict`` / ``from_json``), key for key, a sequential
network's preprocessors included. The JAX fields the port does not carry
(``backprop`` and ``pretrain``: layer-wise pretraining, ROADMAP.md A11)
are written at their JAX defaults and read only at them. A graph carries its truncated-BPTT lengths as the
JAX graph does: as fields, with no truncated-BPTT ``fit``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseLayerConf, FeedForwardLayerConf, LayerConf, layer_from_dict,
    layer_to_dict)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor, Preprocessor,
    RnnToFeedForwardPreProcessor, preprocessor_from_dict,
    preprocessor_to_dict)
from deeplearning4j_tpu_torch.nn.updater import (
    Sgd, Updater, updater_from_dict, updater_to_dict)

__all__ = ["ComputationGraphConfiguration", "ListBuilder",
           "MultiLayerConfiguration", "NeuralNetConfiguration",
           "apply_global_defaults", "infer_preprocessor"]

#: the input kind each layer family expects (the JAX package's table);
#: other layers take any
_EXPECTS = {
    "ff": {"DenseLayer", "OutputLayer", "EmbeddingLayer", "AutoEncoder",
           "CenterLossOutputLayer", "BatchNormalization",
           "VariationalAutoencoder"},
    "cnn": {"ConvolutionLayer", "SubsamplingLayer", "Upsampling2DLayer",
            "ZeroPaddingLayer", "LocalResponseNormalization",
            "Deconvolution2DLayer", "Yolo2OutputLayer", "SpaceToDepthLayer"},
    "rnn": {"LSTM", "GravesLSTM", "GravesBidirectionalLSTM", "SimpleRnn",
            "RnnOutputLayer", "Convolution1DLayer", "Subsampling1DLayer",
            "LastTimeStepLayer", "ZeroPadding1DLayer", "Upsampling1DLayer"},
}


def apply_global_defaults(layer: LayerConf, defaults: Dict[str, Any]) -> None:
    """Cascade builder-level defaults into a layer conf, DL4J-style: a
    global value applies unless the layer set the field explicitly
    (detected as the field differing from its dataclass default); the
    activation reaches the parameterized layers only."""
    cls_defaults = {f.name: f.default for f in dataclasses.fields(layer)
                    if f.default is not dataclasses.MISSING}
    for k, v in defaults.items():
        if v is None or not hasattr(layer, k):
            continue
        if k == "activation" and not isinstance(layer, BaseLayerConf):
            continue
        if getattr(layer, k) == cls_defaults.get(k):
            setattr(layer, k, v)


def infer_preprocessor(it: InputType, layer: LayerConf
                       ) -> Optional[Preprocessor]:
    """The shape adapter a layer needs between the input type reaching it
    and the kind it expects (the JAX package's rule): None where they
    agree (BatchNormalization takes feed-forward and CNN input as it
    is), CNN to feed-forward, a flattened CNN to CNN and RNN to
    feed-forward inserted; feed-forward to CNN has no shape to infer and
    raises, as does every other pair."""
    name = type(layer).__name__
    want = next((k for k, names in _EXPECTS.items() if name in names), None)
    if want is None:
        return None
    have = "ff" if it.kind == "cnn_flat" else it.kind
    if name == "BatchNormalization" and have in ("ff", "cnn"):
        return None
    if have == want:
        return None
    if it.kind == "cnn_flat" and want == "cnn":
        return FeedForwardToCnnPreProcessor(it.height, it.width, it.channels)
    if have == "cnn" and want == "ff":
        return CnnToFeedForwardPreProcessor(it.height, it.width, it.channels)
    if have == "ff" and want == "cnn":
        raise ValueError(
            "Cannot infer FeedForwardToCnn preprocessor shape automatically; "
            "add it explicitly")
    if have == "rnn" and want == "ff":
        return RnnToFeedForwardPreProcessor()
    raise ValueError(f"No automatic preprocessor from {it} to {name}")


def _infer_shapes_and_preprocessors(conf: "MultiLayerConfiguration") -> None:
    """Walk the net once: insert the preprocessors a layer needs (one
    given for that index stays) and fill the ``n_in`` fields from the
    input type reaching each layer."""
    it = conf.input_type
    for i, layer in enumerate(conf.layers):
        if i not in conf.preprocessors:
            pre = infer_preprocessor(it, layer)
            if pre is not None:
                conf.preprocessors[i] = pre
        if i in conf.preprocessors:
            it = conf.preprocessors[i].output_type(it)
        if isinstance(layer, FeedForwardLayerConf) and layer.n_in is None:
            layer.n_in = it.channels if it.kind == "cnn" else it.flat_size()
        it = layer.output_type(it)


def _check_absent(what: str, d: dict, absent: dict, roadmap: str) -> None:
    """Refuse a JAX field the port does not carry at anything but its
    default (``roadmap``: the ROADMAP.md item that ports them)."""
    for key, default in absent.items():
        if key in d and d[key] != default:
            raise NotImplementedError(
                f"{what}.{key} = {d[key]!r}: only {default!r} is ported "
                f"(ROADMAP.md {roadmap})")


@dataclass
class MultiLayerConfiguration:
    """Sequential net config, built through
    ``NeuralNetConfiguration.Builder().list()``: the layers, the
    preprocessors by layer index (each applied to that layer's input),
    the input type, and the training settings (``tbptt`` with
    ``tbptt_fwd_length``: ``fit`` splits each ``[N, C, T]`` batch into
    chunks of that many steps and carries the recurrent state across
    them; ``tbptt_back_length`` is carried as the JAX package carries
    it, unused by either ``fit``). ``dtype`` selects the compute policy
    as for a graph."""

    layers: List[LayerConf] = field(default_factory=list)
    preprocessors: Dict[int, Preprocessor] = field(default_factory=dict)
    input_type: Optional[InputType] = None
    seed: int = 12345
    updater: Updater = field(default_factory=lambda: Sgd(0.1))
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    tbptt: bool = False
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    dtype: str = "float32"

    def layer_input_types(self) -> List[InputType]:
        """The input type each layer sees (after its preprocessor)."""
        if self.input_type is None:
            raise ValueError("input_type not set; call set_input_type or "
                             "provide n_in")
        it, out = self.input_type, []
        for i, layer in enumerate(self.layers):
            pre = self.preprocessors.get(i)
            if pre is not None:
                it = pre.output_type(it)
            out.append(it)
            it = layer.output_type(it)
        return out

    def output_type(self) -> InputType:
        its = self.layer_input_types()
        return self.layers[-1].output_type(its[-1])

    #: the JAX fields this conf lacks, at the defaults they are read at
    _ABSENT = {"backprop": True, "pretrain": False}

    def to_dict(self) -> dict:
        """The JAX package's JSON form, key for key."""
        return {
            "layers": [layer_to_dict(layer) for layer in self.layers],
            "preprocessors": {str(k): preprocessor_to_dict(v)
                              for k, v in self.preprocessors.items()},
            "input_type": self.input_type.to_dict() if self.input_type
            else None,
            "seed": self.seed,
            "updater": updater_to_dict(self.updater),
            "backprop": True,
            "pretrain": False,
            "tbptt": self.tbptt,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "dtype": self.dtype,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        """The inverse of :meth:`to_dict`, with the JAX package's
        defaults for missing keys. Layer-wise pretraining (``backprop``
        off, ``pretrain`` on) is refused (ROADMAP.md A11)."""
        _check_absent("MultiLayerConfiguration", d,
                      MultiLayerConfiguration._ABSENT, "A11")
        return MultiLayerConfiguration(
            layers=[layer_from_dict(x) for x in d["layers"]],
            preprocessors={int(k): preprocessor_from_dict(v)
                           for k, v in d.get("preprocessors", {}).items()},
            input_type=InputType.from_dict(d["input_type"])
            if d.get("input_type") else None,
            seed=d.get("seed", 12345),
            updater=updater_from_dict(d["updater"]) if d.get("updater")
            else Sgd(0.1),
            tbptt=d.get("tbptt", False),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
            dtype=d.get("dtype", "float32"))

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))


class ListBuilder:
    """Sequential-net builder: ``layer``, ``input_preprocessor``,
    ``set_input_type``, ``tbptt`` and ``build``."""

    def __init__(self, parent: "NeuralNetConfiguration.Builder"):
        self._parent = parent
        self._layers: List[LayerConf] = []
        self._preprocessors: Dict[int, Preprocessor] = {}
        self._input_type: Optional[InputType] = None
        self._tbptt = False
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, *args):
        """``layer(conf)`` or ``layer(index, conf)``."""
        self._layers.append(args[-1])
        return self

    def input_preprocessor(self, index: int, pre: Preprocessor):
        """Apply ``pre`` to layer ``index``'s input (inference leaves an
        index given here alone)."""
        self._preprocessors[int(index)] = pre
        return self

    def set_input_type(self, it: InputType):
        self._input_type = it
        return self

    def tbptt(self, fwd: int = 20, back: Optional[int] = None):
        """Truncated BPTT in chunks of ``fwd`` steps (``back``, default
        ``fwd``, is carried in the conf as the JAX package does)."""
        self._tbptt = True
        self._tbptt_fwd = fwd
        self._tbptt_back = back if back is not None else fwd
        return self

    def build(self) -> MultiLayerConfiguration:
        g = self._parent
        for layer in self._layers:
            apply_global_defaults(layer, g._defaults)
        conf = MultiLayerConfiguration(
            layers=self._layers, preprocessors=dict(self._preprocessors),
            input_type=self._input_type, seed=g._seed,
            updater=g._updater, tbptt=self._tbptt,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            gradient_normalization=g._grad_norm,
            gradient_normalization_threshold=g._grad_norm_threshold)
        if conf.input_type is not None:
            _infer_shapes_and_preprocessors(conf)
        return conf


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

        def learning_rate(self, lr: float):
            self._updater.learning_rate = float(lr)
            return self

        def weight_init(self, w: str):
            self._defaults["weight_init"] = w
            return self

        def dist(self, d: dict):
            self._defaults["dist"] = d
            return self

        def activation(self, a: str):
            self._defaults["activation"] = a
            return self

        def l1(self, v: float):
            self._defaults["l1"] = v
            return self

        def l2(self, v: float):
            self._defaults["l2"] = v
            return self

        def bias_init(self, v: float):
            self._defaults["bias_init"] = v
            return self

        def dropout(self, retain: float):
            self._defaults["dropout"] = retain
            return self

        def gradient_normalization(self, method: str,
                                   threshold: float = 1.0):
            self._grad_norm = method
            self._grad_norm_threshold = threshold
            return self

        def list(self) -> ListBuilder:
            return ListBuilder(self)

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
    ``ComputationGraph.fit``. The truncated-BPTT lengths are carried as
    the JAX graph carries them (its ``fit`` has no truncated BPTT)."""

    vertices: Dict[str, Any] = field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = field(default_factory=dict)
    network_inputs: List[str] = field(default_factory=list)
    network_outputs: List[str] = field(default_factory=list)
    input_types: Dict[str, InputType] = field(default_factory=dict)
    seed: int = 12345
    updater: Updater = field(default_factory=lambda: Sgd(0.1))
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
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

    def to_dict(self) -> dict:
        """The JAX package's JSON form, key for key."""
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            vertex_to_dict)
        return {
            "vertices": {k: vertex_to_dict(v)
                         for k, v in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "input_types": {k: v.to_dict()
                            for k, v in self.input_types.items()},
            "seed": self.seed,
            "updater": updater_to_dict(self.updater),
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "dtype": self.dtype,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        """The inverse of :meth:`to_dict`, with the JAX package's
        defaults for missing keys."""
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            vertex_from_dict)
        return ComputationGraphConfiguration(
            vertices={k: vertex_from_dict(v)
                      for k, v in d["vertices"].items()},
            vertex_inputs={k: list(v) for k, v in d["vertex_inputs"].items()},
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            input_types={k: InputType.from_dict(v)
                         for k, v in d.get("input_types", {}).items()},
            seed=d.get("seed", 12345),
            updater=updater_from_dict(d["updater"]) if d.get("updater")
            else Sgd(0.1),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
            dtype=d.get("dtype", "float32"))

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))

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
