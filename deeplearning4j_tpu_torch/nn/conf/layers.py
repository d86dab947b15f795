"""Layer configurations.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers.py``, restricted to
the layers the ported zoo models build, with ``EmbeddingLayer`` and
``DropoutLayer``. The transformer
(``zoo/transformer.py``): ``Convolution1DLayer`` (kernel 1: the token
projection and the FFN), ``PositionalEmbeddingLayer`` (learned
positions), ``LayerNormalization``, ``SelfAttentionLayer`` and
``RnnOutputLayer``. The text LSTM (``zoo/text_lstm.py``): ``GravesLSTM``
(``LSTM`` with peepholes), ``GravesBidirectionalLSTM`` and
``RnnOutputLayer``. ResNet50 (``zoo/resnet.py``): ``ConvolutionLayer``,
``BatchNormalization``, ``ActivationLayer``, ``SubsamplingLayer``,
``ZeroPaddingLayer``, ``GlobalPoolingLayer``, ``DenseLayer`` and
``OutputLayer``. Each conf owns its ``init`` / ``apply`` as in the JAX
package; ``apply`` works on plain tensors with ``{name: tensor}``
parameter dicts and is differentiable by autograd (training
differentiates the whole forward). Parameter names and layouts are the
JAX package's (a conv ``W`` is ``[O, I, kH, kW]``, BN has ``gamma`` /
``beta`` parameters and a ``mean`` / ``var`` state), so parameters and
state copy across unchanged (``util/convert.py``). The whole-sequence
attention runs the flash-attention kernels
(``nn/layers/flash_attention.py``), the LSTM layers the recurrence
kernels (``nn/layers/recurrent.py`` over ``nn/layers/lstm_kernel.py``;
their ``apply`` also takes a ``[N, T]`` mask); the CNN layers run PyTorch's
convolution and pooling (the JAX package's are XLA's too), and the
fused execution plan replaces whole chains of them with the bottleneck
and stem kernels (``nn/graph.py``).

The CNN layers take ``data_format`` ``"NCHW"`` (the public layout) or
``"NHWC"`` (the internal layout ``use_cnn_data_format`` selects). Every
``apply`` takes ``train`` and ``gen``: BN normalizes with the batch
statistics in training and returns its decayed running statistics as
the new state; in training, with the layer's generator ``gen`` (the
network's training generator split per layer), each layer that drops
its input in the JAX package (dense, the dropout layer, convolution,
1-D convolution, attention, the LSTM family and the output layers)
applies its ``dropout`` (:meth:`LayerConf.maybe_dropout_input`,
``nn/conf/dropout.py``). Inference (``train=False``, or no generator)
applies none.

Every layer carries ``dropout`` (a retain probability, 0.0 off, or an
``IDropout``), ``weight_noise`` (an ``IWeightNoise``, applied by the
sequential network) and ``constraints`` (``nn/conf/constraints.py``);
the parameterized ones ``dist`` (the ``"distribution"`` init's dict)
and ``bias_init`` (every bias's initial value), which their ``init``
uses, and ``learning_rate`` and ``updater``, which are serialized and
otherwise unused, as in the JAX package (whose ``fit`` reads neither).
JSON (``layer_to_dict`` / ``layer_from_dict``, over ``LAYER_REGISTRY``)
is the JAX package's wire form: ``{"@class": name, field: value}`` with
every field the JAX conf has, the dropouts, noises and constraints as
their own dicts.

Streaming state (``rnn_time_step``): the attention layer carries a
dense KV cache (``kv_k`` / ``kv_v`` ``[N, Hkv, L, D]``) with its
position ``kv_pos`` (a scalar, or ``[N]`` per row in the engine's slot
arena), or, while the serving engine decodes on its page pool, the
paged view (``kv_page_k`` / ``kv_page_v`` ``[P, Hkv, page_size, D]``
and ``kv_page_table`` ``[N, n_max]``); the learned positional table
carries its ``pos_offset``; an LSTM layer carries its ``h`` / ``c``
``[N, H]`` (in the compute dtype), which ``rnn_time_step`` feeds back
and the truncated-BPTT ``fit`` carries from chunk to chunk.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import losses as _losses
from deeplearning4j_tpu_torch.nn.conf import dropout as _dropout
from deeplearning4j_tpu_torch.nn.conf.constraints import constraint_from_dict
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import convolution as _conv
from deeplearning4j_tpu_torch.nn.layers import normalization as _norm
from deeplearning4j_tpu_torch.nn.layers import recurrent as _rnn
from deeplearning4j_tpu_torch.nn.layers.flash_attention import (
    flash_attention)
from deeplearning4j_tpu_torch.nn.weights import init_weights

NEG_INF = -1e30   # finite: a fully masked row must stay finite

__all__ = ["ActivationLayer", "BATCHED_STREAM_KEYS", "BatchNormalization",
           "Convolution1DLayer", "ConvolutionLayer", "DenseLayer",
           "DropoutLayer", "EmbeddingLayer", "GlobalPoolingLayer",
           "GravesBidirectionalLSTM", "GravesLSTM",
           "LAYER_REGISTRY", "LSTM", "LayerConf", "LayerNormalization",
           "OutputLayer", "PositionalEmbeddingLayer", "RnnOutputLayer",
           "STREAM_STATE_KEYS", "SelfAttentionLayer", "SubsamplingLayer",
           "ZeroPaddingLayer", "check_rewindable", "layer_from_dict",
           "layer_to_dict", "reorder_stream_state", "rewind_stream_state",
           "stream_capacity"]

#: per-layer state keys carried only by the streaming rnn_time_step
#: path and the truncated-BPTT fit (stripped on ordinary forwards,
#: cleared by rnn_clear_previous_state): the LSTM carry h / c, the
#: attention KV cache and its position, the paged view the serving
#: engine installs around its dispatches (with the int8 pool's scale
#: sidecars and the prime-through-the-pool marker), and the learned
#: positional table's offset. (Masked-stream kv_mask and the rolling
#: cache's kv_abs come with their features: ROADMAP.md A6.)
STREAM_STATE_KEYS = frozenset(
    {"h", "c", "kv_k", "kv_v", "kv_pos", "kv_page_k", "kv_page_v",
     "kv_page_table", "kv_page_scale_k", "kv_page_scale_v",
     "kv_page_prime", "pos_offset"})

#: streaming-state keys whose LEADING axis is the batch dimension (beam
#: search gathers these when pruning beams; kv_pos is a batch-independent
#: scalar unless a per-row rewind made it ``[N]``)
BATCHED_STREAM_KEYS = frozenset({"h", "c", "kv_k", "kv_v"})


def stream_capacity(layers):
    """Smallest streaming-position capacity over `layers` (None if
    unbounded): max_length and cache_length both cap."""
    limit = None
    for l in layers:
        if not getattr(l, "supports_streaming", False):
            continue
        for cap in (getattr(l, "max_length", 0),
                    getattr(l, "cache_length", 0)):
            if cap:
                limit = cap if limit is None else min(limit, cap)
    return limit


def reorder_stream_state(net, indices) -> None:
    """Gather the batch dimension of every carried streaming-state tensor
    (beam search's pruning: surviving beam b continues from parent
    ``indices[b]``'s caches and h / c; the JAX package's
    ``reorder_stream_state``). ``indices``: an int array ``[new_batch]``.
    ``kv_pos`` is a batch-independent scalar unless a per-row rewind
    made it ``[N]``, and is then gathered like the caches, so each row
    keeps its own position; the host row-position mirror follows."""
    idx = np.array(indices, np.int64)
    dev = {}
    for name, s in net.state.items():
        if not isinstance(s, dict):
            continue
        out = dict(s)
        for k, v in s.items():
            if torch.is_tensor(v) and (k in BATCHED_STREAM_KEYS or (
                    k == "kv_pos" and v.dim() >= 1)):
                if v.device not in dev:
                    dev[v.device] = torch.as_tensor(idx, device=v.device)
                out[k] = v[dev[v.device]]
        net.state[name] = out
    rows = getattr(net, "_stream_pos_rows", None)
    if rows is not None:         # the host row-position mirror follows
        net._stream_pos_rows = np.asarray(rows)[idx]


def rewind_stream_state(net, n) -> None:
    """Rewind the last ``n`` streamed positions (speculative decoding's
    rollback; the JAX package's ``rewind_stream_state``): the position
    counters (attention ``kv_pos``, the learned positional table's
    ``pos_offset``) move back by ``n``, so the rejected cache slots drop
    out of every position-validity mask and the next write overwrites
    them: a rewound stream is the stream that never saw those tokens.

    ``n`` is an int (every row together) or an int array ``[N]`` (a
    per-row rewind: the engine's verify, where each row accepts its own
    prefix). A per-row rewind turns a scalar ``kv_pos`` into an ``[N]``
    vector, which the attention layer's streaming path already takes (a
    row writes its next chunk at its own slots); a learned positional
    table's ``pos_offset`` is shared, so a net with one refuses an array
    rewind. Every layer's counter moves in one stacked update (three
    launches whatever the depth; the JAX package jits one dispatch),
    with ``n`` copied to the device once.

    Recurrent ``h`` / ``c`` cannot rewind: nets with LSTM layers raise
    (:func:`check_rewindable`). The host mirrors follow: the per-row
    positions (``net._stream_pos_rows``, made by a per-row rewind and
    advanced by ``rnn_time_step``) and the budget counters
    (``_stream_pos``, ``_stream_pos_map``), by how far the furthest row
    moved back."""
    per_row = np.ndim(n) > 0
    if per_row:
        n = np.asarray(n, np.int64)
        if not n.any():
            return
    else:
        n = int(n)
        if n == 0:
            return
    check_rewindable(net, int(np.max(n)) if per_row else n)
    moved, counters = {}, []
    for name, s in net.state.items():
        if not isinstance(s, dict):
            continue
        for k in ("kv_pos", "pos_offset"):
            if k not in s:
                continue
            if per_row and k == "pos_offset":
                raise ValueError(
                    "per-row rewind is attention-only: learned "
                    "positional tables carry a shared pos_offset "
                    "(use a rope or position-free model)")
            if torch.is_tensor(s[k]):
                counters.append(((name, k), s[k]))
            else:                        # pos_offset: a host int
                moved[name, k] = max(0, int(s[k]) - n)
    if counters:
        vals = [v for _, v in counters]
        amount = torch.as_tensor(n, dtype=vals[0].dtype,
                                 device=vals[0].device)
        # a per-row amount turns a scalar kv_pos into [N]
        shape = torch.broadcast_shapes(amount.shape,
                                       *(v.shape for v in vals))
        stacked = torch.stack([v.expand(shape) for v in vals])
        moved.update(zip((ref for ref, _ in counters),
                         torch.sub(stacked, amount).clamp_(min=0)))
    for (name, k), v in moved.items():
        net.state[name] = {**net.state[name], k: v}
    rows = getattr(net, "_stream_pos_rows", None)
    if per_row:
        if rows is None or len(rows) != len(n):
            base = getattr(net, "_stream_pos", None)
            if base is None:
                pm0 = getattr(net, "_stream_pos_map", None) or {}
                base = max(pm0.values(), default=0)
            rows = np.full(len(n), base, np.int64)
        new_rows = np.maximum(rows - n, 0)
        net._stream_pos_rows = new_rows
        n_scalar = int(rows.max()) - int(new_rows.max())
    else:
        n_scalar = n
        if rows is not None:
            net._stream_pos_rows = np.maximum(rows - n, 0)
    if getattr(net, "_stream_pos", None) is not None:
        net._stream_pos = max(0, net._stream_pos - n_scalar)
    pm = getattr(net, "_stream_pos_map", None)
    if pm:
        net._stream_pos_map = {k: max(0, v - n_scalar)
                               for k, v in pm.items()}


def check_rewindable(net, n: int) -> None:
    """Whether ``net`` can rewind up to ``n`` streamed positions (the
    preconditions of :func:`rewind_stream_state`; the engine checks once,
    at construction, with ``n = gamma + 1``): recurrent ``h`` / ``c``
    state, carried or to be carried, cannot rewind."""
    if n < 0:
        raise ValueError(f"rewind must be >= 0, got {n}")
    for s in net.state.values():
        if isinstance(s, dict) and ("h" in s or "c" in s):
            raise ValueError(
                "rewind_stream_state: recurrent h/c streaming state "
                "cannot be rewound (LSTM layers do not support "
                "speculative rollback)")
    layers = list(getattr(net, "layers", None) or []) or [
        getattr(v, "layer", None)
        for v in (getattr(net.conf, "vertices", None) or {}).values()]
    for l in layers:
        # a freshly cleared stream carries no h / c yet, but the layer
        # will as soon as it streams
        if getattr(l, "carries_recurrent_state", False):
            raise ValueError(
                "rewind_stream_state: recurrent h/c streaming state "
                "cannot be rewound (LSTM layers do not support "
                "speculative rollback)")


@dataclass
class LayerConf:
    """Base for all layer configs. ``dropout`` is the RETAIN probability
    applied to the layer's input in training (DL4J's semantics; 0.0 turns
    it off), or an ``IDropout``; ``weight_noise`` an ``IWeightNoise`` on
    the layer's parameters in training; ``constraints`` projected after
    each update."""

    name: Optional[str] = None
    dropout: Any = 0.0
    weight_noise: Any = None
    constraints: Any = None

    def output_type(self, it: InputType) -> InputType:
        return it

    def init(self, gen: torch.Generator, it: InputType, device):
        """Return (params, state) dicts for this layer."""
        return {}, {}

    def apply(self, params, x, state, *, train=False, gen=None):
        """Return (y, new_state). ``train`` selects the training form
        (batch statistics in BatchNormalization, input dropout from the
        generator ``gen``)."""
        raise NotImplementedError

    def draws_in_training(self) -> bool:
        """Whether a training step draws for this layer: its dropout or
        its weight noise."""
        d = self.dropout
        return self.weight_noise is not None or \
            hasattr(d, "apply_dropout") or \
            (isinstance(d, (int, float)) and 0.0 < d < 1.0)

    def maybe_dropout_input(self, x, train, gen):
        """``x`` after this layer's input dropout in training (with a
        generator), else ``x`` itself."""
        if not train or gen is None:
            return x
        if hasattr(self.dropout, "apply_dropout"):
            return self.dropout.apply_dropout(x, gen)
        if isinstance(self.dropout, (int, float)) and \
                0.0 < self.dropout < 1.0:
            keep = self.dropout
            return _dropout.inverted_dropout(
                x, _dropout.bernoulli(keep, x, gen), keep)
        return x

    # regularization coefficients collected by the network loss
    def l1_coeffs(self):
        return {}

    def l2_coeffs(self):
        return {}


@dataclass
class BaseLayerConf(LayerConf):
    """Base for parameterized layers: activation, weight init (``dist``:
    the ``"distribution"`` scheme's dict), bias init and L1/L2
    regularization. As in the JAX package the coefficients reach the
    parameters named ``W``, ``RW`` (``l1``/``l2``) and ``b``
    (``l1_bias``/``l2_bias``) only. ``learning_rate`` and ``updater``
    are carried as the JAX package carries them: serialized, and read by
    neither package's ``fit``."""

    activation: str = "identity"
    weight_init: str = "xavier"
    dist: Optional[dict] = None
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    learning_rate: Optional[float] = None
    updater: Optional[dict] = None

    def l1_coeffs(self):
        return _coeffs(self.l1, self.l1_bias)

    def l2_coeffs(self):
        return _coeffs(self.l2, self.l2_bias)


def _coeffs(weight, bias):
    d = {}
    if weight:
        d["W"] = d["RW"] = weight
    if bias:
        d["b"] = bias
    return d


@dataclass
class FeedForwardLayerConf(BaseLayerConf):
    n_in: Optional[int] = None
    n_out: Optional[int] = None


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _bias(layer, has_bias, device):
    """``{"b": bias_init everywhere}`` of ``n_out`` elements, or none."""
    return {"b": torch.full((layer.n_out,), float(layer.bias_init),
                            device=device)} if has_bias else {}


# ---------------------------------------------------------------------
# feed-forward layers
# ---------------------------------------------------------------------
@dataclass
class DenseLayer(FeedForwardLayerConf):
    """Fully connected: ``x @ W + b``, W ``[n_in, n_out]``."""

    has_bias: bool = True

    def output_type(self, it):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, it, device):
        if self.n_in is None:
            self.n_in = it.flat_size()
        w = init_weights(gen, (self.n_in, self.n_out), self.n_in,
                         self.n_out, self.weight_init, device, self.dist)
        return {"W": w, **_bias(self, self.has_bias, device)}, {}

    def apply(self, params, x, state, *, train=False, gen=None):
        x = self.maybe_dropout_input(x, train, gen)
        y = x @ params["W"]
        if self.has_bias:
            y = y + params["b"]
        return _act.get(self.activation)(y), state


@dataclass
class EmbeddingLayer(FeedForwardLayerConf):
    """Embedding lookup: the input a column of indices (``[N]`` or ``[N,
    1]``), the output ``W[idx] (+ b)``, W ``[n_in, n_out]``."""

    has_bias: bool = True

    def output_type(self, it):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, it, device):
        if self.n_in is None:
            self.n_in = it.flat_size()
        w = init_weights(gen, (self.n_in, self.n_out), self.n_in,
                         self.n_out, self.weight_init, device, self.dist)
        return {"W": w, **_bias(self, self.has_bias, device)}, {}

    def apply(self, params, x, state, *, train=False, gen=None):
        idx = x.to(torch.int32)
        if idx.dim() == 2:
            idx = idx[:, 0]
        y = params["W"][idx.long()]
        if self.has_bias:
            y = y + params["b"]
        return _act.get(self.activation)(y), state


@dataclass
class ActivationLayer(LayerConf):
    """A standalone activation."""

    activation: str = "relu"

    def apply(self, params, x, state, *, train=False, gen=None):
        return _act.get(self.activation)(x), state


@dataclass
class DropoutLayer(LayerConf):
    """Dropout as a layer of its own: ``dropout`` is the retain
    probability (0.5 unless set)."""

    def __post_init__(self):
        if self.dropout == 0.0:
            self.dropout = 0.5

    def apply(self, params, x, state, *, train=False, gen=None):
        return self.maybe_dropout_input(x, train, gen), state


# ---------------------------------------------------------------------
# convolutional layers
# ---------------------------------------------------------------------
@dataclass
class ConvolutionLayer(FeedForwardLayerConf):
    """2-D convolution; W ``[O, I, kH, kW]`` whatever the activation
    layout (``nn/layers/convolution.py``)."""

    kernel: Sequence[int] = (3, 3)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)
    dilation: Sequence[int] = (1, 1)
    convolution_mode: str = "truncate"
    has_bias: bool = True
    data_format: str = "NCHW"

    def output_type(self, it):
        if it.kind != "cnn":
            raise ValueError(f"ConvolutionLayer needs CNN input, got {it}")
        (kh, kw), (sh, sw) = _pair(self.kernel), _pair(self.stride)
        (ph, pw), (dh, dw) = _pair(self.padding), _pair(self.dilation)
        oh = _conv.conv_out_size(it.height, kh, sh, ph, dh,
                                 self.convolution_mode)
        ow = _conv.conv_out_size(it.width, kw, sw, pw, dw,
                                 self.convolution_mode)
        return InputType.convolutional(oh, ow, self.n_out)

    def init(self, gen, it, device):
        if self.n_in is None:
            self.n_in = it.channels
        kh, kw = _pair(self.kernel)
        w = init_weights(gen, (self.n_out, self.n_in, kh, kw),
                         self.n_in * kh * kw, self.n_out * kh * kw,
                         self.weight_init, device, self.dist)
        return {"W": w, **_bias(self, self.has_bias, device)}, {}

    def apply(self, params, x, state, *, train=False, gen=None):
        x = self.maybe_dropout_input(x, train, gen)
        y = _conv.conv2d(x, params["W"], params.get("b"),
                         _pair(self.stride), _pair(self.padding),
                         _pair(self.dilation), self.convolution_mode,
                         self.data_format)
        return _act.get(self.activation)(y), state


@dataclass
class SubsamplingLayer(LayerConf):
    """2-D pooling: max, avg or sum (pnorm pooling, whose exponent
    ``pnorm`` is carried, ports with the breadth layers, ROADMAP.md
    A11)."""

    pooling_type: str = "max"
    kernel: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: Sequence[int] = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: float = 2.0
    data_format: str = "NCHW"

    def output_type(self, it):
        (kh, kw), (sh, sw) = _pair(self.kernel), _pair(self.stride)
        ph, pw = _pair(self.padding)
        oh = _conv.conv_out_size(it.height, kh, sh, ph, 1,
                                 self.convolution_mode)
        ow = _conv.conv_out_size(it.width, kw, sw, pw, 1,
                                 self.convolution_mode)
        return InputType.convolutional(oh, ow, it.channels)

    def apply(self, params, x, state, *, train=False, gen=None):
        k, s, p = _pair(self.kernel), _pair(self.stride), _pair(self.padding)
        pt = self.pooling_type.lower()
        args = (x, k, s, p, self.convolution_mode)
        df = {"data_format": self.data_format}
        if pt == "max":
            return _conv.max_pool2d(*args, **df), state
        if pt == "avg":
            return _conv.avg_pool2d(*args, **df), state
        if pt == "sum":
            return _conv.avg_pool2d(*args, **df) * (k[0] * k[1]), state
        if pt == "pnorm":
            raise NotImplementedError("pnorm pooling is not ported yet "
                                      "(ROADMAP.md A11)")
        raise ValueError(f"unknown pooling type {self.pooling_type}")


@dataclass
class ZeroPaddingLayer(LayerConf):
    """Zero padding ``[top, bottom, left, right]`` (two values: ``[top
    and bottom, left and right]``)."""

    padding: Sequence[int] = (0, 0, 0, 0)
    data_format: str = "NCHW"

    def _pads(self):
        p = list(self.padding)
        if len(p) == 2:
            p = [p[0], p[0], p[1], p[1]]
        return p

    def output_type(self, it):
        t, b, l, r = self._pads()
        return InputType.convolutional(it.height + t + b, it.width + l + r,
                                       it.channels)

    def apply(self, params, x, state, *, train=False, gen=None):
        return _conv.zero_pad2d(x, self._pads(), self.data_format), state


@dataclass
class GlobalPoolingLayer(LayerConf):
    """Global pooling over the spatial axes of CNN input (``[N, C, H,
    W]``, or ``[N, H, W, C]`` under internal NHWC) or the time axis of
    unmasked RNN input: max, avg, sum or pnorm. An avg in bf16
    accumulates in f32 and rounds once, as ``jnp.mean`` does.
    ``collapse_dimensions`` is carried; the JAX layer always collapses
    too."""

    pooling_type: str = "max"
    pnorm: float = 2.0
    collapse_dimensions: bool = True
    data_format: str = "NCHW"

    def output_type(self, it):
        if it.kind == "rnn":
            return InputType.feed_forward(it.size)
        if it.kind == "cnn":
            return InputType.feed_forward(it.channels)
        return it

    def apply(self, params, x, state, *, train=False, gen=None):
        if x.dim() == 4:
            axes = (2, 3) if self.data_format == "NCHW" else (1, 2)
        else:
            axes = tuple(range(2, x.dim()))
        pt = self.pooling_type.lower()
        if pt == "max":
            return x.amax(dim=axes), state
        if pt == "avg":
            return x.mean(dim=axes), state
        if pt == "sum":
            return x.sum(dim=axes), state
        if pt == "pnorm":
            return (x.abs() ** self.pnorm).sum(dim=axes) ** (
                1.0 / self.pnorm), state
        raise ValueError(f"unknown pooling type {self.pooling_type}")


@dataclass
class BatchNormalization(FeedForwardLayerConf):
    """Batch norm with the running statistics as state (``mean``,
    ``var``, f32): eps 1e-5, decay 0.9, gamma 1, beta 0 as in the JAX
    package. Its parameters and state are cast to x's dtype first, as the
    JAX layer does. Inference normalizes with the running statistics and
    returns the state as it is; training (``train=True``) normalizes with
    the batch statistics and returns the decayed running statistics in
    f32, detached (no step's autograd graph stays alive in the state)."""

    eps: float = 1e-5
    decay: float = 0.9
    lock_gamma_beta: bool = False
    gamma: float = 1.0
    beta: float = 0.0
    data_format: str = "NCHW"

    def _nf(self, it):
        return it.channels if it.kind == "cnn" else it.flat_size()

    def init(self, gen, it, device):
        nf = self._nf(it)
        self.n_in = self.n_out = nf
        params = {}
        if not self.lock_gamma_beta:
            params = {"gamma": torch.full((nf,), self.gamma, device=device),
                      "beta": torch.full((nf,), self.beta, device=device)}
        return params, {"mean": torch.zeros(nf, device=device),
                        "var": torch.ones(nf, device=device)}

    def apply(self, params, x, state, *, train=False, gen=None):
        nf = state["mean"].shape[0]
        gamma = params.get("gamma")
        beta = params.get("beta")
        if gamma is None:
            gamma = torch.full((nf,), self.gamma, device=x.device)
            beta = torch.full((nf,), self.beta, device=x.device)
        ch_axis = 3 if (self.data_format == "NHWC" and x.dim() == 4) else 1
        y, new_mean, new_var = _norm.batch_norm(
            x, gamma.to(x.dtype), beta.to(x.dtype),
            state["mean"].to(x.dtype), state["var"].to(x.dtype), train,
            self.eps, self.decay, channel_axis=ch_axis)
        if train:
            state = {"mean": new_mean.detach().float(),
                     "var": new_var.detach().float()}
        return _act.get(self.activation)(y), state


@dataclass
class Convolution1DLayer(FeedForwardLayerConf):
    """1-D convolution over ``[N, C, T]``, ported for kernel 1, stride 1,
    padding 0 and dilation 1 (the position-wise matmul the transformer
    uses, where every convolution mode gives the same result), with or
    without a bias. W is ``[n_out, n_in, kernel]`` as in the JAX
    package."""

    kernel: int = 1
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def __post_init__(self):
        if (self.kernel, self.stride, self.padding, self.dilation) != \
                (1, 1, 0, 1):
            raise NotImplementedError(
                "Convolution1DLayer is ported for kernel=1, stride=1, "
                "padding=0, dilation=1 only (the transformer's "
                "position-wise projections); general 1-D convolution is "
                "ROADMAP.md A11")
        if self.convolution_mode not in ("truncate", "same", "strict",
                                         "causal"):
            raise ValueError(f"unknown convolution mode "
                             f"{self.convolution_mode!r}")

    def output_type(self, it):
        return InputType.recurrent(self.n_out, it.timesteps)

    def init(self, gen, it, device):
        if self.n_in is None:
            self.n_in = it.size
        w = init_weights(gen, (self.n_out, self.n_in, 1), self.n_in,
                         self.n_out, self.weight_init, device, self.dist)
        return {"W": w, **_bias(self, self.has_bias, device)}, {}

    def apply(self, params, x, state, *, train=False, gen=None):
        x = self.maybe_dropout_input(x, train, gen)
        # one [N*T, C] x [C, O] product
        y = x.transpose(1, 2) @ params["W"][:, :, 0].t()
        if self.has_bias:
            y = y + params["b"]
        return _act.get(self.activation)(y.transpose(1, 2)), state


@dataclass
class LayerNormalization(FeedForwardLayerConf):
    """Layer normalization over the feature axis (axis 1 of ``[N, F]``
    and ``[N, F, T]``), statistics in f32 whatever the compute dtype."""

    eps: float = 1e-5

    def init(self, gen, it, device):
        nf = it.size
        self.n_in = self.n_out = nf
        return {"gamma": torch.ones(nf, device=device),
                "beta": torch.zeros(nf, device=device)}, {}

    def apply(self, params, x, state, *, train=False, gen=None):
        xf = x.float() if x.dtype != torch.float64 else x
        mean = xf.mean(dim=1, keepdim=True)
        var = ((xf * xf).mean(dim=1, keepdim=True)
               - mean * mean).clamp_min(0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)
        shape = [1] * x.dim()
        shape[1] = -1
        y = y * params["gamma"].to(x.dtype).reshape(shape) + \
            params["beta"].to(x.dtype).reshape(shape)
        return _act.get(self.activation)(y), state


@dataclass
class PositionalEmbeddingLayer(FeedForwardLayerConf):
    """Adds a learned positional embedding ``P [F, max_length]`` to
    ``[N, F, T]`` input (initialised ``0.02 * N(0, 1)``). A whole-sequence
    forward longer than ``max_length`` is refused.

    Streaming (``rnn_time_step``) carries ``pos_offset``, so each chunk
    gets the embeddings of its absolute positions; the network's stream
    budget guard keeps ``pos_offset + T`` within ``max_length``. A
    left-padded chunk never reaches the layer: ``rnn_time_step`` drops
    the pads first, so they take no position (the JAX package's packed
    accounting)."""

    max_length: int = 1024

    supports_streaming = True

    def output_type(self, it):
        if it.kind != "rnn":
            raise ValueError("PositionalEmbeddingLayer needs RNN input")
        return it

    def init(self, gen, it, device):
        self.n_in = self.n_out = it.size
        p = 0.02 * torch.randn((it.size, self.max_length), generator=gen)
        return {"P": p.to(device)}, {}

    def apply(self, params, x, state, stream=False, *, train=False,
              gen=None):
        t = x.shape[2]
        if t > self.max_length:
            raise ValueError(f"sequence length {t} exceeds max_length "
                             f"{self.max_length}")
        if stream:
            off = int(state.get("pos_offset", 0))
            emb = params["P"][:, off:off + t]
            state = {**state, "pos_offset": off + t}
        else:
            emb = params["P"][:, :t]
        y = x + emb[None].to(x.dtype)
        return _act.get(self.activation)(y), state


@dataclass
class SelfAttentionLayer(FeedForwardLayerConf):
    """Causal multi-head self-attention over ``[N, F, T]``.

    Params Wq/Wk/Wv/Wo ``[n_in, n_out]`` (Wk/Wv ``[n_in, Hkv*D]`` under
    grouped-query attention, ``n_kv_heads`` < ``n_heads``) and their
    biases. ``rope=True`` rotates q/k by absolute position
    (rotate-half convention). With ``cache_length`` set the layer
    streams: ``apply(..., stream=True)`` appends the chunk's K/V to the
    carried cache and attends against it (:meth:`_stream_attend`).
    ``block_size`` is kept for parity with the JAX conf; as on the JAX
    package's kernel path, nothing reads it (the kernels pick their own
    tiles)."""

    n_heads: int = 4
    causal: bool = True
    block_size: int = 512
    cache_length: int = 0
    n_kv_heads: Optional[int] = None
    rope: bool = False
    rope_base: float = 10000.0
    window: Optional[int] = None

    supports_streaming = True

    def output_type(self, it):
        if it.kind != "rnn":
            raise ValueError("SelfAttentionLayer needs RNN input [N,F,T]")
        return InputType.recurrent(self.n_out or it.size, it.timesteps)

    def init(self, gen, it, device):
        if self.window is not None:
            raise NotImplementedError(
                "sliding-window attention (rolling KV cache) is not "
                "ported yet (ROADMAP.md A6)")
        if self.n_in is None:
            self.n_in = it.size
        if self.n_out is None:
            self.n_out = self.n_in
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out {self.n_out} not divisible by "
                             f"n_heads {self.n_heads}")
        if self.n_kv_heads is not None and self.n_kv_heads < 1:
            raise ValueError(f"n_kv_heads must be >= 1, got "
                             f"{self.n_kv_heads}")
        hkv = self.n_kv_heads or self.n_heads
        if self.n_heads % hkv:
            raise ValueError(f"n_heads {self.n_heads} not divisible by "
                             f"n_kv_heads {hkv}")
        d = self.n_out // self.n_heads
        if self.rope and d % 2:
            raise ValueError(f"rope needs an even head dim, got {d}")
        p = {}
        for name in ("q", "k", "v", "o"):
            n_in = self.n_in if name != "o" else self.n_out
            n_out = hkv * d if name in ("k", "v") else self.n_out
            p["W" + name] = init_weights(gen, (n_in, n_out), n_in, n_out,
                                         self.weight_init, device, self.dist)
            p["b" + name] = torch.zeros(n_out, device=device)
        return p, {}

    def apply(self, params, x, state, stream=False, *, train=False,
              gen=None):
        x = self.maybe_dropout_input(x, train, gen)
        n, _, t = x.shape
        h = self.n_heads
        hkv = self.n_kv_heads or h
        d = self.n_out // h
        xt = x.transpose(1, 2)                              # [N,T,F]

        def proj(name, heads):
            y = xt @ params["W" + name] + params["b" + name]
            return y.reshape(n, t, heads, d).transpose(1, 2)

        q = proj("q", h)                                    # [N,H,T,D]
        k, v = proj("k", hkv), proj("v", hkv)               # [N,Hkv,T,D]
        if stream:
            o, state = self._stream_attend(q, k, v, state)
        else:
            if self.rope:
                pos = torch.arange(t, device=x.device)
                q, k = self._rope(q, pos), self._rope(k, pos)
            k, v = self._expand_kv(k, v)
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=self.causal)
        o = o.transpose(1, 2).reshape(n, t, self.n_out)
        o = o @ params["Wo"] + params["bo"]
        return _act.get(self.activation)(o.transpose(1, 2)), state

    def _expand_kv(self, k, v):
        """Repeat K/V heads up to n_heads for grouped-query attention
        (no-op for standard MHA)."""
        reps = self.n_heads // k.shape[1]
        if reps == 1:
            return k, v
        return (k.repeat_interleave(reps, dim=1),
                v.repeat_interleave(reps, dim=1))

    def _stream_attend(self, q, k, v, state):
        """Incremental decode against the dense cache: append the
        chunk's K/V at its positions, attend q against the cache.

        A scalar ``kv_pos`` (one stream, e.g. a batch-1 prime) writes
        the chunk at ``pos .. pos + T``; the stream-budget guard in
        ``ComputationGraph.rnn_time_step`` keeps that inside the cache.
        A per-row ``kv_pos`` (the engine's slot arena) writes each row
        at its own slots; rows past ``cache_length`` (free slots whose
        position coasts) keep their cache unchanged. The cache is
        updated in place."""
        if self.cache_length <= 0:
            raise ValueError(
                "SelfAttentionLayer streaming needs cache_length > 0")
        if not self.causal:
            raise ValueError("streaming decode requires causal=True")
        if state.get("kv_page_table") is not None:
            return self._stream_attend_paged(q, k, v, state)
        n, _, t, d = q.shape
        hkv = k.shape[1]
        L = self.cache_length
        kc = state.get("kv_k")
        if kc is None:
            kc = q.new_zeros((n, hkv, L, d))
            vc = q.new_zeros((n, hkv, L, d))
            pos = torch.zeros((), dtype=torch.int32, device=q.device)
        else:
            vc, pos = state["kv_v"], state["kv_pos"]
        steps = torch.arange(t, dtype=pos.dtype, device=q.device)
        k_idx = torch.arange(L, device=q.device)
        if pos.dim() >= 1:
            q_pos = pos[:, None] + steps                    # [N, T]
            if self.rope:
                q, k = self._rope(q, q_pos), self._rope(k, q_pos)
            inside = (q_pos < L)[..., None, None]
            slot = q_pos.clamp(max=L - 1).long()
            rows = torch.arange(n, device=q.device)[:, None]
            for cache, new in ((kc, k), (vc, v)):
                new = new.transpose(1, 2).to(cache.dtype)   # [N,T,Hkv,D]
                cache[rows, :, slot] = torch.where(
                    inside, new, cache[rows, :, slot])
            valid = k_idx[None, None, :] <= q_pos[..., None]  # [N, T, L]
        else:
            q_pos = pos + steps                             # [T]
            if self.rope:
                q, k = self._rope(q, q_pos), self._rope(k, q_pos)
            kc.index_copy_(2, q_pos.long(), k.to(kc.dtype))
            vc.index_copy_(2, q_pos.long(), v.to(vc.dtype))
            valid = (k_idx[None, :] <= q_pos[:, None])[None]  # [1, T, L]
        o = self._grouped_attend(q, kc, vc, valid)
        return o, {**state, "kv_k": kc, "kv_v": vc, "kv_pos": pos + t}

    def _stream_attend_paged(self, q, k, v, state):
        """Direct paged decode: K/V live in the engine's block-paged pool
        (``kv_page_k`` / ``kv_page_v``) and the per-row page table
        (``kv_page_table``, 0 = the null page). The chunk's tokens are
        appended first, in place, at each row's ``(page, offset)``; then
        the queries attend through the table with the paged-attention
        kernel (``serving/paged_kernel.py``; its plain version on the
        CPU).

        Appends past a row's capacity, and those of free rows (whose
        table rows are all 0), land on the null page 0. Duplicate writes
        there are harmless (and on CUDA their order is not defined):
        every row's length masks page 0 out of what it reads.
        Prefix-shared pages are read-only by block alignment: a row
        appends only at positions at or past its own fresh blocks.

        Two extensions of the state, as in the JAX package:

        - ``kv_page_scale_k`` / ``_v`` present: the pool is int8 with
          per-(page, head) scale sidecars (``serving/quant.py``). The
          chunk is quantized by :func:`quantize_chunk` (each page under
          its base token's scale) and written as int8; the sidecars are
          updated in place and ride the returned state; reads
          dequantize.
        - ``kv_page_prime`` present: the chunk is the engine's batch-1
          prime through the pool (the int8 path: quantize-once means the
          prompt's pool bytes come from the same quantized append the
          decode steps run). Prefix-shared positions (``q_pos < pos``)
          route to the null page, and the read is the dequantize-in-the-
          gather path written here (dequantize to ``q.dtype``, exact,
          then :meth:`_grouped_attend`), the counterpart of the JAX
          package's XLA read for the prime, not the kernel's plain
          version. The port's prime is unpadded (``rnn_time_step`` drops
          pads before the forward), so the JAX package's ``pad_left``
          packing has nothing to do here.
        """
        from deeplearning4j_tpu_torch.serving.paged_kernel import (
            paged_attention)
        from deeplearning4j_tpu_torch.serving.quant import quantize_chunk
        kp, vp = state["kv_page_k"], state["kv_page_v"]
        table = state["kv_page_table"]
        ksc, vsc = state.get("kv_page_scale_k"), state.get("kv_page_scale_v")
        quant = ksc is not None
        prime = state.get("kv_page_prime") is not None
        pos = state.get("kv_pos")
        if pos is None or pos.dim() < 1:
            raise ValueError(
                "direct paged decode needs the per-row kv_pos vector "
                "(the engine arena carries one)")
        n, hkv, t, d = k.shape
        L = self.cache_length
        ps = kp.shape[2]
        q_pos = pos[:, None] + torch.arange(t, dtype=pos.dtype,
                                            device=q.device)
        if self.rope:
            q, k = self._rope(q, q_pos), self._rope(k, q_pos)
        blk = (q_pos // ps).clamp(0, table.shape[1] - 1).long()
        page = table.gather(1, blk)
        writable = q_pos < L                 # past capacity: the null page
        if prime:
            # shared prefix pages are read in place, never rewritten
            writable = writable & (q_pos >= pos[:, None])
        page = torch.where(writable, page, torch.zeros_like(page)).long()
        off = (q_pos % ps).long()
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)       # [N,T,Hkv,D]
        if quant:
            kt, _ = quantize_chunk(kt, ksc, page, q_pos, pos, writable,
                                   page_size=ps)
            vt, _ = quantize_chunk(vt, vsc, page, q_pos, pos, writable,
                                   page_size=ps)
        kp[page, :, off] = kt.to(kp.dtype)
        vp[page, :, off] = vt.to(vp.dtype)
        if prime:
            kd, vd = (self._paged_dense_view(pool, sc, table, q.dtype)
                      for pool, sc in ((kp, ksc), (vp, vsc)))
            valid = torch.arange(L, device=q.device)[None, None, :] \
                <= q_pos[..., None]                            # [N, T, L]
            o = self._grouped_attend(q, kd, vd, valid)
        else:
            reps = self.n_heads // hkv
            scales = dict(k_scales=ksc, v_scales=vsc) if quant else {}
            o = paged_attention(q.reshape(n, hkv, reps * t, d).contiguous(),
                                kp, vp, table, (pos + t).to(torch.int32),
                                query_width=t, **scales)
            o = o.reshape(n, self.n_heads, t, d)
        # the pools and sidecars, updated in place, ride the state
        return o, {**state, "kv_pos": pos + t}

    def _paged_dense_view(self, pool, scales, table, dtype):
        """The dense ``[N, Hkv, L, D]`` view of ``pool`` through
        ``table`` (the prime's read), an int8 pool dequantized under
        its scales to ``dtype`` (exact)."""
        from deeplearning4j_tpu_torch.serving.quant import dequantize
        idx = table.long()
        g = pool[idx]                                # [N, n_blk, Hkv, ps, D]
        if scales is not None:
            g = dequantize(g, scales[idx][:, :, :, None, None], dtype)
        n, nb, hkv, ps, d = g.shape
        return g.transpose(1, 2).reshape(n, hkv, nb * ps, d)[
            :, :, :self.cache_length].to(dtype)

    def _grouped_attend(self, q, kc, vc, valid):
        """Masked attention of ``[N,H,T,D]`` queries against the
        un-expanded ``[N,Hkv,L,D]`` cache (GQA groups share KV heads);
        valid: ``[N|1, T, L]``. f32 scores and softmax."""
        n, _, t, d = q.shape
        hkv = kc.shape[1]
        qg = q.float().reshape(n, hkv, self.n_heads // hkv, t, d)
        s = torch.einsum("ngrtd,ngld->ngrtl", qg,
                         kc.float()) / math.sqrt(d)
        s = s.masked_fill(~valid[:, None, None], NEG_INF)
        o = torch.einsum("ngrtl,ngld->ngrtd", torch.softmax(s, dim=-1),
                         vc.float())
        return o.reshape(n, self.n_heads, t, d).to(q.dtype)

    def _rope(self, x, positions):
        """Rotary position embedding (RoFormer rotate-half convention):
        x ``[N,H,T,D]``, positions ``[T]`` or per-row ``[N,T]``. Pairs
        channel i with i + D/2 and rotates by positions * base^(-2i/D);
        cos/sin are rounded to x's dtype, as in the JAX package."""
        half = x.shape[-1] // 2
        inv = self.rope_base ** (
            -torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = positions.float()[..., None] * inv          # [...,T,half]
        lead = (None, None) if ang.dim() == 2 else (slice(None), None)
        cos = ang.cos()[lead].to(x.dtype)
        sin = ang.sin()[lead].to(x.dtype)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------
# recurrent layers
# ---------------------------------------------------------------------
def _lstm_params(gen, n_in, h, forget_gate_bias_init, weight_init, device,
                 peephole, dist=None):
    """W ``[n_in, 4h]``, RW ``[h, 4h]`` (both with fans ``n_in + h`` and
    ``h``, as in the JAX package), b ``[4h]`` zero but for the forget
    gate's slice, and with ``peephole`` P ``[3, h]`` zero."""
    w = init_weights(gen, (n_in, 4 * h), n_in + h, h, weight_init, device,
                     dist)
    rw = init_weights(gen, (h, 4 * h), n_in + h, h, weight_init, device,
                      dist)
    b = torch.zeros(4 * h, device=device)
    b[h:2 * h] = forget_gate_bias_init
    p = {"W": w, "RW": rw, "b": b}
    if peephole:
        p["P"] = torch.zeros((3, h), device=device)
    return p


@dataclass
class LSTM(FeedForwardLayerConf):
    """LSTM without peepholes over ``[N, C, T]``: W ``[n_in, 4 n_out]``,
    RW ``[n_out, 4 n_out]``, b ``[4 n_out]``, gate order (i, f, c, o),
    the forget gate's bias at ``forget_gate_bias_init``. The recurrence
    runs the LSTM kernels with sigmoid gates and a tanh cell, and the JAX
    scan's step-by-step math with any other activations
    (``nn/layers/recurrent.py``). The
    layer carries ``h`` / ``c`` in its state: a forward starts from the
    carried ones if the network passes them (streaming, truncated BPTT)
    and returns the last step's."""

    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"
    activation: str = "tanh"

    _peephole = False
    #: streams through an h / c carry that cannot be rewound
    carries_recurrent_state = True
    #: apply takes a [N, T] mask
    takes_mask = True

    def output_type(self, it):
        return InputType.recurrent(self.n_out, it.timesteps)

    def init(self, gen, it, device):
        if self.n_in is None:
            self.n_in = it.size
        return _lstm_params(gen, self.n_in, self.n_out,
                            self.forget_gate_bias_init, self.weight_init,
                            device, self._peephole, self.dist), {}

    def apply(self, params, x, state, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout_input(x, train, gen)
        out, h_t, c_t = _rnn.lstm_scan(
            x, params["W"], params["RW"], params["b"], h0=state.get("h"),
            c0=state.get("c"), peephole=params.get("P"), mask=mask,
            gate_act=self.gate_activation, cell_act=self.activation)
        return out, {**state, "h": h_t, "c": c_t}


@dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections: P ``[3, n_out]``, rows (pI, pF,
    pO); pO reads the new cell."""

    _peephole = True


@dataclass
class GravesBidirectionalLSTM(FeedForwardLayerConf):
    """A forward and a reversed GravesLSTM over the same input, their
    outputs SUMMED (width ``n_out``): WF, RWF, bF, PF and their ``B``
    twins. It carries no streaming state."""

    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"
    activation: str = "tanh"

    takes_mask = True

    def output_type(self, it):
        return InputType.recurrent(self.n_out, it.timesteps)

    def init(self, gen, it, device):
        if self.n_in is None:
            self.n_in = it.size
        p = {}
        for tag in ("F", "B"):
            for k, v in _lstm_params(gen, self.n_in, self.n_out,
                                     self.forget_gate_bias_init,
                                     self.weight_init, device, True,
                                     self.dist).items():
                p[k + tag] = v
        return p, {}

    def apply(self, params, x, state, *, train=False, gen=None, mask=None):
        x = self.maybe_dropout_input(x, train, gen)
        y = _rnn.bidirectional_sum(
            x, params["WF"], params["RWF"], params["bF"], params["WB"],
            params["RWB"], params["bB"], peep_f=params["PF"],
            peep_b=params["PB"], mask=mask, gate_act=self.gate_activation,
            cell_act=self.activation)
        return y, state


@dataclass
class OutputLayer(FeedForwardLayerConf):
    """Dense output layer ``x @ W + b`` (W ``[n_in, n_out]``), its
    activation and its loss (:meth:`compute_score`)."""

    loss: str = "mcxent"
    activation: str = "softmax"
    has_bias: bool = True

    def output_type(self, it):
        return InputType.feed_forward(self.n_out)

    def init(self, gen, it, device):
        if self.n_in is None:
            self.n_in = it.flat_size()
        w = init_weights(gen, (self.n_in, self.n_out), self.n_in,
                         self.n_out, self.weight_init, device, self.dist)
        return {"W": w, **_bias(self, self.has_bias, device)}, {}

    def preout(self, params, x, *, train=False, gen=None):
        x = self.maybe_dropout_input(x, train, gen)
        y = x @ params["W"]
        return y + params["b"] if self.has_bias else y

    def apply(self, params, x, state, *, train=False, gen=None):
        return _act.get(self.activation)(
            self.preout(params, x, train=train, gen=gen)), state

    def compute_score(self, labels, preout, mask=None):
        return _losses.score(labels, preout, self.loss, self.activation,
                             mask)


@dataclass
class RnnOutputLayer(FeedForwardLayerConf):
    """Per-timestep dense output over ``[N, C, T]``: W ``[n_in, n_out]``,
    b unless ``has_bias`` is False, the activation over the class axis,
    and its loss (:meth:`compute_score`)."""

    loss: str = "mcxent"
    activation: str = "softmax"
    has_bias: bool = True

    def output_type(self, it):
        return InputType.recurrent(self.n_out, it.timesteps)

    def init(self, gen, it, device):
        if self.n_in is None:
            self.n_in = it.size
        w = init_weights(gen, (self.n_in, self.n_out), self.n_in,
                         self.n_out, self.weight_init, device, self.dist)
        return {"W": w, **_bias(self, self.has_bias, device)}, {}

    def preout(self, params, x, *, train=False, gen=None):
        """The pre-activation output ``[N, O, T]``."""
        x = self.maybe_dropout_input(x, train, gen)
        y = x.transpose(1, 2) @ params["W"]                 # [N,T,O]
        if self.has_bias:
            y = y + params["b"]
        return y.transpose(1, 2)

    def apply(self, params, x, state, *, train=False, gen=None):
        return _act.get(self.activation)(
            self.preout(params, x, train=train, gen=gen)), state

    def compute_score(self, labels, preout, mask=None):
        """Mean loss over the examples with time folded into the batch:
        ``[N, C, T]`` to ``[N*T, C]``, a mask ``[N, T]`` to ``[N*T]``."""
        n, c, t = preout.shape
        p2 = preout.transpose(1, 2).reshape(n * t, c)
        l2 = labels.transpose(1, 2).reshape(n * t, c)
        m2 = mask.reshape(n * t) if mask is not None else None
        return _losses.score(l2, p2, self.loss, self.activation, m2)


# ---------------------------------------------------------------------
# registry and JSON
# ---------------------------------------------------------------------
LAYER_REGISTRY: Dict[str, type] = {c.__name__: c for c in (
    DenseLayer, EmbeddingLayer, ActivationLayer, DropoutLayer,
    ConvolutionLayer, Convolution1DLayer, SubsamplingLayer, ZeroPaddingLayer,
    GlobalPoolingLayer, BatchNormalization, LayerNormalization,
    PositionalEmbeddingLayer, SelfAttentionLayer, LSTM, GravesLSTM,
    GravesBidirectionalLSTM, OutputLayer, RnnOutputLayer)}


def layer_to_dict(layer: LayerConf) -> dict:
    """The JAX package's JSON form of a layer conf: ``{"@class": name}``
    and every field (tuples as lists; a dropout or weight noise object,
    and each constraint, as its own dict)."""
    d = {"@class": type(layer).__name__}
    for f in dataclasses.fields(layer):
        v = getattr(layer, f.name)
        if f.name == "constraints" and v:
            v = [c.to_dict() for c in v]
        elif hasattr(v, "to_dict") and f.name in ("dropout", "weight_noise"):
            v = v.to_dict()
        elif isinstance(v, tuple):
            v = list(v)
        d[f.name] = v
    return d


def layer_from_dict(d: dict) -> LayerConf:
    """The inverse of :func:`layer_to_dict`. A layer the port does not
    have, or a field it does not know, is refused
    (NotImplementedError)."""
    d = dict(d)
    name = d.pop("@class")
    cls = LAYER_REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(f"layer {name!r} is not ported yet "
                                  "(ROADMAP.md A11)")
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise NotImplementedError(f"{name} fields {unknown} are not ported "
                                  "yet (ROADMAP.md A11)")
    if isinstance(d.get("dropout"), dict):
        d["dropout"] = _dropout.dropout_from_dict(d["dropout"])
    if isinstance(d.get("weight_noise"), dict):
        d["weight_noise"] = _dropout.weight_noise_from_dict(
            d["weight_noise"])
    if d.get("constraints"):
        d["constraints"] = [constraint_from_dict(c) if isinstance(c, dict)
                            else c for c in d["constraints"]]
    return cls(**d)
