"""ComputationGraph: the DAG network runtime.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``init``, the
topological-order forward, ``output``, the streaming ``rnn_time_step``
/ ``rnn_clear_previous_state`` pair the decoders and the serving engine
drive, and training: ``fit`` over a DataSet, ``(features, labels)`` or
an iterator, one optimizer step per batch, and ``score``. PyTorch runs
eagerly, so there is no jit cache: each call runs the vertex loop
directly, and a train step is one autograd pass over it. Fused
multi-step dispatch, prefetch, execution plans, listeners and the
non-finite sentinel (ROADMAP.md A4, A5) and masks (A6) are refused.

Parameters live in ``net.params`` as ``{vertex: {name: tensor}}`` (f32
master weights) on ``net.device``; ``net.state`` carries the streaming
state in the same shape; ``net.updater_state`` the updater's. Under
``conf.dtype = "bfloat16"`` inference casts the parameters to bf16 once
and reuses the cast copy until ``net.params`` is replaced; training
casts them inside the differentiated loss on every step (the JAX
package's ``_cast_compute`` inside ``value_and_grad``), so the
gradients reach the f32 master weights, and takes the loss on the
output promoted to f32.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.compute import (
    bf16_cast, bf16_cast_tree, f32_head)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    STREAM_STATE_KEYS, stream_capacity)
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.updater import normalize_gradients, tree_map

__all__ = ["ComputationGraph"]

_BF16 = ("bfloat16", "bf16")


class ComputationGraph:
    """DAG network with fit, score, output and streaming inference."""

    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.params: Dict[str, Any] = {}
        self.state: Dict[str, Any] = {}
        self.updater_state: Dict[str, Any] = {}
        self.iteration_count = 0
        self.epoch_count = 0
        self._score_raw: Any = float("nan")
        #: the non-finite sentinel policy of the JAX package's fit
        #: loops; the port trains without the sentinel, and fit refuses
        #: a policy set here (ROADMAP.md A5)
        self.nonfinite_policy = None
        self.device = None
        self._initialized = False
        self._topo = conf.topological_order()
        self._vertex_input_types: Dict[str, List[InputType]] = {}
        #: streamed positions per streaming vertex (the budget guard)
        self._stream_pos_map: Dict[str, int] = {}
        self._compute = None       # (params, dtype, compute-dtype params)

    def _infer_types(self) -> Dict[str, InputType]:
        out_types: Dict[str, InputType] = dict(self.conf.input_types)
        for name in self._topo:
            ins = self.conf.vertex_inputs.get(name, [])
            missing = [i for i in ins if i not in out_types]
            if missing:
                raise ValueError(f"vertex {name}: missing input types for "
                                 f"{missing} (call set_input_types on the "
                                 "builder)")
            its = [out_types[i] for i in ins]
            self._vertex_input_types[name] = its
            out_types[name] = self.conf.vertices[name].output_type(its)
        return out_types

    def init(self, device=None):
        """Build the parameters from ``conf.seed`` on ``device``
        (default ``"cuda"``; raises without a CUDA device unless
        ``device="cpu"``)."""
        self.device = resolve_device(device)
        self._infer_types()
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        self.params, self.state = {}, {}
        for name in self._topo:
            p, s = self.conf.vertices[name].init(
                gen, self._vertex_input_types[name], self.device)
            self.params[name] = p
            self.state[name] = s
        self.updater_state = self.conf.updater.init_state(self.params)
        self._stream_pos_map = {}
        self._initialized = True
        return self

    @property
    def score_value(self) -> float:
        """The last fit batch's loss (read from the device on first
        access, then cached)."""
        if not isinstance(self._score_raw, float):
            self._score_raw = float(self._score_raw)
        return self._score_raw

    @score_value.setter
    def score_value(self, value) -> None:
        self._score_raw = value

    def add_listener(self, listener):
        raise NotImplementedError("training listeners are not ported yet "
                                  "(ROADMAP.md A5)")

    def set_listeners(self, *listeners):
        raise NotImplementedError("training listeners are not ported yet "
                                  "(ROADMAP.md A5)")

    def load_numpy_params(self, np_params) -> "ComputationGraph":
        """Replace the parameters with the JAX graph's ``net.params`` as
        nested numpy arrays (``{vertex: {name: array}}``, see
        ``util/convert.params_from_numpy``); names and shapes must match
        this graph's."""
        from deeplearning4j_tpu_torch.util.convert import params_from_numpy
        if not self._initialized:
            raise RuntimeError("init() the graph before loading params")
        new = params_from_numpy(np_params, self.device)
        want = {(v, k): tuple(t.shape) for v, p in self.params.items()
                for k, t in p.items()}
        got = {(v, k): tuple(t.shape) for v, p in new.items()
               for k, t in p.items()}
        if want != got:
            raise ValueError(
                f"parameter tree mismatch: missing "
                f"{sorted(set(want) - set(got))}, unexpected "
                f"{sorted(set(got) - set(want))}, shapes differ at "
                f"{sorted(k for k in set(want) & set(got) if want[k] != got[k])}")
        self.params = new
        return self

    def load_numpy_updater_state(self, np_state) -> "ComputationGraph":
        """Replace the updater state with the JAX graph's
        ``net.updater_state`` as numpy (``util/convert.
        updater_state_from_numpy``), to resume a JAX run here; its tree
        must match this graph's updater state."""
        from deeplearning4j_tpu_torch.util.convert import (
            updater_state_from_numpy)
        if not self._initialized:
            raise RuntimeError("init() the graph before loading state")
        new = updater_state_from_numpy(np_state, self.device)
        if _shapes(new) != _shapes(self.updater_state):
            raise ValueError("updater state tree does not match this "
                             "graph's updater and parameters")
        self.updater_state = new
        return self

    # ------------------------------------------------------------------
    def _compute_params(self):
        """The parameters in the compute dtype: the bf16 copy is made
        once per parameter tree (and dtype), not per call."""
        if self.conf.dtype not in _BF16:
            return self.params
        c = self._compute
        if c is None or c[0] is not self.params or c[1] != self.conf.dtype:
            c = (self.params, self.conf.dtype, bf16_cast_tree(self.params))
            self._compute = c
        return c[2]

    def _tensor(self, x) -> torch.Tensor:
        """An input or a label on the net's device; floating arrays
        become f32 (the JAX package's default)."""
        x = torch.as_tensor(x, device=self.device)
        return x.float() if x.dtype == torch.float64 else x

    def _as_input_dict(self, inputs) -> Dict[str, torch.Tensor]:
        """The network inputs by name, in the compute dtype."""
        if len(inputs) == 1 and isinstance(inputs[0], dict):
            pairs = inputs[0].items()
        else:
            pairs = zip(self.conf.network_inputs, inputs)
        return self._cast_compute({}, {name: self._tensor(x)
                                       for name, x in pairs})[1]

    def _cast_compute(self, params, inputs):
        """The bf16 compute cast of a parameter tree and an input dict
        under ``conf.dtype = "bfloat16"`` (differentiable: training
        calls it inside the loss)."""
        if self.conf.dtype in _BF16:
            params = bf16_cast_tree(params)
            inputs = {k: bf16_cast(x) for k, x in inputs.items()}
        return params, inputs

    def _forward(self, params, state, inputs: Dict[str, Any], *,
                 stream: bool = False, preout_of=()):
        """Topological-order forward; returns (activations, new state).
        ``stream`` selects the streaming (KV-cache) path of the
        streaming vertices; other calls see no streaming state. The
        output layers named in ``preout_of`` yield their pre-activation
        output (the loss takes every output's preout in this one
        pass)."""
        acts: Dict[str, Any] = dict(inputs)
        new_state: Dict[str, Any] = {}
        for name in self._topo:
            v = self.conf.vertices[name]
            xs = [acts[i] for i in self.conf.vertex_inputs.get(name, [])]
            v_state = state.get(name, {})
            if not stream:
                v_state = {k: val for k, val in v_state.items()
                           if k not in STREAM_STATE_KEYS}
            if name in preout_of:
                acts[name], new_state[name] = (
                    v.layer.preout(params[name], xs[0]), v_state)
                continue
            extra = ({"stream": stream}
                     if getattr(v, "supports_streaming", False) else {})
            acts[name], new_state[name] = v.apply(params[name], xs, v_state,
                                                  **extra)
        return acts, new_state

    # ------------------------------------------------------------------
    def _loss(self, params, inputs, labels):
        """Sum of the output layers' losses plus the L1/L2 terms, as a
        function of the f32 ``params`` (the compute cast happens here,
        so autograd carries the gradient back through it); returns
        (loss, new state)."""
        outs = self.conf.network_outputs
        for name in outs:
            if not hasattr(getattr(self.conf.vertices[name], "layer", None),
                           "compute_score"):
                raise ValueError(f"output vertex {name} is not an output "
                                 "layer")
        cparams, cinputs = self._cast_compute(params, inputs)
        acts, new_state = self._forward(cparams, self.state, cinputs,
                                        preout_of=set(outs))
        total = 0.0
        for name in outs:
            total = total + self.conf.vertices[name].layer.compute_score(
                labels[name], f32_head(acts[name]))
        return total + self._reg_loss(params), new_state

    def _reg_loss(self, params):
        """L1 and L2 terms of every layer's coefficients, on the f32
        parameters."""
        reg = 0.0
        for name, v in self.conf.vertices.items():
            layer = getattr(v, "layer", None)
            if layer is None:
                continue
            p = params.get(name, {})
            for k, coeff in layer.l1_coeffs().items():
                if k in p:
                    reg = reg + coeff * p[k].abs().sum()
            for k, coeff in layer.l2_coeffs().items():
                if k in p:
                    reg = reg + 0.5 * coeff * (p[k] ** 2).sum()
        return reg

    def _train_step(self, inputs, labels) -> torch.Tensor:
        """One optimizer step: loss and gradients by autograd through the
        whole forward (the flash-attention kernels' backward included),
        gradient normalization, the updater's steps subtracted from the
        parameters. Returns the loss (on the device)."""
        params = tree_map(lambda t: t.detach().requires_grad_(),
                          self.params)
        loss, new_state = self._loss(params, inputs, labels)
        leaves = [(v, k) for v, p in params.items() for k in p]
        grads = torch.autograd.grad(loss, [params[v][k] for v, k in leaves],
                                    allow_unused=True)
        tree = {v: {} for v in params}
        for (v, k), g in zip(leaves, grads):
            tree[v][k] = torch.zeros_like(params[v][k]) if g is None else g
        conf = self.conf
        with torch.no_grad():
            tree = normalize_gradients(tree, conf.gradient_normalization,
                                       conf.gradient_normalization_threshold)
            steps, self.updater_state = conf.updater.update(
                tree, self.updater_state, self.params)
            self.params = tree_map(lambda p, s: p - s, self.params, steps)
        self.state = new_state
        return loss.detach()

    def _batch(self, ds: DataSet):
        """A batch's inputs and labels as f32 tensors by name."""
        if ds.features_mask is not None or ds.labels_mask is not None:
            raise NotImplementedError("feature and label masks in fit are "
                                      "not ported yet (ROADMAP.md A6)")
        feats = ds.features
        if not isinstance(feats, dict):
            feats = dict(zip(self.conf.network_inputs,
                             feats if isinstance(feats, (list, tuple))
                             else [feats]))
        labels = ds.labels
        if not isinstance(labels, dict):
            labels = {self.conf.network_outputs[0]: labels}
        return ({k: self._tensor(x) for k, x in feats.items()},
                {k: self._tensor(y) for k, y in labels.items()})

    def fit(self, data, labels=None, epochs: int = 1, batch_size: int = 32,
            *, steps_per_dispatch: int = 1, prefetch: int = 0,
            pad_tail=None, execution_plan=None):
        """Train: one optimizer step per batch. ``data`` is a DataSet, an
        iterator of DataSets, or features with ``labels`` (arrays, or
        dicts keyed by input / output name), batched by
        ``batch_size``."""
        if steps_per_dispatch != 1:
            raise NotImplementedError("fused multi-step dispatch "
                                      "(steps_per_dispatch > 1) is not "
                                      "ported yet (ROADMAP.md A4)")
        if execution_plan is not None:
            raise NotImplementedError("execution plans are not ported yet "
                                      "(ROADMAP.md A4)")
        if prefetch or pad_tail:
            raise NotImplementedError("device prefetch and tail padding "
                                      "are not ported yet (ROADMAP.md A5)")
        if self.nonfinite_policy is not None:
            raise NotImplementedError("the non-finite sentinel is not "
                                      "ported yet (ROADMAP.md A5)")
        if not self._initialized:
            self.init()
        if labels is not None:
            it = ArrayDataSetIterator(data, labels, batch_size)
        elif isinstance(data, DataSet):
            it = ArrayDataSetIterator(data.features, data.labels, batch_size,
                                      data.features_mask, data.labels_mask)
        else:
            it = data
        if it is not data:
            # the internal iterator's pass index follows the epoch count
            it.restore_state({"epoch": self.epoch_count, "pos": 0})
        for _ in range(epochs):
            for ds in it:
                self._fit_batch(ds)
            self.epoch_count += 1
        return self

    def _fit_batch(self, ds: DataSet):
        inputs, labels = self._batch(ds)
        self.score_value = self._train_step(inputs, labels)
        self.iteration_count += 1

    def score(self, ds: DataSet) -> float:
        """The loss of ``ds`` at the current parameters (L1/L2 terms
        included)."""
        inputs, labels = self._batch(ds)
        with torch.no_grad():
            loss, _ = self._loss(self.params, inputs, labels)
        return float(loss)

    # ------------------------------------------------------------------
    def output(self, *inputs):
        """Output activations (f32 heads): one tensor for a
        single-output graph, else a list."""
        if not self._initialized:
            self.init()
        with torch.no_grad():
            acts, _ = self._forward(self._compute_params(), self.state,
                                    self._as_input_dict(inputs))
            outs = [f32_head(acts[o]) for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def rnn_time_step(self, *inputs, pad_left=None):
        """Stateful streaming inference: run one chunk ``[N, F, T]``
        through the carried streaming state (KV caches) and return its
        outputs.

        ``pad_left`` (single-input graphs) marks the first ``pad_left``
        positions as left padding with packed accounting: pads never
        enter a cache nor take a position. The JAX package feeds the
        padded chunk to keep one jit shape per width bucket; eager
        PyTorch has no shapes to bucket, so the pads are dropped before
        the forward. That is packed priming by construction; the pad
        columns of the output are zeros."""
        if not self._initialized:
            self.init()
        ins = self._as_input_dict(inputs)
        pad = 0
        if pad_left is not None:
            if len(ins) != 1:
                raise ValueError("pad_left needs a single-input graph")
            pad = int(pad_left)
            t = next(iter(ins.values())).shape[-1]
            if not 0 <= pad < t:
                raise ValueError(f"pad_left {pad} out of range for a chunk "
                                 f"of {t} positions")
            ins = {k: x[..., pad:] for k, x in ins.items()}
        t = next(iter(ins.values())).shape[-1]
        new_pos_map = self._check_graph_stream_budget(t)
        with torch.no_grad():
            acts, new_state = self._forward(self._compute_params(),
                                            self.state, ins, stream=True)
            outs = [f32_head(acts[o]) for o in self.conf.network_outputs]
        self.state = new_state
        self._stream_pos_map = new_pos_map
        if pad:
            outs = [torch.nn.functional.pad(o, (pad, 0)) for o in outs]
        return outs[0] if len(outs) == 1 else outs

    def _streaming_vertices(self):
        for name, v in self.conf.vertices.items():
            layer = getattr(v, "layer", None)
            if getattr(layer, "supports_streaming", False):
                yield name, layer

    def _check_graph_stream_budget(self, t: int) -> Dict[str, int]:
        """Validate a chunk of ``t`` positions against every streaming
        vertex's capacity (every vertex of the ported graphs sees the
        chunk's length); returns the counter updates, committed by the
        caller after the forward succeeds."""
        pos = self._stream_pos_map
        updates = {}
        for name, layer in self._streaming_vertices():
            new_pos = pos.get(name, 0) + int(t)
            cap = stream_capacity([layer])
            if cap is not None and new_pos > cap:
                raise ValueError(
                    f"vertex '{name}' streamed {new_pos} positions, "
                    f"exceeding its streaming capacity ({cap}); call "
                    "rnn_clear_previous_state() or raise "
                    "cache_length/max_length")
            updates[name] = new_pos
        return {**pos, **updates}

    def rnn_clear_previous_state(self):
        self._stream_pos_map = {}
        for k, s in self.state.items():
            if isinstance(s, dict):
                self.state[k] = {kk: vv for kk, vv in s.items()
                                 if kk not in STREAM_STATE_KEYS}


def _shapes(tree):
    """The structure of a state tree: shapes of tensors, types of the
    rest."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape) if torch.is_tensor(tree) else type(tree)
