"""ComputationGraph: the DAG network runtime, for inference.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``init``, the
topological-order forward, ``output``, and the streaming
``rnn_time_step`` / ``rnn_clear_previous_state`` pair the decoders and
the serving engine drive. PyTorch runs eagerly, so there is no jit
cache: each call runs the vertex loop directly. Training (``fit``),
fusion plans and masks come in later slices (ROADMAP.md A3-A6).

Parameters live in ``net.params`` as ``{vertex: {name: tensor}}`` on
``net.device``; ``net.state`` carries the streaming state in the same
shape. Under ``conf.dtype = "bfloat16"`` the parameters are cast to
bf16 once and the cast copy is reused until ``net.params`` is replaced.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.compute import (
    bf16_cast, bf16_cast_tree, f32_head)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    STREAM_STATE_KEYS, stream_capacity)
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration)

__all__ = ["ComputationGraph"]

_BF16 = ("bfloat16", "bf16")


class ComputationGraph:
    """DAG network with output and streaming inference."""

    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self.params: Dict[str, Any] = {}
        self.state: Dict[str, Any] = {}
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
        self._stream_pos_map = {}
        self._initialized = True
        return self

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

    def _as_input_dict(self, inputs) -> Dict[str, torch.Tensor]:
        if len(inputs) == 1 and isinstance(inputs[0], dict):
            pairs = inputs[0].items()
        else:
            pairs = zip(self.conf.network_inputs, inputs)
        out = {}
        for name, x in pairs:
            x = torch.as_tensor(x, device=self.device)
            if self.conf.dtype in _BF16:
                x = bf16_cast(x)
            out[name] = x
        return out

    def _forward(self, params, state, inputs: Dict[str, Any], *,
                 stream: bool = False):
        """Topological-order forward; returns (activations, new state).
        ``stream`` selects the streaming (KV-cache) path of the
        streaming vertices; other calls see no streaming state."""
        acts: Dict[str, Any] = dict(inputs)
        new_state: Dict[str, Any] = {}
        for name in self._topo:
            v = self.conf.vertices[name]
            xs = [acts[i] for i in self.conf.vertex_inputs.get(name, [])]
            v_state = state.get(name, {})
            if not stream:
                v_state = {k: val for k, val in v_state.items()
                           if k not in STREAM_STATE_KEYS}
            extra = ({"stream": stream}
                     if getattr(v, "supports_streaming", False) else {})
            acts[name], new_state[name] = v.apply(params[name], xs, v_state,
                                                  **extra)
        return acts, new_state

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
