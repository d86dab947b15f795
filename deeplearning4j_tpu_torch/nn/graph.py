"""ComputationGraph: the DAG network runtime.

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: ``init``, the
topological-order forward, ``output``, the streaming ``rnn_time_step``
/ ``rnn_clear_previous_state`` pair the decoders and the serving engine
drive (the KV caches and positional offsets, and the LSTM layers' ``h``
/ ``c``: a streaming call feeds each layer its carried state and keeps
the new one; other calls start from zeros), training (``fit`` over a
DataSet, ``(features, labels)`` or an iterator, one optimizer step per
batch, or ``steps_per_dispatch=K`` batches as one CUDA graph on the
card, with listeners, tail padding and device prefetch: the fit loop of
``nn/network_base.py``; and ``score``), ``evaluate`` (the ``eval/``
classes fed the f32 heads of ``output()``), ``summary`` (the JAX
package's vertex table), and the fused execution plans of the CNN
stack. PyTorch runs eagerly, so there is no jit cache: each call
runs the vertex loop directly, and a train step is one autograd pass
over it, with batch statistics in every BN (``fit`` trains ResNet50 on
every execution plan). A labels mask reaches only the loss, as in the
JAX ``_loss`` (the example weights of tail padding); features masks
(ROADMAP.md A6) are refused.
In training each layer's ``dropout`` draws from its generator of the
step (``nn/network_base.py``); as in the JAX ``ComputationGraph``, the
graph applies no weight noise and no constraints (those are the
sequential network's), and inference draws nothing.

Execution plans (``set_fusion``, resolved by ``tuning/plan.py``): at
level ``True`` each bn -> [act ->] 1x1-conv group (a BN with one
consumer, an optional ActivationLayer, a 1x1 stride-1 conv; relu or
identity) runs as one op (``nn/layers/fused.py``: the BN affine and the
activation as the conv's prologue, through the fused kernels on NHWC).
At level ``"bottleneck"`` each ResNet bottleneck chain (conv1x1 -> BN ->
relu -> conv3x3 -> BN -> relu -> conv1x1 -> BN -> add -> relu, identity
or downsample form, NHWC) runs through the bottleneck kernels
(``nn/layers/bottleneck.py``), and with ``stem=True`` the [pad ->]
7x7/2 conv -> BN -> relu -> 3x3/2 max-pool stem through the stem kernels
(``nn/layers/stem.py``). The matchers are the JAX package's; only the
gates are the port's own (they refuse what the kernels do not take, not
the TPU's VMEM budget). As in the JAX package, no layer with dropout
joins a fused chain. Parameters and state stay keyed by the original
vertex names, so a plan changes how a chain runs, not what it computes.
In training a fused group differentiates through its kernels' backward
(the fused op's one-pass backward, the bottleneck's and the stem's
backward kernels), each writing its BNs' decayed running statistics
under their vertex names.

Parameters live in ``net.params`` as ``{vertex: {name: tensor}}`` (f32
master weights) on ``net.device``; ``net.state`` carries the BN running
statistics and the streaming state in the same shape;
``net.updater_state`` the updater's. Under ``conf.dtype = "bfloat16"``
inference casts the parameters to bf16 once and reuses the cast copy
until ``net.params`` is replaced; training casts them inside the
differentiated loss on every step (the JAX package's ``_cast_compute``
inside ``value_and_grad``), so the gradients reach the f32 master
weights, and takes the loss on the output promoted to f32.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.compute import (
    bf16_cast, bf16_cast_tree, f32_head)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseVertex, LayerVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    STREAM_STATE_KEYS, ActivationLayer, BatchNormalization,
    ConvolutionLayer, SubsamplingLayer, ZeroPaddingLayer, stream_capacity)
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.network_base import BF16, NetworkBase
from deeplearning4j_tpu_torch.nn.updater import tree_leaves

__all__ = ["ComputationGraph"]


class ComputationGraph(NetworkBase):
    """DAG network with fit, score, output and streaming inference."""

    def __init__(self, conf: ComputationGraphConfiguration):
        super().__init__()
        self.conf = conf
        self._topo = conf.topological_order()
        self._vertex_input_types: Dict[str, List[InputType]] = {}
        #: streamed positions per streaming vertex (the budget guard)
        self._stream_pos_map: Dict[str, int] = {}
        #: the execution plan (set_fusion): False, True or "bottleneck",
        #: the stem switch and the block subset; the matchers' gates read
        #: conf.dtype, so both plan caches are dtype-stamped
        self.fusion_level = False
        self._fuse_stem = False
        self._fusion_only = None
        self._fusion_cache = None      # (dtype, skip, bplan, splan, cplan)
        self._candidates_cache = None  # (dtype, bplan, splan)
        #: the fused chains' conv weights in the kernels' layouts, by
        #: vertex: (the weight tensor they were made from, the copy)
        self._layouts: Dict[str, Any] = {}

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
        self._init_train_gen()
        self._stream_pos_map = {}
        self._initialized = True
        return self

    def summary(self) -> str:
        """The vertex table (the JAX package's text): name, layer or
        vertex type, inputs and parameter count a vertex in topological
        order, then the total."""
        self._infer_types()
        lines = ["=" * 80,
                 f"{'vertex':<24}{'type':<26}{'inputs':<20}{'params':<10}",
                 "-" * 80]
        total = 0
        for name in self._topo:
            v = self.conf.vertices[name]
            nparams = sum(int(np.prod(p.shape)) for p in
                          tree_leaves(self.params.get(name, {})))
            total += nparams
            tname = type(v.layer).__name__ if isinstance(v, LayerVertex) \
                else type(v).__name__
            ins = ",".join(self.conf.vertex_inputs.get(name, []))
            lines.append(f"{name:<24}{tname:<26}{ins:<20}{nparams:<10}")
        lines.append("-" * 80)
        lines.append(f"Total params: {total}")
        lines.append("=" * 80)
        return "\n".join(lines)

    def _layer_items(self):
        for name, v in self.conf.vertices.items():
            layer = getattr(v, "layer", None)
            if layer is not None:
                yield name, layer

    def _layers_in_order(self):
        for name in self._topo:
            layer = getattr(self.conf.vertices[name], "layer", None)
            if layer is not None:
                yield name, layer

    # ------------------------------------------------------------------
    # execution plans: the fused bottleneck and stem chains
    # ------------------------------------------------------------------
    def set_fusion(self, enabled=True, *, stem=False, only=None):
        """Select the execution plan: False (every vertex on its own, the
        "xla" plan), True (each bn -> act -> 1x1-conv group as one fused
        op, ``nn/layers/fused.py``) or ``"bottleneck"`` (each matched
        bottleneck chain through the bottleneck kernels; ``stem=True``
        also the matched stem through the stem kernels; ``only``, a set
        of block output vertex names, restricts the blocks)."""
        if enabled not in (False, True, "bottleneck"):
            raise ValueError(f"unknown fusion level {enabled!r}: expected "
                             "False, True or 'bottleneck'")
        if stem and enabled != "bottleneck":
            raise ValueError("stem=True rides the 'bottleneck' fusion level")
        only = None if only is None else frozenset(only)
        sig = (enabled, bool(stem), only)
        if sig != (self.fusion_level, self._fuse_stem, self._fusion_only):
            self.fusion_level, self._fuse_stem, self._fusion_only = sig
            self._fusion_cache = None
        return self

    def _fusion(self):
        """(skip, bplan, splan) of the selected plan: bplan maps each
        fused block's output vertex to its group, splan the stem's pool
        vertex to its group, skip every absorbed vertex to the vertex
        that runs it (at level True: each group's BN and activation to
        its conv, whose group :meth:`_conv_plan` holds)."""
        if not self.fusion_level:
            return {}, {}, {}
        c = self._fusion_cache
        if c is None or c[0] != self.conf.dtype:
            bplan, splan, cplan = {}, {}, {}
            if self.fusion_level is True:
                skip, cplan = self._conv_fusion()
            else:
                skip, bplan = self._bottleneck_fusion(self._fusion_only)
                splan = self._stem_fusion() if self._fuse_stem else {}
            for out_name, group in splan.items():
                for m in group["members"]:
                    skip[m] = out_name
            c = self._fusion_cache = (self.conf.dtype, skip, bplan, splan,
                                      cplan)
        return c[1:4]

    def _conv_plan(self):
        """Level True's groups: each fused 1x1 conv vertex mapped to
        ``(bn vertex, prologue activation, the BN's input vertex)``, the
        JAX ``_fusion()[0]``; empty at the other levels."""
        self._fusion()
        return self._fusion_cache[4] if self.fusion_level else {}

    def _conv_fusion(self):
        """(skip, cplan) of level True, the JAX package's matcher: a
        BatchNormalization with one input of kind cnn and one consumer,
        optionally an ActivationLayer with one consumer (only under the
        BN's identity activation), then a 1x1, stride-1, pad-0,
        dilation-1 ConvolutionLayer in truncate or same mode whose one
        input is that vertex and whose data format is the BN's; the
        prologue activation relu or identity. skip maps the BN and
        activation vertices to their conv."""
        consumers, layer_of = self._fusion_graph_view()
        cplan: Dict[str, Any] = {}
        skip: Dict[str, str] = {}
        for bn_name in self._topo:
            bn = layer_of(bn_name, BatchNormalization)
            if bn is None or \
                    len(self.conf.vertex_inputs.get(bn_name, [])) != 1 or \
                    self._vertex_input_types[bn_name][0].kind != "cnn":
                continue
            cons = consumers.get(bn_name, [])
            if len(cons) != 1:
                continue
            nxt, act_vertex = cons[0], None
            act = bn.activation or "identity"
            al = layer_of(nxt, ActivationLayer)
            if al is not None:
                acons = consumers.get(nxt, [])
                if act != "identity" or len(acons) != 1:
                    continue
                act_vertex, act, nxt = nxt, al.activation, acons[0]
            conv = layer_of(nxt, ConvolutionLayer)
            if (conv is None or act not in ("relu", "identity")
                    or tuple(conv.kernel) != (1, 1)
                    or tuple(conv.stride) != (1, 1)
                    or tuple(conv.padding) != (0, 0)
                    or tuple(conv.dilation) != (1, 1)
                    or conv.convolution_mode not in ("truncate", "same")
                    or conv.data_format != bn.data_format
                    or self.conf.vertex_inputs.get(nxt)
                    != [act_vertex or bn_name]):
                continue
            cplan[nxt] = (bn_name, act, self.conf.vertex_inputs[bn_name][0])
            skip[bn_name] = nxt
            if act_vertex is not None:
                skip[act_vertex] = nxt
        return skip, cplan

    def _fusion_graph_view(self):
        """The matchers' scaffolding: (consumers map, layer_of). layer_of(n,
        cls) is vertex n's layer iff n is a plain LayerVertex of exactly
        ``cls`` with no preprocessor, no dropout and not a network
        output."""
        self._infer_types()
        consumers: Dict[str, List[str]] = {}
        for cname, srcs in self.conf.vertex_inputs.items():
            for src in srcs:
                consumers.setdefault(src, []).append(cname)
        outputs = set(self.conf.network_outputs)

        def layer_of(n, cls):
            v = self.conf.vertices.get(n)
            if (not isinstance(v, LayerVertex) or v.preprocessor is not None
                    or n in outputs):
                return None
            l = v.layer
            return l if type(l) is cls and not l.dropout else None

        return consumers, layer_of

    def _chain(self, consumers):
        """(sole_consumer, chain_next): chain_next(n) is n's one consumer
        if that consumer has n as its ONE input (a second input would make
        the unfused vertex read another xs[0] than the fused chain)."""
        def sole_consumer(n):
            c = consumers.get(n, [])
            return c[0] if len(c) == 1 else None

        def chain_next(n):
            c = sole_consumer(n)
            if c is None or self.conf.vertex_inputs.get(c, []) != [n]:
                return None
            return c

        return sole_consumer, chain_next

    def _bottleneck_fusion(self, only=None):
        """(skip, bplan) of the bottleneck level: bplan maps the final
        relu vertex of each bottleneck (conv1x1 -> bn -> relu -> conv3x3
        -> bn -> relu -> conv1x1 -> bn -> add -> relu, no biases, NHWC;
        identity skip at stride 1, or a conv1x1 -> bn shortcut at the
        block's stride) to its vertex group; skip maps every absorbed
        vertex to that output. ``only`` keeps just the named blocks."""
        from deeplearning4j_tpu_torch.nn.layers.bottleneck import (
            fused_bottleneck_supported)
        consumers, layer_of = self._fusion_graph_view()
        sole_consumer, chain_next = self._chain(consumers)
        outputs = set(self.conf.network_outputs)

        def conv_ok(l, kernel, padding, stride=(1, 1)):
            return (l is not None and tuple(l.kernel) == kernel
                    and tuple(l.stride) == stride
                    and tuple(l.padding) == padding
                    and tuple(l.dilation) == (1, 1)
                    and not l.has_bias
                    and l.activation in (None, "identity")
                    and l.data_format == "NHWC")

        def walk_bn_act(name):
            """name is a conv; its one consumer must be a bn with a relu
            (its own activation or an ActivationLayer vertex). Returns
            (bn, act vertex, following vertex) or None."""
            bn_name = chain_next(name)
            bn = bn_name and layer_of(bn_name, BatchNormalization)
            if bn is None or \
                    len(self.conf.vertex_inputs.get(bn_name, [])) != 1:
                return None
            nxt = chain_next(bn_name)
            if nxt is None:
                return None
            act = bn.activation or "identity"
            act_vertex = None
            al = layer_of(nxt, ActivationLayer)
            if al is not None and act == "identity":
                act_vertex, act = nxt, al.activation
                nxt = chain_next(act_vertex)
            if act != "relu" or nxt is None:
                return None
            return bn_name, act_vertex, nxt

        bplan: Dict[str, Dict[str, Any]] = {}
        skip: Dict[str, str] = {}
        for ca_name in self._topo:
            conv_a = layer_of(ca_name, ConvolutionLayer)
            if conv_a is None:
                continue
            stride = tuple(conv_a.stride)
            if stride not in ((1, 1), (2, 2)) or \
                    not conv_ok(conv_a, (1, 1), (0, 0), stride):
                continue
            srcs = self.conf.vertex_inputs.get(ca_name, [])
            if len(srcs) != 1:
                continue
            src = srcs[0]
            it = self._vertex_input_types[ca_name][0]
            if it.kind != "cnn":
                continue
            w1 = walk_bn_act(ca_name)
            if w1 is None:
                continue
            bn_a, act_a, cb_name = w1
            conv_b = layer_of(cb_name, ConvolutionLayer)
            if not conv_ok(conv_b, (3, 3), (1, 1)):
                continue
            w2 = walk_bn_act(cb_name)
            if w2 is None:
                continue
            bn_b, act_b, cc_name = w2
            conv_c = layer_of(cc_name, ConvolutionLayer)
            if not conv_ok(conv_c, (1, 1), (0, 0)):
                continue
            bn_c_name = chain_next(cc_name)
            bn_c = bn_c_name and layer_of(bn_c_name, BatchNormalization)
            if bn_c is None or (bn_c.activation or "identity") != "identity":
                continue
            add_name = sole_consumer(bn_c_name)
            addv = add_name and self.conf.vertices.get(add_name)
            if (not isinstance(addv, ElementWiseVertex)
                    or addv.op.lower() != "add" or add_name in outputs):
                continue
            add_ins = self.conf.vertex_inputs.get(add_name, [])
            skip_group = {}
            if sorted(add_ins) == sorted([bn_c_name, src]):
                if stride != (1, 1):
                    continue          # a strided main path needs a conv skip
            else:
                # downsample form: the other add input is src -> conv_skip
                # (1x1, the same stride) -> bn_skip (identity activation)
                others = [i for i in add_ins if i != bn_c_name]
                if len(add_ins) != 2 or len(others) != 1:
                    continue
                bn_s_name = others[0]
                bn_s = layer_of(bn_s_name, BatchNormalization)
                if bn_s is None or \
                        (bn_s.activation or "identity") != "identity" or \
                        sole_consumer(bn_s_name) != add_name:
                    continue
                cs_in = self.conf.vertex_inputs.get(bn_s_name, [])
                if len(cs_in) != 1:
                    continue
                cs_name = cs_in[0]
                conv_s = layer_of(cs_name, ConvolutionLayer)
                if not conv_ok(conv_s, (1, 1), (0, 0), stride) or \
                        chain_next(cs_name) != bn_s_name or \
                        self.conf.vertex_inputs.get(cs_name, []) != [src]:
                    continue
                skip_group = {"conv_skip": cs_name, "bn_skip": bn_s_name}
            out_name = chain_next(add_name)
            out_act = out_name and layer_of(out_name, ActivationLayer)
            if out_act is None or out_act.activation != "relu":
                continue
            bns = [self.conf.vertices[n].layer
                   for n in ((bn_a, bn_b, bn_c_name)
                             + ((skip_group["bn_skip"],)
                                if skip_group else ()))]
            if len({(b.eps, b.decay) for b in bns}) != 1:
                continue
            if len({b.data_format for b in bns} | {"NHWC"}) != 1:
                continue
            if not fused_bottleneck_supported(
                    (1, it.height, it.width, it.channels),
                    conv_a.n_out, conv_c.n_out,
                    self.conf.dtype or "float32",
                    stride=stride[0], has_skip=bool(skip_group)):
                continue
            if only is not None and out_name not in only:
                continue
            group = {"src": src, "conv_a": ca_name, "bn_a": bn_a,
                     "conv_b": cb_name, "bn_b": bn_b, "conv_c": cc_name,
                     "bn_c": bn_c_name, "add": add_name,
                     "stride": stride[0],
                     "h": it.height, "w": it.width, "cin": it.channels,
                     "cmid": conv_a.n_out, "cout": conv_c.n_out,
                     **skip_group}
            members = [ca_name, bn_a, cb_name, bn_b, cc_name, bn_c_name,
                       add_name] + list(skip_group.values())
            members += [m for m in (act_a, act_b) if m]
            if any(m in skip for m in members):
                continue
            bplan[out_name] = group
            for m in members:
                skip[m] = out_name
        return skip, bplan

    def _stem_fusion(self):
        """splan of the stem: maps the max-pool vertex closing a
        [ZeroPadding(3,3,3,3) ->] 7x7/2 conv (pad 3 in total, no bias) ->
        BN -> relu -> 3x3/2 pad-1 max-pool chain (NHWC, single consumers)
        to its group. The pad vertex may carry the graph's entry
        preprocessor, which the group still applies."""
        from deeplearning4j_tpu_torch.nn.layers.stem import (
            fused_stem_supported)
        consumers, layer_of = self._fusion_graph_view()
        _, chain_next = self._chain(consumers)
        outputs = set(self.conf.network_outputs)
        splan: Dict[str, Dict[str, Any]] = {}
        for cv_name in self._topo:
            conv = layer_of(cv_name, ConvolutionLayer)
            if (conv is None or tuple(conv.kernel) != (7, 7)
                    or tuple(conv.stride) != (2, 2)
                    or tuple(conv.dilation) != (1, 1)
                    or conv.has_bias
                    or conv.activation not in (None, "identity")
                    or conv.data_format != "NHWC"
                    or conv.convolution_mode != "truncate"):
                continue
            srcs = self.conf.vertex_inputs.get(cv_name, [])
            if len(srcs) != 1:
                continue
            members = [cv_name]
            pre_vertex = None
            if tuple(conv.padding) == (0, 0):
                # the ZeroPadding(3,3,3,3) form (the zoo ResNet50's),
                # matched by hand: the pad vertex may carry the entry
                # preprocessor, which the fused group absorbs
                pad_name = srcs[0]
                pv = self.conf.vertices.get(pad_name)
                padl = pv.layer if (
                    isinstance(pv, LayerVertex)
                    and type(pv.layer) is ZeroPaddingLayer
                    and pad_name not in outputs
                    and not pv.layer.dropout) else None
                if (padl is None or tuple(padl._pads()) != (3, 3, 3, 3)
                        or padl.data_format != "NHWC"
                        or chain_next(pad_name) != cv_name):
                    continue
                if pv.preprocessor is not None:
                    pre_vertex = pad_name
                pin = self.conf.vertex_inputs.get(pad_name, [])
                if len(pin) != 1:
                    continue
                src = pin[0]
                it = self._vertex_input_types[pad_name][0]
                members.append(pad_name)
            elif tuple(conv.padding) == (3, 3):
                src = srcs[0]
                it = self._vertex_input_types[cv_name][0]
            else:
                continue
            if it.kind != "cnn":
                continue
            bn_name = chain_next(cv_name)
            bn = bn_name and layer_of(bn_name, BatchNormalization)
            if bn is None or \
                    len(self.conf.vertex_inputs.get(bn_name, [])) != 1:
                continue
            members.append(bn_name)
            nxt = chain_next(bn_name)
            act = bn.activation or "identity"
            if nxt is not None:
                al = layer_of(nxt, ActivationLayer)
                if al is not None and act == "identity":
                    members.append(nxt)
                    act = al.activation
                    nxt = chain_next(nxt)
            if act != "relu" or nxt is None:
                continue
            pool = layer_of(nxt, SubsamplingLayer)
            if (pool is None or pool.pooling_type.lower() != "max"
                    or tuple(pool.kernel) != (3, 3)
                    or tuple(pool.stride) != (2, 2)
                    or tuple(pool.padding) != (1, 1)
                    or pool.convolution_mode != "truncate"
                    or pool.data_format != "NHWC"):
                continue
            if not fused_stem_supported(
                    (1, it.height, it.width, it.channels), conv.n_out,
                    self.conf.dtype or "float32"):
                continue
            splan[nxt] = {"src": src, "conv": cv_name, "bn": bn_name,
                          "pre_vertex": pre_vertex,
                          "h": it.height, "w": it.width,
                          "cin": it.channels, "cout": conv.n_out,
                          "members": members}
        return splan

    def fusion_candidates(self):
        """Everything the fused plan COULD engage on this graph, whatever
        plan is selected: (bottleneck block groups, stem groups), memoised
        per conf.dtype (the gates read it)."""
        c = self._candidates_cache
        if c is None or c[0] != self.conf.dtype:
            _, bplan = self._bottleneck_fusion(None)
            c = self._candidates_cache = (self.conf.dtype, bplan,
                                          self._stem_fusion())
        return c[1:]

    def _apply_fused(self, conv_name, bn_name, act, src, params, state,
                     new_state, acts, *, train):
        """Run one level-True group (``nn/layers/fused.py``): reads the
        BN's raw input ``acts[src]``, writes the conv's output (its own
        activation applied after the op) into ``acts[conv_name]`` and, in
        training, the BN's new running statistics (detached) into
        ``new_state`` under its vertex name."""
        from deeplearning4j_tpu_torch.nn import activations
        from deeplearning4j_tpu_torch.nn.layers.fused import bn_act_conv1x1
        bn = self.conf.vertices[bn_name].layer
        conv = self.conf.vertices[conv_name].layer
        y = acts[src]
        p, s = params.get(bn_name, {}), state[bn_name]
        nf = s["mean"].shape[0]
        gamma = p.get("gamma", torch.full((nf,), bn.gamma, dtype=y.dtype,
                                          device=y.device))
        beta = p.get("beta", torch.full((nf,), bn.beta, dtype=y.dtype,
                                        device=y.device))
        out, mean, var = bn_act_conv1x1(
            y, gamma, beta, s["mean"], s["var"], params[conv_name]["W"],
            params[conv_name].get("b"), train=train, eps=bn.eps,
            decay=bn.decay, act=act, data_format=conv.data_format)
        acts[conv_name] = activations.get(conv.activation)(out)
        new_state[bn_name] = ({"mean": mean.detach(), "var": var.detach()}
                              if train else s)
        new_state[conv_name] = state.get(conv_name, {})

    def _apply_fused_bottleneck(self, out_name, group, params, state,
                                new_state, acts, *, train):
        """Run one bottleneck group through the kernels: reads the block
        input, writes the final relu output into ``acts[out_name]`` and,
        in training, each BN's new running statistics (detached) into
        ``new_state`` under its vertex name."""
        from deeplearning4j_tpu_torch.nn.layers.bottleneck import (
            fused_bottleneck)
        x = acts[group["src"]].contiguous()
        bn_a, pa = self._bn_params(group["bn_a"], params, state, x.dtype)
        pb = self._bn_params(group["bn_b"], params, state, x.dtype)[1]
        pc = self._bn_params(group["bn_c"], params, state, x.dtype)[1]
        ws = ps = None
        if "conv_skip" in group:                  # downsample (entry) form
            ps = self._bn_params(group["bn_skip"], params, state,
                                 x.dtype)[1]
            ws = self._kernel_weight(params, group["conv_skip"], "1x1")
        acts[out_name], stats = fused_bottleneck(
            x, self._kernel_weight(params, group["conv_a"], "1x1"), pa,
            self._kernel_weight(params, group["conv_b"], "3x3"), pb,
            self._kernel_weight(params, group["conv_c"], "1x1"), pc,
            w_skip=ws, bn_skip=ps, stride=group["stride"], train=train,
            eps=bn_a.eps, decay=bn_a.decay)
        if train:
            bns = [group[k] for k in ("bn_a", "bn_b", "bn_c", "bn_skip")
                   if k in group]
            for i, bn_name in enumerate(bns):
                new_state[bn_name] = {"mean": stats[2 * i].detach(),
                                      "var": stats[2 * i + 1].detach()}

    def _apply_fused_stem(self, out_name, group, params, state, new_state,
                          acts, *, train):
        """Run the stem group through the kernels: reads the network
        input (through the absorbed pad vertex's preprocessor, the entry
        transpose), writes the pooled output into ``acts[out_name]`` and,
        in training, the stem BN's new running statistics (detached) into
        ``new_state`` under its vertex name."""
        from deeplearning4j_tpu_torch.nn.layers.stem import fused_stem
        x = acts[group["src"]]
        if group["pre_vertex"]:
            x = self.conf.vertices[group["pre_vertex"]].preprocessor.apply(x)
        bn, p = self._bn_params(group["bn"], params, state, x.dtype)
        acts[out_name], (mean, var) = fused_stem(
            x.contiguous(), self._kernel_weight(params, group["conv"], "s2d"),
            p, train=train, eps=bn.eps, decay=bn.decay)
        if train:
            new_state[group["bn"]] = {"mean": mean.detach(),
                                      "var": var.detach()}

    def _kernel_weight(self, params, name, layout):
        """Conv vertex ``name``'s OIHW weight in a kernel's layout: "1x1"
        ``[I, O]``; "3x3" tap-major ``[9, I, O]``, tap ``t = kh * 3 + kw``
        (the kernel's order of shifted windows, cross-correlation like
        F.conv2d); "s2d" the stem's space-to-depth ``[64 I, O]``. Outside
        autograd it is made once per weight tensor and kept until that
        tensor is replaced (a new ``net.params``, or its compute-dtype
        copy), not per forward. In training it is made inside the autograd
        graph on every step and not kept: each step's weight is a new
        tensor, dW flows back through the layout to the OIHW weight, and
        a kept copy would hold the last step's graph alive."""
        from deeplearning4j_tpu_torch.nn.layers.stem import stem_weight_s2d
        w4 = params[name]["W"]
        grad = torch.is_grad_enabled() and w4.requires_grad
        hit = self._layouts.get(name)
        if not grad and hit is not None and hit[0] is w4:
            return hit[1]
        o, i = w4.shape[0], w4.shape[1]
        if layout == "1x1":
            w = w4.reshape(o, i).t().contiguous()
        elif layout == "3x3":
            w = w4.permute(2, 3, 1, 0).reshape(9, i, o).contiguous()
        else:
            w = stem_weight_s2d(w4)
        if not grad:
            self._layouts[name] = (w4, w)
        return w

    def _bn_params(self, bn_name, params, state, dtype):
        """(layer, BnParams) of a BN vertex for the fused chains, rounded
        through the compute dtype as the unfused layer rounds them."""
        from deeplearning4j_tpu_torch.nn.layers.bottleneck import BnParams
        bn = self.conf.vertices[bn_name].layer
        p, s = params.get(bn_name, {}), state[bn_name]
        nf = s["mean"].shape[0]
        dev = s["mean"].device
        gamma = p.get("gamma", torch.full((nf,), bn.gamma, device=dev))
        beta = p.get("beta", torch.full((nf,), bn.beta, device=dev))
        return bn, BnParams(
            gamma=gamma.to(dtype), beta=beta.to(dtype),
            running_mean=s["mean"].to(dtype).float(),
            running_var=s["var"].to(dtype).float())

    # ------------------------------------------------------------------
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
        if self.conf.dtype in BF16:
            params = bf16_cast_tree(params)
            inputs = {k: bf16_cast(x) for k, x in inputs.items()}
        return params, inputs

    def _forward(self, params, state, inputs: Dict[str, Any], *,
                 train: bool = False, stream: bool = False, preout_of=(),
                 gens=None):
        """Topological-order forward; returns (activations, new state).
        ``train`` selects every vertex's training form (BN batch
        statistics, their running averages in the new state). ``stream``
        selects the streaming (KV-cache) path of the streaming vertices;
        other calls see no streaming state. The output layers named in
        ``preout_of`` yield their pre-activation output (the loss takes
        every output's preout in this one pass). The chains of the
        selected execution plan run fused. ``gens`` (a training step's
        generators by vertex) feed the layers' dropout."""
        skip, bplan, splan = self._fusion()
        cplan = self._conv_plan()
        acts: Dict[str, Any] = dict(inputs)
        new_state: Dict[str, Any] = {}
        for name in self._topo:
            if name in skip:           # absorbed into a fused chain
                new_state[name] = state.get(name, {})
                continue
            if name in cplan:
                self._apply_fused(name, *cplan[name], params, state,
                                  new_state, acts, train=train)
                continue
            if name in bplan:
                self._apply_fused_bottleneck(name, bplan[name], params,
                                             state, new_state, acts,
                                             train=train)
            elif name in splan:
                self._apply_fused_stem(name, splan[name], params, state,
                                       new_state, acts, train=train)
            if name in bplan or name in splan:
                new_state[name] = state.get(name, {})
                continue
            v = self.conf.vertices[name]
            xs = [acts[i] for i in self.conf.vertex_inputs.get(name, [])]
            v_state = state.get(name, {})
            if not stream:
                v_state = {k: val for k, val in v_state.items()
                           if k not in STREAM_STATE_KEYS}
            g = gens.get(name) if gens else None
            if name in preout_of:
                acts[name], new_state[name] = (
                    v.layer.preout(params[name], xs[0], train=train, gen=g),
                    v_state)
                continue
            extra = ({"stream": stream}
                     if getattr(v, "supports_streaming", False) else {})
            acts[name], new_state[name] = v.apply(params[name], xs, v_state,
                                                  train=train, gen=g,
                                                  **extra)
        return acts, new_state

    # ------------------------------------------------------------------
    def _loss(self, params, inputs, labels, *, train: bool = True,
              gens=None, lmasks=None):
        """Sum of the output layers' losses plus the L1/L2 terms, as a
        function of the f32 ``params`` (the compute cast happens here,
        so autograd carries the gradient back through it), with the
        forward in its training form unless ``train=False`` (``score``),
        with a training step's generators ``gens``; ``lmasks`` (labels
        masks by output name) weight each output's loss and reach
        nothing else, as in the JAX ``_loss``. Returns (loss, new
        state)."""
        outs = self.conf.network_outputs
        for name in outs:
            if not hasattr(getattr(self.conf.vertices[name], "layer", None),
                           "compute_score"):
                raise ValueError(f"output vertex {name} is not an output "
                                 "layer")
        cparams, cinputs = self._cast_compute(params, inputs)
        acts, new_state = self._forward(cparams, self.state, cinputs,
                                        train=train, preout_of=set(outs),
                                        gens=gens)
        total = 0.0
        for name in outs:
            total = total + self.conf.vertices[name].layer.compute_score(
                labels[name], f32_head(acts[name]),
                (lmasks or {}).get(name))
        return total + self._reg_loss(params), new_state

    def _batch_loss_fn(self, ds: DataSet, gens, carry_rnn: bool = False):
        inputs, labels, lmasks = self._batch(ds)
        return lambda p: self._loss(p, inputs, labels, gens=gens,
                                    lmasks=lmasks)

    def _batch(self, ds: DataSet):
        """A batch's inputs and labels as f32 tensors by name, and its
        labels masks by output name (or None). A labels mask weights the
        loss only (the JAX ``_loss``); a features mask would reach the
        layers and is refused (ROADMAP.md A6)."""
        if ds.features_mask is not None:
            raise NotImplementedError("feature masks in fit are not ported "
                                      "yet (ROADMAP.md A6)")
        feats = ds.features
        if not isinstance(feats, dict):
            feats = dict(zip(self.conf.network_inputs,
                             feats if isinstance(feats, (list, tuple))
                             else [feats]))
        out0 = self.conf.network_outputs[0]
        labels = ds.labels
        if not isinstance(labels, dict):
            labels = {out0: labels}
        lmasks = ds.labels_mask
        if lmasks is not None and not isinstance(lmasks, dict):
            lmasks = {out0: lmasks}
        return ({k: self._tensor(x) for k, x in feats.items()},
                {k: self._tensor(y) for k, y in labels.items()},
                None if lmasks is None else
                {k: self._tensor(m) for k, m in lmasks.items()})

    def fit(self, data, labels=None, epochs: int = 1, batch_size: int = 32,
            *, steps_per_dispatch: int = 1, prefetch: int = 0,
            pad_tail=None, execution_plan=None):
        """Train: one optimizer step per batch. ``data`` is a DataSet, an
        iterator of DataSets, or features with ``labels`` (arrays, or
        dicts keyed by input / output name), batched by
        ``batch_size``. ``execution_plan`` ("auto" | "fused" | "xla") is
        resolved once per call (``tuning/plan.py``: "auto" per shape from
        the kernel-crossover store, "fused" every eligible block and the
        stem where the store says it wins); None keeps the net's plan
        (``set_fusion(True)`` included). A fused group, block or stem
        trains through its backward kernels.

        ``steps_per_dispatch=K`` runs each run of K same-shape batches as
        one group (one CUDA graph replay on the card), ``prefetch=N``
        stages batches N deep through ``pipeline.DevicePrefetchIterator``
        and ``pad_tail`` (default: on when K > 1) pads the ragged last
        batch with an example-weight labels mask, unless it has a
        features mask and no labels mask (the JAX predicate); see
        ``nn/network_base.py``."""
        return self._fit(data, labels, epochs, batch_size,
                         steps_per_dispatch=steps_per_dispatch,
                         prefetch=prefetch, pad_tail=pad_tail,
                         execution_plan=execution_plan)

    def _pad_when(self, ds: DataSet) -> bool:
        return ds.labels is not None and (
            ds.labels_mask is not None or ds.features_mask is None)

    def _plan_key(self):
        return (self.fusion_level, self._fuse_stem, self._fusion_only)

    def score(self, ds: DataSet) -> float:
        """The loss of ``ds`` at the current parameters (L1/L2 terms
        included)."""
        inputs, labels, lmasks = self._batch(ds)
        with torch.no_grad():
            loss, _ = self._loss(self.params, inputs, labels, train=False,
                                 lmasks=lmasks)
        return float(loss)

    def evaluate(self, iterator):
        """Classification evaluation over an iterator or a DataSet (the
        JAX ``ComputationGraph.evaluate``): an ``eval.Evaluation`` of
        ``output(features)`` against the labels, under the labels mask.
        A batch with a features mask raises: the JAX graph passes it to
        its forward, which the port's ``output`` does not take yet
        (ROADMAP.md A6)."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        return self._evaluate(Evaluation(), iterator)

    def _eval_output(self, ds: DataSet):
        if ds.features_mask is not None:
            raise NotImplementedError(
                "evaluate on a batch with a features mask needs masks in "
                "ComputationGraph.output, which are not ported yet "
                "(ROADMAP.md A6)")
        return self.output(ds.features)

    # ------------------------------------------------------------------
    def output(self, *inputs, train: bool = False):
        """Output activations (f32 heads) of the forward under the
        selected execution plan: one tensor for a single-output graph,
        else a list. CNN inputs are NCHW. ``train=True`` runs the
        training forward (BN batch statistics, dropout drawn from a step
        of the training generator) and drops its new state, as the JAX
        package does."""
        if not self._initialized:
            self.init()
        gens = self._step_gens() if train else None
        with torch.no_grad():
            acts, _ = self._forward(self._compute_params(), self.state,
                                    self._as_input_dict(inputs),
                                    train=train, gens=gens)
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
        new_pos_map = self._stream_begin(t)
        outs = self._stream_apply(ins)
        self._stream_end(new_pos_map)
        if pad:
            outs = [torch.nn.functional.pad(o, (pad, 0)) for o in outs]
        return outs[0] if len(outs) == 1 else outs

    # -- rnn_time_step in its host and device parts (the serving engine
    # -- captures the device part in its decode-step CUDA graph) -------
    def _stream_input(self, x: torch.Tensor):
        """A one-hot ``[N, V, T]`` device tensor as the device part's
        input (single-input graphs; the compute cast on the device)."""
        return self._as_input_dict((x,))

    def _stream_begin(self, t: int):
        """Host part, before the forward: the streaming budget of a
        chunk of ``t`` positions (raises past a capacity); returns what
        :meth:`_stream_end` commits."""
        return self._check_graph_stream_budget(t)

    def _stream_apply(self, ins):
        """Device part: one streaming forward of the cast inputs through
        the carried state, which it replaces (``self.state``); returns
        the outputs, promoted to f32, as a list. Reads nothing on the
        host and copies nothing in from it."""
        with torch.no_grad():
            acts, new_state = self._forward(self._compute_params(),
                                            self.state, ins, stream=True)
            outs = [f32_head(acts[o]) for o in self.conf.network_outputs]
        self.state = new_state
        return outs

    def _stream_end(self, new_pos_map) -> None:
        """Host part, after the forward: the streamed-position mirrors
        (per-row ones too, after a per-row rewind)."""
        old_max = max(self._stream_pos_map.values(), default=0)
        self._stream_pos_map = new_pos_map
        rows = getattr(self, "_stream_pos_rows", None)
        if rows is not None:    # per-row positions, after a per-row rewind
            self._stream_pos_rows = rows + (
                max(new_pos_map.values(), default=0) - old_max)

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

    def _clear_stream_positions(self):
        self._stream_pos_map = {}
        self._stream_pos_rows = None
