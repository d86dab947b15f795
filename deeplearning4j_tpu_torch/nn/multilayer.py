"""MultiLayerNetwork: the sequential network runtime.

Counterpart of ``deeplearning4j_tpu/nn/multilayer.py``: ``init``, the
layer-by-layer forward, ``output``, the streaming ``rnn_time_step`` /
``rnn_clear_previous_state`` pair, training (``fit`` over a DataSet,
``(features, labels)`` or an iterator, one optimizer step per batch or
``steps_per_dispatch=K`` batches as one CUDA graph on the card, truncated
BPTT when the configuration asks for it, with listeners, tail padding
and device prefetch: the fit loop of ``nn/network_base.py``),
``score``, ``evaluate`` and ``evaluate_regression``, ``feed_forward``
(every layer's activation), ``summary`` (the JAX package's layer table,
character for character) and ``clone``.
PyTorch runs eagerly: each call runs the layer loop directly, and a
train step is one autograd pass over it (``nn/network_base.py``).

Parameters, state and updater state are trees keyed by layer index
(``"0"``, ``"1"``, ...), as in the JAX package, so the JAX network's
trees load as they are (``load_numpy_params`` and the other loaders).
Under ``conf.dtype = "bfloat16"`` the forward runs on bf16 copies of the
parameters and input (inference reuses one cast copy; training casts
inside the differentiated loss, so the gradients reach the f32 master
weights) and the loss takes the output layer's pre-activation promoted
to f32, as the JAX ``_cast_compute`` and ``_loss`` do.

Recurrent state: an LSTM layer returns its last ``h`` / ``c`` in its
state. An ordinary forward (``output``, a ``fit`` step) strips the
carried ones first and starts from zeros; ``rnn_time_step`` feeds them
back and keeps the new ones; truncated BPTT (``_fit_tbptt``) clears them
at the start of each batch and carries them from chunk to chunk,
detached (the JAX package gets that by running each chunk as its own
jitted call). As there, a tBPTT batch (``[N, C, T]`` under
``conf.tbptt``) always runs by itself, never in a K-step group. A
``[N, T]`` mask in ``output(mask=)`` reaches the LSTM layers (masked
steps carry h and c through and output zeros). In ``fit`` a labels mask
reaches only the loss, as in the JAX ``_loss`` (the example weights of
tail padding); features masks are refused (ROADMAP.md A6), as is a mask
through a preprocessor, and ``pretrain`` (it pretrains AutoEncoder and
VAE layers, ROADMAP.md A11). A layer's preprocessor
(``conf.preprocessors``: CNN / feed-forward / RNN adapters) reshapes its
input before it runs, in the forward and in the loss, as in the JAX
``_forward`` and ``_loss``. ``evaluate`` and
``evaluate_regression`` feed the ``eval/`` classes the f32 heads of
``output()`` as host arrays, as the JAX package does.

Regularization in training, as the JAX ``MultiLayerNetwork`` applies
it: each step takes one generator a layer from the training generator
(``nn/network_base.py``); a layer's ``weight_noise`` perturbs its
(compute-dtype) parameters before its ``apply`` in the layer loop (the
output layer's loss path, like the JAX ``_loss``, takes none), its
``dropout`` drops its input, and after the update the layers'
``constraints`` are projected onto the new parameters, before the
non-finite sentinel's select. ``output()``, ``rnn_time_step`` and
``score`` draw nothing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.compute import (
    bf16_cast, bf16_cast_tree, f32_head)
from deeplearning4j_tpu_torch.nn.conf.constraints import apply_constraints
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    STREAM_STATE_KEYS, GlobalPoolingLayer, SelfAttentionLayer,
    stream_capacity)
from deeplearning4j_tpu_torch.nn.conf.network import (
    MultiLayerConfiguration, _infer_shapes_and_preprocessors)
from deeplearning4j_tpu_torch.nn.network_base import BF16, NetworkBase
from deeplearning4j_tpu_torch.nn.updater import tree_leaves, tree_map

__all__ = ["MultiLayerNetwork"]


class MultiLayerNetwork(NetworkBase):
    """Sequential network with fit, score, output and streaming
    inference."""

    def __init__(self, conf: MultiLayerConfiguration):
        super().__init__()
        self.conf = conf
        self.layers = conf.layers
        self._stream_pos = 0

    def _layer_items(self):
        return ((str(i), layer) for i, layer in enumerate(self.layers))

    def init(self, device=None):
        """Build the parameters from ``conf.seed`` on ``device``
        (default ``"cuda"``; raises without a CUDA device unless
        ``device="cpu"``)."""
        self.device = resolve_device(device)
        if self.conf.input_type is None:
            n_in = getattr(self.layers[0], "n_in", None)
            if n_in is None:
                raise ValueError("set conf.input_type or the first layer's "
                                 "n_in")
            self.conf.input_type = InputType.feed_forward(n_in)
        _infer_shapes_and_preprocessors(self.conf)
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        self.params, self.state = {}, {}
        for i, (layer, it) in enumerate(zip(self.layers,
                                            self.conf.layer_input_types())):
            p, s = layer.init(gen, it, self.device)
            self.params[str(i)] = p
            self.state[str(i)] = s
        self.updater_state = self.conf.updater.init_state(self.params)
        self._init_train_gen()
        self._stream_pos = 0
        self._initialized = True
        return self

    def _constrain(self, params):
        if not any(layer.constraints for layer in self.layers):
            return params
        return apply_constraints(self.layers, params)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def _cast_compute(self, params, x):
        """The bf16 compute cast of the parameters and the input under
        ``conf.dtype = "bfloat16"`` (differentiable: training calls it
        inside the loss)."""
        if self.conf.dtype in BF16:
            return bf16_cast_tree(params), bf16_cast(x)
        return params, x

    def _forward(self, params, state, x, *, train=False, carry_rnn=False,
                 stream=False, mask=None, upto: Optional[int] = None,
                 gens=None):
        """The layers' activations (``acts[i]`` is layer i's output) and
        the new state. Each layer sees its state stripped of the
        streaming keys unless ``carry_rnn``; ``stream`` selects the
        streaming path of the streaming layers; ``mask`` ``[N, T]``
        reaches the recurrent layers; ``upto`` stops before that layer
        (its state and the later layers' pass through). ``gens`` (a
        training step's generators by layer key) feed each layer's weight
        noise, applied here, and its dropout."""
        acts, new_state = [], {}
        n = len(self.layers) if upto is None else upto
        h = x
        for i in range(n):
            layer = self.layers[i]
            h = self._preprocess(i, h, mask)
            s_i = state.get(str(i), {})
            if not carry_rnn:
                s_i = {k: v for k, v in s_i.items()
                       if k not in STREAM_STATE_KEYS}
            extra = _mask_kwargs(layer, mask)
            if getattr(layer, "supports_streaming", False):
                extra["stream"] = stream
            g_i = gens.get(str(i)) if gens else None
            p_i = params[str(i)]
            if train and g_i is not None and layer.weight_noise is not None:
                p_i = layer.weight_noise.apply_to_params(p_i, g_i)
            h, new_state[str(i)] = layer.apply(p_i, h, s_i, train=train,
                                               gen=g_i, **extra)
            acts.append(h)
        for i in range(n, len(self.layers)):
            new_state[str(i)] = state.get(str(i), {})
        return acts, new_state

    def _preprocess(self, i, h, mask):
        """Layer ``i``'s preprocessor applied to its input ``h`` (a mask
        through one is refused, ROADMAP.md A6)."""
        pre = self.conf.preprocessors.get(i)
        if pre is None:
            return h
        if mask is not None:
            raise NotImplementedError(
                f"a mask through {type(pre).__name__} is not ported yet "
                "(ROADMAP.md A6)")
        return pre.apply(h)

    def _loss(self, params, state, x, y, *, train=True, carry_rnn=False,
              gens=None, lmask=None):
        """The output layer's loss on the f32 promotion of its
        pre-activation, plus the L1/L2 terms, as a function of the f32
        ``params`` (the compute cast happens here), with a training
        step's generators ``gens``; ``lmask`` weights the loss and
        reaches nothing else, as in the JAX ``_loss``. Returns (loss,
        new state)."""
        out_idx = len(self.layers) - 1
        out_layer = self.layers[out_idx]
        if not hasattr(out_layer, "compute_score"):
            raise ValueError("the last layer must be an output layer to "
                             "compute a loss")
        cparams, cx = self._cast_compute(params, x)
        acts, new_state = self._forward(cparams, state, cx, train=train,
                                        carry_rnn=carry_rnn, upto=out_idx,
                                        gens=gens)
        h = self._preprocess(out_idx, acts[-1] if acts else cx, None)
        preout = out_layer.preout(
            cparams[str(out_idx)], h, train=train,
            gen=gens.get(str(out_idx)) if gens else None)
        score = out_layer.compute_score(y, f32_head(preout), lmask)
        return score + self._reg_loss(params), new_state

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1, batch_size: int = 32,
            *, steps_per_dispatch: int = 1, prefetch: int = 0,
            pad_tail=None, execution_plan=None):
        """Train: one optimizer step per batch, or per chunk of
        ``conf.tbptt_fwd_length`` steps of a ``[N, C, T]`` batch under
        truncated BPTT. ``data`` is a DataSet, an iterator of DataSets,
        or features with ``labels``, batched by ``batch_size``.
        ``execution_plan`` validates as for a graph; a sequential network
        has no fused chains, so every plan runs its layers as they
        are.

        ``steps_per_dispatch=K`` runs each run of K same-shape batches as
        one group (one CUDA graph replay on the card; a tBPTT batch
        always runs by itself), ``prefetch=N`` stages batches N deep
        through ``pipeline.DevicePrefetchIterator``, and ``pad_tail``
        (default: on when K > 1) pads the ragged last batch with an
        example-weight labels mask; see ``nn/network_base.py``."""
        return self._fit(data, labels, epochs, batch_size,
                         steps_per_dispatch=steps_per_dispatch,
                         prefetch=prefetch, pad_tail=pad_tail,
                         execution_plan=execution_plan)

    def _batch(self, ds: DataSet):
        """A batch's features, labels and labels mask (or None) as
        tensors; a features mask is refused (ROADMAP.md A6)."""
        _refuse_masks(ds)
        return (self._tensor(ds.features), self._tensor(ds.labels),
                None if ds.labels_mask is None
                else self._tensor(ds.labels_mask))

    def _batch_loss_fn(self, ds: DataSet, gens, carry_rnn: bool = False):
        x, y, m = self._batch(ds)
        return lambda p: self._loss(p, self.state, x, y, carry_rnn=carry_rnn,
                                    gens=gens, lmask=m)

    def _runs_alone(self, ds: DataSet) -> bool:
        return bool(self.conf.tbptt) and ds.features.ndim == 3

    def _fit_alone(self, ds: DataSet):
        self._fit_tbptt(ds)

    def _fit_tbptt(self, ds: DataSet):
        """Truncated BPTT: the batch in chunks of ``tbptt_fwd_length``
        steps, one optimizer step each, the recurrent state cleared first
        and carried (detached) from chunk to chunk; a labels mask ``[N,
        T]`` is cut with the labels."""
        _refuse_masks(ds)
        t = ds.features.shape[2]
        L = self.conf.tbptt_fwd_length
        self.rnn_clear_previous_state()
        for s in range(0, t, L):
            labels, lmask = ds.labels, ds.labels_mask
            if labels is not None and labels.ndim == 3:
                labels = labels[:, :, s:s + L]
            if lmask is not None:
                lmask = lmask[:, s:s + L]
            self._fit_batch(DataSet(ds.features[:, :, s:s + L], labels,
                                    None, lmask), carry_rnn=True)

    def score(self, ds: DataSet = None, features=None, labels=None) -> float:
        """The loss of ``ds`` (or of ``features`` and ``labels``) at the
        current parameters, L1/L2 terms included."""
        if ds is None:
            ds = DataSet(features, labels)
        x, y, m = self._batch(ds)
        with torch.no_grad():
            loss, _ = self._loss(self.params, self.state, x, y, train=False,
                                 lmask=m)
        return float(loss)

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def output(self, x, train: bool = False, mask=None):
        """The output layer's activations (f32) for ``x``, from zero
        recurrent state; ``mask`` ``[N, T]`` reaches the recurrent
        layers. ``train=True`` runs the training forward, dropout and
        weight noise drawn from a step of the training generator, as the
        JAX package does."""
        if not self._initialized:
            self.init()
        m = None if mask is None else self._tensor(mask)
        gens = self._step_gens() if train else None
        with torch.no_grad():
            acts, _ = self._forward(self._compute_params(), self.state,
                                    self._cast_compute({}, self._tensor(x))[1],
                                    train=train, mask=m, gens=gens)
        return f32_head(acts[-1])

    def feed_forward(self, x, train: bool = False):
        """Every layer's activation (``[i]`` is layer i's output, after
        its preprocessor and the layer), each promoted to f32 as
        ``output()``'s; ``train=True`` runs the training forward, drawing
        from a step of the training generator."""
        if not self._initialized:
            self.init()
        gens = self._step_gens() if train else None
        with torch.no_grad():
            acts, _ = self._forward(self._compute_params(), self.state,
                                    self._cast_compute({}, self._tensor(x))[1],
                                    train=train, gens=gens)
        return [f32_head(a) for a in acts]

    def rnn_time_step(self, x, pad_left=None):
        """Stateful streaming inference: run one chunk ``[N, F, T]``
        through the carried state (each LSTM layer's h / c, attention
        caches) and keep the new state; returns the chunk's outputs.

        ``pad_left`` marks the first ``pad_left`` positions as left
        padding, which the JAX package feeds as masked steps (h and c
        pass through; no position is taken); eager PyTorch has no shapes
        to bucket, so the pads are dropped before the forward, which
        leaves the state as the masked steps would, and the pad columns
        of the output are zeros."""
        if not self._initialized:
            self.init()
        x = self._cast_compute({}, self._tensor(x))[1]
        pad = 0
        if pad_left is not None:
            pad = int(pad_left)
            if not 0 <= pad < x.shape[-1]:
                raise ValueError(f"pad_left {pad} out of range for a chunk "
                                 f"of {x.shape[-1]} positions")
            x = x[..., pad:]
        new_pos = self._stream_begin(int(x.shape[-1]))
        out = self._stream_apply(x)
        self._stream_end(new_pos)
        return torch.nn.functional.pad(out, (pad, 0)) if pad else out

    # -- rnn_time_step in its host and device parts (the serving engine
    # -- captures the device part in its decode-step CUDA graph) -------
    def _stream_input(self, x: torch.Tensor) -> torch.Tensor:
        """A one-hot ``[N, V, T]`` device tensor as the device part's
        input (the compute cast on the device)."""
        return self._cast_compute({}, self._tensor(x))[1]

    def _stream_begin(self, t: int) -> int:
        """Host part, before the forward: the streaming budget of a
        chunk of ``t`` positions (raises past the smallest capacity);
        returns the position :meth:`_stream_end` commits."""
        new_pos = self._stream_pos + int(t)
        cap = stream_capacity(self.layers)
        if cap is not None and new_pos > cap:
            raise ValueError(
                f"streamed {new_pos} positions, exceeding the smallest "
                f"streaming capacity ({cap}); call "
                "rnn_clear_previous_state() or raise cache_length/"
                "max_length")
        return new_pos

    def _stream_apply(self, x: torch.Tensor) -> torch.Tensor:
        """Device part: one streaming forward of the cast input through
        the carried state, which it replaces (``self.state``); returns
        the output promoted to f32. Reads nothing on the host and copies
        nothing in from it."""
        with torch.no_grad():
            acts, new_state = self._forward(self._compute_params(),
                                            self.state, x, carry_rnn=True,
                                            stream=True)
        self.state = new_state
        return f32_head(acts[-1])

    def _stream_end(self, new_pos: int) -> None:
        """Host part, after the forward: the streamed-position mirrors
        (per-row ones too, after a per-row rewind)."""
        rows = getattr(self, "_stream_pos_rows", None)
        if rows is not None:    # per-row positions, after a per-row rewind
            self._stream_pos_rows = rows + (new_pos - self._stream_pos)
        self._stream_pos = new_pos

    def _clear_stream_positions(self):
        self._stream_pos = 0
        self._stream_pos_rows = None

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def evaluate(self, iterator):
        """Classification evaluation over an iterator or a DataSet (the
        JAX ``MultiLayerNetwork.evaluate``): an ``eval.Evaluation`` of
        ``output(features, mask=features_mask)`` against the labels,
        under the labels mask."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
        return self._evaluate(Evaluation(), iterator)

    def evaluate_regression(self, iterator):
        """Regression evaluation, as :meth:`evaluate`, into an
        ``eval.RegressionEvaluation``."""
        from deeplearning4j_tpu_torch.eval.evaluation import (
            RegressionEvaluation)
        return self._evaluate(RegressionEvaluation(), iterator)

    def _eval_output(self, ds: DataSet):
        return self.output(ds.features, mask=ds.features_mask)

    # ------------------------------------------------------------------
    # info
    # ------------------------------------------------------------------
    def summary(self) -> str:
        """The layer table (the JAX package's text): index, layer type,
        output type and parameter count a layer, then the total."""
        its = self.conf.layer_input_types()
        lines = ["=" * 72,
                 f"{'idx':<4}{'layer':<28}{'out type':<24}{'params':<12}",
                 "-" * 72]
        total = 0
        for i, layer in enumerate(self.layers):
            nparams = sum(int(np.prod(p.shape)) for p in
                          tree_leaves(self.params.get(str(i), {})))
            total += nparams
            ot = layer.output_type(its[i])
            lines.append(f"{i:<4}{type(layer).__name__:<28}"
                         f"{str(ot.to_dict()):<24}{nparams:<12}")
        lines.append("-" * 72)
        lines.append(f"Total params: {total}")
        lines.append("=" * 72)
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        """A network of the same configuration (through its JSON) with
        copies of the parameters and state on the same device; nothing
        is shared with this one."""
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_dict(self.conf.to_dict()))
        if self._initialized:
            net.init(device=self.device)
            net.params = tree_map(_copy, self.params)
            net.state = tree_map(_copy, self.state)
        return net

    # ------------------------------------------------------------------
    # not ported
    # ------------------------------------------------------------------
    def pretrain(self, iterator, epochs: int = 1):
        raise NotImplementedError(
            "layer-wise pretraining (AutoEncoder and VAE layers) is not "
            "ported yet (ROADMAP.md A11)")


def _copy(a):
    return a.detach().clone() if torch.is_tensor(a) else a


def _refuse_masks(ds: DataSet) -> None:
    """A features mask would reach the layers in the JAX package: it is
    refused; a labels mask reaches only the loss and passes."""
    if ds.features_mask is not None:
        raise NotImplementedError("feature masks in fit are not ported "
                                  "yet (ROADMAP.md A6)")


def _mask_kwargs(layer, mask):
    """The mask argument for ``layer``: the recurrent layers take it; a
    layer that would read it in the JAX package (attention, pooling over
    time) is refused; the others ignore it, as there."""
    if mask is None:
        return {}
    if getattr(layer, "takes_mask", False):
        return {"mask": mask}
    if isinstance(layer, (SelfAttentionLayer, GlobalPoolingLayer)):
        raise NotImplementedError(
            f"a mask through {type(layer).__name__} is not ported yet "
            "(ROADMAP.md A6)")
    return {}
