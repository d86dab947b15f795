"""What the two network runtimes share.

``ComputationGraph`` (``nn/graph.py``) and ``MultiLayerNetwork``
(``nn/multilayer.py``) keep their parameters as ``{key: {name:
tensor}}`` trees (f32 master weights; keys are vertex names in a graph,
layer indices ``"0"``, ``"1"``, ... in a sequential network), the state
and the updater state in trees of the same keys, and train the same way:
one autograd pass over the forward, gradient normalization, the
updater's steps subtracted, under the non-finite sentinel
(``resilience/sentinel.py``: by default a step whose loss or raw
gradients are not finite changes nothing). This base holds that, the
compute-dtype copy of the parameters that inference reuses, the last
loss (``score_value``, read from the device on first access, as the JAX
package's ``LazyScore``), the parameter and state loaders from the JAX
package's numpy trees, the fit options the port refuses (ROADMAP.md
A5), and the training generator.

The training generator is an explicit ``torch.Generator`` on the
network's device, seeded ``conf.seed + 1`` (the JAX package's training
key) and not saved in archives (the JAX package saves no key either).
Each training step advances it once and splits it into one generator a
layer, in layer order (:meth:`NetworkBase._step_gens`), which the
layer's weight noise and input dropout draw from. On the card the split
is by Philox offset (layer i of a step starts ``i * 2^32`` counters
past the step's base), so it needs no device read; on the CPU the step
draws one seed a layer. Inference draws nothing.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.nn.compute import bf16_cast_tree
from deeplearning4j_tpu_torch.nn.conf.layers import STREAM_STATE_KEYS
from deeplearning4j_tpu_torch.nn.updater import normalize_gradients, tree_map
from deeplearning4j_tpu_torch.resilience.sentinel import (
    effective_policy, guard_updates, record_step_flag, tree_finite)

__all__ = ["BF16", "NetworkBase"]

BF16 = ("bfloat16", "bf16")

#: the Philox offset between two layers' generators in one step (a
#: multiple of 4, as the CUDA generator's offsets are; a layer's draws in
#: a step take far fewer counters: a draw of N values advances the
#: offset by about 4 N / (the threads of its grid)), and the offsets'
#: range (they wrap, as the generator's 64-bit counter does)
_SPLIT, _OFFSETS = 1 << 32, 1 << 64


class NetworkBase:
    """The parameter trees, the training step's update, and the numpy
    loaders of a network; a subclass sets ``conf``, ``params``,
    ``state``, ``updater_state``, ``device`` and ``_initialized``, and
    yields its layers by key from :meth:`_layer_items`."""

    def __init__(self):
        self.params: Dict[str, Any] = {}
        self.state: Dict[str, Any] = {}
        self.updater_state: Dict[str, Any] = {}
        self.iteration_count = 0
        self.epoch_count = 0
        self._score_raw: Any = float("nan")
        #: the non-finite sentinel's policy ("skip", "record", "off");
        #: None takes the process default (resilience/sentinel.py)
        self.nonfinite_policy = None
        self.device = None
        self._initialized = False
        self._compute = None       # (params, dtype, compute-dtype params)
        self._train_gen = None

    def _layer_items(self):
        """(key, layer conf) of every layer with parameters or state."""
        raise NotImplementedError

    def _layers_in_order(self):
        """(key, layer conf) of every layer in layer order (a graph's:
        topological)."""
        return self._layer_items()

    def _init_train_gen(self):
        """The training generator, seeded ``conf.seed + 1``."""
        self._train_gen = torch.Generator(device=self.device)
        self._train_gen.manual_seed(int(self.conf.seed) + 1)

    def _step_gens(self) -> Dict[str, torch.Generator]:
        """One step's generators by layer key: the training generator
        advanced once and split per layer, in layer order; a generator
        only for the layers that draw (dropout, weight noise)."""
        items = list(self._layers_in_order())
        g = self._train_gen
        if g.device.type == "cuda":
            base = g.get_offset()
            g.set_offset((base + len(items) * _SPLIT) % _OFFSETS)

            def make(i):
                gi = torch.Generator(device=g.device)
                gi.manual_seed(g.initial_seed())
                gi.set_offset((base + i * _SPLIT) % _OFFSETS)
                return gi
        else:
            seeds = torch.randint(0, 1 << 62, (len(items),),
                                  generator=g).tolist()

            def make(i):
                return torch.Generator().manual_seed(seeds[i])
        return {key: make(i) for i, (key, layer) in enumerate(items)
                if layer.draws_in_training()}

    def _constrain(self, params):
        """The parameters after an update's projections: none here (the
        JAX ``ComputationGraph`` applies no constraints); the sequential
        network projects its layers' constraints."""
        return params

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

    def num_params(self) -> int:
        return sum(t.numel() for p in self.params.values()
                   for t in p.values())

    # ------------------------------------------------------------------
    # the JAX package's trees as numpy
    # ------------------------------------------------------------------
    def load_numpy_params(self, np_params):
        """Replace the parameters with the JAX network's ``net.params``
        as nested numpy arrays (``{key: {name: array}}``, see
        ``util/convert.params_from_numpy``); keys, names and shapes must
        match this network's."""
        from deeplearning4j_tpu_torch.util.convert import params_from_numpy
        if not self._initialized:
            raise RuntimeError("init() the network before loading params")
        new = params_from_numpy(np_params, self.device)
        want = {(v, k): tuple(t.shape) for v, p in self.params.items()
                for k, t in p.items()}
        got = {(v, k): tuple(t.shape) for v, p in new.items()
               for k, t in p.items()}
        if want != got:
            differ = sorted(k for k in set(want) & set(got)
                            if want[k] != got[k])
            raise ValueError(
                f"parameter tree mismatch: missing "
                f"{sorted(set(want) - set(got))}, unexpected "
                f"{sorted(set(got) - set(want))}, shapes differ at {differ}")
        self.params = new
        return self

    def load_numpy_updater_state(self, np_state):
        """Replace the updater state with the JAX network's
        ``net.updater_state`` as numpy (``util/convert.
        updater_state_from_numpy``), to resume a JAX run here; its tree
        must match this network's updater state."""
        from deeplearning4j_tpu_torch.util.convert import (
            updater_state_from_numpy)
        if not self._initialized:
            raise RuntimeError("init() the network before loading state")
        new = updater_state_from_numpy(np_state, self.device)
        if _shapes(new) != _shapes(self.updater_state):
            raise ValueError("updater state tree does not match this "
                             "network's updater and parameters")
        self.updater_state = new
        return self

    def load_numpy_state(self, np_state):
        """Replace the state with the JAX network's ``net.state`` as
        numpy (``util/convert.state_from_numpy``): the BN running mean
        and variance by key; its tree must match this network's."""
        from deeplearning4j_tpu_torch.util.convert import state_from_numpy
        if not self._initialized:
            raise RuntimeError("init() the network before loading state")
        new = state_from_numpy(np_state, self.device)
        if _shapes(new) != _shapes(self.state):
            raise ValueError("state tree does not match this network's")
        self.state = new
        return self

    # ------------------------------------------------------------------
    def _compute_params(self):
        """The parameters in the compute dtype: the bf16 copy is made
        once per parameter tree (and dtype), not per call."""
        if self.conf.dtype not in BF16:
            return self.params
        c = self._compute
        if c is None or c[0] is not self.params or c[1] != self.conf.dtype:
            c = (self.params, self.conf.dtype, bf16_cast_tree(self.params))
            self._compute = c
        return c[2]

    def _tensor(self, x) -> torch.Tensor:
        """An input or a label on the network's device; floating arrays
        become f32 (the JAX package's default)."""
        x = torch.as_tensor(x, device=self.device)
        return x.float() if x.dtype == torch.float64 else x

    def _reg_loss(self, params):
        """L1 and L2 terms of every layer's coefficients, on the f32
        parameters."""
        reg = 0.0
        for key, layer in self._layer_items():
            p = params.get(key, {})
            for k, coeff in layer.l1_coeffs().items():
                if k in p:
                    reg = reg + coeff * p[k].abs().sum()
            for k, coeff in layer.l2_coeffs().items():
                if k in p:
                    reg = reg + 0.5 * coeff * (p[k] ** 2).sum()
        return reg

    def _step(self, loss_fn) -> torch.Tensor:
        """One optimizer step: ``loss_fn(params)`` returns (loss, new
        state) for leaf copies of the f32 parameters; the gradients by
        autograd, normalized, the updater's steps subtracted; the new
        state kept detached (no step's graph stays alive in it, as none
        crosses a jitted step in the JAX package). Under the sentinel's
        policy (not "off") the loss and the raw gradients are tested on
        the device, and the flag read once, after the update is queued
        (``resilience/sentinel.py`` says why); under "skip" a bad step
        leaves the parameters, the updater state and the layer state as
        they were. The layers' constraints are projected after the
        update, before the sentinel's select (:meth:`_constrain`).
        Returns the loss (on the device)."""
        policy = effective_policy(self)
        old_state = self.state
        params = tree_map(lambda t: t.detach().requires_grad_(),
                          self.params)
        loss, new_state = loss_fn(params)
        leaves = [(v, k) for v, p in params.items() for k in p]
        grads = torch.autograd.grad(loss, [params[v][k] for v, k in leaves],
                                    allow_unused=True)
        tree = {v: {} for v in params}
        for (v, k), g in zip(leaves, grads):
            tree[v][k] = torch.zeros_like(params[v][k]) if g is None else g
        conf = self.conf
        new_state = tree_map(
            lambda t: t.detach() if torch.is_tensor(t) else t, new_state)
        with torch.no_grad():
            # the raw gradients: normalization must not hide an Inf
            ok = None if policy == "off" else tree_finite(loss, tree)
            tree = normalize_gradients(tree, conf.gradient_normalization,
                                       conf.gradient_normalization_threshold)
            steps, new_upd = conf.updater.update(
                tree, self.updater_state, self.params)
            new_params = self._constrain(
                tree_map(lambda p, s: p - s, self.params, steps))
            new = (new_params, new_upd, new_state)
            good = ok is None or bool(ok)      # the step's one host read
            if not good:
                new = guard_updates(ok, policy, (new_params, self.params),
                                    (new_upd, self.updater_state),
                                    (new_state, old_state))
        self.params, self.updater_state, self.state = new
        record_step_flag(self, good, policy)
        return loss.detach()

    def _fit_iterator(self, data, labels, batch_size, *, steps_per_dispatch,
                      prefetch, pad_tail):
        """The batches of ``fit``'s arguments, after refusing the options
        the port has not got (ROADMAP.md A5)."""
        if steps_per_dispatch != 1:
            raise NotImplementedError("fused multi-step dispatch "
                                      "(steps_per_dispatch > 1) is not "
                                      "ported yet (ROADMAP.md A5)")
        if prefetch or pad_tail:
            raise NotImplementedError("device prefetch and tail padding "
                                      "are not ported yet (ROADMAP.md A5)")
        effective_policy(self)   # raises on a policy it does not know
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
        return it

    def rnn_clear_previous_state(self):
        """Drop the streaming state (LSTM h / c, KV caches, positional
        offsets) and the streamed-position counters."""
        self._clear_stream_positions()
        self.state = _strip_stream(self.state)

    def _clear_stream_positions(self):
        raise NotImplementedError


def _strip_stream(state):
    """A state tree without its streaming keys."""
    return {k: ({kk: vv for kk, vv in s.items()
                 if kk not in STREAM_STATE_KEYS}
                if isinstance(s, dict) else s)
            for k, s in state.items()}


def _shapes(tree):
    """The structure of a state tree: shapes of tensors, types of the
    rest."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape) if torch.is_tensor(tree) else type(tree)
