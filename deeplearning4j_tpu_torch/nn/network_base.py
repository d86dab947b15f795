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
package's numpy trees, the training generator, and the fit loop the two
networks share (:meth:`NetworkBase._fit`): listeners, tail padding, the
device prefetch stage and ``steps_per_dispatch=K`` groups.

The fit loop is the JAX package's (``nn/multilayer.py`` ``fit`` /
``_fit_epoch`` / ``_fit_group`` / ``_fit_batch``). Batches are padded to
the pass's first batch's row count when ``pad_tail`` (default: on when
K > 1) and grouped by ``pipeline.padding.group_signature`` into runs of
K; a full run is one group (:meth:`NetworkBase._fit_group`), a trailing
partial run or a batch whose signature changes runs per batch, as does
every tBPTT batch of the sequential network. Listeners fire once per
logical step (``record_batch`` with the batch's real rows, then
``iteration_done`` with the step's loss as a device scalar: no host read
unless the listener makes one). On the CPU a group runs its K steps one
after another. On the card the group is one CUDA graph of the K steps
(:class:`_StepGraph`), replayed once per K batches: the first full group
of a graph's key runs eagerly, as real steps, so every first-use cost
(kernel attributes, library builds, cuBLAS handles) happens before the
capture of the second. A capture that fails raises: there is no
fallback beyond the JAX package's own per-batch runs, which the fit
counts (``net.fit_dispatch``).

The training generator is an explicit ``torch.Generator`` on the
network's device, seeded ``conf.seed + 1`` (the JAX package's training
key) and not saved in archives (the JAX package saves no key either;
checkpoints save its state, ``util/checkpoint.py``). Each training step
advances it once and splits it into one generator a layer, in layer
order (:meth:`NetworkBase._step_gens`), which the layer's weight noise
and input dropout draw from. On the card the split is by Philox offset
(layer i of a step starts ``i * 2^32`` counters past the step's base),
so it needs no device read; on the CPU the step draws one seed a layer.
Inference draws nothing. A step graph holds one generator a (step,
drawing layer), registered with the graph: before each replay each is
set to the seed and offset its eager twin would take
(:meth:`_StepGraph.draw`), and the replay's draws start there, so a
replayed group draws what K eager steps draw.

The fit loop keeps the JAX loop's data cursor: ``_dispatched_in_epoch``
(the batches dispatched in the pass, the fit loop's own count, not the
prefetch worker's), ``_canon_in_epoch`` and ``_cursor_pass``; a restored
checkpoint's cursor is consumed when a fit starts, and after every
dispatch (a group, each batch of the trailing flush, each tBPTT batch,
each K = 1 batch) ``resilience.durable.dispatch_boundary`` runs the
listeners' cadence saves and a pending preemption.
"""

from __future__ import annotations

import contextlib
import gc
import time
from collections import Counter
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.monitoring import ensure_started
from deeplearning4j_tpu_torch.monitoring.listener import (
    finalize_fit_telemetry, maybe_record_fit_iteration)
from deeplearning4j_tpu_torch.monitoring.runtime import record_capture
from deeplearning4j_tpu_torch.monitoring.tracing import phase_detail, span
from deeplearning4j_tpu_torch.nn.compute import bf16_cast_tree
from deeplearning4j_tpu_torch.nn.conf.layers import STREAM_STATE_KEYS
from deeplearning4j_tpu_torch.nn.updater import (
    normalize_gradients, tree_leaves, tree_map)
from deeplearning4j_tpu_torch.optimize.listeners import close_listeners
from deeplearning4j_tpu_torch.pipeline.padding import (
    group_signature, num_real_examples, pad_batch, with_example_weights)
from deeplearning4j_tpu_torch.pipeline.prefetch import (
    DevicePrefetchIterator, batch_arrays, map_batch)
from deeplearning4j_tpu_torch.resilience.durable import (
    capture_cursor_pass, consume_restored_cursor, dispatch_boundary)
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
        #: (params, dtype, compute-dtype params); a write into the
        #: parameter tensors in place (a step graph's replay) drops it
        self._compute = None
        self._train_gen = None
        self.listeners: List = []
        self._stash_features = None
        self._last_batch_features = None
        self._canon_in_epoch = None
        #: the K-step group's CUDA graph (:class:`_StepGraph`)
        self._step_graph = None
        #: how fit's logical steps ran: "graph_steps" (inside a replayed
        #: graph), "eager_group_steps" (a group run step by step: every
        #: group on the CPU, the warm-up group on the card),
        #: "batch_steps" (per batch: K = 1, partial groups, signature
        #: changes, tBPTT chunks); "captures", "replays"
        self.fit_dispatch: Counter = Counter()
        #: the data cursor (resilience/durable.py): batches dispatched
        #: in the pass, the pass's index, a restored checkpoint's cursor
        self._dispatched_in_epoch = 0
        self._cursor_pass = None
        self._restored_pipeline_state = None
        self._preemption_guard = None

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

    def _draw_index(self):
        """(position in layer order, key) of each layer that draws in
        training (dropout, weight noise)."""
        return [(i, key) for i, (key, layer)
                in enumerate(self._layers_in_order())
                if layer.draws_in_training()]

    def _step_base(self) -> int:
        """On the card: the training generator's offset for one step,
        the generator advanced past it (one ``_SPLIT`` a layer)."""
        g = self._train_gen
        base = g.get_offset()
        n = sum(1 for _ in self._layers_in_order())
        g.set_offset((base + n * _SPLIT) % _OFFSETS)
        return base

    def _step_gens(self) -> Dict[str, torch.Generator]:
        """One step's generators by layer key: the training generator
        advanced once and split per layer, in layer order; a generator
        only for the layers that draw (dropout, weight noise)."""
        g = self._train_gen
        if g.device.type == "cuda":
            base = self._step_base()

            def make(i):
                return _philox_at(torch.Generator(device=g.device),
                                  g.initial_seed(), base, i)
        else:
            n = sum(1 for _ in self._layers_in_order())
            seeds = torch.randint(0, 1 << 62, (n,), generator=g).tolist()

            def make(i):
                return torch.Generator().manual_seed(seeds[i])
        return {key: make(i) for i, key in self._draw_index()}

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

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def add_listener(self, listener):
        self.listeners.append(listener)
        return self

    def _evaluate(self, ev, iterator):
        """Accumulate ``ev`` (an ``eval/`` class) over ``iterator`` or a
        DataSet, as the JAX networks' ``evaluate`` do: a DataSet is
        batched by 128 with its masks dropped (the JAX package wraps its
        features and labels alone); each batch's f32 output head
        (:meth:`_eval_output`) reaches ``ev.eval`` as a host array, with
        the batch's labels mask."""
        if isinstance(iterator, DataSet):
            iterator = ArrayDataSetIterator(iterator.features,
                                            iterator.labels, 128)
        for ds in iterator:
            ev.eval(_host(ds.labels), _host(self._eval_output(ds)),
                    mask=_host(ds.labels_mask))
        return ev

    def _eval_output(self, ds: DataSet):
        """The inference output an evaluation of ``ds`` reads."""
        raise NotImplementedError

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
        self._drop_step_graph()
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
        self._drop_step_graph()
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
        self._drop_step_graph()
        return self

    # ------------------------------------------------------------------
    def _compute_params(self):
        """The parameters in the compute dtype: the bf16 copy is made
        once per parameter tree (and dtype), not per call; whatever
        writes into the tree's tensors in place drops it
        (``self._compute = None``)."""
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

    def _step(self, loss_fn, *, on_device=False, phases=False):
        """One optimizer step: ``loss_fn(params)`` returns (loss, new
        state) for leaf copies of the f32 parameters; the gradients by
        autograd, normalized, the updater's steps subtracted; the new
        state kept detached (no step's graph stays alive in it, as none
        crosses a jitted step in the JAX package). Under the sentinel's
        policy (not "off") the loss and the raw gradients are tested on
        the device; under "skip" a bad step leaves the parameters, the
        updater state and the layer state as they were. The layers'
        constraints are projected after the update, before the
        sentinel's select (:meth:`_constrain`).

        The eager per-batch step reads the flag once, after the update
        is queued, selects only on a bad step and counts the flag; it
        returns the loss (on the device). ``on_device=True`` (a K-step
        group, the body of its CUDA graph) reads nothing: it selects on
        every step, as the JAX step does, keeps no streaming carry in the
        new state (as the JAX scan's carry), and returns (loss, flag), the
        flag a 0-d bool tensor or None under "off". ``phases`` opens the
        ``forward``, ``backward`` and ``update`` spans."""
        policy = effective_policy(self)
        old_state = self.state
        with _phase("forward", phases):
            params = tree_map(lambda t: t.detach().requires_grad_(),
                              self.params)
            loss, new_state = loss_fn(params)
        with _phase("backward", phases):
            leaves = [(v, k) for v, p in params.items() for k in p]
            grads = torch.autograd.grad(
                loss, [params[v][k] for v, k in leaves], allow_unused=True)
        with _phase("update", phases), torch.no_grad():
            tree = {v: {} for v in params}
            for (v, k), g in zip(leaves, grads):
                tree[v][k] = torch.zeros_like(params[v][k]) if g is None \
                    else g
            conf = self.conf
            new_state = tree_map(
                lambda t: t.detach() if torch.is_tensor(t) else t, new_state)
            if on_device:
                # a group's state carries no stream (the JAX scan's
                # carry), so every step's state has one structure
                new_state = _strip_stream(new_state)
            # the raw gradients: normalization must not hide an Inf
            ok = None if policy == "off" else tree_finite(loss, tree)
            tree = normalize_gradients(tree, conf.gradient_normalization,
                                       conf.gradient_normalization_threshold)
            steps, new_upd = conf.updater.update(
                tree, self.updater_state, self.params)
            new_params = self._constrain(
                tree_map(lambda p, s: p - s, self.params, steps))
            new = (new_params, new_upd, new_state)
            pairs = ((new_params, self.params), (new_upd, self.updater_state),
                     (new_state, old_state))
            if on_device:
                if ok is not None:
                    new = guard_updates(ok, policy, *pairs)
            else:
                good = ok is None or bool(ok)   # the step's one host read
                if not good:
                    new = guard_updates(ok, policy, *pairs)
        self.params, self.updater_state, self.state = new
        if on_device:
            return loss.detach(), ok
        record_step_flag(self, good, policy)
        return loss.detach()

    # ------------------------------------------------------------------
    # the fit loop (the JAX package's, shared by both networks)
    # ------------------------------------------------------------------
    def _fit(self, data, labels, epochs, batch_size, *, steps_per_dispatch,
             prefetch, pad_tail, execution_plan):
        """``fit``'s body: the iterator of its arguments, wrapped by the
        prefetch stage when ``prefetch`` (padding in its worker, before
        the transfer), then ``epochs`` passes of :meth:`_fit_epoch` with
        the listeners' epoch hooks, and the one end-of-fit sync."""
        effective_policy(self)   # raises on a policy it does not know
        if not self._initialized:
            self.init()
        ensure_started()
        if execution_plan is not None:
            from deeplearning4j_tpu_torch.tuning.plan import (
                apply_execution_plan)
            apply_execution_plan(self, execution_plan)
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
        k = max(1, int(steps_per_dispatch))
        pad = (k > 1) if pad_tail is None else bool(pad_tail)
        if prefetch:
            # the worker pads ragged batches and gives every batch its
            # example-weight mask, so the mask crosses with the batch
            # (:meth:`_fit_epoch`'s ``with_example_weights`` then keeps it)
            it = DevicePrefetchIterator(
                it, prefetch=prefetch, pad_to="auto" if pad else None,
                pad_when=self._pad_when, device=self.device,
                transform=self._example_weights if pad else None)
        # listener capability scan hoisted out of the per-batch path
        self._stash_features = any(getattr(l, "needs_batch_features", False)
                                   for l in self.listeners)
        # a restored checkpoint's cursor moves the iterator to the batch
        # after the last dispatched one; the pass index is pinned for
        # the pass (resilience/durable.py)
        consume_restored_cursor(self, it)
        capture_cursor_pass(self, it)
        try:
            for _ in range(epochs):
                for lst in self.listeners:
                    lst.on_epoch_start(self, self.epoch_count)
                self._fit_epoch(it, k, pad)
                # the epoch counts as completed before on_epoch_end
                # (whose saves must record it so), which still receives
                # its index
                epoch_idx = self.epoch_count
                self.epoch_count += 1
                self._dispatched_in_epoch = 0
                self._canon_in_epoch = None
                self._cursor_pass += 1
                for lst in self.listeners:
                    lst.on_epoch_end(self, epoch_idx)
            # the one sync, after the final batch
            finalize_fit_telemetry(self)
        finally:
            self._stash_features = None
            self._cursor_pass = None
            close_listeners(self.listeners)
        return self

    def _pad_when(self, ds: DataSet) -> bool:
        """Whether tail padding applies to ``ds`` (the JAX package's
        predicate of each network)."""
        return ds.labels is not None

    def _example_weights(self, ds: DataSet) -> DataSet:
        """``ds`` with an example-weight mask where padding applies."""
        return with_example_weights(ds) if self._pad_when(ds) else ds

    def _runs_alone(self, ds: DataSet) -> bool:
        """Whether ``ds`` always runs by itself (the sequential
        network's tBPTT batches)."""
        return False

    def _fit_epoch(self, it, k: int, pad: bool):
        """One pass over the iterator: pad ragged batches to the
        canonical (first-batch) row count when ``pad``, and run each run
        of ``k`` same-signature batches as one group when k > 1; anything
        else (a signature change, the trailing partial group, a batch
        that runs alone) runs per batch. After each dispatch the cursor
        counts its batches and ``dispatch_boundary`` runs."""
        canon = self._canon_in_epoch
        group: List[DataSet] = []
        sig = None

        def flush():
            nonlocal sig
            if not group:
                sig = None
                return
            if len(group) == k:
                self._fit_group(group)
            else:
                for b in group:
                    self._fit_batch(b)
            self._dispatched_in_epoch += len(group)
            group.clear()
            sig = None
            dispatch_boundary(self)

        for ds in it:
            if self._runs_alone(ds):
                flush()
                self._fit_alone(ds)
                self._dispatched_in_epoch += 1
                dispatch_boundary(self)
                continue
            if canon is None:
                canon = ds.num_examples()
                self._canon_in_epoch = canon
            if pad and self._pad_when(ds):
                if ds.num_examples() < canon:
                    ds = pad_batch(ds, canon)
                # every batch carries an example-weight mask, so the
                # padded tail shares the full batches' signature (exact:
                # a ones-masked mean is the plain mean)
                ds = with_example_weights(ds)
            if k == 1:
                self._fit_batch(ds)
                self._dispatched_in_epoch += 1
                dispatch_boundary(self)
                continue
            s = group_signature(ds)
            if group and s != sig:
                flush()
            sig = s
            group.append(ds)
            if len(group) == k:
                flush()
        flush()

    def _fit_alone(self, ds: DataSet):
        raise NotImplementedError

    def _batch_loss_fn(self, ds: DataSet, gens, carry_rnn: bool = False):
        """The loss of batch ``ds`` as a function of the parameters, with
        a training step's generators ``gens``."""
        raise NotImplementedError

    def _fit_batch(self, ds: DataSet, carry_rnn: bool = False):
        """One eager optimizer step on ``ds``, then the listeners."""
        t0 = time.perf_counter()
        stash = self._stash_features
        if stash is None:   # a direct call outside fit: no hoisted scan
            stash = any(getattr(l, "needs_batch_features", False)
                        for l in self.listeners)
        if stash:
            self._last_batch_features = ds.features
        with span("etl"):
            loss_fn = self._batch_loss_fn(ds, self._step_gens(), carry_rnn)
        if phase_detail():
            loss = self._step(loss_fn, phases=True)
        else:
            with span("step"):
                loss = self._step(loss_fn)
        # a device scalar: the host read waits for score_value
        self.score_value = loss
        with span("listener"):
            n_real = num_real_examples(ds)
            for lst in self.listeners:
                if hasattr(lst, "record_batch"):
                    lst.record_batch(n_real)
                lst.iteration_done(self, self.iteration_count,
                                   self._score_raw)
        self.iteration_count += 1
        self.fit_dispatch["batch_steps"] += 1
        maybe_record_fit_iteration(self, n_real, time.perf_counter() - t0)

    def _fit_group(self, group: Sequence[DataSet]):
        """One K-step group: on the card one replay of its CUDA graph
        (:meth:`_group_on_card`), on the CPU the K steps in turn; then
        the sentinel's [K] flags queued (no host read) and the listeners
        fired once per logical step with a lazy element of the group's
        [K] device loss vector."""
        t0 = time.perf_counter()
        k = len(group)
        policy = effective_policy(self)
        self.state = _strip_stream(self.state)
        if self.device.type == "cuda":
            with span("step"):
                losses, flags, event = self._group_on_card(group, policy)
        else:
            with span("etl"):
                gens = [self._step_gens() for _ in range(k)]
            with span("step"):
                losses, flags = self._group_steps(group, policy, gens)
            event = None
            self.fit_dispatch["eager_group_steps"] += k
        if flags is not None:
            record_step_flag(self, flags, policy, event=event)
        self.score_value = losses[-1]
        with span("listener"):
            for i, b in enumerate(group):
                if self._stash_features:
                    self._last_batch_features = b.features
                for lst in self.listeners:
                    if hasattr(lst, "record_batch"):
                        lst.record_batch(num_real_examples(b))
                    lst.iteration_done(self, self.iteration_count, losses[i])
                self.iteration_count += 1
        maybe_record_fit_iteration(
            self, sum(num_real_examples(b) for b in group),
            time.perf_counter() - t0, n_batches=k)

    def _group_steps(self, group, policy, gens):
        """The K steps of a group, each selecting on the device (the
        body of the group's CUDA graph); returns the [K] losses and the
        [K] flags (None under "off")."""
        losses, flags = [], []
        for ds, g in zip(group, gens):
            loss, ok = self._step(self._batch_loss_fn(ds, g), on_device=True)
            losses.append(loss.float().reshape(()))
            flags.append(ok)
        return (torch.stack(losses),
                None if policy == "off" else torch.stack(flags))

    def _plan_key(self):
        """The execution plan a step graph bakes in (a graph's fusion
        level; none for the sequential network)."""
        return None

    def _step_graph_key(self, group, policy):
        """What a step graph bakes in: K, the dtype policy, the sentinel
        policy, the execution plan, the batch signature, the trees'
        structure and the updater with its hyperparameters (a step takes
        the learning rate as a Python number: a new rate needs a new
        graph)."""
        return ("scan", len(group), self.conf.dtype, policy,
                self._plan_key(), _batch_key(group[0]), _trees_key(self),
                repr(self.conf.updater))

    def _group_on_card(self, group, policy):
        """The group as one replay of its CUDA graph (captured at the
        second group of its key; the first runs its steps eagerly).
        Returns the [K] losses and flags (copies the next replay will not
        overwrite) and an event recorded after them."""
        key = self._step_graph_key(group, policy)
        sg = self._step_graph
        if sg is not None and sg.key != key:
            self._drop_step_graph()
            sg = None
        if sg is None:
            sg = self._step_graph = _StepGraph(key, self.device)
        cur = torch.cuda.current_stream(self.device)
        sg.stream.wait_stream(cur)
        with torch.cuda.stream(sg.stream):
            sg.fill(group, self._tensor)
            if not sg.warm:
                gens = [self._step_gens() for _ in group]
                losses, flags = self._group_steps(sg.slots, policy, gens)
                sg.warm = True
                self.fit_dispatch["eager_group_steps"] += len(group)
            else:
                if sg.graph is None:
                    self._capture(sg, policy)
                sg.draw(self)
                sg.bind(self)
                sg.replay(self)
                self.fit_dispatch["replays"] += 1
                self.fit_dispatch["graph_steps"] += len(group)
                losses = sg.losses.clone()
                flags = None if sg.flags is None else sg.flags.clone()
        cur.wait_stream(sg.stream)
        event = torch.cuda.Event()
        event.record(cur)
        return losses, flags, event

    def _capture(self, sg, policy):
        """Capture the K steps over the group's slots into ``sg.graph``:
        static copies of the parameter, updater and layer state trees
        become the network's trees, the graph's steps chain through its
        private pool, and the last step's trees are copied back into the
        static ones, so each replay updates them in place. The steps
        draw from the graph's own generators, one a (step, drawing
        layer), registered with the graph (each replay reads their seed
        and offset as :meth:`_StepGraph.draw` set them)."""
        t0 = time.perf_counter()
        sg.statics = tuple(
            tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, tree)
            for tree in (self.params, self.updater_state, self.state))
        sg.bind(self)
        graph = torch.cuda.CUDAGraph()
        sg.make_gens(self, graph)
        try:
            with _collector_paused(), torch.cuda.graph(
                    graph, stream=sg.stream,
                    capture_error_mode="thread_local"):
                sg.losses, sg.flags = self._group_steps(sg.slots, policy,
                                                        sg.gens)
                with torch.no_grad():
                    _tree_copy(sg.statics, (self.params, self.updater_state,
                                            self.state))
        finally:
            self.params, self.updater_state, self.state = sg.statics
        sg.graph = graph
        self.fit_dispatch["captures"] += 1
        record_capture(f"{type(self).__name__}.step_graph_k{len(sg.gens)}",
                       time.perf_counter() - t0)

    def _drop_step_graph(self):
        """Drop the K-step graph (its private memory pool with it); the
        next group of a fit warms and captures anew."""
        self._step_graph = None

    def rnn_clear_previous_state(self):
        """Drop the streaming state (LSTM h / c, KV caches, positional
        offsets) and the streamed-position counters."""
        self._clear_stream_positions()
        self.state = _strip_stream(self.state)

    def _clear_stream_positions(self):
        raise NotImplementedError


@contextlib.contextmanager
def _phase(name: str, on: bool):
    """The span ``name`` when ``on``, else nothing."""
    if on:
        with span(name):
            yield
    else:
        yield


@contextlib.contextmanager
def _collector_paused():
    """Keep Python's cyclic garbage collector off until the block ends (a
    graph's capture). Dead networks sit in reference cycles with their
    step graphs; a collection that ran inside a capture would tear such a
    graph down there, a call a capturing stream does not allow: the
    capture is invalidated and fails only at its end. The garbage waits
    for the next collection after the block (a full collection first
    would cost seconds in a large process)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class _StepGraph:
    """A K-step group's CUDA graph and what it reads and writes: the
    capture stream, K static input slots (DataSets of device tensors),
    the static parameter, updater and layer state trees it updates in
    place, and its static [K] losses and flags."""

    def __init__(self, key, device):
        self.key = key
        self.stream = torch.cuda.Stream(device)
        self.slots = None
        self.warm = False
        self.graph = None
        self.statics = None
        self.losses = self.flags = None
        #: [K] {layer key: generator} the graph's steps draw from, and the
        #: drawing layers' (position in layer order, key)
        self.gens = None
        self.draw_index = None

    def make_gens(self, net, graph):
        """The graph's generators, one a (step, drawing layer), each
        registered with ``graph`` before its capture (a draw from an
        unregistered generator cannot be captured), seeded as the
        training generator."""
        k = len(self.slots)
        self.draw_index = net._draw_index()
        seed = net._train_gen.initial_seed()
        self.gens = [{key: torch.Generator(device=net.device).manual_seed(
            seed) for _, key in self.draw_index} for _ in range(k)]
        for gens in self.gens:
            for g in gens.values():
                graph.register_generator_state(g)

    def draw(self, net):
        """Before a replay: advance the training generator by K steps, as
        K eager steps would, and set the generator of each (step j,
        layer at position i) to the seed and offset that step's eager
        twin takes (:func:`_philox_at`). A replay starts each
        generator's draws at the offset set here and moves it on by the
        draws' counters; it is set again before the next."""
        seed = net._train_gen.initial_seed()
        for gens in self.gens:
            base = net._step_base()
            for i, key in self.draw_index:
                _philox_at(gens[key], seed, base, i)

    def fill(self, group, to_tensor):
        """Copy the group's batches into the slots (made at the first
        group), on the current (capture) stream."""
        if self.slots is None:
            self.slots = [map_batch(lambda x: torch.empty_like(
                to_tensor(x)), b) for b in group]
        for slot, b in zip(self.slots, group):
            for d, x in zip(batch_arrays(slot), batch_arrays(b),
                            strict=True):
                d.copy_(torch.as_tensor(np.ascontiguousarray(x))
                        if isinstance(x, np.ndarray) else x)

    def bind(self, net):
        """Make the static trees the network's, first copying in the
        values of trees an eager step replaced since the last replay."""
        trees = (net.params, net.updater_state, net.state)
        if any(a is not b for a, b in zip(_tensors(trees),
                                          _tensors(self.statics),
                                          strict=True)):
            with torch.no_grad():
                _tree_copy(self.statics, trees)
        net.params, net.updater_state, net.state = self.statics

    def replay(self, net):
        """One replay over the network's (static) trees. It writes the
        parameters in place, so the network's compute-dtype copy of them
        is dropped, and so are a graph's kernel-layout weights (kept per
        weight tensor, which a replay rewrites without replacing)."""
        self.graph.replay()
        net._compute = None
        layouts = getattr(net, "_layouts", None)
        if layouts:
            layouts.clear()


def _host(x):
    """``x`` as a host numpy array (a list of heads stacked, as
    ``np.asarray`` stacks the JAX package's), None as None."""
    if isinstance(x, (list, tuple)):
        return np.asarray([_host(t) for t in x])
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return x


def _philox_at(gen, seed, base, i):
    """``gen`` set to the Philox stream ``seed`` at layer position ``i``
    of the step whose base offset is ``base``."""
    gen.manual_seed(seed)
    gen.set_offset((base + i * _SPLIT) % _OFFSETS)
    return gen


def _tensors(trees):
    """The tensor leaves of a tuple of trees, in a fixed order."""
    return [t for tree in trees for t in tree_leaves(tree)
            if torch.is_tensor(t)]


def _tree_copy(dst, src):
    """Copy every tensor leaf of the trees ``src`` into ``dst``'s (same
    structure and shapes)."""
    for d, s in zip(_tensors(dst), _tensors(src), strict=True):
        d.copy_(s)


def _trees_key(net):
    """The structure of a network's parameter, updater state and layer
    state trees (a step graph's key): each leaf's shape and dtype, or
    its type."""
    def leaf(x):
        if torch.is_tensor(x):
            return tuple(x.shape), str(x.dtype)
        return type(x).__name__
    return tuple(tree_map(leaf, t)
                 for t in (net.params, net.updater_state, net.state))


def _batch_key(ds: DataSet):
    """A batch's shapes, mask presence and dtypes (a step graph's input
    signature)."""
    return group_signature(ds), tuple(_dtype_name(x)
                                      for x in batch_arrays(ds))


def _dtype_name(x) -> str:
    """The dtype a batch array has on the network (float64 arrays
    become float32 there), by name."""
    if torch.is_tensor(x):
        name = str(x.dtype).replace("torch.", "")
    else:
        name = np.asarray(x).dtype.name
    return "float32" if name == "float64" else name


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
