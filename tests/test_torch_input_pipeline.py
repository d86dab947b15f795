"""The port's input pipeline against the JAX package's
(deeplearning4j_tpu_torch/pipeline/), on the CPU, where the prefetch
stage makes host tensors (the pinned ring and the copy stream run on the
card: ``chip_smoke.py``'s ``prefetch_lstm`` phase).

- ``pad_batch``, ``with_example_weights``, ``example_weight_mask``,
  ``num_real_examples`` and ``group_signature`` give the JAX package's
  arrays and signatures for the same batches: 2-D and sequence labels,
  dict-keyed graph batches, a batch with its own labels mask, a full
  batch;
- ``DevicePrefetchIterator`` behaves as the JAX one over the same base
  iterators: the batches (padded by ``pad_to`` and ``pad_when``), the
  telemetry counts, a base that fails (its error re-raised in the
  consumer after the batches before it), a flaky base retried through
  ``RetryPolicy`` (the same batches and retry counts), a generator base
  that dies under retry (the original error, not a truncated pass), the
  consumer-side cursor (``state`` / ``restore_state``) and an abandoned
  pass; ``mesh=`` is refused (ROADMAP.md A9).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ArrayDataSetIterator as JArrayIt)
from deeplearning4j_tpu.monitoring import metrics as jmetrics
from deeplearning4j_tpu.pipeline import padding as jpadding
from deeplearning4j_tpu.pipeline.prefetch import (
    DevicePrefetchIterator as JPrefetch)
from deeplearning4j_tpu.resilience.retry import RetryPolicy as JRetry
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.monitoring import metrics as tmetrics
from deeplearning4j_tpu_torch.pipeline import padding as tpadding
from deeplearning4j_tpu_torch.pipeline.prefetch import (
    DevicePrefetchIterator)
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy

RNG = np.random.default_rng(0)


def _arr(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


CASES = {
    "dense": dict(features=_arr(3, 4), labels=_arr(3, 2)),
    "sequence": dict(features=_arr(3, 5, 7), labels=_arr(3, 2, 7)),
    "graph_dicts": dict(features={"a": _arr(3, 4), "b": _arr(3, 2, 6)},
                        labels={"out": _arr(3, 5)}),
    "own_mask": dict(features=_arr(3, 4), labels=_arr(3, 2, 6),
                     labels_mask=(RNG.random((3, 6)) > 0.4)
                     .astype(np.float32)),
    "features_mask": dict(features=_arr(3, 4, 6), labels=_arr(3, 2),
                          features_mask=np.ones((3, 6), np.float32)),
    "no_labels": dict(features=_arr(3, 4)),
}


def _np(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x.numpy() if torch.is_tensor(x) else x)


def _assert_same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys()
        for k in b:
            _assert_same(a[k], b[k])
    elif b is None:
        assert a is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _assert_batches_equal(got, want):
    for f in ("features", "labels", "features_mask", "labels_mask"):
        _assert_same(getattr(got, f), getattr(want, f))
    assert tpadding.num_real_examples(got) == \
        jpadding.num_real_examples(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_padding_gives_the_jax_arrays(case):
    kw = CASES[case]
    t, j = DataSet(**kw), JDataSet(**kw)
    for target in (3, 5):
        _assert_batches_equal(tpadding.pad_batch(t, target),
                              jpadding.pad_batch(j, target))
        if target > 3 and kw.get("labels") is not None:
            assert tpadding.num_real_examples(
                tpadding.pad_batch(t, target)) == 3
    _assert_batches_equal(tpadding.with_example_weights(t),
                          jpadding.with_example_weights(j))
    assert tpadding.group_signature(t) == jpadding.group_signature(j)
    assert tpadding.group_signature(tpadding.with_example_weights(
        tpadding.pad_batch(t, 5))) == jpadding.group_signature(
        jpadding.with_example_weights(jpadding.pad_batch(j, 5)))
    if kw.get("labels") is not None:
        _assert_same(tpadding.example_weight_mask(kw["labels"]),
                     jpadding.example_weight_mask(kw["labels"]))


def _data(n=11, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 4)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _counters(m, r):
    return {n: (0.0 if r.get(n) is None else r.get(n).value())
            for n in ("dl4jtpu_prefetch_h2d_bytes_total",
                      "dl4jtpu_prefetch_batches_total")}


@pytest.mark.parametrize("pad_to", [None, "auto", 4])
def test_prefetch_delivers_the_jax_batches(pad_to):
    x, y = _data()
    jr, tr = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    kw = dict(prefetch=2, pad_to=pad_to,
              pad_when=lambda ds: ds.num_examples() != 2)
    jit = JPrefetch(JArrayIt(x, y, 3), registry=jr, **kw)
    tit = DevicePrefetchIterator(ArrayDataSetIterator(x, y, 3), registry=tr,
                                 **kw)
    for _ in range(2):                      # two passes
        got, want = list(tit), list(jit)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert all(torch.is_tensor(v) for v in (g.features, g.labels))
            _assert_batches_equal(g, w)
    assert _counters(tmetrics, tr) == _counters(jmetrics, jr)
    assert tit.last_worker_error is None


class _Base:
    """An object iterator over fixed batches; ``fail_at`` pulls raise
    ``exc`` (once each) before the batch at that position."""

    def __init__(self, make_ds, x, y, fail_at=(), exc=OSError):
        self.make_ds, self.x, self.y = make_ds, x, y
        self.fail_at, self.exc = set(fail_at), exc

    def __iter__(self):
        base = self

        class It:
            i, failed = 0, set()

            def __next__(self):
                if self.i >= len(base.x) // 2:
                    raise StopIteration
                if self.i in base.fail_at and self.i not in self.failed:
                    self.failed.add(self.i)
                    raise base.exc(f"flaky pull {self.i}")
                s = slice(2 * self.i, 2 * self.i + 2)
                self.i += 1
                return base.make_ds(base.x[s], base.y[s])

            def __iter__(self):
                return self
        return It()


def _gen_base(make_ds, x, y, n_ok, exc):
    class Base:
        def __iter__(self):
            for i in range(n_ok):
                yield make_ds(x[2 * i:2 * i + 2], y[2 * i:2 * i + 2])
            raise exc("base died")
    return Base()


def _drain(it):
    """The batches a pass delivers and the error it ends with."""
    got = []
    try:
        for ds in it:
            got.append(ds)
    except Exception as e:  # noqa: BLE001 — the error is the result
        return got, (type(e).__name__, str(e))
    return got, None


def _retries(m):
    c = m.global_registry().get("dl4jtpu_retries_total")
    return 0.0 if c is None else c.total()


@pytest.mark.parametrize("kind", ["failing", "retried", "dead_generator"])
def test_prefetch_errors_and_retries_as_jax(kind):
    x, y = _data(n=10)
    out = {}
    for name, make_ds, pre, policy, m in (
            ("jax", JDataSet, JPrefetch, JRetry, jmetrics),
            ("port", DataSet, DevicePrefetchIterator, RetryPolicy,
             tmetrics)):
        retry = None
        if kind == "failing":
            base = _Base(make_ds, x, y, fail_at=(2,), exc=ValueError)
        elif kind == "retried":
            base = _Base(make_ds, x, y, fail_at=(1, 3))
            retry = policy(max_attempts=3, base_delay=0.0, jitter=0.0)
        else:
            base = _gen_base(make_ds, x, y, 2, OSError)
            retry = policy(max_attempts=3, base_delay=0.0, jitter=0.0)
        r0 = _retries(m)
        got, err = _drain(pre(base, prefetch=2, retry=retry))
        out[name] = ([np.asarray(_np(d.features)) for d in got], err,
                     _retries(m) - r0)
    (tb, terr, tret), (jb, jerr, jret) = out["port"], out["jax"]
    assert terr == jerr and tret == jret
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)
    want = {"failing": (2, "ValueError", 0), "retried": (5, None, 2),
            "dead_generator": (2, "OSError", 1)}[kind]
    assert (len(tb), terr and terr[0], tret) == want


def test_the_cursor_counts_what_the_consumer_took_as_jax():
    x, y = _data(n=10)
    jit = JPrefetch(JArrayIt(x, y, 2), prefetch=3)
    tit = DevicePrefetchIterator(ArrayDataSetIterator(x, y, 2), prefetch=3)
    for it in (jit, tit):
        gen = iter(it)
        next(gen)
        next(gen)
        assert it.state() == {"epoch": 0, "pos": 2}
        gen.close()                 # an abandoned pass stops its worker
        it._last_thread.join(timeout=10)
        assert not it._last_thread.is_alive()
        it.restore_state({"epoch": 0, "pos": 2})
        assert it.state() == {"epoch": 0, "pos": 2}
    rest_t, rest_j = list(tit), list(jit)
    assert len(rest_t) == len(rest_j) == 3
    for g, w in zip(rest_t, rest_j):
        _assert_batches_equal(g, w)
    assert tit.state()["pos"] == 0


def test_what_the_stage_refuses():
    x, y = _data()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        DevicePrefetchIterator(ArrayDataSetIterator(x, y), mesh=object())
    with pytest.raises(ValueError, match="prefetch depth"):
        DevicePrefetchIterator(ArrayDataSetIterator(x, y), prefetch=0)
    with pytest.raises(ValueError, match="pad_to"):
        DevicePrefetchIterator(ArrayDataSetIterator(x, y), pad_to=0)
