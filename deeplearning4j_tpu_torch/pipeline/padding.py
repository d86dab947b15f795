"""Tail-batch shape bucketing: pad ragged batches to the canonical batch
shape with an example-weight mask folded into the loss.

Counterpart of ``deeplearning4j_tpu/pipeline/padding.py``: the same
arrays, on numpy, for the same batch.

The last batch of an epoch is usually smaller than the rest. Dispatching
it ragged captures a SECOND CUDA graph of the training step for that one
shape (the recapture the monitoring counter counts), and under
``steps_per_dispatch > 1`` it keeps the batch out of its K-step group.
Instead `pad_batch` repeats a real row up to the canonical row count and
zeroes the padded rows' weight in the labels mask. The loss reduction
(``nn/losses._reduce``) sums ``per_example * mask`` and divides by the
UNMASKED count, so the score and every gradient term of a padded batch
are exactly the math of the unpadded batch: padded rows multiply by 0
into the sum and are excluded from the normalizer. Repeating a real row
(rather than zero-filling) keeps the padded rows' forward activations
finite, so no NaN can leak through ``0 * nan`` in the masked sum.

`example_weight_mask` builds the all-ones mask for a FULL batch: under
padding every batch in a fit carries an explicit example-weight mask, so
the whole epoch shares one step signature (ones-masked mean == plain
mean, exactly — same sum, same count).

Caveat: layers whose statistics couple rows across the batch
(BatchNormalization batch stats in train mode) see the padded rows, so
with such layers the padded tail is an approximation, not an identity.
Everything row-wise (dense/conv/rnn/attention, all losses) is exact.

Host-side module by design: padding runs BEFORE the device transfer
(in the fit loop or in DevicePrefetchIterator's worker), on numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet

__all__ = ["example_weight_mask", "group_signature", "num_real_examples",
           "pad_batch", "with_example_weights"]


def _pad_rows(a, target: int):
    """Pad axis 0 to `target` rows by repeating row 0 (dict-aware)."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: _pad_rows(v, target) for k, v in a.items()}
    a = np.asarray(a)
    n = a.shape[0]
    if n >= target:
        return a
    reps = np.repeat(a[:1], target - n, axis=0)
    return np.concatenate([a, reps], axis=0)


def _zero_rows_from(m, start: int):
    """Zero mask rows >= start (dict-aware); returns a copy."""
    if m is None:
        return None
    if isinstance(m, dict):
        return {k: _zero_rows_from(v, start) for k, v in m.items()}
    m = np.array(m, copy=True)
    m[start:] = 0
    return m


def example_weight_mask(labels):
    """All-ones example-weight mask matching the labels layout: [N, C]
    labels -> [N] mask; [N, C, T] sequence labels -> [N, T] (the
    per-timestep mask RnnOutputLayer folds); dict labels -> dict of
    masks. Built from shape METADATA only — never materializes device
    values."""
    if isinstance(labels, dict):
        return {k: example_weight_mask(v) for k, v in labels.items()}
    shp = tuple(labels.shape)
    if len(shp) >= 3:
        return np.ones((shp[0], shp[-1]), np.float32)
    return np.ones((shp[0],), np.float32)


def with_example_weights(ds: DataSet) -> DataSet:
    """Attach an all-ones example-weight labels mask to a batch that has
    none, so full batches share one step signature with padded tails.
    Exact: the masked mean over an all-ones mask IS the plain mean."""
    if ds.labels_mask is not None or ds.labels is None:
        return ds
    out = DataSet(ds.features, ds.labels, ds.features_mask,
                  example_weight_mask(ds.labels))
    out.real_examples = num_real_examples(ds)
    return out


def pad_batch(ds: DataSet, target_n: int) -> DataSet:
    """Pad a ragged batch to `target_n` rows; the returned DataSet's
    labels mask zeroes the padded rows (synthesizing an all-ones mask
    first when the batch had none). `num_real_examples` on the result
    still reports the original row count for throughput stats."""
    n = ds.num_examples()
    if n >= target_n:
        return ds
    lmask = ds.labels_mask
    if lmask is None and ds.labels is not None:
        lmask = example_weight_mask(ds.labels)
    lmask = _zero_rows_from(_pad_rows(lmask, target_n), n)
    out = DataSet(_pad_rows(ds.features, target_n),
                  _pad_rows(ds.labels, target_n),
                  _pad_rows(ds.features_mask, target_n),
                  lmask)
    out.real_examples = n
    return out


def num_real_examples(ds: DataSet) -> int:
    """Rows that carry loss weight: the pre-padding count for a padded
    batch, num_examples() otherwise."""
    n = getattr(ds, "real_examples", None)
    return int(n) if n is not None else ds.num_examples()


def _shape_of(x) -> Optional[tuple]:
    if x is None:
        return None
    if isinstance(x, dict):
        return tuple(sorted((k, tuple(v.shape)) for k, v in x.items()))
    return tuple(x.shape)


def group_signature(ds: DataSet) -> tuple:
    """Hashable stacking signature of a batch: array shapes and mask
    presence. Batches are fused into one K-step dispatch only when
    their signatures are identical — anything else (ragged shape that
    escaped padding, mixed mask presence) falls back to the per-batch
    step rather than forcing a recapture or a semantic change."""
    return (_shape_of(ds.features), _shape_of(ds.labels),
            _shape_of(ds.features_mask), _shape_of(ds.labels_mask))
