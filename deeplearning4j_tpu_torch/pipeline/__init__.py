"""Input pipeline: device prefetch and tail-batch shape bucketing.

Counterpart of ``deeplearning4j_tpu/pipeline/``, the stages feeding
``fit(..., steps_per_dispatch=K, prefetch=depth, pad_tail=...)``:

- ``prefetch.DevicePrefetchIterator``: a bounded background stage that
  copies batches to the card ahead of the consumer (a pinned staging
  ring and a copy stream), with queue-depth and bytes-moved telemetry
  in the global metrics registry;
- ``padding.pad_batch`` / ``padding.with_example_weights``: pad the
  ragged last batch of an epoch to the canonical batch shape with an
  example-weight mask folded into the loss, so a fit's batches share one
  K-step group signature (exact for row-wise layers; see padding.py for
  the BatchNorm caveat).
"""

from deeplearning4j_tpu_torch.pipeline.padding import (  # noqa: F401
    example_weight_mask, group_signature, num_real_examples, pad_batch,
    with_example_weights)
from deeplearning4j_tpu_torch.pipeline.prefetch import (  # noqa: F401
    PREFETCH_BATCHES, PREFETCH_BYTES, PREFETCH_DEPTH,
    DevicePrefetchIterator, prefetch_bytes_total)

__all__ = [
    "DevicePrefetchIterator", "PREFETCH_BATCHES", "PREFETCH_BYTES",
    "PREFETCH_DEPTH", "example_weight_mask", "group_signature",
    "num_real_examples", "pad_batch", "prefetch_bytes_total",
    "with_example_weights",
]
