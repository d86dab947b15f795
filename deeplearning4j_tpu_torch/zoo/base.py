"""ZooModel base.

Counterpart of ``deeplearning4j_tpu/zoo/base.py``: ``conf()`` describes
the network, ``init(device=None)`` builds it with seeded weights on the
card (``"cuda"`` unless the caller passes ``device="cpu"``). A model's
own keywords (a transformer's ``updater=``) are its constructor's.
Pretrained checkpoints, the model registry and execution plans come
with the formats and the fused plans (ROADMAP.md A1, A4).
"""

from __future__ import annotations

__all__ = ["ZooModel"]

#: the JAX zoo's keyword options this port refuses until ROADMAP.md A4
_NOT_PORTED = ("fuse", "execution_plan", "data_format")


class ZooModel:
    """Base for zoo models."""

    def __init__(self, num_classes: int = 1000, seed: int = 12345,
                 **not_ported):
        for k, v in not_ported.items():
            if k not in _NOT_PORTED:
                raise TypeError(f"unexpected argument {k!r}")
            if v:
                raise NotImplementedError(
                    f"{k}= is not ported yet (ROADMAP.md A4)")
        self.num_classes = num_classes
        self.seed = seed

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build and initialize the network on ``device`` (default
        ``"cuda"``)."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        return ComputationGraph(self.conf()).init(device)
