"""Shared JSON serde surface for evaluation classes.

Counterpart of ``deeplearning4j_tpu/eval/base.py``. Equivalent of the
reference's Jackson annotations on eval classes
(eval/serde/ROCSerializer.java, ConfusionMatrixSerializer.java,
ConfusionMatrixDeserializer.java): every evaluation object round-trips
through JSON so results can be persisted, shipped to the UI, and reloaded.
"""

from __future__ import annotations


class EvalJsonMixin:
    """to_json/from_json via the central eval/serde registry."""

    def to_json(self) -> str:
        from deeplearning4j_tpu_torch.eval import serde
        return serde.to_json(self)

    def to_dict(self) -> dict:
        from deeplearning4j_tpu_torch.eval import serde
        return serde.to_dict(self)

    @classmethod
    def from_json(cls, s: str):
        from deeplearning4j_tpu_torch.eval import serde
        obj = serde.from_json(s)
        if not isinstance(obj, cls):
            raise TypeError(
                f"JSON encodes {type(obj).__name__}, not {cls.__name__}")
        return obj

    @classmethod
    def from_dict(cls, d: dict):
        from deeplearning4j_tpu_torch.eval import serde
        obj = serde.from_dict(d)
        if not isinstance(obj, cls):
            raise TypeError(
                f"dict encodes {type(obj).__name__}, not {cls.__name__}")
        return obj
