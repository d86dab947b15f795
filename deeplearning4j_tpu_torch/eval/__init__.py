"""Evaluation: classification, regression, ROC, binary and calibration
metrics, their JSON wire form and the HTML exports.

Counterpart of ``deeplearning4j_tpu/eval/``, with the same exports.
Everything here is host-side numpy: the networks' ``evaluate`` runs the
forward on the card and hands each batch's f32 heads to
:meth:`Evaluation.eval` as host arrays.
"""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    Evaluation,
    RegressionEvaluation,
    ConfusionMatrix,
)
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass  # noqa: F401
from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary  # noqa: F401
from deeplearning4j_tpu_torch.eval.calibration import EvaluationCalibration  # noqa: F401
from deeplearning4j_tpu_torch.eval.serde import (  # noqa: F401
    from_dict as eval_from_dict,
    from_json as eval_from_json,
    to_dict as eval_to_dict,
    to_json as eval_to_json,
)
