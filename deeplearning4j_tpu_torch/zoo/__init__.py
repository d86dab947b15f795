"""Model zoo (the models ported so far)."""

from deeplearning4j_tpu_torch.zoo.base import ZooModel  # noqa: F401
from deeplearning4j_tpu_torch.zoo.lenet import LeNet  # noqa: F401
from deeplearning4j_tpu_torch.zoo.resnet import ResNet50  # noqa: F401
from deeplearning4j_tpu_torch.zoo.text_lstm import (  # noqa: F401
    TextGenerationLSTM)
from deeplearning4j_tpu_torch.zoo.transformer import (  # noqa: F401
    TextGenerationTransformer)
