"""Configuration DSL (the subset the ported models build)."""

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType  # noqa: F401
from deeplearning4j_tpu_torch.nn.conf.network import (  # noqa: F401
    ComputationGraphConfiguration, MultiLayerConfiguration,
    NeuralNetConfiguration)
