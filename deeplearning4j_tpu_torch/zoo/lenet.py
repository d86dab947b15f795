"""LeNet: conv 5x5 (20) -> max pool 2 -> conv 5x5 (50) -> max pool 2 ->
dense 500 (relu) -> softmax.

Counterpart of ``deeplearning4j_tpu/zoo/lenet.py`` (the reference's
first BASELINE configuration, LeNet on MNIST), the same sequential
network: xavier weights, ``Adam(1e-3)`` unless ``updater`` says
otherwise, NCHW input ``[N, channels, height, width]``; the flatten
before the dense layer is the inferred ``CnnToFeedForwardPreProcessor``.
The convolutions and pools are PyTorch's own (the JAX package runs them
through XLA, no Pallas kernel).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.updater import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel

__all__ = ["LeNet"]


class LeNet(ZooModel):
    """The JAX zoo model's constructor; ``updater`` defaults to
    ``Adam(1e-3)``."""

    def __init__(self, num_classes: int = 10, seed: int = 12345,
                 height: int = 28, width: int = 28, channels: int = 1,
                 updater=None, **kw):
        super().__init__(num_classes, seed, **kw)
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater if updater is not None else Adam(1e-3)

    def conf(self):
        return (NeuralNetConfiguration.Builder()
                .seed(self.seed)
                .updater(self.updater)
                .weight_init("xavier")
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel=(5, 5),
                                        stride=(1, 1),
                                        activation="identity"))
                .layer(SubsamplingLayer(pooling_type="max", kernel=(2, 2),
                                        stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel=(5, 5),
                                        stride=(1, 1),
                                        activation="identity"))
                .layer(SubsamplingLayer(pooling_type="max", kernel=(2, 2),
                                        stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes, loss="mcxent",
                                   activation="softmax"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())
