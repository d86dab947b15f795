"""ResNet50: bottleneck residual blocks as a ComputationGraph.

Counterpart of ``deeplearning4j_tpu/zoo/resnet.py``, the same graph with
the same vertex names: the stem (ZeroPadding(3) -> 7x7/2 conv -> BN ->
relu -> 3x3/2 max pool), four stages of 3, 4, 6 and 3 bottlenecks
(conv1x1 -> BN -> relu -> conv3x3 -> BN -> relu -> conv1x1 -> BN -> add
-> relu; the first block of each stage downsamples through a conv1x1 ->
BN shortcut, at stride 1 in s2 and 2 after), global average pooling
and a softmax output. He ("relu") weight init, ``Nesterovs(0.1,
momentum=0.9)`` unless ``updater=`` says otherwise.

Its fast path is ``data_format="NHWC", execution_plan="fused"`` (every
bottleneck through the bottleneck kernels, in ``output`` and in ``fit``,
whose backward runs the backward kernels), then
``net.set_fusion("bottleneck", stem=True)`` for the stem kernels too
(inference only: training with them is the next slice).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer,
    GlobalPoolingLayer, OutputLayer, SubsamplingLayer, ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.updater import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel

__all__ = ["ResNet50"]


class ResNet50(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 12345,
                 height: int = 224, width: int = 224, channels: int = 3,
                 updater=None, **options):
        super().__init__(num_classes, seed, **options)
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater if updater is not None else Nesterovs(
            1e-1, momentum=0.9)

    def _conv_bn(self, g, name, n_out, kernel, stride, pad, inp,
                 activation="relu"):
        g.add_layer(f"{name}_conv",
                    ConvolutionLayer(n_out=n_out, kernel=kernel,
                                     stride=stride, padding=pad,
                                     activation="identity", has_bias=False),
                    inp)
        g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
        if activation:
            g.add_layer(f"{name}_act", ActivationLayer(activation=activation),
                        f"{name}_bn")
            return f"{name}_act"
        return f"{name}_bn"

    def _bottleneck(self, g, name, inp, filters, stride=(1, 1),
                    downsample=False):
        f1, f2, f3 = filters
        x = self._conv_bn(g, f"{name}_a", f1, (1, 1), stride, (0, 0), inp)
        x = self._conv_bn(g, f"{name}_b", f2, (3, 3), (1, 1), (1, 1), x)
        x = self._conv_bn(g, f"{name}_c", f3, (1, 1), (1, 1), (0, 0), x,
                          activation=None)
        if downsample:
            skip = self._conv_bn(g, f"{name}_skip", f3, (1, 1), stride,
                                 (0, 0), inp, activation=None)
        else:
            skip = inp
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, skip)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_out"

    def conf(self):
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(self.updater)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        g.add_layer("stem_pad", ZeroPaddingLayer(padding=(3, 3, 3, 3)),
                    "input")
        x = self._conv_bn(g, "stem", 64, (7, 7), (2, 2), (0, 0), "stem_pad")
        g.add_layer("stem_pool",
                    SubsamplingLayer(pooling_type="max", kernel=(3, 3),
                                     stride=(2, 2), padding=(1, 1)), x)
        x = "stem_pool"
        stages = [("s2", [64, 64, 256], 3, (1, 1)),
                  ("s3", [128, 128, 512], 4, (2, 2)),
                  ("s4", [256, 256, 1024], 6, (2, 2)),
                  ("s5", [512, 512, 2048], 3, (2, 2))]
        for sname, filters, reps, stride in stages:
            x = self._bottleneck(g, f"{sname}b0", x, filters, stride=stride,
                                 downsample=True)
            for r in range(1, reps):
                x = self._bottleneck(g, f"{sname}b{r}", x, filters)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          loss="mcxent",
                                          activation="softmax"), "avgpool")
        return g.set_outputs("output").build()
