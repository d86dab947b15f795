"""ZooModel base.

Counterpart of ``deeplearning4j_tpu/zoo/base.py``: ``conf()`` describes
the network, ``init(device=None)`` builds it with seeded weights on the
card (``"cuda"`` unless the caller passes ``device="cpu"``). The JAX
zoo's build options: ``data_format="NHWC"`` runs the CNN stack in the
internal NHWC layout (the public input stays NCHW), and
``execution_plan="auto" | "fused" | "xla"`` resolves the execution plan
at build time (``tuning/plan.py``, "auto" from the kernel-crossover
store), for inference and training alike. The JAX zoo's direct
``fuse=`` switches set the fusion level as they are: ``fuse=True`` the
bn -> act -> 1x1-conv plan (``nn/layers/fused.py``), ``fuse=
"bottleneck"`` the bottleneck plan; ``fuse=`` with ``execution_plan=``
is refused, as there. A model with no such chain (the transformer)
builds with an empty plan. A model whose ``conf()`` is a sequential
``MultiLayerConfiguration`` (the text LSTM) builds a
``MultiLayerNetwork``: ``execution_plan=`` validates and changes
nothing there, and ``fuse=`` is refused (the fused chains are graph
features), as in the JAX zoo.
Pretrained checkpoints and the model registry come with the rest of the
zoo (ROADMAP.md A11).
"""

from __future__ import annotations

__all__ = ["ZooModel"]

#: the JAX zoo's build options
_OPTIONS = ("data_format", "execution_plan", "fuse")


class ZooModel:
    """Base for zoo models."""

    def __init__(self, num_classes: int = 1000, seed: int = 12345,
                 **options):
        for k in options:
            if k not in _OPTIONS:
                raise TypeError(f"unexpected argument {k!r}")
        self.num_classes = num_classes
        self.seed = seed
        self.options = options

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build and initialize the network on ``device`` (default
        ``"cuda"``), in the chosen layout and execution plan."""
        from deeplearning4j_tpu_torch.nn.conf.network import (
            MultiLayerConfiguration)
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.tuning.plan import apply_execution_plan
        level = self.options.get("fuse", False)
        plan = self.options.get("execution_plan")
        if level and plan:
            raise ValueError(
                f"{type(self).__name__}: fuse= and execution_plan= are "
                "mutually exclusive (execution_plan supersedes fuse)")
        conf = self.conf()
        if isinstance(conf, MultiLayerConfiguration):
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork)
            if level or self.options.get("data_format"):
                raise ValueError(
                    f"{type(self).__name__}: fuse= and data_format= need a "
                    "ComputationGraph model")
            net = MultiLayerNetwork(conf).init(device)
            apply_execution_plan(net, plan)
            return net
        if self.options.get("data_format"):
            conf.use_cnn_data_format(self.options["data_format"])
        net = ComputationGraph(conf).init(device)
        if level:
            net.set_fusion(level)
        else:
            apply_execution_plan(net, plan)
        return net
