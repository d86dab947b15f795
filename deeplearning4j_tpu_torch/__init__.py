"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of deeplearning4j_tpu.

A second package beside the JAX one, for an NVIDIA H100. Each module
mirrors its counterpart's path in ``deeplearning4j_tpu`` (for example
``serving/engine.py``), and each TPU kernel on a ported path is a
hand-written CUDA C++ kernel for Hopper (``sm_90a``) beside a plain
PyTorch version of the same function. The port imports ``torch`` and
numpy, never ``jax`` nor anything of ``deeplearning4j_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; without a CUDA device they raise instead of
carrying on quietly on the CPU.

Ported so far: the rope transformer served through the paged
generation engine (``zoo.TextGenerationTransformer``,
``serving.GenerationEngine``) with the paged-decode kernel
(``serving/csrc/paged_attention.cu``); the transformer trained through
``ComputationGraph.fit`` (losses, Sgd/Adam, learned positions) with the
flash-attention forward and backward kernels
(``nn/layers/csrc/flash_attention.cu``); ResNet50 (``zoo.ResNet50``)
classifying and training on the fused execution plan, its bottleneck
blocks and stem through the conv kernels and their backward kernels
(``nn/layers/csrc/bottleneck.cu``, ``bottleneck_bwd.cu``, ``stem.cu``,
``stem_bwd.cu``), the plan resolved from a measured kernel-crossover
store (``tuning``); and the fit loop of both networks (listeners, tail
padding, a device prefetch stage, ``steps_per_dispatch=K`` as one CUDA
graph of K steps), publishing into the monitoring registry
(``monitoring``, ``pipeline``, ``optimize``). ROADMAP.md lists the
rest.
"""

__version__ = "0.1.0"
