"""Layer implementations with hand-written kernels: flash attention
(``flash_attention``), the fused bottleneck (``bottleneck``), the fused
stem (``stem``) and the fused bn -> act -> 1x1 conv (``fused``, exported
here as the JAX package's ``nn/layers/fused.py`` names)."""

from deeplearning4j_tpu_torch.nn.layers.fused import (  # noqa: F401
    FUSED_BWD, FUSED_FWD, FusedMatmul, bn_act_conv1x1,
    fused_conv1x1_supported, fused_matmul, fused_matmul_bwd,
    fused_matmul_bwd_plain, fused_matmul_plain)

__all__ = ["FUSED_BWD", "FUSED_FWD", "FusedMatmul", "bn_act_conv1x1",
           "fused_conv1x1_supported", "fused_matmul", "fused_matmul_bwd",
           "fused_matmul_bwd_plain", "fused_matmul_plain"]
