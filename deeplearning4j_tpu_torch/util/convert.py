"""Carry parameters between the JAX package and the port.

The port keeps every parameter layout of the JAX package: attention and
output weights are ``[n_in, n_out]``, the kernel-1 ``Convolution1DLayer``
weight is ``[n_out, n_in, 1]``, biases and LayerNorm gains are 1-D. So
a JAX graph's ``net.params``, taken to numpy, loads into the port's
graph under the same vertex and parameter names with no transposes
(``tests/test_torch_transformer.py`` pins that).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(np_params, device=None) -> dict:
    """``{vertex: {name: array}}`` of floating arrays → the same tree of
    float32 tensors on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    out = {}
    for vertex, p in np_params.items():
        out[vertex] = {}
        for name, a in p.items():
            arr = np.asarray(a)
            if not np.issubdtype(arr.dtype, np.floating):
                raise TypeError(f"{vertex}.{name}: expected a floating "
                                f"array, got {arr.dtype}")
            out[vertex][name] = torch.tensor(arr, dtype=torch.float32,
                                             device=dev)
    return out


def params_to_numpy(params) -> dict:
    """The port's parameter tree as float32 numpy arrays (the inverse
    of :func:`params_from_numpy`)."""
    return {v: {k: t.detach().float().cpu().numpy() for k, t in p.items()}
            for v, p in params.items()}
