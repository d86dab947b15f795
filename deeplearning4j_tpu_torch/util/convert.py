"""Carry parameters and updater state between the JAX package and the
port.

The port keeps every parameter layout of the JAX package: attention and
output weights are ``[n_in, n_out]``, the kernel-1 ``Convolution1DLayer``
weight is ``[n_out, n_in, 1]``, biases and LayerNorm gains are 1-D. So
a JAX graph's ``net.params``, taken to numpy, loads into the port's
graph under the same vertex and parameter names with no transposes
(``tests/test_torch_transformer.py`` pins that).

The graph state carries across too: the BN running mean and variance of
``net.state`` (``{vertex: {"mean": array, "var": array}}``, empty dicts
elsewhere) become f32 tensors under the same names
(``ComputationGraph.load_numpy_state``; ``tests/test_torch_resnet.py``).

The updater state carries across the same way: the JAX ``Adam`` state
``{"m": tree, "v": tree, "t": step}`` taken to numpy becomes the port's
(trees of f32 tensors, ``t`` a 0-d int32 tensor), so a JAX run resumes
in the port (``tests/test_torch_training.py``); ``RmsProp``'s ``{"g2":
tree}`` and ``Nesterovs``' ``{"v": tree}`` carry across the same way
(``tests/test_torch_text_lstm.py``). A sequential network's trees are
keyed by layer index (``"0"``, ``"1"``, ...) instead of vertex name, and
its state carries the LSTM layers' ``h`` / ``c`` only while it streams
or trains through truncated BPTT.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy", "state_from_numpy",
           "state_to_numpy", "updater_state_from_numpy",
           "updater_state_to_numpy"]


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


def state_from_numpy(np_state, device=None) -> dict:
    """A graph state ``{vertex: {name: array}}`` of floating arrays (the
    BN running statistics) to the same tree of f32 tensors on
    ``device`` (default ``"cuda"``)."""
    return params_from_numpy(np_state, device)


def state_to_numpy(state) -> dict:
    """The inverse of :func:`state_from_numpy`."""
    return params_to_numpy(state)


def updater_state_from_numpy(np_state, device=None) -> dict:
    """An updater state of numpy arrays (nested dicts; floating arrays
    are moment trees, integer scalars step counts) → the port's: f32
    tensors and 0-d int32 step counts on ``device`` (default
    ``"cuda"``)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        arr = np.asarray(x)
        if np.issubdtype(arr.dtype, np.integer) and arr.ndim == 0:
            return torch.tensor(int(arr), dtype=torch.int32, device=dev)
        if not np.issubdtype(arr.dtype, np.floating):
            raise TypeError(f"updater state leaf of dtype {arr.dtype}")
        return torch.tensor(arr, dtype=torch.float32, device=dev)

    return conv(np_state)


def updater_state_to_numpy(state) -> dict:
    """The inverse of :func:`updater_state_from_numpy` (step counts as
    int32 scalars, as the JAX package keeps them)."""
    if isinstance(state, dict):
        return {k: updater_state_to_numpy(v) for k, v in state.items()}
    if not state.dtype.is_floating_point:
        return np.asarray(int(state), np.int32)
    return state.detach().float().cpu().numpy()
