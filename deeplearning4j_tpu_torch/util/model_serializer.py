"""Model archives: write a network to a zip and restore it.

Counterpart of ``deeplearning4j_tpu/util/model_serializer.py``, in its
wire form, so either package reads what the other wrote: a zip of
``configuration.json`` (the configuration's JSON, ``to_json``),
``meta.json`` (``model_type``, ``iteration_count``, ``epoch_count``,
``framework``) and one ``.npy`` entry per leaf of the parameter, state
and updater-state trees, ``params/<key>/<name>.npy``, ``state/...``,
``updater/...`` (a sequential network's keys are its layer indices).
The trees go through ``util/convert.py`` (f32 leaves, step counts int32
scalars), so they load with no transposes. The streaming carry (an LSTM
layer's ``h`` / ``c``, an attention layer's KV cache) is not written,
and one read from an archive is dropped: a restored network starts a
fresh stream.

The zip is written through ``resilience/durable.py``'s
``atomic_replace_path``: a failed write leaves the old file whole.
``restore_*`` build the network from the configuration on ``device``
(default ``"cuda"``, as every entry point; ``device="cpu"`` on the
host), then load each tree over the initialized one, names and shapes
checked. A fitted normalizer rides in the archive as ``normalizer.json``
(``add_normalizer_to_model`` / ``restore_normalizer_from_file``, the JAX
package's JSON form: each package restores the other's).
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.layers import STREAM_STATE_KEYS
from deeplearning4j_tpu_torch.nn.updater import tree_leaves
from deeplearning4j_tpu_torch.resilience.durable import atomic_replace_path
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, state_to_numpy, updater_state_to_numpy)

__all__ = ["CONFIG_JSON", "MODEL_TYPE_KEY", "add_normalizer_to_model",
           "restore_computation_graph", "restore_model",
           "restore_multi_layer_network", "restore_normalizer_from_file",
           "write_model"]

CONFIG_JSON = "configuration.json"
MODEL_TYPE_KEY = "model_type"


def _flatten(tree, prefix="") -> Dict[str, Any]:
    """``{"a/b/c": array}`` of a tree of nested dicts."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _write_tree(zf: zipfile.ZipFile, prefix: str, tree) -> None:
    for path, arr in _flatten(tree).items():
        buf = io.BytesIO()
        np.save(buf, arr)
        zf.writestr(f"{prefix}/{path}.npy", buf.getvalue())


def _read_tree(zf: zipfile.ZipFile, prefix: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name in zf.namelist():
        if not name.startswith(prefix + "/") or not name.endswith(".npy"):
            continue
        path = name[len(prefix) + 1:-4].split("/")
        d = out
        for seg in path[:-1]:
            d = d.setdefault(seg, {})
        d[path[-1]] = np.load(io.BytesIO(zf.read(name)))
    return out


def _without_stream(state):
    """A network state without its streaming carry."""
    return {k: {n: t for n, t in s.items() if n not in STREAM_STATE_KEYS}
            for k, s in state.items()}


def _with_empty(skeleton, loaded):
    """``loaded`` (a tree read from the zip) with the subtrees of
    ``skeleton`` (the initialized tree) that hold no leaves, and so no
    zip entry: a parameterless layer's empty dict."""
    if not isinstance(skeleton, dict) or not isinstance(loaded, dict):
        return loaded
    out = {k: _with_empty(skeleton.get(k), v) for k, v in loaded.items()}
    for k, v in skeleton.items():
        if k not in out and isinstance(v, dict) and not tree_leaves(v):
            out[k] = {}
    return out


def _model_type(model) -> str:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if isinstance(model, MultiLayerNetwork):
        return "MultiLayerNetwork"
    if isinstance(model, ComputationGraph):
        return "ComputationGraph"
    raise ValueError(f"cannot serialize {type(model)}")


def write_model(model, path: str, save_updater: bool = True) -> None:
    """Save a MultiLayerNetwork or ComputationGraph (the JAX package's
    ``write_model``): its configuration, counters, parameters, state
    and, with ``save_updater``, its updater state."""
    meta = {MODEL_TYPE_KEY: _model_type(model),
            "iteration_count": model.iteration_count,
            "epoch_count": model.epoch_count,
            "framework": "deeplearning4j_tpu_torch"}
    with atomic_replace_path(path) as tmp:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr(CONFIG_JSON, model.conf.to_json())
            zf.writestr("meta.json", json.dumps(meta))
            _write_tree(zf, "params", params_to_numpy(model.params))
            _write_tree(zf, "state",
                        state_to_numpy(_without_stream(model.state)))
            if save_updater:
                _write_tree(zf, "updater",
                            updater_state_to_numpy(model.updater_state))


def _restore(net, zf: zipfile.ZipFile, load_updater: bool):
    """Load the zip's trees over the initialized ``net`` (names and
    shapes checked by its loaders) and its counters."""
    net.load_numpy_params(_with_empty(net.params, _read_tree(zf, "params")))
    state = _without_stream(_read_tree(zf, "state"))
    if tree_leaves(state):
        net.load_numpy_state(_with_empty(net.state, state))
    if load_updater:
        upd = _read_tree(zf, "updater")
        if upd:
            net.load_numpy_updater_state(_with_empty(net.updater_state, upd))
    meta = json.loads(zf.read("meta.json"))
    net.iteration_count = meta.get("iteration_count", 0)
    net.epoch_count = meta.get("epoch_count", 0)
    return net


def restore_multi_layer_network(path: str, load_updater: bool = True,
                                device=None):
    """A MultiLayerNetwork from an archive, on ``device``."""
    from deeplearning4j_tpu_torch.nn.conf.network import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    with zipfile.ZipFile(path) as zf:
        conf = MultiLayerConfiguration.from_json(
            zf.read(CONFIG_JSON).decode())
        return _restore(MultiLayerNetwork(conf).init(device=device), zf,
                        load_updater)


def restore_computation_graph(path: str, load_updater: bool = True,
                              device=None):
    """A ComputationGraph from an archive, on ``device``."""
    from deeplearning4j_tpu_torch.nn.conf.network import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    with zipfile.ZipFile(path) as zf:
        conf = ComputationGraphConfiguration.from_json(
            zf.read(CONFIG_JSON).decode())
        return _restore(ComputationGraph(conf).init(device=device), zf,
                        load_updater)


def restore_model(path: str, load_updater: bool = True, device=None):
    """An archive's network of whichever type its ``meta.json`` names."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
    if meta[MODEL_TYPE_KEY] == "MultiLayerNetwork":
        return restore_multi_layer_network(path, load_updater, device)
    return restore_computation_graph(path, load_updater, device)


NORMALIZER_JSON = "normalizer.json"


def add_normalizer_to_model(path: str, normalizer) -> None:
    """Embed a fitted normalizer (``datasets/normalizers.py``) in an
    existing archive as ``normalizer.json``, its ``to_json()``; an
    archive holds one. The archive is rewritten whole and replaced
    atomically, as ``write_model`` writes it."""
    with zipfile.ZipFile(path) as src:
        if NORMALIZER_JSON in src.namelist():
            raise ValueError(f"{path} already contains a normalizer")
        entries = [(i, src.read(i)) for i in src.infolist()]
    with atomic_replace_path(path) as tmp:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as zf:
            for info, data in entries:
                zf.writestr(info, data)
            zf.writestr(NORMALIZER_JSON, normalizer.to_json())


def restore_normalizer_from_file(path: str):
    """The archive's normalizer, or None when it holds none."""
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        normalizer_from_dict)
    with zipfile.ZipFile(path) as zf:
        if NORMALIZER_JSON not in zf.namelist():
            return None
        return normalizer_from_dict(json.loads(zf.read(NORMALIZER_JSON)))
