"""The port's beam search (deeplearning4j_tpu_torch/util/decoding.py
``beam_search``, nn/conf/layers.py ``reorder_stream_state``, the zoo's
``beam_search``) against the JAX package's, on the CPU in f32.

- A rope TextGenerationTransformer (vocab 64, width 32, 4 heads, 2 kv
  heads, 2 layers, max_length 24) and a TextGenerationLSTM (vocab 64,
  hidden 32, 2 layers), the JAX parameters loaded into both packages
  (the output layer's weights scaled up so the distributions are peaked
  and no two hypotheses tie within f32 noise). Each case returns the
  same best sequence and its log-probability within SCORE_ATOL of the
  JAX package's (a sum of up to 8 f32 log-probabilities whose
  forwards agree to ~1e-6).
- Cases: no stop tokens; stop tokens taken from the unstopped result
  (a hypothesis finishes, and the early stop ends the search);
  ``beam_width`` above the vocabulary (W = V beams); a ``max_length``
  that cuts the steps.
- ``reorder_stream_state`` on a batch stream with a per-row ``kv_pos``
  (after a per-row rewind): the gathered counters, caches and host row
  mirror equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JaxLSTM
from deeplearning4j_tpu.zoo import TextGenerationTransformer as JaxTFM
from deeplearning4j_tpu_torch.nn.conf.layers import (
    reorder_stream_state, rewind_stream_state)
from deeplearning4j_tpu_torch.util.decoding import _one_hot, beam_search
from deeplearning4j_tpu_torch.zoo import (
    TextGenerationLSTM, TextGenerationTransformer)
from torch_threads import one_thread  # noqa: F401 (autouse)

V, E, HEADS, KV_HEADS, LAYERS, MAXLEN = 64, 32, 4, 2, 2, 24
SEED = [3, 17, 42, 5]
STEPS = 8
SCORE_ATOL = 1e-4
OUT_ATOL = 1e-5            # f32 forwards of the two packages


def _peaked(params, out_key):
    """The JAX init's parameters as f32 numpy, the output layer's
    weights scaled by 4 (peaked distributions: no near ties)."""
    np_params = {v: {k: np.asarray(a, np.float32) for k, a in p.items()}
                 for v, p in params.items()}
    np_params[out_key]["W"] = 4.0 * np_params[out_key]["W"]
    return np_params


@pytest.fixture(scope="module")
def transformer():
    kw = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
              max_length=MAXLEN, positional="rope", n_kv_heads=KV_HEADS)
    jmodel = JaxTFM(**kw)
    jnet = jmodel.init()
    np_params = _peaked(jnet.params, "out")
    jnet.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = TextGenerationTransformer(**kw)
    tnet = model.init(device="cpu").load_numpy_params(np_params)
    return jmodel, jnet, model, tnet


@pytest.fixture(scope="module")
def lstm():
    kw = dict(vocab_size=V, hidden=32, layers=LAYERS, max_length=5)
    jmodel = JaxLSTM(**kw)
    jnet = jmodel.init()
    np_params = _peaked(jnet.params, str(LAYERS))
    jnet.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = TextGenerationLSTM(**kw)
    tnet = model.init(device="cpu")
    tnet.load_numpy_params(np_params)
    return jmodel, jnet, model, tnet


def _same(got, want):
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= SCORE_ATOL, (got[1], want[1])


@pytest.fixture(scope="module")
def unstopped(transformer, lstm):
    """Each model's unstopped search, both packages (the stop cases take
    their stop tokens from it)."""
    out = {}
    for name, (jmodel, jnet, model, tnet) in (("transformer", transformer),
                                              ("lstm", lstm)):
        out[name] = (model.beam_search(tnet, SEED, STEPS, beam_width=4),
                     jmodel.beam_search(jnet, SEED, STEPS, beam_width=4))
    return out


@pytest.mark.parametrize("name", ["transformer", "lstm"])
def test_beam_search_equals_the_jax_packages(unstopped, name):
    got, want = unstopped[name]
    _same(got, want)
    assert len(got[0]) == len(SEED) + STEPS and got[1] < 0


@pytest.mark.parametrize("name", ["transformer", "lstm"])
@pytest.mark.parametrize("at", [1, 3])
def test_stop_tokens_finish_hypotheses_as_in_jax(transformer, lstm,
                                                 unstopped, name, at):
    jmodel, jnet, model, tnet = transformer if name == "transformer" \
        else lstm
    best = unstopped[name][1][0]
    stop = {best[len(SEED) + at]}
    got = model.beam_search(tnet, SEED, STEPS, beam_width=4,
                            stop_tokens=stop)
    want = jmodel.beam_search(jnet, SEED, STEPS, beam_width=4,
                              stop_tokens=stop)
    _same(got, want)
    # a finished hypothesis won: it ends at its stop token, early
    assert got[0][-1] in stop and len(got[0]) <= len(SEED) + at + 1


def test_a_beam_width_above_the_vocabulary_takes_every_token(lstm):
    jmodel, jnet, model, tnet = lstm
    got = model.beam_search(tnet, SEED, 3, beam_width=V + 6)
    _same(got, jmodel.beam_search(jnet, SEED, 3, beam_width=V + 6))
    assert tnet.state["0"]["h"].shape[0] == V           # W = V beams


def test_max_length_cuts_the_search(transformer):
    from deeplearning4j_tpu.util.decoding import beam_search as jax_beam
    _, jnet, _, tnet = transformer
    got = beam_search(tnet, SEED, STEPS, V, beam_width=3, max_length=7)
    _same(got, jax_beam(jnet, SEED, STEPS, V, beam_width=3, max_length=7))
    assert len(got[0]) == 7


def test_reorder_with_a_per_row_kv_pos_is_the_jax_packages(transformer):
    _, jnet, _, tnet = transformer
    ids = np.random.default_rng(4).integers(0, V, (3, 6))
    for net in (jnet, tnet):
        net.rnn_clear_previous_state()
    x = _one_hot(tnet, ids)
    tnet.rnn_time_step(x)
    jnet.rnn_time_step(x.numpy())
    amounts = np.array([2, 0, 3])
    rewind_stream_state(tnet, amounts)
    jax_layers.rewind_stream_state(jnet, amounts)
    order = np.array([2, 0, 0, 1])
    reorder_stream_state(tnet, order)
    jax_layers.reorder_stream_state(jnet, order)
    names = [n for n, s in tnet.state.items()
             if isinstance(s, dict) and "kv_pos" in s]
    assert len(names) == LAYERS
    for n in names:
        np.testing.assert_array_equal(tnet.state[n]["kv_pos"].numpy(),
                                      np.asarray(jnet.state[n]["kv_pos"]))
        for k in ("kv_k", "kv_v"):
            np.testing.assert_allclose(tnet.state[n][k].numpy(),
                                       np.asarray(jnet.state[n][k]),
                                       rtol=0, atol=OUT_ATOL)
    np.testing.assert_array_equal(tnet.state[names[0]]["kv_pos"].numpy(),
                                  [3, 4, 4, 6])
    np.testing.assert_array_equal(tnet._stream_pos_rows,
                                  jnet._stream_pos_rows)
