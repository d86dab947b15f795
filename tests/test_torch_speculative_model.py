"""The port's one-shot speculation (deeplearning4j_tpu_torch/util/
decoding.py ``speculative_sample`` with a model draft or a host
proposer, ``speculative_beam_search``; the zoo's ``speculative_sample``)
against the JAX package's, on the CPU in f32, and the persisted int8
verdict (``tuning/crossover.py`` ``record_quant_verdict``).

- Nets: a rope TextGenerationTransformer target (vocab 32, width 32, 4
  heads, 2 kv heads, 2 layers, max_length 64) and a one-layer draft of
  another seed, the JAX parameters loaded into both packages (the output
  layers' weights scaled by 4: peaked distributions, no near ties
  within f32 noise).
- ``speculative_sample``: greedy, sampled and filtered (temperature, top
  k, top p) with the model draft, and with the prompt-lookup proposer:
  the tokens equal the JAX function's with the same numpy rng, token
  for token; greedy also equals the port's ``sample_stream``. Stop tokens
  and ``max_length`` cut as in the JAX function; the zoo's wrapper is
  the function.
- ``speculative_beam_search`` with both draft kinds, stop tokens and a
  ``max_length``: the sequence equal to the JAX function's and to the
  port's ``beam_search``; the score within SCORE_ATOL of the JAX one (a
  sum of f32 log-probabilities whose forwards agree to ~1e-6, as
  ``test_torch_beam_search.py``) and within SCORE_REL of ``beam_search``'s
  (the JAX package's own test holds the pair at rel 1e-6).
- The text LSTM is refused as target and as draft (``check_rewindable``),
  as in the JAX package; the engine still refuses a network draft and
  names the one-shot path.
- The int8 verdict (``chip_smoke.py --calibrate``'s write): recorded
  into the store at ``default_path()`` and read by a fresh
  ``kv_dtype="auto"`` engine: int8 after an int8 win, bf16 after a
  loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.util import decoding as jdec
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JaxLSTM
from deeplearning4j_tpu.zoo import TextGenerationTransformer as JaxTFM
from deeplearning4j_tpu_torch.serving import (
    GenerationEngine, PagedKVConfig, SpeculationConfig)
from deeplearning4j_tpu_torch.tuning import (
    KernelCrossoverStore, record_quant_verdict, reset_default_store)
from deeplearning4j_tpu_torch.tuning.crossover import default_path
from deeplearning4j_tpu_torch.util import decoding as tdec
from deeplearning4j_tpu_torch.zoo import (
    TextGenerationLSTM, TextGenerationTransformer)
from torch_threads import one_thread  # noqa: F401 (autouse)

V, E, HEADS, KV_HEADS, MAXLEN = 32, 32, 4, 2, 64
SEED = [1, 2, 3, 4, 5, 1, 2, 3]
STEPS, GAMMA = 20, 3
SCORE_ATOL = 1e-4
SCORE_REL = 1e-6


def _pair(layers, seed):
    """The JAX model and net and the port's, the JAX init's parameters
    (the output layer's scaled by 4) loaded into both."""
    kw = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=layers,
              max_length=MAXLEN, positional="rope", n_kv_heads=KV_HEADS,
              seed=seed)
    jmodel = JaxTFM(**kw)
    jnet = jmodel.init()
    np_params = {v: {k: np.asarray(a, np.float32) for k, a in p.items()}
                 for v, p in jnet.params.items()}
    np_params["out"]["W"] = 4.0 * np_params["out"]["W"]
    jnet.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = TextGenerationTransformer(**kw)
    return jmodel, jnet, model, model.init(device="cpu").load_numpy_params(
        np_params)


@pytest.fixture(scope="module")
def nets():
    jmodel, jnet, model, tnet = _pair(2, 1)
    _, jdraft, _, tdraft = _pair(1, 2)
    return jmodel, jnet, jdraft, model, tnet, tdraft


MODES = {"greedy": dict(top_k=1), "sampled": dict(temperature=1.0),
         "filtered": dict(temperature=0.8, top_k=5, top_p=0.9)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_model_draft_speculative_sample_equals_the_jax_packages(nets, mode):
    jmodel, jnet, jdraft, model, tnet, tdraft = nets
    kw = MODES[mode]
    want = jdec.speculative_sample(jnet, jdraft, SEED, STEPS, V, gamma=GAMMA,
                                   rng=np.random.default_rng(5), **kw)
    got = tdec.speculative_sample(tnet, tdraft, SEED, STEPS, V, gamma=GAMMA,
                                  rng=np.random.default_rng(5), **kw)
    assert got == want and len(got) == len(SEED) + STEPS
    if mode == "greedy":
        assert got == tdec.sample_stream(tnet, SEED, STEPS, V, top_k=1)


def test_the_host_proposer_equals_the_jax_packages(nets):
    jmodel, jnet, jdraft, model, tnet, tdraft = nets
    want = jdec.speculative_sample(jnet, jdec.prompt_lookup_proposer(2),
                                   SEED, STEPS, V, gamma=GAMMA,
                                   rng=np.random.default_rng(3))
    got = tdec.speculative_sample(tnet, tdec.prompt_lookup_proposer(2),
                                  SEED, STEPS, V, gamma=GAMMA,
                                  rng=np.random.default_rng(3))
    assert got == want


@pytest.mark.parametrize("cut", ["stop", "max_length"])
def test_stop_tokens_and_max_length_cut_as_in_jax(nets, cut):
    jmodel, jnet, jdraft, model, tnet, tdraft = nets
    free = tdec.speculative_sample(tnet, tdraft, SEED, STEPS, V,
                                   gamma=GAMMA, top_k=1)
    kw = ({"stop_tokens": {free[len(SEED) + 5]}} if cut == "stop"
          else {"max_length": len(SEED) + 7})
    want = jdec.speculative_sample(jnet, jdraft, SEED, STEPS, V,
                                   gamma=GAMMA, top_k=1, **kw)
    got = tdec.speculative_sample(tnet, tdraft, SEED, STEPS, V,
                                  gamma=GAMMA, top_k=1, **kw)
    assert got == want
    if cut == "stop":
        assert got[-1] in kw["stop_tokens"] and len(got) <= len(SEED) + 6
    else:
        assert len(got) == len(SEED) + 7


def test_the_zoo_wrapper_is_the_function(nets):
    jmodel, jnet, jdraft, model, tnet, tdraft = nets
    got = model.speculative_sample(tnet, tdraft, SEED, 10, gamma=2,
                                   rng=np.random.default_rng(1))
    want = jmodel.speculative_sample(jnet, jdraft, SEED, 10, gamma=2,
                                     rng=np.random.default_rng(1))
    assert got == want == tdec.speculative_sample(
        tnet, tdraft, SEED, 10, V, gamma=2, rng=np.random.default_rng(1),
        max_length=MAXLEN)


@pytest.mark.parametrize("draft", ["lookup", "model"])
@pytest.mark.parametrize("case", [
    dict(width=3, gamma=3), dict(width=4, gamma=2),
    dict(width=3, gamma=3, stop=True), dict(width=2, gamma=4, max_len=True)],
    ids=["w3g3", "w4g2", "stop", "max_length"])
def test_speculative_beam_search_equals_jax_and_beam_search(nets, draft,
                                                            case):
    jmodel, jnet, jdraft, model, tnet, tdraft = nets
    steps = 10
    kw = {}
    if case.get("stop"):
        best = tdec.beam_search(tnet, SEED, steps, V, beam_width=3)[0]
        kw["stop_tokens"] = {best[len(SEED) + 2]}
    if case.get("max_len"):
        kw["max_length"] = len(SEED) + 6
    jd = jdec.prompt_lookup_proposer(2) if draft == "lookup" else jdraft
    td = tdec.prompt_lookup_proposer(2) if draft == "lookup" else tdraft
    want = jdec.speculative_beam_search(jnet, jd, SEED, steps, V,
                                        beam_width=case["width"],
                                        gamma=case["gamma"], **kw)
    got = tdec.speculative_beam_search(tnet, td, SEED, steps, V,
                                       beam_width=case["width"],
                                       gamma=case["gamma"], **kw)
    plain = tdec.beam_search(tnet, SEED, steps, V, beam_width=case["width"],
                             **kw)
    assert got[0] == want[0] == plain[0]
    assert abs(got[1] - want[1]) <= SCORE_ATOL
    assert got[1] == pytest.approx(plain[1], rel=SCORE_REL)
    if case.get("stop"):
        assert got[0][-1] in kw["stop_tokens"]
    if case.get("max_len"):
        assert len(got[0]) == kw["max_length"]


def test_the_text_lstm_is_refused_as_in_jax(nets):
    jmodel, jnet, jdraft, model, tnet, tdraft = nets
    lstm = TextGenerationLSTM(vocab_size=V, hidden=8, layers=1,
                              max_length=5).init(device="cpu")
    jlstm = JaxLSTM(vocab_size=V, hidden=8, layers=1, max_length=5).init()
    for fn, args in ((tdec.speculative_sample, (lstm, tdraft)),
                     (tdec.speculative_sample, (tnet, lstm)),
                     (tdec.speculative_beam_search, (lstm, tdraft)),
                     (tdec.speculative_beam_search, (tnet, lstm))):
        with pytest.raises(ValueError, match="cannot be rewound"):
            fn(*args, SEED, 4, V)
    with pytest.raises(ValueError, match="cannot be rewound"):
        jdec.speculative_sample(jlstm, jdraft, SEED, 4, V)


def test_arguments_are_checked(nets):
    jmodel, jnet, jdraft, model, tnet, tdraft = nets
    with pytest.raises(ValueError, match="gamma"):
        tdec.speculative_sample(tnet, tdraft, SEED, 4, V, gamma=0)
    with pytest.raises(TypeError, match="callable"):
        tdec.speculative_sample(tnet, object(), SEED, 4, V)
    other = TextGenerationTransformer(vocab_size=V + 1, embed_dim=E,
                                      n_heads=HEADS, n_layers=1,
                                      max_length=MAXLEN,
                                      positional="rope").init(device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        tdec.speculative_beam_search(tnet, other, SEED, 4, V)
    # the engine keeps refusing a network draft, as the JAX engine does,
    # and names the one-shot path
    with pytest.raises(TypeError, match="speculative_sample"):
        SpeculationConfig(draft=tdraft)


def test_the_int8_verdict_is_persisted_for_a_fresh_auto_engine(
        nets, tmp_path, monkeypatch):
    """``record_quant_verdict`` (what ``chip_smoke.py --calibrate`` calls
    with ``serve_int8``'s turns) writes the store at ``default_path()``;
    a fresh ``kv_dtype="auto"`` engine reads it."""
    jmodel, jnet, jdraft, model, tnet, tdraft = nets
    # default_path() is the working directory's store once it has one
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "KERNEL_CROSSOVER_TORCH.json"
    KernelCrossoverStore(path=str(path)).save()
    assert default_path() == str(path)
    paging = dict(page_size=4, kv_dtype="auto")

    def fresh_auto():
        reset_default_store(None)       # a fresh process's store
        try:
            return GenerationEngine(tnet, V, slots=2, device="cpu",
                                    paging=PagedKVConfig(**paging))
        finally:
            reset_default_store(None)
    key = fresh_auto()._quant_key
    assert fresh_auto()._kv_dtype == "bf16"        # uncalibrated
    reset_default_store(None)
    try:
        entry = record_quant_verdict(key, 200.0, 100.0, device="cpu")
    finally:
        reset_default_store(None)
    assert KernelCrossoverStore.load(str(path)).lookup(key, "cpu") == entry
    assert entry["kernel_ms"] == 5.0 and entry["fallback_ms"] == 10.0
    assert entry["platform"] == "cpu" and entry["source"] == "calibrate"
    eng = fresh_auto()
    assert eng._kv_dtype == "int8"
    h = eng.submit(SEED, steps=3, top_k=1)
    eng.run_until_idle()
    assert len(h.result(timeout=0)) == len(SEED) + 3
    # a later, losing measurement's mean flips the verdict back
    reset_default_store(None)
    try:
        record_quant_verdict(key, 10.0, 100.0, device="cpu")
    finally:
        reset_default_store(None)
    assert fresh_auto()._kv_dtype == "bf16"
