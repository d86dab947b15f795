"""The port's in-engine speculative decoding (``GenerationEngine(
speculation=SpeculationConfig(...))``, ``util/decoding.py``'s
``verify_tokens`` / ``accept_proposals`` / ``prompt_lookup_proposer``,
``nn/conf/layers.py``'s ``rewind_stream_state`` / ``check_rewindable``)
against the JAX package on the CPU, f32, with the same seeded weights.

- Greedy streams over the page pools (the net's own dtype, "bf16" by
  name, and int8): equal to the JAX speculative engine's; over the
  unquantized pool equal to the port's one-shot ``sample_stream`` too,
  and over the int8 pool to the port's plain int8 engine. The JAX engine
  reads its pools through its own XLA path (``decode_impl="xla"``).
- Sampled streams (temperature, top-k, top-p) equal to the JAX
  speculative engine's for the same seeds: ``accept_proposals`` draws
  each request's rng in the JAX order.
- The verify reaches ``paged_attention`` at query width 1 + gamma on
  every decode forward (on the card that is rows 15 and 16).
- int8 under rewind: a rejected draft written at a page's base position
  prices the page; the next write there re-prices it, so the sidecar and
  the pool equal those of plain single-token appends (a layer-level case
  with a base draft 100x larger), and an engine run whose rejected
  drafts land on base positions streams as plain int8.
- ``rewind_stream_state`` with an ``[N]`` array on a batch stream: each
  layer's ``kv_pos`` and the host mirrors equal the JAX package's, and
  the next chunk's outputs agree within ``OUT_ATOL``.
- The page budget reserves the verify's gamma extra positions; free
  rows rewind the whole verify width.
- Refusals that stay: an LSTM net under speculation (the engine, and
  ``check_rewindable`` as the JAX package's), learned positions under an
  array rewind, a gamma under 1, a model draft, a request without
  speculative headroom.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.serving import (
    GenerationEngine as JaxEngine, PagedKVConfig as JaxPaged,
    SpeculationConfig as JaxSpec)
from deeplearning4j_tpu.util.decoding import (
    prompt_lookup_proposer as jax_proposer)
from deeplearning4j_tpu.zoo import TextGenerationTransformer as JaxTFM
from deeplearning4j_tpu_torch.nn.conf.layers import (
    SelfAttentionLayer, check_rewindable, rewind_stream_state)
from deeplearning4j_tpu_torch.serving import (
    GenerationEngine, PagedKVConfig, SpeculationConfig)
from deeplearning4j_tpu_torch.serving import paged_kernel
from deeplearning4j_tpu_torch.serving.paging import pages_needed
from deeplearning4j_tpu_torch.serving.quant import pool_leaves
from deeplearning4j_tpu_torch.util.decoding import (
    _one_hot, prompt_lookup_proposer)
from deeplearning4j_tpu_torch.zoo import (
    TextGenerationLSTM, TextGenerationTransformer)
from torch_threads import one_thread  # noqa: F401 (autouse)

V, E, HEADS, KV_HEADS, LAYERS, MAXLEN, PS = 16, 32, 4, 2, 2, 40, 4
GAMMA, STEPS = 3, 10
PROMPTS = [[1, 2, 3, 1, 2], [4, 5, 4, 5], [7, 8, 7], [1, 2, 3, 4, 1, 2, 3],
           [9, 9, 9, 9, 9]]
SAMPLED = {0: dict(temperature=0.8), 1: dict(top_k=5, temperature=1.2),
           2: dict(top_p=0.9), 3: dict(top_k=3, top_p=0.8, temperature=0.7),
           4: dict(temperature=1.0)}
OUT_ATOL = 1e-5            # f32 forwards of the two packages


@pytest.fixture(scope="module")
def nets():
    kw = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
              max_length=MAXLEN, positional="rope", n_kv_heads=KV_HEADS)
    jnet = JaxTFM(**kw).init()
    rng = np.random.default_rng(7)
    np_params = {v: {k: np.asarray(a, np.float32) if k.startswith("W")
                     else rng.normal(float(k == "gamma"), 0.2, a.shape)
                     .astype(np.float32) for k, a in p.items()}
                 for v, p in jnet.params.items()}
    jnet.params = {v: {k: jnp.asarray(a) for k, a in p.items()}
                   for v, p in np_params.items()}
    model = TextGenerationTransformer(**kw)
    tnet = model.init(device="cpu").load_numpy_params(np_params)
    saved = jax_layers.paged_decode_impl()
    yield jnet, tnet, model
    jax_layers.set_paged_decode_impl(*saved)


def _trace(engine, sampled=False):
    """Staggered admissions, one step between submits; greedy unless
    ``sampled``, each request with its own seeded rng."""
    hs = []
    for i, p in enumerate(PROMPTS):
        kw = SAMPLED[i] if sampled else dict(top_k=1)
        hs.append(engine.submit(p, steps=STEPS,
                                rng=np.random.default_rng(i), **kw))
        engine.step()
    engine.run_until_idle()
    return [h.result(timeout=0) for h in hs]


def _jax(nets, kv, sampled):
    return _trace(JaxEngine(nets[0], V, slots=3, paging=JaxPaged(
        page_size=PS, kv_dtype=kv, decode_impl="xla"),
        speculation=JaxSpec(jax_proposer(2), gamma=GAMMA)), sampled)


def _port(nets, kv, spec=True, draft=None, **kw):
    return GenerationEngine(
        nets[1], V, slots=3, device="cpu",
        paging=PagedKVConfig(page_size=PS, kv_dtype=kv, **kw),
        speculation=SpeculationConfig(draft or prompt_lookup_proposer(2),
                                      gamma=GAMMA) if spec else None)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_streams_equal_the_jax_speculative_engine(nets, kv, sampled,
                                                  monkeypatch):
    widths = []
    real = paged_kernel.paged_attention

    def record(*args, query_width, **kw):
        widths.append(query_width)
        return real(*args, query_width=query_width, **kw)
    monkeypatch.setattr(paged_kernel, "paged_attention", record)
    eng = _port(nets, kv)
    got = _trace(eng, sampled)
    assert got == _jax(nets, kv, sampled)
    # every decode forward was a verify at width 1 + gamma
    assert widths and set(widths) == {1 + GAMMA}
    assert len(widths) == LAYERS * eng.dispatches
    assert eng.spec_proposed > 0 and 0 < eng.spec_accepted <= \
        eng.spec_proposed
    assert eng.tokens_generated > eng.dispatches
    if sampled:
        return
    monkeypatch.setattr(paged_kernel, "paged_attention", real)
    if kv == "bf16":
        want = [nets[2].sample_stream(nets[1], p, steps=STEPS, top_k=1,
                                      rng=np.random.default_rng(i))
                for i, p in enumerate(PROMPTS)]
    else:
        want = _trace(_port(nets, kv, spec=False))
    assert got == want


def test_the_slot_arena_speculates_too(nets):
    eng = GenerationEngine(nets[1], V, slots=3, device="cpu",
                           speculation=SpeculationConfig(
                               prompt_lookup_proposer(2), gamma=GAMMA))
    want = [nets[2].sample_stream(nets[1], p, steps=STEPS, top_k=1,
                                  rng=np.random.default_rng(i))
            for i, p in enumerate(PROMPTS)]
    assert _trace(eng) == want


def test_int8_rejected_drafts_on_page_bases_stream_as_plain(nets):
    """A proposer that is wrong on purpose (always token + 5): most
    drafts are rejected, and some rejected ones sit at a page's base
    position; the streams still equal the plain int8 engine's."""
    calls = []

    def wrong(ids, g):
        props = [(ids[-1] + 5) % V] * g
        calls.append((list(ids), props))
        return props

    got = _trace(_port(nets, "int8", draft=wrong))
    assert got == _trace(_port(nets, "int8", spec=False))
    on_base = 0
    for seen, props in calls:
        ids, = [g for g in got if g[:len(seen)] == seen]
        accepted = 0
        while accepted < len(props) and \
                ids[len(seen) + accepted] == props[accepted]:
            accepted += 1
        # the pending token sits at position len(seen) - 1, proposal j
        # at len(seen) + j
        on_base += sum((len(seen) + j) % PS == 0
                       for j in range(accepted, len(props)))
    assert on_base >= 3


def test_int8_reprices_a_base_position_after_a_rejected_draft():
    """Layer level, through ``_stream_attend_paged``: positions 0-2
    appended one at a time, a verify chunk at 3-5 whose position 4 (page
    1's base) is a rejected draft 100x larger, a rewind to 4, and the
    real tokens at 4-5. Page 1's scale and its two tokens equal those of
    plain single-token appends, bit for bit."""
    rng = np.random.default_rng(3)
    hkv, d, heads = 2, 8, 4
    layer = SelfAttentionLayer(n_in=heads * d, n_out=heads * d,
                               n_heads=heads, n_kv_heads=hkv,
                               cache_length=16)
    real = torch.from_numpy(rng.standard_normal((6, hkv, d)).astype(
        np.float32))
    draft = real[4] * 100.0

    def run(chunks):
        pools, scales = pool_leaves(5, PS, [(hkv, d)])
        state = {"kv_page_k": pools[0], "kv_page_v": pools[1],
                 "kv_page_scale_k": scales[0], "kv_page_scale_v": scales[1],
                 "kv_page_table": torch.tensor([[1, 2, 3, 4]],
                                               dtype=torch.int32)}
        for pos, rows in chunks:
            kv = torch.stack(rows)[None].transpose(1, 2)   # [1,Hkv,T,D]
            q = torch.zeros((1, heads, len(rows), d))
            state["kv_pos"] = torch.tensor([pos], dtype=torch.int32)
            _, state = layer._stream_attend_paged(q, kv, kv.clone(), state)
        return pools, scales

    plain = run([(p, [real[p]]) for p in range(6)])
    spec = run([(0, [real[0]]), (1, [real[1]]), (2, [real[2]]),
                (3, [real[3], draft, real[5]]),      # 4 rejected
                (4, [real[4], real[5]])])
    for a, b in zip(plain[1], spec[1]):               # page 1's scales
        assert torch.equal(a[1:3], b[1:3])
    for a, b in zip(plain[0], spec[0]):
        assert torch.equal(a[1:3], b[1:3])            # pages 1 and 2
    # the draft did price page 2 (positions 4-7) before its rewind
    mid = run([(0, [real[0]]), (1, [real[1]]), (2, [real[2]]),
               (3, [real[3], draft, real[5]])])
    assert mid[1][0][2].max() > 10 * plain[1][0][2].max()


def test_the_per_row_rewind_is_the_jax_packages(nets):
    jnet, tnet, _ = nets
    ids = np.random.default_rng(4).integers(0, V, (3, 6))
    for net in (jnet, tnet):
        net.rnn_clear_previous_state()
    # the JAX engines of this module leave their sequential-network
    # mirror on the graph they served; a fresh graph has none
    jnet.__dict__.pop("_stream_pos", None)
    x = _one_hot(tnet, ids)
    tnet.rnn_time_step(x)
    jnet.rnn_time_step(x.numpy())
    amounts = np.array([2, 0, 3])
    rewind_stream_state(tnet, amounts)
    jax_layers.rewind_stream_state(jnet, amounts)
    names = [n for n, s in tnet.state.items()
             if isinstance(s, dict) and "kv_pos" in s]
    assert len(names) == LAYERS
    for n in names:
        np.testing.assert_array_equal(tnet.state[n]["kv_pos"].numpy(),
                                      np.asarray(jnet.state[n]["kv_pos"]))
    np.testing.assert_array_equal(tnet._stream_pos_rows,
                                  jnet._stream_pos_rows)
    assert tnet._stream_pos_map == jnet._stream_pos_map
    nxt = _one_hot(tnet, ids[:, :2])
    got = tnet.rnn_time_step(nxt).numpy()
    want = np.asarray(jnet.rnn_time_step(nxt.numpy()))
    np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL)
    np.testing.assert_array_equal(tnet._stream_pos_rows,
                                  jnet._stream_pos_rows)
    # a scalar rewind moves every counter together
    rewind_stream_state(tnet, 1)
    jax_layers.rewind_stream_state(jnet, 1)
    for n in names:
        np.testing.assert_array_equal(tnet.state[n]["kv_pos"].numpy(),
                                      np.asarray(jnet.state[n]["kv_pos"]))
    assert tnet._stream_pos_map == jnet._stream_pos_map
    for net in (jnet, tnet):
        net.rnn_clear_previous_state()


def test_the_page_budget_holds_the_verify_width(nets):
    eng = _port(nets, "bf16", prefix_cache=False)
    h = eng.submit([1, 2, 3], steps=9, top_k=1)
    eng.step()
    assert eng.page_pool.used_count() == pages_needed(12 - 1 + GAMMA, PS)
    # the two free rows rewind the whole verify width: their positions
    # do not coast
    while eng.step():
        for n, s in eng.net.state.items():
            if isinstance(s, dict) and "kv_pos" in s:
                assert s["kv_pos"][1:].tolist() == [0, 0], n
    assert len(h.result(timeout=0)) == 12
    assert eng.page_pool.used_count() == 0


def test_the_refusals_that_stay(nets):
    _, tnet, _ = nets
    with pytest.raises(ValueError, match="gamma"):
        SpeculationConfig(prompt_lookup_proposer(), gamma=0)
    with pytest.raises(TypeError, match="host proposer"):
        SpeculationConfig(tnet)
    with pytest.raises(ValueError, match="ngram"):
        prompt_lookup_proposer(0)
    eng = _port(nets, "bf16")
    with pytest.raises(ValueError, match="headroom"):
        eng.submit([1, 2, 3], steps=MAXLEN - 3, top_k=1)
    lstm = TextGenerationLSTM(vocab_size=10, hidden=12, layers=1,
                              max_length=40).init(device="cpu")
    # the engine serves the LSTM (tests/test_torch_serving_ledger.py);
    # with speculation it refuses as the JAX engine does: h / c cannot
    # rewind
    with pytest.raises(ValueError, match="cannot be rewound"):
        GenerationEngine(lstm, 10, slots=2, device="cpu",
                         speculation=SpeculationConfig(
                             prompt_lookup_proposer()))
    from deeplearning4j_tpu.zoo import TextGenerationLSTM as JaxLSTM
    jlstm = JaxLSTM(vocab_size=10, hidden=12, layers=1,
                    max_length=40).init()
    for check, net in ((check_rewindable, lstm),
                       (jax_layers.check_rewindable, jlstm)):
        with pytest.raises(ValueError, match="cannot be rewound"):
            check(net, 2)
    learned = TextGenerationTransformer(
        vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=1,
        max_length=MAXLEN).init(device="cpu")
    learned.rnn_time_step(_one_hot(learned, [[1, 2, 3], [4, 5, 6]]))
    with pytest.raises(ValueError, match="attention-only"):
        rewind_stream_state(learned, np.array([1, 0]))
    rewind_stream_state(learned, 2)
    offs = [s["pos_offset"] for s in learned.state.values()
            if isinstance(s, dict) and "pos_offset" in s]
    assert offs == [1]
    assert learned._stream_pos_map and \
        set(learned._stream_pos_map.values()) == {1}
