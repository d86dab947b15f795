"""What the serving engine's decode-step CUDA graph needs of the engine
(deeplearning4j_tpu_torch/serving/engine.py), checked on the CPU, where
the same device part of a dispatch runs eagerly.

- The address contract: every tensor a dispatch reads or writes (the
  page pools, the int8 scale sidecars, the page table, the ``kv_pos``
  the layers share, the LSTM ``h`` / ``c``) keeps its address across decode
  and verify steps, admissions (an int8 prime writes through the pool),
  retirements and the verify's per-row rewinds, until a supervisor's
  rebuild, after which every one of them has moved but the page store
  (the pools and scale sidecars, zeroed in place: ROADMAP.md C9). The
  leaves are
  enumerated here from the engine's stores and ``net.state``, not from
  the engine's own list. With the device table rebuilt at every
  admission and retirement, as the engine did before the graph, the
  same walk reports the table moved.
- The split ``rnn_time_step``: a dispatch (the host part, the device
  part with its new leaves copied into the fixed ones, the host part
  again) equals ``step_tokens`` / ``verify_tokens`` (the whole
  ``rnn_time_step``) on the same installed paged view, bitwise in f32:
  the distributions, every state leaf, the pools and sidecars and the
  host position mirrors, at the plain and verify widths, over the bf16
  (here the net's f32) and int8 pools, and for the LSTM arena.
- What a graph baked in (``_graph_reads``) holds across steps and moves
  with new parameter tensors, a new bf16 compute copy and a rebuild:
  the engine captures again then.
- The engine's streams still equal the JAX engine's (``decode_impl=
  "xla"``), greedy token for token and sampled with the same rngs.

Sizes: 2 layers, width 32, vocab 64, 4 slots, page size 4.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import (
    GenerationEngine as JaxEngine, PagedKVConfig as JaxPaged)
from deeplearning4j_tpu.zoo import TextGenerationTransformer as JaxTFM
from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.serving import (
    EngineSupervisor, GenerationEngine, PagedKVConfig, SpeculationConfig)
from deeplearning4j_tpu_torch.util.decoding import (
    prompt_lookup_proposer, step_tokens, verify_tokens)
from deeplearning4j_tpu_torch.zoo import (
    TextGenerationLSTM, TextGenerationTransformer)
from torch_threads import one_thread  # noqa: F401 (autouse)

V, E, HEADS, KV_HEADS, LAYERS, MAXLEN, PS, SLOTS = 64, 32, 4, 2, 2, 32, 4, 4
GAMMA = 2
PROMPTS = [[1, 2, 3, 1, 2, 3, 1], [4, 5], [6, 7, 8, 9, 6, 7], [10, 11, 12],
           [13, 14, 13, 14, 13], [2, 3], [5, 6, 7, 8, 9, 10, 11, 12, 13]]
STEPS = [3, 9, 5, 7, 4, 6, 3]
SAMPLED = [dict(temperature=0.8), dict(top_k=5), dict(top_p=0.9),
           dict(top_k=3, temperature=1.2)]
KW = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
          max_length=MAXLEN, positional="rope", n_kv_heads=KV_HEADS)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxTFM(**KW).init()
    np_params = {v: {k: np.asarray(a, np.float32) for k, a in p.items()}
                 for v, p in jnet.params.items()}
    tnet = TextGenerationTransformer(**KW).init(device="cpu")
    tnet.load_numpy_params(np_params)
    return jnet, tnet


@pytest.fixture(scope="module")
def lstm():
    return TextGenerationLSTM(vocab_size=V, hidden=E,
                              layers=LAYERS).init(device="cpu")


def _engine(net, kind, **kw):
    if kind == "lstm":
        return GenerationEngine(net, V, slots=SLOTS, device="cpu", **kw)
    spec = kind.endswith("spec")
    return GenerationEngine(
        net, V, slots=SLOTS, device="cpu",
        paging=PagedKVConfig(page_size=PS, kv_dtype=kind.split("-")[0]),
        speculation=(SpeculationConfig(prompt_lookup_proposer(2),
                                       gamma=GAMMA) if spec else None),
        **kw)


def _leaves(eng):
    """Every tensor a dispatch reads or writes, by name, from the
    engine's stores and the net's state."""
    out = {f"pool{i}": t for i, t in enumerate(eng._page_store or ())}
    out.update({f"scales{i}": t
                for i, t in enumerate(eng._scale_store or ())})
    if eng._page_store is not None:
        out["table"] = eng._tables()
    for n, s in eng.net.state.items():
        for k in ("kv_pos", "h", "c"):
            if isinstance(s, dict) and k in s:
                out[f"{n}.{k}"] = s[k]
    return out


def _walk(eng):
    """Drive 7 requests of mixed lengths through the 4 slots (admissions
    and retirements mid-run), checking the leaves' addresses after every
    step; then a fault and the rebuild. Returns the names that moved
    before the rebuild, the names that kept their address through it,
    and what the leaves were."""
    hs = []
    for i, (p, n) in enumerate(zip(PROMPTS, STEPS)):
        hs.append(eng.submit(p, steps=n, top_k=1))
        if i < 2:
            eng.step()
    eng.step()
    ref = {k: t.data_ptr() for k, t in _leaves(eng).items()}
    names = set(ref)
    moved = set()
    retired = 0
    for _ in range(3):
        eng.step()
        retired = max(retired, sum(h.done for h in hs))
        now = {k: t.data_ptr() for k, t in _leaves(eng).items()}
        assert set(now) == names
        moved |= {k for k in names if now[k] != ref[k]}
    held = dict(_leaves(eng))          # alive: no address can be reused
    eng._decode_chaos = chaos.FaultBurstInjector(k=1)
    eng.step()                         # the fault, the rebuild
    assert eng._supervisor.rebuilds == 1
    after = {k: t.data_ptr() for k, t in _leaves(eng).items()}
    assert set(after) == names
    kept = {k for k in names if after[k] == held[k].data_ptr()}
    eng.run_until_idle()
    assert all(h.done and h.error is None for h in hs)
    return moved, kept, names, retired


@pytest.mark.parametrize("kind", ["bf16", "int8", "bf16-spec", "int8-spec",
                                  "lstm"])
def test_every_step_leaf_keeps_its_address_until_a_rebuild(nets, lstm,
                                                            kind):
    net = lstm if kind == "lstm" else nets[1]
    eng = _engine(net, kind, supervisor=EngineSupervisor())
    moved, kept, names, retired = _walk(eng)
    assert retired >= 1                     # retirements were walked
    want = {"h", "c"} if kind == "lstm" else {"kv_pos", "table", "pool0"}
    if kind.startswith("int8"):
        want.add("scales0")
    assert want <= {k.split(".")[-1] for k in names}
    assert moved == set()
    # a rebuild moves every leaf but the page store, zeroed in place
    assert kept == {k for k in names if k.startswith(("pool", "scales"))}
    if kind.endswith("spec"):
        assert eng.spec_proposed > 0         # verify rewinds were walked


def test_the_walk_catches_a_table_rebuilt_at_each_change(nets):
    """The engine before the graph: every admission and retirement
    dropped the device table and the next dispatch built a new one."""
    eng = _engine(nets[1], "bf16", supervisor=EngineSupervisor())
    state = {"dirty": False}

    def rebuilt_table():
        if state["dirty"]:
            t = np.zeros((eng.slots, eng._n_max), np.int32)
            for s, pages in enumerate(eng._page_tables):
                t[s, :len(pages)] = pages
            eng._table_dev = torch.as_tensor(t)
            state["dirty"] = False
        return eng._table_dev

    def write_row(slot, pages):
        state["dirty"] = True
    eng._tables = rebuilt_table
    eng._write_table_row = write_row
    moved, _, _, _ = _walk(eng)
    assert moved == {"table"}


def test_what_a_graph_baked_in_moves_with_new_weights_or_a_rebuild(nets):
    """A decode graph is replayed only while what it read at capture is
    what the engine would read now (``_graph_reads``: the step's leaves
    and the compute parameters' leaves): steady across steps, moved by
    new parameter tensors (a fit's, or a new bf16 compute copy) and by a
    rebuild."""
    from deeplearning4j_tpu_torch.serving.engine import _same_tensors
    net = TextGenerationTransformer(**KW).init(device="cpu")
    net.load_numpy_params({v: {k: t.numpy() for k, t in p.items()}
                           for v, p in nets[1].params.items()})
    eng = _engine(net, "bf16", supervisor=EngineSupervisor())
    for p in PROMPTS[:2]:
        eng.submit(p, steps=8, top_k=1)
    eng.step()
    reads = eng._graph_reads()
    eng.step()
    assert _same_tensors(reads, eng._graph_reads())
    net.params = {v: {k: t.clone() for k, t in p.items()}
                  for v, p in net.params.items()}
    assert not _same_tensors(reads, eng._graph_reads())
    reads = eng._graph_reads()
    net.conf.dtype = "bfloat16"          # a compute copy, made once
    bf16 = eng._graph_reads()
    assert not _same_tensors(reads, bf16)
    assert _same_tensors(bf16, eng._graph_reads())
    net._compute = None                  # in-place writes drop the copy
    assert not _same_tensors(bf16, eng._graph_reads())
    net.conf.dtype = "float32"
    reads = eng._graph_reads()
    eng._decode_chaos = chaos.FaultBurstInjector(k=1)
    eng.step()                           # the fault, the rebuild
    assert eng._supervisor.rebuilds == 1
    assert not _same_tensors(reads, eng._graph_reads())


def _snapshot(eng):
    """Copies of everything a dispatch may change (leaves and host
    mirrors)."""
    net = eng.net
    leaves = {k: t.clone() for k, t in _leaves(eng).items()}
    host = (getattr(net, "_stream_pos", None),
            dict(getattr(net, "_stream_pos_map", None) or {}),
            getattr(net, "_stream_pos_rows", None))
    return leaves, host


def _restore(eng, snap):
    leaves, host = snap
    for k, t in _leaves(eng).items():
        t.copy_(leaves[k])
    net = eng.net
    if host[0] is not None:
        net._stream_pos = host[0]
    net._stream_pos_map = dict(host[1])
    net._stream_pos_rows = host[2]


def _whole(eng, chunk):
    """The whole ``rnn_time_step`` on the engine's installed view."""
    paged = eng._pool is not None
    if paged:
        eng._install_paged_state()
    try:
        if chunk.shape[1] == 1:
            return step_tokens(eng.net, chunk[:, 0])[:, :, None]
        return verify_tokens(eng.net, chunk)
    finally:
        if paged:
            eng._extract_paged_state()


@pytest.mark.parametrize("kind,width", [("bf16", 1), ("int8", 1),
                                        ("bf16", 1 + GAMMA),
                                        ("int8", 1 + GAMMA), ("lstm", 1)])
def test_the_split_dispatch_equals_the_whole_rnn_time_step(nets, lstm,
                                                           kind, width):
    net = lstm if kind == "lstm" else nets[1]
    eng = _engine(net, kind)
    for p, n in zip(PROMPTS[:3], STEPS[:3]):
        eng.submit(p, steps=n + 4, top_k=1)
    eng.step()
    eng.step()
    chunk = np.random.default_rng(5).integers(0, V, (SLOTS, width))
    eng._sync_accounting()
    snap = _snapshot(eng)
    got = eng._dispatch(chunk)
    got_leaves, got_host = _snapshot(eng)
    _restore(eng, snap)
    want = _whole(eng, chunk).astype(np.float32)
    want_leaves, want_host = _snapshot(eng)
    assert got.shape == (SLOTS, V, width)
    np.testing.assert_array_equal(got, want)
    assert set(got_leaves) == set(want_leaves)
    for k in got_leaves:
        assert torch.equal(got_leaves[k], want_leaves[k]), k
    assert got_host[:2] == want_host[:2]
    np.testing.assert_array_equal(got_host[2], want_host[2])


@pytest.fixture(scope="module")
def jax_streams(nets):
    out = {}
    for sampled in (False, True):
        out[sampled] = _trace(JaxEngine(nets[0], V, slots=SLOTS,
                                        paging=JaxPaged(page_size=PS,
                                                        decode_impl="xla")),
                              sampled)
    return out


def _trace(eng, sampled):
    """Staggered admissions of prompts cut to 4 tokens (two of the JAX
    engine's prime buckets: its compiles are most of this test's
    time)."""
    hs = []
    for i, (p, n) in enumerate(zip(PROMPTS, STEPS)):
        p = p[:4]
        kw = SAMPLED[i % len(SAMPLED)] if sampled else dict(top_k=1)
        hs.append(eng.submit(p, steps=n, rng=np.random.default_rng(i),
                             **kw))
        eng.step()
    eng.run_until_idle()
    return [h.result(timeout=0) for h in hs]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_the_streams_equal_the_jax_engines(nets, jax_streams, sampled):
    assert _trace(_engine(nets[1], "bf16"), sampled) == jax_streams[sampled]
