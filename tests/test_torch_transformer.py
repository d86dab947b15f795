"""The port's rope TextGenerationTransformer against the JAX graph with
the same parameters (carried across by util/convert.params_from_numpy):
whole-sequence output(), chunked streaming rnn_time_step, and packed
(pad_left) priming. Run with standard and grouped-query attention.
Tolerance: f32, atol=2e-5, rtol=1e-4 (XLA and torch sum in different
orders); bf16 (the compute policy the card serves in): bit for bit
against the JAX graph run op by op."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo import TextGenerationTransformer as JaxTFM
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.layers import Convolution1DLayer
from deeplearning4j_tpu_torch.util.convert import (
    params_from_numpy, params_to_numpy)
from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer
from torch_threads import one_thread  # noqa: F401 (autouse)

V, E, HEADS, LAYERS, MAXLEN = 24, 32, 4, 2, 32
TOL = dict(atol=2e-5, rtol=1e-4)


def _models(n_kv_heads):
    kw = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
              max_length=MAXLEN, positional="rope", n_kv_heads=n_kv_heads)
    jnet = JaxTFM(**kw).init()
    # weights as initialised; biases, gammas and betas drawn away from
    # their constant init so that every add and scale rounds
    rng = np.random.default_rng(7)
    np_params = {v: {k: np.asarray(a, np.float32) if k.startswith("W")
                     else rng.normal(float(k == "gamma"), 0.2, a.shape)
                     .astype(np.float32) for k, a in p.items()}
                 for v, p in jnet.params.items()}
    jnet.params = {v: {k: jnp.asarray(a) for k, a in p.items()}
                   for v, p in np_params.items()}
    tnet = TextGenerationTransformer(**kw).init(device="cpu")
    tnet.load_numpy_params(np_params)
    return jnet, tnet, np_params


@pytest.fixture(scope="module", params=[None, 2], ids=["mha", "gqa2"])
def nets(request):
    return _models(request.param)


def _one_hot(ids):
    x = np.zeros((len(ids), V, len(ids[0])), np.float32)
    for b, row in enumerate(ids):
        x[b, row, np.arange(len(row))] = 1.0
    return x


def _ids(seed, b, t):
    return np.random.default_rng(seed).integers(0, V, (b, t)).tolist()


def test_params_round_trip_keeps_names_shapes_and_layouts(nets):
    _, tnet, np_params = nets
    back = params_to_numpy(params_from_numpy(np_params, "cpu"))
    assert back.keys() == np_params.keys()
    for v, p in np_params.items():
        assert back[v].keys() == p.keys()
        for k, a in p.items():
            np.testing.assert_array_equal(back[v][k], a)
    # the port keeps the JAX layouts: kernel-1 conv W [n_out, n_in, 1],
    # attention / output W [n_in, n_out]
    assert tuple(tnet.params["embed"]["W"].shape) == (E, V, 1)
    assert tuple(tnet.params["ffn0a"]["W"].shape) == (4 * E, E, 1)
    assert tuple(tnet.params["attn0"]["Wq"].shape) == (E, E)
    assert tuple(tnet.params["out"]["W"].shape) == (E, V)
    np.testing.assert_array_equal(
        tnet.params["attn1"]["Wk"].numpy(), np_params["attn1"]["Wk"])


def test_load_rejects_a_mismatched_tree(nets):
    _, tnet, np_params = nets
    bad = {v: dict(p) for v, p in np_params.items()}
    bad["out"]["W"] = bad["out"]["W"][:, :-1]
    with pytest.raises(ValueError, match="shapes differ"):
        TextGenerationTransformer(
            vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
            max_length=MAXLEN, positional="rope",
            n_kv_heads=tnet.conf.vertices["attn0"].layer.n_kv_heads
        ).init(device="cpu").load_numpy_params(bad)


def test_output_matches_jax(nets):
    jnet, tnet, _ = nets
    x = _one_hot(_ids(0, 2, 12))
    want = np.asarray(jnet.output(x))
    got = tnet.output(x)
    assert got.dtype == torch.float32 and got.shape == (2, V, 12)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_chunked_rnn_time_step_matches_jax(nets):
    jnet, tnet, _ = nets
    x = _one_hot(_ids(1, 2, 14))
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    for a, b in ((0, 5), (5, 6), (6, 11), (11, 14)):
        want = np.asarray(jnet.rnn_time_step(x[:, :, a:b]))
        got = tnet.rnn_time_step(x[:, :, a:b]).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    # streaming == the whole-sequence forward
    np.testing.assert_allclose(got, tnet.output(x).numpy()[:, :, 11:],
                               **TOL)


def test_pad_left_rnn_time_step_matches_jax(nets):
    """Packed priming: pads never enter the cache nor take positions.
    The real columns and the stream after it match the JAX graph."""
    jnet, tnet, _ = nets
    ids = _ids(2, 1, 7)[0]
    pad = 3
    x = _one_hot([[0] * pad + ids])
    x[:, :, :pad] = 0.0
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    want = np.asarray(jnet.rnn_time_step(x, pad_left=pad))
    got = tnet.rnn_time_step(x, pad_left=pad).numpy()
    np.testing.assert_allclose(got[:, :, pad:], want[:, :, pad:], **TOL)
    nxt = _one_hot([[5]])
    np.testing.assert_allclose(tnet.rnn_time_step(nxt).numpy(),
                               np.asarray(jnet.rnn_time_step(nxt)), **TOL)


def test_stream_budget_guard(nets):
    _, tnet, _ = nets
    tnet.rnn_clear_previous_state()
    tnet.rnn_time_step(_one_hot(_ids(3, 1, MAXLEN)))
    with pytest.raises(ValueError, match="streaming capacity"):
        tnet.rnn_time_step(_one_hot([[1]]))


def _torch(a):
    """A JAX array as a torch tensor of the same dtype (bf16 exactly)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _assert_vertices_match(tnet, acts, want_acts, state=None, cols=0):
    """Each port vertex on the JAX vertex's own bf16 inputs (and, when
    streaming, its carried cache) against the JAX vertex's output: same
    dtype; at least 99% of the elements bit for bit (an f32 sum taken in
    another order may flip a rounding), none off by more than one bf16
    ulp of the vertex's largest value. Another rounding point (a double
    rounding, an f32 intermediate kept or dropped) differs in far more
    elements than 1% (see test_bf16_policy_keeps_f32_heads)."""
    params = tnet._compute_params()
    for name in tnet._topo:
        v = tnet.conf.vertices[name]
        xs = [_torch(acts[i])[..., cols:]
              for i in tnet.conf.vertex_inputs[name]]
        extra = {}
        v_state = {}
        if getattr(v, "supports_streaming", False):
            extra = {"stream": state is not None}
            if state is not None:
                v_state = {k: _torch(a) for k, a in state[name].items()}
        got, _ = v.apply(params[name], xs, v_state, **extra)
        want = _torch(want_acts[name])[..., cols:]
        assert got.dtype == want.dtype == torch.bfloat16, name
        got, want = got.float().numpy(), want.float().numpy()
        exact = np.mean(got == want)
        assert exact >= 0.99, (name, exact)
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -8 *
                                   np.abs(want).max(), err_msg=name)


def _jax_flash_path(monkeypatch):
    """Route the JAX layer's whole-sequence attention through the Pallas
    flash kernel in interpret mode: the path a TPU takes, whose rounding
    points the port's flash-attention kernels keep (p rounded to V's
    dtype before P.V). On the CPU ``blockwise_attention`` would take its
    scan, which keeps p in f32."""
    from deeplearning4j_tpu.nn.layers.pallas_attention import (
        flash_attention)
    from deeplearning4j_tpu.parallel import sequence

    def flash(q, k, v, causal=False, block_size=512, key_mask=None,
              use_pallas=None, window=None):
        return flash_attention(q, k, v, causal=causal, key_mask=key_mask,
                               window=window, block_q=128, block_k=128,
                               interpret=True)

    monkeypatch.setattr(sequence, "blockwise_attention", flash)


def test_bf16_policy_keeps_f32_heads(nets, monkeypatch):
    """conf.dtype bf16: params and inputs cast to bf16 once, bf16
    activations between vertices, f32 heads, and every rounding point
    inside a vertex kept: LayerNorm statistics in f32 and its affine in
    bf16, gelu and the output softmax op by op in bf16, residual adds in
    bf16; whole-sequence attention as the flash kernels compute it (f32
    scores and softmax, p rounded to bf16 before P.V; the JAX reference
    runs its Pallas kernel in interpret mode), streamed attention's
    scores and softmax in f32 over the bf16 cache.

    The reference is the JAX graph's forward run op by op, so that
    every op rounds to its dtype, and each port vertex is fed the JAX
    vertex's inputs: for output(), for a chunked stream and for a
    pad_left prime. A vertex whose rounding points differ fails the 99%
    cut (F.gelu rounds once from f32 and matches jax.nn.gelu in about
    55% of the elements; torch.softmax in about 32%). Under jit, XLA's
    CPU fusions keep f32 between some bf16 ops (jax.nn.softmax's own
    source notes that jit changes its numerics), so the jitted graph is
    no reference for rounding; the engine test holds greedy streams
    against it."""
    jnet, tnet, _ = nets
    _jax_flash_path(monkeypatch)
    saved = jnet.conf.dtype, tnet.conf.dtype
    jnet.conf.dtype = tnet.conf.dtype = "bfloat16"
    try:
        # one chunk width throughout: each new shape makes the op-by-op
        # JAX forward compile every op again
        x = _one_hot(_ids(4, 2, 12))
        got = tnet.output(x[:, :, :6])
        assert got.dtype == torch.float32
        assert tnet._compute_params()["attn0"]["Wq"].dtype == torch.bfloat16
        assert tnet._compute_params() is tnet._compute_params()  # cast once
        jparams, ins = jnet._cast_compute(jnet.params, {"in": x[:, :, :6]})
        fwd = functools.partial(jnet._forward, jparams, train=False,
                                rng=jax.random.PRNGKey(0))
        acts, _, _ = fwd({}, ins)
        assert acts["out"].dtype == jnp.bfloat16
        _assert_vertices_match(tnet, acts, acts)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(acts["out"].astype(jnp.float32)))

        # a chunked stream: each chunk against the cache JAX carried in
        _, ins = jnet._cast_compute(jnet.params, {"in": x})
        state = {}
        for a, b in ((0, 6), (6, 12)):
            chunk = {"in": ins["in"][:, :, a:b]}
            acts, new_state, _ = fwd(state, chunk, carry_rnn=True,
                                     stream=True)
            _assert_vertices_match(tnet, {**chunk, **acts}, acts,
                                   state=state or _fresh(tnet))
            state = new_state
        assert state["attn0"]["kv_k"].dtype == jnp.bfloat16

        # a packed (pad_left) prime: pads never reach the port's layers
        pad = 2
        xp = _one_hot([[0] * pad + r for r in _ids(5, 2, 4)])
        xp[:, :, :pad] = 0.0
        _, pins = jnet._cast_compute(jnet.params, {"in": xp})
        acts, _, _ = fwd({}, pins, carry_rnn=True, stream=True,
                         pad=jnp.asarray(pad, jnp.int32))
        _assert_vertices_match(tnet, {**pins, **acts}, acts,
                               state=_fresh(tnet), cols=pad)
    finally:
        jnet.conf.dtype, tnet.conf.dtype = saved


def _fresh(tnet):
    """An empty streaming state for every vertex."""
    return {name: {} for name in tnet._topo}


def test_entry_points_default_to_cuda(monkeypatch):
    """No device given means "cuda"; without a CUDA device that raises
    instead of carrying on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TextGenerationTransformer(vocab_size=V, embed_dim=E,
                                      n_heads=HEADS, n_layers=1,
                                      max_length=MAXLEN, positional="rope")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({}, None)


def test_left_out_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        TextGenerationTransformer(vocab_size=V, positional="rope",
                                  window=4)
    # fuse=True builds with an empty bn -> act -> 1x1-conv plan, as the
    # JAX package's does (the transformer has no such chain)
    kw = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=1,
              max_length=MAXLEN, positional="rope", fuse=True)
    tnet = TextGenerationTransformer(**kw).init(device="cpu")
    jnet = JaxTFM(**kw).init()
    assert tnet.fusion_level is True and jnet.fuse_bn_act_conv is True
    assert tnet._conv_plan() == jnet._fusion()[0] == {}
    assert tnet._fusion() == ({}, {}, {})
    with pytest.raises(TypeError, match="kernel_size"):
        TextGenerationTransformer(vocab_size=V, positional="rope",
                                  kernel_size=64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        Convolution1DLayer(n_out=4, kernel=3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        ElementWiseVertex(op="max")
