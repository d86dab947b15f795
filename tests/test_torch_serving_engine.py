"""The port's GenerationEngine (deeplearning4j_tpu_torch/serving/
engine.py) on the CPU.

- Against the JAX engine, with the same seeded parameters and prompts:
  greedy token streams are identical, with the slot arena
  (``paging=None``) and with direct paging plus the prefix cache over a
  shared-prefix prompt set. The JAX engine runs its Pallas paged kernel
  in interpret mode (``decode_impl="pallas", kernel_interpret=True``),
  as tests/test_serving_paged_kernel.py runs it; the port's wrapper
  takes its plain version on CPU tensors.
- Torch against torch: engine == one-shot ``sample_stream``, greedy and
  sampled with the same numpy rng (the contract the JAX package pins on
  itself).
- The port imports neither jax nor deeplearning4j_tpu (an ast scan).
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.serving import (
    GenerationEngine as JaxEngine, PagedKVConfig as JaxPaged)
from deeplearning4j_tpu.zoo import TextGenerationTransformer as JaxTFM
from deeplearning4j_tpu_torch.serving import (
    GenerationEngine, PagedKVConfig, ServingQueueFull)
from deeplearning4j_tpu_torch.serving.paged_kernel import PAGED_ATTENTION
from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer
from torch_threads import one_thread  # noqa: F401 (autouse)

V, E, HEADS, LAYERS, MAXLEN, PS = 16, 32, 4, 2, 40, 4
SYS = [1, 2, 3, 4, 5, 6, 7, 8]             # two full shared blocks
PROMPTS = [SYS + [9, 10, 11], [3, 4, 5], SYS + [12], [7, 6],
           SYS + [2, 2, 2, 2, 5], [9]]
STEPS = 6
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def nets():
    kw = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
              max_length=MAXLEN, positional="rope", n_kv_heads=2)
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
    model = TextGenerationTransformer(**kw)
    tnet = model.init(device="cpu").load_numpy_params(np_params)
    saved = jax_layers.paged_decode_impl()
    yield jnet, tnet, model
    jax_layers.set_paged_decode_impl(*saved)


def _trace(engine, prompts=PROMPTS, steps=STEPS, submit_kw=None):
    """Staggered admissions (one engine step between submits), greedy
    unless overridden, each request with its own seeded rng."""
    hs = []
    for i, p in enumerate(prompts):
        kw = dict(top_k=1)
        kw.update((submit_kw or {}).get(i, {}))
        hs.append(engine.submit(p, steps=steps,
                                rng=np.random.default_rng(i), **kw))
        engine.step()
    engine.run_until_idle()
    return [h.result(timeout=0) for h in hs]


@pytest.mark.parametrize("paged,dtype", [
    (False, "float32"), (True, "float32"), (True, "bfloat16")],
    ids=["slots", "paged", "paged_bf16"])
def test_greedy_streams_match_the_jax_engine(nets, paged, dtype):
    """paged_bf16 is the card's serving configuration: bf16 compute and
    a bf16 page pool. The JAX engine runs jitted there, a few bf16 ulps
    from the op-by-op rounding test_torch_transformer.py pins; the
    greedy streams still agree token for token."""
    jnet, tnet, _ = nets
    saved = jnet.conf.dtype, tnet.conf.dtype
    jnet.conf.dtype = tnet.conf.dtype = dtype
    try:
        jpaging = (JaxPaged(page_size=PS, direct=True, decode_impl="pallas",
                            kernel_interpret=True) if paged else None)
        want = _trace(JaxEngine(jnet, V, slots=3, paging=jpaging))
        eng = GenerationEngine(tnet, V, slots=3, device="cpu",
                               paging=PagedKVConfig(page_size=PS)
                               if paged else None)
        assert _trace(eng) == want
    finally:
        jnet.conf.dtype, tnet.conf.dtype = saved
    if paged:
        assert eng.prefix_cache.hits >= 2       # the shared SYS blocks
        assert eng.page_pool.used_count() == len(eng.prefix_cache)
        assert {p.dtype for p in eng._page_store} == {getattr(torch, dtype)}


SAMPLED = {0: dict(top_k=None, temperature=0.8),
           1: dict(top_k=5, temperature=1.2),
           2: dict(top_k=None, top_p=0.9),
           3: dict(top_k=3, top_p=0.8, temperature=0.7)}


@pytest.mark.parametrize("paged", [False, True], ids=["slots", "paged"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_engine_equals_sample_stream(nets, paged, sampled):
    _, tnet, model = nets
    submit_kw = SAMPLED if sampled else {}
    eng = GenerationEngine(tnet, V, slots=2, device="cpu",
                           paging=PagedKVConfig(page_size=PS)
                           if paged else None)
    got = _trace(eng, submit_kw=submit_kw)
    for i, p in enumerate(PROMPTS):
        kw = dict(top_k=1)
        kw.update(submit_kw.get(i, {}))
        want = model.sample_stream(tnet, p, steps=STEPS,
                                   rng=np.random.default_rng(i), **kw)
        assert got[i] == want, (i, kw)


def test_kernel_wrapper_counts_no_launch_on_cpu(nets):
    _, tnet, _ = nets
    before = PAGED_ATTENTION.launches
    eng = GenerationEngine(tnet, V, slots=2, device="cpu",
                           paging=PagedKVConfig(page_size=PS))
    _trace(eng, PROMPTS[:2])
    assert eng.dispatches > 0 and PAGED_ATTENTION.launches == before


def test_retirement_reasons(nets):
    _, tnet, _ = nets
    eng = GenerationEngine(tnet, V, slots=2, device="cpu",
                           paging=PagedKVConfig(page_size=PS))
    greedy = _trace(eng, PROMPTS[:1])[0]
    stop_tok = greedy[len(PROMPTS[0]) + 1]     # the 2nd generated token
    h_stop = eng.submit(PROMPTS[0], steps=STEPS, top_k=1,
                        stop_tokens=[stop_tok])
    h_cap = eng.submit([3] * (MAXLEN - 3), steps=10, top_k=1,
                       max_length=MAXLEN + 5)
    h_cancel = eng.submit([4, 5], steps=STEPS, top_k=1)
    h_cancel.cancel()
    h_late = eng.submit([5, 6], steps=STEPS, top_k=1, timeout=0.0)
    eng.run_until_idle()
    assert h_stop.result(timeout=0)[-1] == stop_tok
    assert h_stop.finish_reason == "stop"
    assert h_cap.finish_reason == "capacity"
    # primed to MAXLEN - 3, then one token per position up to capacity
    assert len(h_cap.generated) == 4
    assert h_cancel.finish_reason == "cancelled"
    assert h_late.finish_reason == "error"
    assert eng.page_pool.used_count() == len(eng.prefix_cache)
    eng.shutdown()
    assert not eng.is_healthy()


def test_queue_policies_and_background_loop(nets):
    _, tnet, _ = nets
    eng = GenerationEngine(tnet, V, slots=1, device="cpu", queue_limit=1,
                           queue_policy="fail_fast")
    eng.submit([1, 2], steps=2, top_k=1)
    with pytest.raises(ServingQueueFull):
        eng.submit([1, 2], steps=2, top_k=1)
    eng.run_until_idle()
    eng2 = GenerationEngine(tnet, V, slots=2, device="cpu",
                            paging=PagedKVConfig(page_size=PS)).warmup(8)
    eng2.start()
    hs = [eng2.submit(p, steps=4, top_k=1) for p in PROMPTS[:3]]
    outs = [h.result(timeout=60) for h in hs]
    eng2.shutdown()
    assert [len(o) - len(p) for o, p in zip(outs, PROMPTS)] == [4, 4, 4]
    assert list(hs[0]) == outs[0][len(PROMPTS[0]):]     # the token stream
    assert eng2.prefix_cache is not None and len(eng2.prefix_cache) > 0


def test_left_out_arguments_raise(nets, monkeypatch):
    _, tnet, _ = nets
    # the engine takes every argument of the JAX engine's (speculation:
    # tests/test_torch_speculation.py; the supervisor, the chaos seams,
    # decode_retry, overload and registry: tests/test_torch_serving_
    # supervisor.py); what stays unknown is refused as unexpected
    with pytest.raises(TypeError, match="unexpected keyword"):
        GenerationEngine(tnet, V, device="cpu", page_publisher=object())
    # the int8 pool is ported (tests/test_torch_serving_quant.py); the
    # legacy round trip it cannot ride is refused as in the JAX package
    with pytest.raises(ValueError, match="needs direct=True"):
        PagedKVConfig(kv_dtype="int8", direct=False)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        PagedKVConfig(decode_impl="xla")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A7"):
        PagedKVConfig(direct=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerationEngine(tnet, V)


def _forbidden(module: str) -> bool:
    return any(module == m or module.startswith(m + ".")
               for m in ("jax", "deeplearning4j_tpu"))


def test_port_imports_neither_jax_nor_the_jax_package():
    assert _forbidden("deeplearning4j_tpu.nn") and _forbidden("jax")
    assert not _forbidden("deeplearning4j_tpu_torch.nn")
    assert not _forbidden("jaxtyping")
    files = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad
