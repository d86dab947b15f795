"""The port's kernel-crossover store, calibration harness and execution-
plan resolution (deeplearning4j_tpu_torch/tuning/) against the JAX
package's tuning/, on the CPU.

- The fingerprints are the JAX package's strings, and so is the verdict
  rule. The implementation revisions are the JAX package's but for the
  two training domains, one higher: their fallback is timed as the xla
  plan's layers, and a stored entry of the old revision is pruned.
- The store: a saved entry reads back (the JAX file layout), repeated
  records merge into a running mean, an entry of a stale revision is
  pruned on load, a torn file reads as uncalibrated, timings that are
  not positive are refused, and an entry measured on another platform or
  device kind is ignored with a warning; entries are read for the device
  a caller names, by default the card.
- ``apply_execution_plan`` on ResNet50 at 64x64 (NHWC, f32): "auto" on
  an uncalibrated store is the xla plan, and "auto" and "fused" against
  stores holding the same verdicts choose the same blocks and stem, with
  the same record, as the JAX package's on its own ResNet50.
- ``calibrate_training_kernels`` fills every distinct block shape and
  the stem (the same keys as the JAX harness; timing monkeypatched), and
  once for real at 32x32 (the plain versions' steps run). Its fallback,
  ``xla_plan_bottleneck`` / ``xla_plan_stem`` (the xla plan's layers),
  computes ``reference_bottleneck`` / ``reference_stem``: outputs,
  running statistics and gradients within 1e-5 of each tensor's largest
  value in f32 (cuDNN-free CPU convolutions against einsums: sums in
  other orders).
- The port never writes (nor names in its code) the JAX package's
  ``KERNEL_CROSSOVER.json``.
"""

import ast
import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import tuning as jt
from deeplearning4j_tpu.tuning import crossover as jcross
from deeplearning4j_tpu.tuning.plan import _block_key as j_block_key
from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch import tuning as tt
from deeplearning4j_tpu_torch.tuning import crossover as tcross
from deeplearning4j_tpu_torch.tuning.plan import _block_key, _stem_key
from deeplearning4j_tpu_torch.zoo import ResNet50

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_default_stores():
    tt.reset_default_store(tt.KernelCrossoverStore(path="/nonexistent/none"))
    jt.reset_default_store(jt.KernelCrossoverStore(path="/nonexistent/none"))
    yield
    tt.reset_default_store(None)
    jt.reset_default_store(None)


FINGERPRINTS = {
    "generic": ("fingerprint", ("d", "float32"), {"b": 2, "a": 1}),
    "bf16": ("fingerprint", ("d", "bfloat16"), {}),
    "any": ("fingerprint", ("d", None), {"x": 3}),
    "f64": ("fingerprint", ("d", "float64"), {"L": 4, "d": 2}),
    "block": ("bottleneck_fingerprint",
              (14, 14, 1024, 256, 1024, 1, False, "bfloat16"), {}),
    "block_skip": ("bottleneck_fingerprint",
                   (56, 56, 256, 128, 512, 2, True, "float32"), {}),
    "stem": ("stem_fingerprint", (224, 224, 3, 64, "bfloat16"), {}),
    "decode": ("decode_fingerprint", (16, 64, 8, 1024, "bfloat16"), {}),
    "quant": ("quant_fingerprint", (16, 64, 8, 1024, "bfloat16"), {}),
}


@pytest.mark.parametrize("case", sorted(FINGERPRINTS))
def test_fingerprints_are_the_jax_strings(case):
    name, args, kw = FINGERPRINTS[case]
    assert getattr(tcross, name)(*args, **kw) == \
        getattr(jcross, name)(*args, **kw)


#: the domains whose fallback the port measures otherwise than the JAX
#: package (the xla plan's layers, not the reference composition)
REMEASURED = ("train_bottleneck", "train_stem")


def test_revisions_and_verdicts_are_the_jax_packages():
    assert set(tt.IMPL_REVS) == set(jt.IMPL_REVS)
    for domain, rev in tt.IMPL_REVS.items():
        assert rev == jt.IMPL_REVS[domain] + (domain in REMEASURED), domain
    for e in ({"kernel_ms": 1.0, "fallback_ms": 2.0},
              {"kernel_ms": 2.0, "fallback_ms": 2.0}, {}, {"kernel_ms": 1}):
        assert tt.winner(e) == jt.winner(e)
    assert tt.CROSSOVER_NAME == "KERNEL_CROSSOVER_TORCH.json"


# ---------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------
def test_record_save_load_round_trip(tmp_path):
    p = str(tmp_path / tt.CROSSOVER_NAME)
    s = tt.KernelCrossoverStore(path=p)
    key = tcross.fingerprint("train_bottleneck", "float32", h=4)
    s.record(key, 1.5, 3.0, device=CPU)
    assert s.save() == p
    raw = json.loads(Path(p).read_text())
    assert set(raw) == {"version", "tool", "entries"}
    e = tt.KernelCrossoverStore.load(p).lookup(key, device=CPU)
    assert e["kernel_ms"] == 1.5 and e["fallback_ms"] == 3.0
    assert (e["platform"], e["device_kind"]) == ("cpu", "cpu")
    assert e["impl_rev"] == tt.IMPL_REVS["train_bottleneck"]
    assert tt.KernelCrossoverStore.load(p).choose(key, device=CPU) \
        == "kernel"
    assert not Path(p + ".tmp").exists()


def test_records_ratchet_to_a_running_mean():
    s = tt.KernelCrossoverStore(path="/nonexistent/none")
    key = tcross.fingerprint("train_stem", "float32", h=8)
    s.record(key, 1.0, 2.0, device=CPU)
    e = s.record(key, 3.0, 4.0, device=CPU)
    assert e["samples"] == 2
    assert e["kernel_ms"] == pytest.approx(2.0)
    assert e["fallback_ms"] == pytest.approx(3.0)
    # another device kind starts over
    e = s.record(key, 5.0, 1.0, platform="cuda", device_kind="some card")
    assert e["samples"] == 1 and e["kernel_ms"] == 5.0


def test_a_stale_revision_is_pruned_on_load(tmp_path):
    p = str(tmp_path / tt.CROSSOVER_NAME)
    s = tt.KernelCrossoverStore(path=p)
    key = tcross.fingerprint("train_bottleneck", "float32", h=4)
    s.record(key, 1.0, 2.0, device=CPU)
    s._entries[key]["impl_rev"] = tt.IMPL_REVS["train_bottleneck"] - 1
    s.save()
    s2 = tt.KernelCrossoverStore.load(p)
    assert len(s2) == 0
    assert s2.choose(key, default="fallback", device=CPU) == "fallback"


@pytest.mark.parametrize("domain", REMEASURED)
def test_a_revision_one_entry_of_the_old_fallback_is_pruned(tmp_path,
                                                            domain):
    """An entry calibrated against the reference composition (revision
    1, as the earlier harness stored them) no longer decides "auto"."""
    p = tmp_path / tt.CROSSOVER_NAME
    key = tcross.fingerprint(domain, "bfloat16", h=56)
    p.write_text(json.dumps({"version": 1, "entries": {key: {
        "kernel_ms": 3.7, "fallback_ms": 7.9, "platform": "cpu",
        "device_kind": "cpu", "impl_rev": 1, "samples": 1}}}))
    s = tt.KernelCrossoverStore.load(str(p))
    assert len(s) == 0
    assert s.choose(key, default="fallback", device=CPU) == "fallback"


@pytest.mark.parametrize("text", ["{ torn json", "[1, 2]", ""])
def test_a_torn_store_reads_as_uncalibrated(tmp_path, text):
    p = tmp_path / tt.CROSSOVER_NAME
    p.write_text(text)
    assert len(tt.KernelCrossoverStore.load(str(p))) == 0


@pytest.mark.parametrize("kernel_ms,fallback_ms",
                         [(0.0, 1.0), (1.0, -2.0), (float("nan"), 1.0)])
def test_invalid_timings_are_refused(kernel_ms, fallback_ms):
    s = tt.KernelCrossoverStore(path="/nonexistent/none")
    with pytest.raises(ValueError, match="positive"):
        s.record("d|x|f32", kernel_ms, fallback_ms, device=CPU)
    assert len(s) == 0


@pytest.mark.parametrize("platform,kind", [("cuda", "NVIDIA H100 80GB HBM3"),
                                           ("cpu", "another cpu")])
def test_a_foreign_entry_is_ignored_with_a_warning(caplog, platform, kind):
    key = tcross.fingerprint("train_stem", "bfloat16", h=16)
    s = tt.KernelCrossoverStore(entries={key: {
        "kernel_ms": 1.0, "fallback_ms": 2.0, "platform": platform,
        "device_kind": kind, "impl_rev": tt.IMPL_REVS["train_stem"],
        "samples": 1}})
    with caplog.at_level(logging.WARNING):
        assert s.lookup(key, device=CPU) is None
        assert s.choose(key, default="fallback", device=CPU) == "fallback"
    assert any(f"calibrated on {platform}" in r.message
               for r in caplog.records)
    assert s.decisions[("train_stem", "default")] == 1


def test_decisions_and_calibrations_are_counted():
    s = tt.KernelCrossoverStore(path="/nonexistent/none")
    key = tcross.fingerprint("train_stem", "float32", h=9)
    assert s.choose(key, device=CPU) is None
    s.record(key, 1.0, 5.0, device=CPU)
    assert s.choose(key, device=CPU) == "kernel"
    assert s.decisions == {("train_stem", "default"): 1,
                           ("train_stem", "kernel"): 1}
    assert s.calibrations == {("train_stem", "kernel"): 1}


def test_entries_are_read_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = tt.KernelCrossoverStore(entries={"train_stem|h=1|f32": {}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.lookup("train_stem|h=1|f32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        s.record("train_stem|h=1|f32", 1.0, 2.0)


def test_calibrate_times_both_sides_and_persists(tmp_path, monkeypatch):
    times = iter([1.25, 4.0])
    monkeypatch.setattr(tcross, "_time_thunk",
                        lambda fn, w, i, device=None: next(times))
    p = str(tmp_path / tt.CROSSOVER_NAME)
    s = tt.KernelCrossoverStore(path=p)
    key = tcross.fingerprint("train_stem", "float32", h=8)
    e = s.calibrate(key, lambda: None, lambda: None, device=CPU,
                    persist=True)
    assert (e["kernel_ms"], e["fallback_ms"]) == (1.25, 4.0)
    assert tt.KernelCrossoverStore.load(p).choose(key, device=CPU) \
        == "kernel"
    # the harness itself: the warm-up calls, then the timed ones
    monkeypatch.undo()
    calls = []
    assert tcross._time_thunk(lambda: calls.append(1), 2, 3, CPU) >= 0
    assert len(calls) == 5


# ---------------------------------------------------------------------
# the execution plans against the JAX package's
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def nets():
    jnet = JResNet50(num_classes=10, height=64, width=64,
                     data_format="NHWC").init()
    tnet = ResNet50(num_classes=10, height=64, width=64,
                    data_format="NHWC").init(device=CPU)
    return jnet, tnet


def _stores(verdicts, tmp_path):
    """A JAX and a port store (on the CPU) holding ``verdicts``: {key:
    (kernel_ms, fallback_ms)}."""
    js = jt.KernelCrossoverStore(path=str(tmp_path / "jax.json"))
    ts = tt.KernelCrossoverStore(path=str(tmp_path / "port.json"))
    for key, (k, f) in verdicts.items():
        js.record(key, k, f)
        ts.record(key, k, f, device=CPU)
    return js, ts


def _resolve(nets, plan, js, ts):
    jnet, tnet = nets
    jrec = jt.apply_execution_plan(jnet, plan, store=js)
    trec = tt.apply_execution_plan(tnet, plan, store=ts)
    assert trec == jrec
    _, _, jbplan = jnet._fusion()
    assert set(tnet._fusion()[1]) == set(jbplan)
    assert set(tnet._fusion()[2]) == set(jnet._stem_plan())
    return trec


def test_the_candidates_have_the_jax_keys(nets):
    jnet, tnet = nets
    jb, js_ = jnet.fusion_candidates()
    tb, ts_ = tnet.fusion_candidates()
    assert set(tb) == set(jb) and set(ts_) == set(js_) == {"stem_pool"}
    for name in tb:
        assert _block_key(tb[name], "float32") == \
            j_block_key(jb[name], "float32")
    assert _stem_key(ts_["stem_pool"], "float32") == \
        jt.stem_fingerprint(64, 64, 3, 64, "float32")


def test_auto_on_an_uncalibrated_store_is_the_xla_plan(nets, tmp_path):
    rec = _resolve(nets, "auto", *_stores({}, tmp_path))
    assert rec["level"] is False and rec["blocks"] == 0 and not rec["stem"]
    assert len(rec["keys"]) == 17
    assert {v["choice"] for v in rec["keys"].values()} == {"fallback"}
    assert nets[1].fusion_level is False


def _verdicts(nets, stem_wins):
    """The stem (if ``stem_wins``) and the blocks of stages s3 and s5b0's
    shape win; every other candidate loses."""
    _, tnet = nets
    bc, sc = tnet.fusion_candidates()
    out = {}
    for name, grp in bc.items():
        win = name.startswith("s3") or name == "s5b0_out"
        out[_block_key(grp, "float32")] = (1.0, 2.0) if win else (2.0, 1.0)
    out[_stem_key(sc["stem_pool"], "float32")] = \
        (1.0, 3.0) if stem_wins else (3.0, 1.0)
    return out


@pytest.mark.parametrize("stem_wins", [True, False])
def test_auto_resolves_per_shape_as_the_jax_plan(nets, tmp_path, stem_wins):
    js, ts = _stores(_verdicts(nets, stem_wins), tmp_path)
    ts.save()
    rec = _resolve(nets, "auto", js, tt.KernelCrossoverStore.load(ts.path))
    assert rec["blocks"] == 5 and rec["stem"] == stem_wins
    assert set(nets[1]._fusion()[1]) == {
        "s3b0_out", "s3b1_out", "s3b2_out", "s3b3_out", "s5b0_out"}


@pytest.mark.parametrize("stem_wins", [True, False])
def test_fused_engages_the_stem_as_the_jax_plan(nets, tmp_path, stem_wins):
    rec = _resolve(nets, "fused", *_stores(_verdicts(nets, stem_wins),
                                           tmp_path))
    assert rec["blocks"] == 16 and rec["stem"] == stem_wins
    assert set(rec["keys"]) == {"stem_pool"}
    rec = _resolve(nets, "fused", *_stores({}, tmp_path))
    assert rec["blocks"] == 16 and not rec["stem"]
    _resolve(nets, "xla", *_stores({}, tmp_path))


# ---------------------------------------------------------------------
# the calibration harness
# ---------------------------------------------------------------------
def test_calibration_fills_every_distinct_shape(nets, tmp_path,
                                                monkeypatch):
    jnet, tnet = nets
    monkeypatch.setattr(tcross, "_time_thunk", lambda *a, **k: 1.0)
    monkeypatch.setattr(jcross, "_time_thunk", lambda *a, **k: 1.0)
    s = tt.KernelCrossoverStore(path=str(tmp_path / tt.CROSSOVER_NAME))
    out = tt.calibrate_training_kernels(tnet, batch_size=2, store=s,
                                        persist=True)
    jout = jt.calibrate_training_kernels(
        jnet, batch_size=2, store=jt.KernelCrossoverStore(
            path=str(tmp_path / "jax.json")))
    assert set(out) == set(jout) and len(out) == 9
    loaded = tt.KernelCrossoverStore.load(s.path)
    assert set(loaded.entries()) == set(out)
    assert all(e["platform"] == "cpu" and e["source"] == "calibrate"
               for e in loaded.entries().values())
    assert len(tt.calibrate_training_kernels(
        tnet, batch_size=2, store=s, include_stem=False)) == 8


def _close(got, want, what):
    got, want = got.detach(), want.detach()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * max(1.0, float(want.abs().max())), (what, err)


@pytest.mark.parametrize("stride,skip", [(1, False), (2, True), (1, True)])
def test_the_xla_plan_fallback_computes_reference_bottleneck(stride, skip):
    from deeplearning4j_tpu_torch.nn.layers.bottleneck import (
        BnParams, reference_bottleneck)
    from deeplearning4j_tpu_torch.tuning.calibrate import (
        oihw_weights, xla_plan_bottleneck)
    rng = np.random.default_rng(stride + 2 * skip)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).requires_grad_()

    def bn(c):
        return BnParams(*(torch.from_numpy(rng.normal(m, 0.2, c)
                                           .astype(np.float32))
                          for m in (1.0, 0.0)),
                        torch.zeros(c), torch.ones(c))

    cin, cmid, cout = (8, 4, 16) if skip else (16, 8, 16)
    x, wa = arr(2, 8, 8, cin), arr(cin, cmid, scale=0.3)
    wb, wc = arr(9, cmid, cmid, scale=0.2), arr(cmid, cout, scale=0.3)
    ws = arr(cin, cout, scale=0.3) if skip else None
    kw = dict(bn_a=bn(cmid), bn_b=bn(cmid), bn_c=bn(cout),
              bn_skip=bn(cout) if skip else None, stride=stride, train=True)
    ref, ref_stats = reference_bottleneck(x, wa, wb=wb, wc=wc, w_skip=ws,
                                          **kw)
    leaves = [t for t in (x, wa, wb, wc, ws) if t is not None]
    ref_grads = torch.autograd.grad(ref.sum(), leaves)
    xla = [t.detach().requires_grad_() if t is not None else None
           for t in (x, *oihw_weights(wa, wb, wc, ws))]
    got, stats = xla_plan_bottleneck(xla[0], xla[1], wb=xla[2], wc=xla[3],
                                     w_skip=xla[4], **kw)
    grads = torch.autograd.grad(got.sum(), [t for t in xla if t is not None])
    _close(got, ref, "out")
    assert len(stats) == len(ref_stats) == (8 if skip else 6)
    for a, b in zip(stats, ref_stats):
        _close(a, b, "running stats")
    _close(grads[0], ref_grads[0], "dx")
    ref_w = oihw_weights(*ref_grads[1:4], ref_grads[4] if skip else None)
    for a, b in zip(grads[1:], [w for w in ref_w if w is not None]):
        _close(a, b, "dW")


def test_the_xla_plan_fallback_computes_reference_stem():
    from deeplearning4j_tpu_torch.nn.layers.bottleneck import BnParams
    from deeplearning4j_tpu_torch.nn.layers.stem import reference_stem
    from deeplearning4j_tpu_torch.tuning.calibrate import xla_plan_stem
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3))
                         .astype(np.float32)).requires_grad_()
    w = torch.from_numpy((rng.standard_normal((8, 3, 7, 7)) * 0.2)
                         .astype(np.float32)).requires_grad_()
    bn = BnParams(torch.full((8,), 1.1), torch.full((8,), 0.1),
                  torch.zeros(8), torch.ones(8))
    ref, ref_stats = reference_stem(x, w, bn, train=True)
    ref_grads = torch.autograd.grad(ref.sum(), [x, w])
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    got, stats = xla_plan_stem(xl, wl, bn, train=True)
    grads = torch.autograd.grad(got.sum(), [xl, wl])
    for a, b in zip((got, *stats, *grads), (ref, *ref_stats, *ref_grads)):
        _close(a, b, "stem")


def test_calibration_runs_the_training_steps():
    net = ResNet50(num_classes=10, height=32, width=32,
                   data_format="NHWC").init(device=CPU)
    s = tt.KernelCrossoverStore(path="/nonexistent/none")
    out = tt.calibrate_training_kernels(net, batch_size=1, store=s,
                                        warmup=0, iters=1)
    assert len(out) == 9
    assert all(np.isfinite(e["kernel_ms"]) and e["kernel_ms"] > 0
               and e["fallback_ms"] > 0 for e in out.values())


def test_the_port_never_writes_the_jax_store(tmp_path, monkeypatch):
    jax_store = REPO / "KERNEL_CROSSOVER.json"
    before = jax_store.read_bytes() if jax_store.exists() else None
    monkeypatch.chdir(tmp_path)
    (tmp_path / tt.CROSSOVER_NAME).write_text("{}")
    assert tcross.default_path() == str(tmp_path / tt.CROSSOVER_NAME)
    tt.reset_default_store(None)
    monkeypatch.setattr(tcross, "_time_thunk", lambda *a, **k: 1.0)
    net = ResNet50(num_classes=10, height=32, width=32,
                   data_format="NHWC").init(device=CPU)
    tt.calibrate_training_kernels(net, batch_size=1, persist=True)
    assert len(json.loads((tmp_path / tt.CROSSOVER_NAME).read_text())
               ["entries"]) == 9
    assert not (tmp_path / "KERNEL_CROSSOVER.json").exists()
    after = jax_store.read_bytes() if jax_store.exists() else None
    assert after == before
    # and no code of the port names the JAX package's file
    for path in (REPO / "deeplearning4j_tpu_torch").rglob("*.py"):
        for text in _code_strings(ast.parse(path.read_text())):
            assert "KERNEL_CROSSOVER.json" not in text, path


def _code_strings(tree):
    """The string constants of a module but its docstrings."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]
