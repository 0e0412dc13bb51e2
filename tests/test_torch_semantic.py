"""The port's semantic gate.

Model-free: the reference's own tests of the signature, the cache, the
revalidation budget, the admission controller and gate snapshots
(``tests/test_semantic.py``), and the gate's decisions against the
reference's: both gates are fed the reference's own signatures of a real
stream, so their inputs are identical and their decisions, counters,
thresholds and assembled predictions must be too.  (Bucket keys quantize
the embedding, so whole gated runs are compared within the port only.)

With models (random weights, on the CPU): a gate at threshold 0 equals no
gate bit for bit; a gated run pays fewer forwards; snapshot / restore of a
gated run continues bit for bit; Q8's gated fused plan equals its gated
unfused twin, its signature consumed (no signature of the gate's own);
``FusedPrefixOp(sig=False)`` leaves the gate to compute its own.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.costs import CostCatalog  # noqa: E402
from repro_torch.semantic import (GateConfig, SemanticGate,  # noqa: E402
                                  TemporalSignature)

DETECTOR_SEED = 129


def _gate(**kw):
    return SemanticGate(GateConfig(**kw), device="cpu")


def _scene(value: float, shape=(3, 32, 64)) -> np.ndarray:
    """One deterministic already-normalized frame (max <= 8)."""
    f = np.full(shape, value, np.float32)
    f[:, ::4, ::4] = -value
    return f


def _frames(*values) -> np.ndarray:
    return np.stack([_scene(v) for v in values])


def _fake_preds(n: int, tag: int = 0):
    return {"present": np.full(n, tag, np.int32),
            "plate": np.full((n, 6), tag, np.int32)}


def _pump(gate, feed, frames, tag=0):
    adm = gate.admit(feed, "big", frames)
    adm.bind(_fake_preds(adm.n_model, tag) if adm.n_model else None)
    return adm, adm.assemble()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# model-free: signature, cache, budget, controller (the reference's tests)
# ---------------------------------------------------------------------------

def test_signature_distance_and_buckets():
    sig = TemporalSignature(device="cpu")
    a, b, c = _frames(0.5), _frames(0.5), _frames(-1.5)
    fa, ea = sig.features(a)
    fb, eb = sig.features(b)
    fc, ec = sig.features(c)
    assert TemporalSignature.distance(fa[0], ea[0], fb[0], eb[0]) == 0.0
    assert TemporalSignature.distance(fa[0], ea[0], fc[0], ec[0]) > 0.1
    fn, en = sig.features(a + 0.001)
    assert TemporalSignature.distance(fa[0], ea[0], fn[0], en[0]) < 0.01
    assert TemporalSignature.bucket(ea[0], 0.5) == \
        TemporalSignature.bucket(eb[0], 0.5)
    raw = ((a * 0.25 + 0.5) * 255.0).astype(np.float32)
    fr, er = sig.features(raw)
    assert TemporalSignature.distance(fa[0], ea[0], fr[0], er[0]) < 1e-4


def test_gate_hits_misses_and_revalidation_budget():
    gate = _gate(threshold=0.05, revalidate_every=4)
    frames = _frames(0.5, 0.5, 0.5, 0.5)
    adm, out = _pump(gate, "f", frames, tag=7)
    assert gate.counters["cache_misses"] == 1
    assert gate.counters["cache_hits"] == 3
    assert np.array_equal(out["present"], np.full(4, 7, np.int32))
    adm2, out2 = _pump(gate, "f", frames, tag=7)
    assert gate.counters["revalidations"] == 1
    assert gate.counters["cache_mismatches"] == 0
    assert np.array_equal(out2["present"], np.full(4, 7, np.int32))
    for entries in gate.cache._feeds.values():
        for e in entries.values():
            assert e.since_reval < gate.config.revalidate_every


def test_gate_mismatch_tightens_threshold_and_repairs_keyframe():
    gate = _gate(threshold=0.05, revalidate_every=2, accuracy_budget=0.05)
    frames = _frames(0.5, 0.5)
    _pump(gate, "f", frames, tag=1)
    adm, out = _pump(gate, "f", frames, tag=2)
    assert gate.counters["revalidations"] >= 1
    assert gate.counters["cache_mismatches"] >= 1
    thr = gate.controller.threshold("f")
    assert 0.0 < thr < gate.config.threshold
    adm3, out3 = _pump(gate, "f", frames, tag=2)
    assert out3["present"][0] == 2
    for _ in range(200):
        gate.controller.observe("f", False)
    assert gate.controller.threshold("f") == \
        pytest.approx(gate.config.threshold)


def test_gate_cache_is_bounded_lru():
    gate = _gate(threshold=0.05, max_entries=4)
    for i in range(10):
        _pump(gate, "f", _frames(-2.0 + i * 0.45), tag=i)
    assert len(gate.cache._feeds["f"]) <= 4
    assert gate.counters["cache_misses"] == 10


def test_gate_snapshot_restore_roundtrip_model_free():
    gate = _gate(threshold=0.05, revalidate_every=4)
    frames = _frames(0.5, 0.5, -1.5)
    _pump(gate, "f", frames, tag=3)
    gate.controller.observe("f", True)
    st = gate.snapshot()
    g2 = _gate(threshold=0.05, revalidate_every=4)
    g2.restore(st)
    assert g2.counters == gate.counters
    assert g2.controller.threshold("f") == gate.controller.threshold("f")
    a1, o1 = _pump(gate, "f", frames, tag=9)
    a2, o2 = _pump(g2, "f", frames, tag=9)
    assert a1.n_model == a2.n_model
    for k in o1:
        assert np.array_equal(o1[k], o2[k])


def test_gate_reset_scopes_to_feed():
    gate = _gate(threshold=0.05)
    _pump(gate, "a", _frames(0.5))
    _pump(gate, "b", _frames(0.5))
    gate.reset("a")
    assert "a" not in gate.cache._feeds and "b" in gate.cache._feeds
    gate.reset()
    assert not gate.cache._feeds


def test_gate_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        SemanticGate(GateConfig())


def test_cost_catalog_gate_hit_rates_roundtrip(tmp_path):
    cat = CostCatalog()
    assert cat.mean_gate_hit_rate() == 0.0
    cat.record_gate_hit_rate("tb0", 0.8)
    cat.record_gate_hit_rate("vb0", 0.2)
    cat.record_gate_hit_rate("tb0", 0.4)
    assert 0.4 < cat.gate_hit_rates["tb0"] < 0.8
    path = str(tmp_path / "cat.json")
    cat.save(path)
    back = CostCatalog.load(path)
    assert back.gate_hit_rates == cat.gate_hit_rates
    assert back.mean_gate_hit_rate() == pytest.approx(
        cat.mean_gate_hit_rate())


def test_cost_catalog_gate_hit_rates_match_reference():
    from repro.core.costs import CostCatalog as JaxCatalog

    out = []
    for cls in (CostCatalog, JaxCatalog):
        cat = cls()
        for feed, rate in (("tb0", 0.8), ("vb0", 0.2), ("tb0", 0.4),
                           ("tb0", 0.9)):
            cat.record_gate_hit_rate(feed, rate)
        out.append((cat.to_dict(), cat.mean_gate_hit_rate()))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the gate's decisions on the reference's own signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(threshold=0.06),
    dict(threshold=0.06, revalidate_every=4, mismatch_min_tasks=1),
    dict(threshold=0.12, revalidate_every=3, max_entries=8,
         accuracy_budget=0.2),
])
def test_gate_decisions_equal_reference_on_its_signatures(cfg):
    """TollBooth seed 11, 256 frames in batches of 16 (two feeds, the
    second on the normalized road crop); the reference's signature
    computes (feats, emb) once and both gates take them.  Predictions are
    the stream's own labels, so revalidations meet real changes."""
    from repro.data import TollBoothStream as JaxTollBooth
    from repro.semantic import GateConfig as JaxConfig
    from repro.semantic import SemanticGate as JaxGate

    frames, labels = JaxTollBooth(seed=11).batch(256)
    crop = ((frames[:, :, 64:128].astype(np.float32) / 255.0 - 0.5) / 0.25)
    tg, jg = _gate(**cfg), JaxGate(JaxConfig(**cfg))
    for feed, src in (("raw", frames), ("crop", crop)):
        for lo in range(0, 256, 16):
            batch = src[lo:lo + 16]
            sig = jg.signature.features(batch)
            sig = (np.asarray(sig[0]), np.asarray(sig[1]))
            rows = labels[lo:lo + 16]
            preds = {k: np.array([int(r[f]) for r in rows])
                     for k, f in (("present", "car_present"),
                                  ("color", "n_cars"),
                                  ("brand", "car_readable"))}
            outs = []
            for gate in (tg, jg):
                adm = gate.admit(feed, "big", batch,
                                 sig=(sig[0].copy(), sig[1].copy()))
                mr = np.asarray(adm.model_rows, np.int64)
                adm.bind({k: v[mr] for k, v in preds.items()}
                         if adm.n_model else None)
                outs.append(([p[0] for p in adm.plan], adm.model_rows,
                             len(adm.reval), adm.assemble()))
            (tp, tm, tr, ta), (jp, jm, jr, ja) = outs
            assert (tp, tm, tr) == (jp, jm, jr)
            assert ta.keys() == ja.keys()
            for k in ta:
                np.testing.assert_array_equal(ta[k], ja[k])
    assert tg.counters == jg.counters
    assert tg.feed_counters == jg.feed_counters
    assert tg.counters["cache_hits"] > 0 and tg.counters["revalidations"] > 0
    for feed in ("raw", "crop"):
        assert tg.controller.snapshot(feed) == jg.controller.snapshot(feed)
        assert tg.hit_rate(feed) == jg.hit_rate(feed)


def test_port_signature_near_reference():
    """The port's own signature of the same frames is within float32
    tolerance of the reference's (buckets may fall either side of an
    edge, which is why the decisions above take one signature)."""
    from repro.data import TollBoothStream as JaxTollBooth
    from repro.semantic import TemporalSignature as JaxSig

    frames, _ = JaxTollBooth(seed=11).batch(16)
    tf, te = TemporalSignature(device="cpu").features(frames)
    jf, je = JaxSig().features(frames)
    np.testing.assert_allclose(tf, np.asarray(jf), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(te, np.asarray(je), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# with models: the solo extract's gate path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx():
    from repro_torch.configs.samsara_stream import STREAM_MLLM_CONFIG
    from repro_torch.streaming.detector import TinyDet
    from repro_torch.streaming.mllm import StreamMLLM
    from repro_torch.streaming.operators import OpContext

    m = StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device="cpu").init(
        torch.Generator().manual_seed(0))
    det = TinyDet(device="cpu").init(
        torch.Generator().manual_seed(DETECTOR_SEED))
    return OpContext(mllm=m, detector=det, device="cpu")


def _run(plan, ctx, gate=None, n=32, seed=11, mb=16):
    from repro_torch.data import TollBoothStream
    from repro_torch.streaming.runtime import StreamRuntime

    gctx = dataclasses.replace(ctx, gate=gate)
    return StreamRuntime(plan, gctx, micro_batch=mb).run(
        TollBoothStream(seed=seed), n)


def _naive(qid="Q8"):
    from repro_torch.queries.catalog import get_query

    return get_query(qid).naive_plan()


def q8_prefix_plan(fused, sig=True):
    """Q8's fused plan (Skip, FusedPreprocess, CheapColor, Detect in one
    FusedPrefixOp) without its filter, or its unfused twin."""
    from repro_torch.queries.catalog import get_query
    from repro_torch.streaming import operators as ops
    from repro_torch.streaming.fused import FusedPrefixOp
    from repro_torch.streaming.plan import Plan

    chain = [ops.SkipOp(amount=3, threshold=0.02, regions=(4, 8)),
             ops.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2),
             ops.CheapColorFilterOp("red", min_frac=0.008),
             ops.DetectOp(threshold=0.5)]
    if fused:
        chain = [FusedPrefixOp(stage_ops=tuple(chain), sig=sig)]
    return Plan([ops.SourceOp("tollbooth")] + chain
                + [ops.MLLMExtractOp(get_query("Q8").tasks, "big"),
                   ops.SinkOp()], query="Q8")


class _CountingFeatures:
    """Counts the gate's own ``TemporalSignature.features`` calls."""

    def __init__(self, sig):
        self.calls = 0
        self._features = sig.features
        sig.features = self

    def __call__(self, frames):
        self.calls += 1
        return self._features(frames)


def test_disabled_gate_is_bitwise_identical(ctx):
    plain = _run(_naive("Q2"), ctx)
    gate = _gate(threshold=0.0)
    gated = _run(_naive("Q2"), ctx, gate)
    assert gated.outputs == plain.outputs
    assert gated.op_input_counts == plain.op_input_counts
    assert gate.counters["cache_misses"] == 0


def test_gated_run_skips_redundant_forwards(ctx):
    from repro_torch.queries.catalog import get_query

    gate = _gate(threshold=0.06, revalidate_every=8)
    plan = _naive("Q2")
    res = _run(plan, ctx, gate, n=64)
    assert gate.counters["cache_hits"] > 0
    assert gate.served() == 64 + 16           # + the warmup batch
    assert res.mllm_frames == 64
    extract = plan.ops[1]
    paid = gate.counters["cache_misses"] + gate.counters["revalidations"]
    assert paid < 64 + 16
    # one bucket-padded forward a batch at most; fully cached batches none
    assert extract.forwards <= 4
    assert 0.0 <= get_query("Q2").evaluate(res) <= 1.0


def test_gated_snapshot_restore_continues_exactly(ctx):
    from repro_torch.data import TollBoothStream
    from repro_torch.streaming.runtime import StreamRuntime

    def runtime():
        gate = _gate(threshold=0.06, revalidate_every=4)
        return StreamRuntime(_naive("Q8"), dataclasses.replace(ctx,
                                                               gate=gate),
                             micro_batch=16), gate

    rt, gate = runtime()
    s = TollBoothStream(seed=11)
    rt.run(s, 32, flush=False)
    snap = copy.deepcopy(rt.snapshot())
    assert snap["ops"][1]["gate"] is not None
    cont = rt.run(s, 32, warmup=0)
    rt2, gate2 = runtime()
    rt2.restore(snap)
    s2 = TollBoothStream(seed=11)
    s2.batch(32)
    resumed = rt2.run(s2, 32)
    assert resumed.outputs == cont.outputs
    assert resumed.window_results == cont.window_results
    assert resumed.op_input_counts == cont.op_input_counts
    assert rt2.plan.ops[1].forwards == rt.plan.ops[1].forwards


def test_fused_gated_equals_unfused_and_consumes_its_signature(ctx):
    cfg = dict(threshold=0.06)
    runs = {}
    for fused in (True, False):
        gate = _gate(**cfg)
        own = _CountingFeatures(gate.signature)
        runs[fused] = (_run(q8_prefix_plan(fused), ctx, gate, seed=3),
                       dict(gate.counters), own.calls)
    (f, fc, fcalls), (u, uc, ucalls) = runs[True], runs[False]
    assert f.outputs == u.outputs
    assert f.mllm_frames == u.mllm_frames > 0
    assert fc == uc and fc["cache_misses"] > 0
    assert fcalls == 0 and ucalls > 0
    # no signature leaks past the extract
    assert all("_sig" not in r for r in f.outputs)


def test_fused_without_signature_leaves_it_to_the_gate(ctx):
    gate_sig, gate_nosig = _gate(threshold=0.06), _gate(threshold=0.06)
    calls = _CountingFeatures(gate_nosig.signature)
    a = _run(q8_prefix_plan(True), ctx, gate_sig, seed=3)
    b = _run(q8_prefix_plan(True, sig=False), ctx, gate_nosig, seed=3)
    assert calls.calls > 0
    assert a.outputs == b.outputs
    assert gate_sig.counters == gate_nosig.counters


def test_fused_sig_false_skips_the_signature_stage(ctx):
    from repro_torch.data import TollBoothStream
    from repro_torch.streaming.operators import OpContext

    frames, _ = TollBoothStream(seed=3).batch(8)
    out = {}
    for sig in (True, False):
        op = q8_prefix_plan(True, sig=sig).ops[1]
        op.open(dataclasses.replace(ctx) if sig else
                OpContext(detector=ctx.detector, device="cpu"))
        out[sig] = op.process({"frames": frames, "idx": np.arange(8)})
    assert "_sig" in out[True] and "_sig" not in out[False]
    np.testing.assert_array_equal(out[True]["idx"], out[False]["idx"])
    assert np.array_equal(out[True]["frames"], out[False]["frames"])
