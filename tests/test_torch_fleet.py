"""The port's fleet optimizer and plan audit.

Model-free, against the reference on identical descriptors: ``safe_join``
and ``joined_prefix``, ``extract_bucket`` and ``coalescing_saving_us``,
the cost sentinel and selectivity-aware chain costs; ``PlanAudit``
reproducing the planner's predictions exactly, its measured-cost join,
drift flags, reconcile and rendering, each equal to the reference's audit
over the reference's forests.  With models (the smoke MLLM config, random
weights, on the CPU): a fleet optimization (held for validity: its costs
are measured times, as logical rule R1's) whose plans, served through
``MultiStreamRuntime.from_fleet`` and ``MultiQueryRuntime.from_fleet``,
equal each plan's solo run bit for bit; probed serving equal to unprobed,
its ``forward_device_ms`` probes feeding ``forward_gap``, the reconcile
pass and the audit's rows.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import fleet as jfleet  # noqa: E402
from repro.core.costs import CostCatalog as JaxCatalog  # noqa: E402
from repro.obs import Metrics as JaxMetrics  # noqa: E402
from repro.obs import PlanAudit as JaxAudit  # noqa: E402
from repro.queries import get_query as jax_get_query  # noqa: E402
from repro.scheduler import SharingTreePlanner as JaxPlanner  # noqa: E402
from repro.scheduler import sharing_tree as jtree  # noqa: E402
from repro.streaming import operators as jops  # noqa: E402
from repro.streaming.plan import Plan as JaxPlan  # noqa: E402

from repro_torch.configs.samsara_stream import \
    STREAM_MLLM_SMALL_CONFIG as CFG  # noqa: E402
from repro_torch.core import fleet  # noqa: E402
from repro_torch.core.costs import CostCatalog  # noqa: E402
from repro_torch.core.fleet import FleetOptimizer, FleetQuery  # noqa: E402
from repro_torch.data import TollBoothStream, VolleyballStream  # noqa: E402
from repro_torch.obs import (NULL_TRACER, Metrics,  # noqa: E402
                             Observability, PlanAudit, forward_gap,
                             write_flight_report)
from repro_torch.queries.catalog import get_query  # noqa: E402
from repro_torch.scheduler import (Feed, MultiStreamRuntime,  # noqa: E402
                                   SharingTreePlanner)
from repro_torch.scheduler import sharing_tree as tree  # noqa: E402
from repro_torch.semantic import GateConfig, SemanticGate  # noqa: E402
from repro_torch.streaming import operators as ops  # noqa: E402
from repro_torch.streaming.mllm import StreamMLLM  # noqa: E402
from repro_torch.streaming.multiquery import MultiQueryRuntime  # noqa: E402
from repro_torch.streaming.plan import Plan  # noqa: E402
from repro_torch.streaming.runtime import StreamRuntime  # noqa: E402

SIDES = {"torch": (ops, get_query, Plan, fleet, tree, SharingTreePlanner,
                   CostCatalog, PlanAudit, Metrics),
         "jax": (jops, jax_get_query, JaxPlan, jfleet, jtree, JaxPlanner,
                 JaxCatalog, JaxAudit, JaxMetrics)}


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU runs on one thread, beside JAX's runtime and the suite's
    other worker processes; the colour count is exact at any thread count
    (``tests/test_torch_fused_prefix.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn):
    """``fn(side modules)`` on the port and on the reference."""
    return fn(*SIDES["torch"]), fn(*SIDES["jax"])


def _desc(op):
    return None if op is None else op.signature()


# ---------------------------------------------------------------------------
# (a) safe-join canonicalization and the server-level cost terms
# ---------------------------------------------------------------------------

SAFE_JOIN_CASES = {
    "skip": lambda m: [m.SkipOp(amount=6, roi=(0, 0, 32, 64)),
                       m.SkipOp(amount=2, roi=(32, 32, 32, 64))],
    "skip_no_roi": lambda m: [m.SkipOp(amount=6), m.SkipOp(amount=2,
                                                           threshold=0.01)],
    "skip_conditions": lambda m: [m.SkipOp(condition="no_car"),
                                  m.SkipOp(condition="static")],
    "downscale": lambda m: [m.DownscaleOp(factor=4), m.DownscaleOp(factor=2)],
    "crop": lambda m: [m.CropOp(region=(0, 0, 64, 128)),
                       m.CropOp(region=(32, 64, 64, 128))],
    "fused": lambda m: [m.FusedPreprocessOp(crop=(0, 0, 64, 128), factor=4),
                        m.FusedPreprocessOp(crop=(64, 0, 64, 128),
                                            factor=2, grey=True)],
    "cheap_color": lambda m: [m.CheapColorFilterOp(color="red",
                                                   min_frac=0.02),
                              m.CheapColorFilterOp(color="red",
                                                   min_frac=0.01,
                                                   roi=(0, 0, 8, 8))],
    "cheap_color_differ": lambda m: [m.CheapColorFilterOp(color="red"),
                                     m.CheapColorFilterOp(color="blue")],
    "detect": lambda m: [m.DetectOp(threshold=0.7),
                         m.DetectOp(threshold=0.4)],
    "source": lambda m: [m.SourceOp("tollbooth"), m.SourceOp("tollbooth")],
    "source_differ": lambda m: [m.SourceOp("tollbooth"),
                                m.SourceOp("volleyball")],
    "mixed_classes": lambda m: [m.CropOp(), m.DownscaleOp()],
    "unknown_identical": lambda m: [m.GreyscaleOp(), m.GreyscaleOp()],
    "window_differ": lambda m: [m.WindowAggOp(kind="top_color"),
                                m.WindowAggOp(kind="top_brand")],
}


@pytest.mark.parametrize("case", list(SAFE_JOIN_CASES))
def test_safe_join_equals_reference(case):
    got, want = _both(lambda m, get, P, fl, *_: _desc(
        fl.safe_join(SAFE_JOIN_CASES[case](m))))
    assert got == want


def test_safe_join_takes_least_aggressive_params():
    j = fleet.safe_join([ops.SkipOp(amount=6, roi=(0, 0, 32, 64)),
                         ops.SkipOp(amount=2, roi=(32, 32, 32, 64))])
    assert j.amount == 2 and j.roi == (0, 0, 64, 96)
    j = fleet.safe_join([ops.FusedPreprocessOp(crop=(0, 0, 64, 128),
                                               factor=4),
                         ops.FusedPreprocessOp(crop=(64, 0, 64, 128),
                                               factor=2)])
    assert j.crop == (0, 0, 128, 128) and j.factor == 2 and not j.grey


JOIN_CHAINS = {
    "private_op_dropped": lambda m: (
        [m.SourceOp("tollbooth"), m.SkipOp(amount=4),
         m.CropOp(region=(0, 0, 64, 256)), m.CheapColorFilterOp("red")],
        [m.SourceOp("tollbooth"), m.SkipOp(amount=2),
         m.CropOp(region=(64, 0, 64, 256))]),
    "order_violation": lambda m: (
        [m.SourceOp("tollbooth"), m.CropOp(region=(0, 0, 64, 256)),
         m.DownscaleOp(factor=2)],
        [m.SourceOp("tollbooth"), m.DownscaleOp(factor=4),
         m.CropOp(region=(0, 0, 32, 128))]),
    "identical": lambda m: (
        [m.SourceOp("tollbooth"), m.SkipOp(amount=3),
         m.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2)],) * 2,
    "three_chains": lambda m: (
        [m.SourceOp("tollbooth"), m.SkipOp(amount=4), m.DownscaleOp(4)],
        [m.SourceOp("tollbooth"), m.SkipOp(amount=1), m.DownscaleOp(2)],
        [m.SourceOp("tollbooth"), m.DetectOp(0.3), m.DownscaleOp(2)]),
}


@pytest.mark.parametrize("case", list(JOIN_CHAINS))
def test_joined_prefix_equals_reference(case):
    got, want = _both(lambda m, get, P, fl, *_: [
        o.signature() for o in fl.joined_prefix(list(JOIN_CHAINS[case](m)))])
    assert got == want


def _bucket_chains(m):
    src = m.SourceOp(stream_name="tollbooth")
    ex = m.MLLMExtractOp(tasks=("present",), model="big")
    return [[src, ex],
            [src, m.CropOp(region=(64, 0, 64, 256)), m.DownscaleOp(2), ex],
            [src, m.FusedPreprocessOp(crop=(0, 0, 128, 256), factor=2), ex],
            [src, m.SkipOp(), m.GreyscaleOp(), ex],
            [src],
            [src, m.MLLMExtractOp(tasks=("present",), model="adaptive")],
            [src, m.MLLMExtractOp(tasks=("present",), model="small")]]


@pytest.mark.parametrize("shape", [(3, 128, 256), (3, 96, 192)])
def test_extract_bucket_equals_reference(shape):
    got, want = _both(lambda m, get, P, fl, tr, *_: [
        tr.extract_bucket(c, shape) for c in _bucket_chains(m)])
    assert got == want
    assert got[0] == ("big", shape) and got[4] is None and got[5] is None


def _forest_sets(m, get, P, planner_cls, cat):
    planner = planner_cls(catalog=cat)

    def forest(crop=None, model="big", stream="tollbooth"):
        chain = [m.SourceOp(stream_name=stream)]
        if crop is not None:
            chain.append(m.CropOp(region=crop))
        chain.append(m.MLLMExtractOp(tasks=("present",), model=model))
        return planner.plan([P(chain + [m.SinkOp()], query="q")])

    return {
        "aligned": [forest(), forest(stream="volleyball")],
        "three": [forest(), forest(stream="volleyball"),
                  forest(stream="volleyball")],
        "misaligned": [forest(), forest(crop=(64, 0, 64, 256))],
        "mixed_model": [forest(), forest(model="small")],
        "catalog": [planner.plan([get(q).naive_plan()
                                  for q in ("Q2", "Q6", "Q8")]),
                    planner.plan([get(q).naive_plan()
                                  for q in ("Q1", "Q5")]),
                    planner.plan([get("Q12").naive_plan()])],
    }


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("case", ["aligned", "three", "misaligned",
                                  "mixed_model", "catalog"])
def test_coalescing_saving_equals_reference(case, calibrated):
    def run(m, get, P, fl, tr, planner_cls, cat_cls, *_):
        cat = cat_cls()
        if calibrated:
            cat.record("mllm[big]", 900.0, overhead_us=120.0, direct=True)
            cat.record("CropOp", 4.0, pass_rate=1.0, direct=True)
        forests = _forest_sets(m, get, P, planner_cls, cat)[case]
        return [tr.coalescing_saving_us(forests, cat, micro_batch=mb)
                for mb in (1, 8, 16)]

    got, want = _both(run)
    assert got == pytest.approx(want, abs=1e-9, rel=0)
    if case == "aligned" and not calibrated:
        assert got[2] == pytest.approx(tree.EXTRACT_DISPATCH_US / 16)
    if case in ("misaligned", "mixed_model"):
        assert got == [0.0, 0.0, 0.0]


def test_zero_cost_is_a_measurement_not_a_fallback():
    op = ops.SkipOp()
    assert op.cost_us < 0 and tree.op_cost_us(op) == 30.0
    op.cost_us = 0.0
    assert tree.op_cost_us(op) == 0.0
    cat = CostCatalog()
    cat.record("SkipOp", 7.5, direct=True)
    cat.record("mllm[small]", 99.0, direct=True)
    assert tree.op_cost_us(ops.SkipOp(), cat) == 7.5
    assert tree.op_cost_us(ops.MLLMExtractOp(model="small"), cat) == 99.0
    assert tree.op_cost_us(ops.MLLMExtractOp(model="big"), cat) == 1200.0


def test_chain_cost_tail_seeded_by_prefix_reach():
    skip, mllm = ops.SkipOp(), ops.MLLMExtractOp()
    skip.cost_us, skip.pass_rate = 10.0, 0.1
    mllm.cost_us = 1000.0
    whole = tree.chain_cost_us([skip, mllm])
    split = tree.chain_cost_us([skip]) + tree.chain_cost_us(
        [mllm], reach=tree.chain_reach([skip]))
    assert split == pytest.approx(whole)
    assert tree.uncalibrated([skip, mllm]) == []
    fresh = ops.MLLMExtractOp()
    assert tree.uncalibrated([skip, fresh]) == [fresh.name]


# ---------------------------------------------------------------------------
# (b) PlanAudit against the reference (model-free)
# ---------------------------------------------------------------------------

AUDIT_SETS = [("Q2", "Q6", "Q8"), ("Q1",), ("Q1", "Q5", "Q12"),
              ("Q3", "Q7", "Q9", "Q13")]


def _audit(side, qids, catalog_kw=None, tolerance=0.5, gate=None):
    m, get, P, fl, tr, planner_cls, cat_cls, audit_cls, _ = SIDES[side]
    cat = cat_cls()
    for kw in catalog_kw or ():
        cat.record(**kw)
    planner = planner_cls(catalog=cat, micro_batch=16, gate_hit_rate=gate)
    forest = planner.plan([get(q).naive_plan() for q in qids])
    return audit_cls(forest, catalog=cat, micro_batch=16,
                     gate_hit_rate=planner.gate_hit_rate,
                     tolerance=tolerance), cat


CAL = [dict(key="mllm[big]", us=900.0, overhead_us=120.0, direct=True),
       dict(key="FilterOp", us=3.0, pass_rate=0.5, direct=True)]


@pytest.mark.parametrize("gate", [None, 0.3])
@pytest.mark.parametrize("qids", AUDIT_SETS, ids="+".join)
def test_audit_reproduces_planner_predictions_exactly(qids, gate):
    audit, _ = _audit("torch", qids, CAL, gate=gate)
    ref, _ = _audit("jax", qids, CAL, gate=gate)
    assert audit.verify_predictions() == pytest.approx(0.0, abs=1e-9)
    rows, want = audit.rows(), ref.rows()
    assert len(rows) == len(want)
    for r, w in zip(rows, want):
        assert r.keys() == w.keys()
        for k in r:
            assert r[k] == pytest.approx(w[k], abs=1e-9, rel=0), k
        assert r["predicted_saving_us"] == pytest.approx(
            r["predicted_indep_us"] - r["predicted_shared_us"])
    assert audit.table() == ref.table()


def test_audit_verify_detects_stale_predictions():
    audit, cat = _audit("torch", ("Q2", "Q6"))
    assert audit.verify_predictions() == pytest.approx(0.0, abs=1e-9)
    cat.record("mllm[big]", 50_000.0, direct=True)
    assert audit.verify_predictions() > 0.1


def _synthetic_metrics(metrics_cls):
    m = metrics_cls()
    for _ in range(4):
        m.observe("op_wall_us/SkipOp", 2000.0)
    m.inc("op_frames/SkipOp", 64)
    m.inc("op_rows_out/SkipOp", 32)
    m.observe("op_wall_us/FilterOp", 40.0)
    m.inc("op_frames/FilterOp", 16)
    m.observe("forward_device_ms/big", 64.0)
    m.inc("forward_device_frames/big", 32)
    m.observe("forward_ms", 10.0)
    m.observe("forward_device_ms", 8.0)
    return m


@pytest.mark.parametrize("qids", AUDIT_SETS[:3], ids="+".join)
def test_audit_measured_join_equals_reference(qids):
    audit, _ = _audit("torch", qids)
    ref, _ = _audit("jax", qids)
    m, jm = _synthetic_metrics(Metrics), _synthetic_metrics(JaxMetrics)
    measured = audit.measured_costs(m)
    assert measured == ref.measured_costs(jm)
    assert measured["SkipOp"]["us"] == pytest.approx(125.0)
    assert measured["SkipOp"]["pass_rate"] == pytest.approx(0.5)
    assert measured["mllm[big]"]["us"] == pytest.approx(2000.0)
    rows, want = audit.rows(m), ref.rows(jm)
    for r, w in zip(rows, want):
        assert r.keys() == w.keys()
        for k in r:
            assert r[k] == pytest.approx(w[k], abs=1e-9, rel=0), k
    assert any(r["flagged"] for r in rows)
    assert audit.table(m) == ref.table(jm)


def test_audit_reconcile_moves_catalog_like_reference():
    audit, _ = _audit("torch", ("Q2", "Q6", "Q8"))
    ref, _ = _audit("jax", ("Q2", "Q6", "Q8"))
    cat, jcat = CostCatalog(), JaxCatalog()
    for c in (cat, jcat):
        c.record("mllm[big]", 500.0, direct=True)
    flags = audit.reconcile(_synthetic_metrics(Metrics), cat)
    jflags = ref.reconcile(_synthetic_metrics(JaxMetrics), jcat)
    assert flags == jflags and "mllm[big]" in flags
    assert cat.to_dict() == jcat.to_dict()
    assert cat.entries["mllm[big]"].us == pytest.approx(1250.0)
    assert audit.reconcile(Metrics(), cat) == []


def test_audit_table_and_flight_report_render(tmp_path):
    audit, _ = _audit("torch", ("Q2", "Q6"))
    table = audit.table()
    assert "Q2+Q6" in table and "pred save" in table
    m = Metrics()
    m.observe("forward_ms", 10.0)
    m.observe("forward_device_ms", 8.0)
    path = write_flight_report(
        str(tmp_path / "flight_report.md"), audit=audit, metrics=m,
        flagged=["mllm[big]"], notes=["test run"])
    body = open(path).read()
    assert "# Serving flight report" in body
    assert "Optimizer audit" in body and "mllm[big]" in body
    assert "poll latency" in body
    gap = forward_gap(m)
    assert gap["gap_ms"] == pytest.approx(2.0)
    assert gap["gap_frac"] == pytest.approx(0.2)


def test_audit_fusion_rows_from_reports():
    from repro_torch.core.superopt import OptimizationReport

    report = OptimizationReport(
        query="Q8", naive_plan="", final_plan="", phases=[
            {"phase": "physical", "fused_prefix": {
                "fused": True, "segment": ["skip", "fused_preprocess"],
                "fused_us": 40.0, "unfused_us": 70.0,
                "fused_marginal_us": 2.0, "fused_overhead_us": 8.0,
                "batch": 16}}])
    audit, _ = _audit("torch", ("Q2",))
    audit.reports = {"Q8": report}
    m = Metrics()
    m.observe("op_wall_us/FusedPrefixOp", 800.0)
    m.inc("op_frames/FusedPrefixOp", 16)
    fuse = [r for r in audit.rows(m) if r["kind"] == "fuse"]
    assert len(fuse) == 1 and fuse[0]["decision"] == "skip+fused_preprocess"
    assert fuse[0]["predicted_saving_us"] == pytest.approx(30.0)
    assert fuse[0]["drift"] == pytest.approx(800.0 / 40.0)
    assert fuse[0]["flagged"]


# ---------------------------------------------------------------------------
# (c) with models: the fleet served, and probed serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx():
    m = StreamMLLM(CFG, patch=16, device="cpu").init(
        torch.Generator().manual_seed(0))
    return ops.OpContext(mllm=m, device="cpu")


def _tb(seed):
    return TollBoothStream(seed=seed)


@pytest.fixture(scope="module")
def fleet_result(ctx):
    torch.set_num_threads(1)
    fo = FleetOptimizer(ctx, val_frames=16, micro_batch=8)
    return fo, fo.optimize([FleetQuery(get_query(q), _tb, feed="tb")
                            for q in ("Q2", "Q6")], phases=("semantic",))


def test_fleet_plans_valid_and_calibrated(fleet_result):
    fo, res = fleet_result
    assert sorted(res.plans) == ["Q2", "Q6"]
    assert set(res.plans_by_feed) == {"tb"}
    for p in res.plans.values():
        assert tree.uncalibrated(p.ops) == []
        assert isinstance(p.ops[0], ops.SourceOp)
        assert isinstance(p.ops[-1], ops.SinkOp)
    assert res.fleet_cost_us["fleet"] < res.fleet_cost_us["naive"]
    assert res.fleet_cost_us["fleet"] <= \
        res.fleet_cost_us["solo"] * (1.0 + 5 * fo.rel_margin)
    assert res.decisions and "fleet cost" in res.describe()
    # later calibrations move the shared catalog, so the stored forest
    # costs are priced again, not reproduced (see the model-free tests)
    rows = res.audit().rows()
    assert len(rows) == sum(len(f.groups()) for f in res.forests.values())


def test_fleet_execution_equal_to_solo(ctx, fleet_result):
    _, res = fleet_result
    ms = MultiStreamRuntime.from_fleet(res, {"tb": _tb(555)}, ctx,
                                       micro_batch=8)
    out = ms.run(32)
    mq = MultiQueryRuntime.from_fleet(res, "tb", ctx, micro_batch=8).run(
        _tb(555), 32)
    for p in res.plans_by_feed["tb"]:
        solo = StreamRuntime(p.clone(), ctx, micro_batch=8).run(_tb(555), 32)
        for got in (out.feeds["tb"].per_query[p.query],
                    mq.per_query[p.query]):
            assert got.outputs == solo.outputs
            assert got.window_results == solo.window_results
            assert got.mllm_frames == solo.mllm_frames
    assert ms.planner.catalog is res.catalog
    assert "tb" in ms.describe()


def _probed_feeds():
    return [Feed("tb", _tb(7), [get_query(q).naive_plan()
                                for q in ("Q2", "Q6")]),
            Feed("vb", VolleyballStream(seed=5),
                 [get_query("Q12").naive_plan()])]


def test_probed_serving_bitwise_identical_with_device_timing(ctx):
    base = MultiStreamRuntime(
        _probed_feeds(), ctx, micro_batch=8,
        gate=SemanticGate(GateConfig(threshold=0.06), device="cpu")).run(32)
    cat = CostCatalog()
    obs = Observability(tracer=NULL_TRACER, slo_target_ms=10_000.0)
    ms = MultiStreamRuntime(
        _probed_feeds(), dataclasses.replace(ctx, obs=obs), micro_batch=8,
        planner=SharingTreePlanner(catalog=cat, micro_batch=8),
        gate=SemanticGate(GateConfig(threshold=0.06), device="cpu"))
    ms.server.device_probe_every = 1
    probed = ms.run(32)
    for feed in ("tb", "vb"):
        for q, r in base.feeds[feed].per_query.items():
            assert probed.feeds[feed].per_query[q].outputs == r.outputs
            assert probed.feeds[feed].per_query[q].window_results == \
                r.window_results
    dev = obs.metrics.histogram("forward_device_ms")
    assert dev.count == probed.server_stats["forwards"] > 0
    gap = forward_gap(obs.metrics)
    assert gap is not None and gap["gap_ms"] >= 0
    assert any(k.startswith("mllm[") for k in cat.entries), \
        sorted(cat.entries)
    rows = ms.audit().rows(obs.metrics)
    assert rows and all("drift" in r for r in rows)
    assert ms.drift_flags is not None
