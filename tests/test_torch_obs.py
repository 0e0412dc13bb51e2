"""The port's observability package and its hooks.

Model-free: the reference's own tests of the tracer ring, the log-binned
histogram, the registry, the SLO tracker and the disabled path's cost
(``tests/test_obs.py``, bounds kept), the cost catalog's reconcile and the
forward gap (``tests/test_audit.py``), and the registry's numbers against
the reference's on the same samples.  With models (bridged random
weights, on the CPU): an observed run equals the unobserved one bit for
bit and records the runtime's spans, SLO rows and gauges; the
super-optimizer records a span per phase.
"""
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.costs import CostCatalog  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    NULL_OBS,
    NULL_TRACER,
    PHASES,
    Histogram,
    Metrics,
    Observability,
    SLOTracker,
    Tracer,
    forward_gap,
    resolve_obs,
    write_flight_report,
)


@pytest.fixture(scope="module")
def ctx():
    from repro_torch.configs.samsara_stream import STREAM_MLLM_CONFIG
    from repro_torch.streaming.mllm import StreamMLLM
    from repro_torch.streaming.operators import OpContext

    m = StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device="cpu").init(
        torch.Generator().manual_seed(0))
    return OpContext(mllm=m, device="cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tracer: ring buffer, wraparound, export
# ---------------------------------------------------------------------------

def test_tracer_records_spans_instants_counters():
    tr = Tracer(capacity=16)
    t0 = tr.now()
    tr.span("prefix:skip", "prefix", t0, t0 + 1000, track="feed:a", n=16)
    tr.instant("gate:hit", "gate", track="feed:a", n=3)
    tr.counter("inflight", 2)
    evs = tr.events()
    assert [e["kind"] for e in evs] == ["X", "i", "C"]
    assert evs[0]["name"] == "prefix:skip" and evs[0]["n"] == 16
    assert evs[0]["t1_ns"] - evs[0]["t0_ns"] == 1000
    assert evs[2]["n"] == 2 and evs[2]["track"] == "counters"
    assert tr.recorded == 3 and tr.dropped == 0
    tr.reset()
    assert tr.events() == [] and tr.recorded == 0


def test_tracer_ring_wraparound_keeps_newest():
    tr = Tracer(capacity=8)
    for i in range(20):
        tr.span(f"s{i}", "prefix", i, i + 1)
    assert tr.recorded == 20 and tr.dropped == 12
    evs = tr.events()
    assert len(evs) == 8
    assert [e["name"] for e in evs] == [f"s{i}" for i in range(12, 20)]


def test_chrome_export_is_perfetto_loadable_json(tmp_path):
    tr = Tracer()
    t0 = tr.now()
    tr.span("forward[big]", "forward", t0, t0 + 5_000_000, track="device",
            n=32)
    tr.span("queue_wait", "queue", t0, t0 + 1_000_000, track="feed:a",
            n=16)
    tr.instant("gate:miss", "gate", track="feed:a", n=1)
    tr.counter("inflight", 1)
    path = tmp_path / "trace.json"
    assert tr.export_chrome(str(path)) == 4
    data = json.loads(path.read_text())
    evs = data["traceEvents"]
    names = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert {"device", "feed:a", "counters", "repro-serving"} <= names
    spans = [e for e in evs if e["ph"] == "X"]
    assert len(spans) == 2
    fwd = next(e for e in spans if e["name"] == "forward[big]")
    assert fwd["dur"] == pytest.approx(5000.0)
    assert fwd["args"]["n"] == 32
    assert all("ts" in e and "pid" in e and "tid" in e
               for e in evs if e["ph"] != "M")
    assert data["otherData"]["dropped_events"] == 0


# ---------------------------------------------------------------------------
# metrics and SLO
# ---------------------------------------------------------------------------

def test_histogram_percentiles_match_numpy_within_bin_width():
    rng = np.random.default_rng(7)
    vals = rng.lognormal(mean=2.0, sigma=1.0, size=20_000)
    h = Histogram()
    for v in vals:
        h.record(float(v))
    rel = h.growth - 1.0
    for p in (50, 90, 95, 99):
        ref = np.percentile(vals, p)
        assert h.percentile(p) == pytest.approx(ref, rel=3 * rel + 1e-3)
    assert h.mean() == pytest.approx(vals.mean(), rel=1e-6)
    assert h.percentile(0) >= h.vmin and h.percentile(100) <= h.vmax


def test_histogram_weighted_and_clamped():
    h = Histogram()
    h.record(10.0, n=99)
    h.record(1e9, n=1)
    assert h.count == 100
    assert h.percentile(50) == pytest.approx(10.0, rel=0.05)
    assert h.percentile(99.9) <= h.vmax
    h2 = Histogram()
    h2.record(1e-9)
    assert h2.percentile(50) == pytest.approx(1e-9)


def test_histogram_merge_equals_interleaved_recording():
    rng = np.random.default_rng(3)
    a, b = rng.lognormal(1.0, 1.5, 500), rng.lognormal(3.0, 0.5, 300)
    ha, hb, both = Histogram(), Histogram(), Histogram()
    for v in a:
        ha.record(float(v))
        both.record(float(v))
    for v in b:
        hb.record(float(v))
        both.record(float(v))
    ha.merge(hb)
    assert np.array_equal(ha.counts, both.counts)
    assert ha.count == both.count and ha.vmax == both.vmax


def test_registry_numbers_equal_the_reference():
    """The same samples through both packages' registries and SLO
    trackers give the same rows and the same table."""
    from repro.obs import Metrics as JaxMetrics
    from repro.obs import SLOTracker as JaxSLO

    rng = np.random.default_rng(11)
    samples = {"a": rng.lognormal(2.0, 0.7, 200),
               "b": rng.lognormal(3.5, 0.7, 100)}
    regs = []
    for metrics_cls, slo_cls in ((Metrics, SLOTracker),
                                 (JaxMetrics, JaxSLO)):
        m = metrics_cls()
        slo = slo_cls(m, target_ms=40.0)
        for feed, vals in samples.items():
            for v in vals:
                slo.record(feed, float(v), staleness_ms=2 * float(v), n=2)
        slo.record_degraded("b", 3)
        m.inc("server/forwards", 7)
        m.set_gauge("run/wall_s", 1.25)
        regs.append((m.to_rows(), slo.rows(), slo.combined(), slo.table()))
    assert regs[0] == regs[1]


def test_metrics_snapshot_restore_drops_later_metrics():
    m = Metrics()
    m.inc("requests", 5)
    m.set_gauge("wall_s", 1.5)
    m.observe("lat_ms/a", 3.0, 4)
    snap = m.snapshot()
    m.inc("requests", 100)
    m.observe("lat_ms/a", 50.0)
    m.inc("created_later")
    m.restore(snap)
    assert m.counter("requests").value == 5
    assert m.gauge("wall_s").value == 1.5
    assert m.histogram("lat_ms/a").count == 4
    assert "created_later" not in m._counters
    rows = {r["name"]: r for r in m.to_rows()}
    assert rows["lat_ms/a"]["p50"] == pytest.approx(3.0, rel=0.05)


def test_metrics_drop_prefix():
    m = Metrics()
    m.observe("queue_wait_ms/a", 1.0)
    m.observe("queue_wait_ms/b", 2.0)
    m.observe("forward_ms", 3.0)
    m.inc("forwards")
    m.drop("queue_wait_ms")
    m.drop("forward_ms")
    assert {r["name"] for r in m.to_rows()} == {"forwards"}


def test_metrics_ingest_is_idempotent():
    m = Metrics()
    stats = {"forwards": 3, "frames": np.int64(40), "mean_ms": 1.5,
             "name": "skipped"}
    m.ingest("server", stats)
    m.ingest("server", stats)
    assert m.counter("server/forwards").value == 3
    assert m.counter("server/frames").value == 40
    assert m.gauge("server/mean_ms").value == 1.5
    assert "server/name" not in {r["name"] for r in m.to_rows()}


def test_slo_tracker_rows_and_combined():
    m = Metrics()
    slo = SLOTracker(m, target_ms=100.0)
    slo.set_target("b", 10.0)
    for _ in range(90):
        slo.record("a", 50.0)
    for _ in range(10):
        slo.record("a", 400.0, staleness_ms=500.0)
    slo.record("b", 20.0, n=10)
    ra = slo.row("a")
    assert ra["frames"] == 100 and ra["violations"] == 10
    assert ra["attainment"] == pytest.approx(0.9)
    assert ra["p50_ms"] == pytest.approx(50.0, rel=0.05)
    assert ra["p99_ms"] == pytest.approx(400.0, rel=0.05)
    rb = slo.row("b")
    assert rb["violations"] == 10 and rb["attainment"] == 0.0
    c = slo.combined()
    assert c["frames"] == 110 and c["violations"] == 20
    assert "ALL" in slo.table() and "a" in slo.table()


def test_observability_resolution_and_null():
    assert resolve_obs(None, None) is NULL_OBS
    o = Observability(tracer=NULL_TRACER)
    assert resolve_obs(None, o) is o
    assert NULL_OBS.now() == 0 and not NULL_OBS.enabled
    assert o.now() > 0
    assert o.tracer.events() == []


# ---------------------------------------------------------------------------
# the no-overhead contract (the reference's bound, measured the same way)
# ---------------------------------------------------------------------------

def test_disabled_path_overhead_bounded_under_one_percent():
    reps = 100_000
    t0 = time.perf_counter_ns()
    for _ in range(reps):
        NULL_OBS.now()
        NULL_TRACER.span("x", "prefix", 0, 0)
    per_site_ns = (time.perf_counter_ns() - t0) / reps
    assert per_site_ns < 10_000
    # pessimistic profile: 40 instrumented sites per frame, serving at
    # 200 frames/s (5 ms a frame)
    overhead = (40 * per_site_ns) / 5e6
    assert overhead < 0.01


# ---------------------------------------------------------------------------
# reconcile and the forward gap (the reference's test_audit.py)
# ---------------------------------------------------------------------------

def test_reconcile_converges_miscalibrated_catalog():
    cat = CostCatalog()
    cat.record("mllm[big]", 50.0, direct=True, overhead_us=10.0)
    truth = {"mllm[big]": {"us": 400.0, "overhead_us": 80.0, "frames": 64}}
    assert cat.reconcile(truth) == ["mllm[big]"]
    for _ in range(11):
        cat.reconcile(truth)
    e = cat.entries["mllm[big]"]
    assert e.us == pytest.approx(400.0, rel=0.05)
    assert e.overhead_us == pytest.approx(80.0, rel=0.05)
    assert cat.reconcile(truth) == []


def test_reconcile_bypasses_direct_protection_and_creates_entries():
    cat = CostCatalog()
    cat.record("FilterOp", 10.0, direct=True)
    cat.record("FilterOp", 1000.0, direct=False)
    assert cat.entries["FilterOp"].us == 10.0
    cat.reconcile({"FilterOp": {"us": 30.0, "frames": 8}})
    assert cat.entries["FilterOp"].us == pytest.approx(20.0)
    flags = cat.reconcile({"DetectOp": {"us": 77.0, "frames": 4,
                                        "pass_rate": 0.5}})
    assert flags == []
    assert cat.entries["DetectOp"].us == 77.0
    assert cat.entries["DetectOp"].pass_rate == 0.5


def test_reconcile_ignores_garbage_measurements():
    cat = CostCatalog()
    cat.record("SkipOp", 30.0)
    cat.reconcile({"SkipOp": {"us": float("nan")}, "CropOp": {"us": -5.0}})
    assert cat.entries["SkipOp"].us == 30.0
    assert "CropOp" not in cat.entries


def test_reconcile_matches_reference():
    from repro.core.costs import CostCatalog as JaxCatalog

    seq = [{"mllm[big]": {"us": 400.0, "overhead_us": 80.0}},
           {"mllm[big]": {"us": 390.0}, "SkipOp": {"us": 12.0,
                                                  "pass_rate": 0.4}},
           {"SkipOp": {"us": 30.0, "pass_rate": 0.6}}]
    out = []
    for cls in (CostCatalog, JaxCatalog):
        cat = cls()
        cat.record("mllm[big]", 50.0, direct=True, overhead_us=10.0)
        flags = [cat.reconcile(m) for m in seq]
        out.append((flags, cat.to_dict()))
    assert out[0] == out[1]


def test_forward_gap_none_without_probes():
    m = Metrics()
    assert forward_gap(m) is None
    m.observe("forward_ms", 10.0)
    assert forward_gap(m) is None
    m.observe("forward_device_ms", 4.0)
    gap = forward_gap(m)
    assert gap["gap_ms"] == pytest.approx(6.0, rel=0.05)


def test_flight_report_renders_what_was_measured(tmp_path):
    m = Metrics()
    slo = SLOTracker(m, target_ms=50.0)
    slo.record("mq", 12.0, n=16)
    m.set_gauge("run/wall_s", 2.0)
    m.set_gauge("run/fps", 64.0)
    path = write_flight_report(str(tmp_path / "r" / "flight.md"),
                               slo=slo, metrics=m, flagged=["mllm[big]"],
                               notes=["port"])
    body = open(path).read()
    assert "## SLO attainment" in body and "mq" in body
    assert "## Headline" in body and "`mllm[big]`" in body
    assert "Optimizer audit" not in body


# ---------------------------------------------------------------------------
# hooks: observed == unobserved, spans recorded
# ---------------------------------------------------------------------------

def _q8_reduced():
    from repro_torch.queries.catalog import get_query
    from repro_torch.streaming import operators as ops
    from repro_torch.streaming.plan import Plan

    q = get_query("Q8")
    return Plan([ops.SourceOp("tollbooth"),
                 ops.SkipOp(amount=3, threshold=0.02, regions=(4, 8)),
                 ops.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2),
                 ops.CheapColorFilterOp("red", min_frac=0.008),
                 ops.MLLMExtractOp(q.tasks, "big"), ops.SinkOp()],
                query="Q8")


def test_observed_stream_run_is_bitwise_and_traced(ctx):
    from repro_torch.data import TollBoothStream
    from repro_torch.streaming.runtime import StreamRuntime

    base = StreamRuntime(_q8_reduced(), ctx, micro_batch=8).run(
        TollBoothStream(seed=3), 32)
    obs = Observability(slo_target_ms=10_000.0)
    octx = dataclasses.replace(ctx, obs=obs)
    traced = StreamRuntime(_q8_reduced(), octx, micro_batch=8).run(
        TollBoothStream(seed=3), 32)
    assert traced.outputs == base.outputs
    assert traced.op_input_counts == base.op_input_counts
    evs = obs.tracer.events()
    names = {e["name"] for e in evs}
    assert {f"op:{n}" for n in base.op_input_counts} <= names
    assert {e["cat"] for e in evs} == {"prefix"}
    assert {e["track"] for e in evs} == {"stream"}
    assert len(evs) == 4 * len(base.op_input_counts)   # 4 batches
    assert obs.slo.feeds() == ["stream"]
    assert obs.slo.row("stream")["frames"] == 32
    assert obs.metrics.gauge("run/wall_s").value > 0


def test_observed_multiquery_is_bitwise(ctx, tmp_path):
    from repro_torch.data import TollBoothStream
    from repro_torch.queries.catalog import get_query
    from repro_torch.streaming.multiquery import MultiQueryRuntime

    def plans():
        return [get_query(q).naive_plan() for q in ("Q2", "Q6", "Q8")]

    base = MultiQueryRuntime(plans(), ctx, micro_batch=8).run(
        TollBoothStream(seed=11), 24)
    obs = Observability(slo_target_ms=10_000.0)
    got = MultiQueryRuntime(plans(), dataclasses.replace(ctx, obs=obs),
                            micro_batch=8).run(TollBoothStream(seed=11), 24)
    for q, r in base.per_query.items():
        assert got.per_query[q].outputs == r.outputs
        assert got.per_query[q].window_results == r.window_results
    assert obs.slo.feeds() == ["mq"]
    assert obs.slo.row("mq")["frames"] == 24
    assert obs.metrics.gauge("run/wall_s").value == got.wall_s
    evs = obs.tracer.events()
    # 3 batches: the source and the merged extract, then the fan-out
    assert [e["name"] for e in evs[:3]] == [
        "op:source[tollbooth]", "op:mllm[big:present,color,plate]", "tail"]
    assert len(evs) == 9 and {e["track"] for e in evs} == {"feed:mq"}
    assert {e["cat"] for e in evs} == {"prefix", "tail"} <= set(PHASES)
    assert obs.tracer.export_chrome(str(tmp_path / "t.json")) == 9


def test_superoptimizer_records_phase_spans_and_gauges(ctx):
    from repro_torch.core.superopt import SuperOptimizer
    from repro_torch.data import TollBoothStream
    from repro_torch.queries.catalog import get_query

    obs = Observability()
    octx = dataclasses.replace(ctx, obs=obs)
    plan, report = SuperOptimizer(octx, val_frames=16).optimize(
        get_query("Q2"), lambda seed: TollBoothStream(seed=seed),
        phases=("semantic",))
    spans = [e for e in obs.tracer.events() if e["track"] == "superopt"]
    assert [e["name"] for e in spans] == ["opt:semantic", "opt:calibration"]
    assert {e["cat"] for e in spans} == {"optimize"}
    gauges = {r["name"]: r["value"] for r in obs.metrics.to_rows()
              if r["kind"] == "gauge"}
    for ph, w in report.phase_wall_s.items():
        assert gauges[f"superopt/Q2/{ph}_wall_s"] == w
    for row in report.op_timings:
        assert gauges[f"superopt/Q2/op_us/{row['op']}"] == row["us"]
    # the validation runs inside the phase are observed runs too
    assert obs.slo.row("stream")["frames"] > 0
    assert {e["cat"] for e in obs.tracer.events()} <= set(PHASES) | \
        {"optimize"}
