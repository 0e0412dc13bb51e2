"""The port's fault-injection package and its stream guard.

Model-free: the reference's own schedule, injector, transport, breaker and
retry tests (``tests/test_faults.py``), and the port's schedules against
the reference's for the same seed and rules, event for event.  With the
stream runtime on the CPU: ``NULL_FAULTS`` is inert, corrupt deliveries
that ``guard_stream`` absorbs leave every record bitwise unchanged, and a
dead link raises ``SourceFaultError``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.faults import (  # noqa: E402
    CLOSED,
    HALF_OPEN,
    NULL_FAULTS,
    OPEN,
    CircuitBreaker,
    FaultInjector,
    FaultRule,
    RetryPolicy,
    SourceFaultError,
    guard_stream,
    resolve_faults,
)


# ---------------------------------------------------------------------------
# schedule / injector unit tests (model-free)
# ---------------------------------------------------------------------------

def test_fault_rule_schedule_arithmetic():
    r = FaultRule(site="forward", kind="error", feed="a",
                  start=2, every=3, count=2)
    hits = [e for e in range(20) if r.matches("forward", "a", "big", e)]
    assert hits == [2, 5]
    assert not r.matches("forward", "b", "big", 2)
    assert not r.matches("source", "a", "", 2)
    rv = FaultRule(site="forward", kind="error", variant="small")
    assert rv.matches("forward", "x", "small", 0)
    assert not rv.matches("forward", "x", "big", 0)
    with pytest.raises(AssertionError):
        FaultRule(site="source", kind="error")


def test_injector_pure_and_deterministic():
    rules = [FaultRule(site="forward", kind="error", p=0.5, param=2)]
    a, b = FaultInjector(rules, seed=9), FaultInjector(rules, seed=9)
    pattern = [a.fault_at("forward", "f", "big", e) for e in range(32)]
    assert pattern == [b.fault_at("forward", "f", "big", e)
                       for e in reversed(range(32))][::-1]
    assert any(p is not None for p in pattern)
    assert any(p is None for p in pattern)
    c = FaultInjector(rules, seed=10)
    assert pattern != [c.fault_at("forward", "f", "big", e)
                       for e in range(32)]
    assert a.peek_event("source", "f") == 0
    assert a.next_event("source", "f") == 0
    assert a.next_event("source", "f") == 1
    assert a.next_event("source", "g") == 0
    assert a.peek_event("source", "f") == 2
    a.fire("forward", "f", "big",
           next(e for e, p in enumerate(pattern) if p is not None))
    assert len(a.log) == 1 and a.log[0]["site"] == "forward"


def test_attempt_clearing_models_transient_faults():
    inj = FaultInjector([FaultRule(site="forward", kind="error",
                                   param=2)], seed=0)
    assert inj.fault_at("forward", "f", "big", 0, attempt=0) is not None
    assert inj.fault_at("forward", "f", "big", 0, attempt=1) is not None
    assert inj.fault_at("forward", "f", "big", 0, attempt=2) is None


def test_transport_corruption_detectable_and_reversible():
    inj = FaultInjector([FaultRule(site="source", kind="corrupt",
                                   param=1)], seed=0)
    frames = np.arange(2 * 3 * 4 * 4, dtype=np.uint8).reshape(2, 3, 4, 4)
    pristine = frames.copy()
    bad = inj.transport("f", frames, event=0, attempt=0)
    assert not inj.delivered_ok(bad)
    assert np.array_equal(frames, pristine)
    ok = inj.transport("f", frames, event=0, attempt=1)
    assert inj.delivered_ok(ok)
    assert ok is frames
    ff = np.ones((1, 3, 4, 4), np.float32)
    assert not inj.delivered_ok(inj.transport("f", ff, event=0))


def test_null_faults_inert_and_resolution_order():
    assert not NULL_FAULTS.enabled
    assert NULL_FAULTS.fault_at("forward", "f", "big", 0) is None
    assert NULL_FAULTS.next_event("source", "f") == 0
    assert NULL_FAULTS.next_event("source", "f") == 0
    inj = FaultInjector(seed=1)
    assert resolve_faults(None, inj) is inj
    assert resolve_faults(inj, FaultInjector(seed=2)) is inj
    assert resolve_faults(None, None) is NULL_FAULTS


def test_retry_policy_backoff_is_exponential():
    rp = RetryPolicy(max_attempts=4, backoff_base=2)
    assert [rp.backoff_rounds(a) for a in (1, 2, 3)] == [2, 4, 8]


def test_circuit_breaker_lifecycle():
    br = CircuitBreaker(cooldown=2, max_cooldown=8)
    assert br.closed and br.state == CLOSED
    br.trip("ingest dead")
    br.trip("ingest dead")
    assert br.state == OPEN and br.counters["trips"] == 1
    assert br.last_reason == "ingest dead"
    br.tick()
    assert br.state == OPEN
    br.tick()
    assert br.state == HALF_OPEN and br.should_probe
    br.probe_failed()
    assert br.state == OPEN and br.cooldown == 4
    br.probe_failed()
    br.probe_failed()
    assert br.cooldown == 8
    for _ in range(br.cooldown):
        br.tick()
    assert br.state == HALF_OPEN
    br.close()
    assert br.closed and br.cooldown == 2
    assert br.counters["recoveries"] == 1


# ---------------------------------------------------------------------------
# the schedules against the reference's
# ---------------------------------------------------------------------------

RULE_SETS = [
    [FaultRule(site="forward", kind="error", p=0.5, param=2)],
    [FaultRule(site="forward", kind="error", feed="tb0", start=1, every=3,
               count=2, param=1),
     FaultRule(site="forward", kind="latency", start=0, every=4, count=3,
               param=2),
     FaultRule(site="source", kind="stall", feed="vb0", start=1, every=2,
               count=3),
     FaultRule(site="source", kind="corrupt", feed="vb0", start=4, every=3,
               count=2, param=1)],
    [FaultRule(site="source", kind="corrupt", p=0.3, param=3),
     FaultRule(site="forward", kind="error", variant="small", p=0.7,
               param=99)],
]


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("rules", range(len(RULE_SETS)))
def test_schedule_equals_reference(seed, rules):
    """For the same seed and rules the port's injector fires the
    reference's faults at every (site, feed, variant, event, attempt),
    logs them alike and corrupts the same elements."""
    from repro.faults import FaultInjector as JaxInjector
    from repro.faults import FaultRule as JaxRule

    trules = RULE_SETS[rules]
    jrules = [JaxRule(**dataclasses.asdict(r)) for r in trules]
    ti, ji = FaultInjector(trules, seed=seed), JaxInjector(jrules, seed=seed)
    frames = np.random.RandomState(seed).randint(
        0, 256, (2, 3, 8, 8)).astype(np.uint8)
    for site, variant in (("source", ""), ("forward", "big"),
                          ("forward", "small")):
        for feed in ("tb0", "vb0", "x"):
            for event in range(40):
                for attempt in range(4):
                    assert ti.fire(site, feed, variant, event, attempt) == \
                        ji.fire(site, feed, variant, event, attempt)
    assert ti.log == ji.log
    for event in range(12):
        for attempt in range(3):
            a = ti.transport("vb0", frames, event, attempt)
            b = ji.transport("vb0", frames, event, attempt)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            assert ti.delivered_ok(a) == ji.delivered_ok(b)
    for _ in range(5):
        assert ti.next_event("source", "tb0") == \
            ji.next_event("source", "tb0")


# ---------------------------------------------------------------------------
# guard_stream through the StreamRuntime
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ctx():
    """The stream models on the CPU, on one thread: run after JAX's CPU
    runtime has started in the same process, PyTorch's thread pool
    slowed these small runs 40x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    from repro_torch.configs.samsara_stream import STREAM_MLLM_CONFIG
    from repro_torch.streaming.mllm import StreamMLLM
    from repro_torch.streaming.operators import OpContext

    m = StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device="cpu").init(
        torch.Generator().manual_seed(0))
    yield OpContext(mllm=m, device="cpu")
    torch.set_num_threads(n)


def _plan():
    from repro_torch.queries.catalog import get_query
    from repro_torch.streaming import operators as ops
    from repro_torch.streaming.plan import Plan

    q = get_query("Q8")
    return Plan([ops.SourceOp("tollbooth"),
                 ops.SkipOp(amount=3, threshold=0.02, regions=(4, 8)),
                 ops.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2),
                 ops.MLLMExtractOp(q.tasks, "big"), ops.SinkOp()],
                query="Q8")


def _run(ctx, faults=None, n=32):
    from repro_torch.data import TollBoothStream
    from repro_torch.streaming.runtime import StreamRuntime

    fctx = dataclasses.replace(ctx, faults=faults)
    return StreamRuntime(_plan(), fctx, micro_batch=8).run(
        TollBoothStream(seed=3), n)


def test_guard_stream_is_the_bare_stream_without_faults():
    s = object()
    assert guard_stream(s, None) is s
    assert guard_stream(s, NULL_FAULTS) is s
    assert guard_stream(s, FaultInjector(seed=0)) is not s


def test_absorbed_corrupt_deliveries_keep_records_bitwise(ctx):
    base = _run(ctx)
    assert len(base.outputs) > 0
    assert _run(ctx, NULL_FAULTS).outputs == base.outputs
    inj = FaultInjector(seed=3, rules=[
        FaultRule(site="source", kind="corrupt", start=0, every=2,
                  param=2)])
    got = _run(ctx, inj)
    assert got.outputs == base.outputs
    assert got.op_input_counts == base.op_input_counts
    assert got.labels == base.labels
    # events 0 and 2 (of 4 pulls), two failed attempts each
    assert [(e["event"], e["attempt"]) for e in inj.log] == \
        [(0, 0), (0, 1), (2, 0), (2, 1)]


def test_dead_link_raises_source_fault(ctx):
    inj = FaultInjector(seed=0, rules=[
        FaultRule(site="source", kind="corrupt", start=1, param=99)])
    with pytest.raises(SourceFaultError, match="source event 1"):
        _run(ctx, inj)
