"""The port's serving tier: sharing-tree planner, shared extract server,
multi-stream runtime, the server path of ``MultiQueryRuntime``, faults and
the gate inside the server.

Model-free: the planner's groups, share keys, decisions and costs equal
the reference's (``tests/test_scheduler.py``'s cases); the server's
backpressure counters and watchdog.  With models (the smoke MLLM config,
random weights drawn by the reference and bridged into the port, on the
CPU): coalesced rows equal the op's solo rows; the dispatch/poll protocol,
staging reuse, partial-bucket deferral and shape buckets; the reference's
example workload (four feeds) served by the port equals the reference's
``MultiStreamRuntime`` and the port's own independent runs, pipelined
equals lock-step, and lock-step server statistics equal the reference's;
fault partitions equal the reference's under the same injector schedule;
the gate's counters in the server equal the reference server's on the
reference's signatures.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.samsara_stream import \
    STREAM_MLLM_SMALL_CONFIG as JAX_CFG  # noqa: E402
from repro.data import TollBoothStream as JaxTollBooth  # noqa: E402
from repro.data import VolleyballStream as JaxVolleyball  # noqa: E402
from repro.queries import get_query as jax_get_query  # noqa: E402
from repro.scheduler import Feed as JaxFeed  # noqa: E402
from repro.scheduler import MultiStreamRuntime as JaxMultiStream  # noqa: E402
from repro.scheduler import SharedExtractServer as JaxServer  # noqa: E402
from repro.scheduler import SharingTreePlanner as JaxPlanner  # noqa: E402
from repro.streaming import operators as jops  # noqa: E402
from repro.streaming.mllm import StreamMLLM as JaxMLLM  # noqa: E402
from repro.streaming.multiquery import \
    MultiQueryRuntime as JaxMultiQuery  # noqa: E402
from repro.streaming.plan import Plan as JaxPlan  # noqa: E402

from repro_torch.bridge import load_reference_params  # noqa: E402
from repro_torch.configs.samsara_stream import \
    STREAM_MLLM_SMALL_CONFIG as CFG  # noqa: E402
from repro_torch.core.costs import CostCatalog  # noqa: E402
from repro_torch.core.multiquery import share_key  # noqa: E402
from repro_torch.data import TollBoothStream, VolleyballStream  # noqa: E402
from repro_torch.faults import (ExtractFaultError,  # noqa: E402
                                ExtractStallError, FaultInjector,
                                FaultRule, RetryPolicy)
from repro_torch.queries.catalog import QUERIES, get_query  # noqa: E402
from repro_torch.scheduler import (Feed, MultiStreamRuntime,  # noqa: E402
                                   SharedExtractServer, SharingTreePlanner)
from repro_torch.scheduler.sharing_tree import chain_cost_us  # noqa: E402
from repro_torch.semantic import GateConfig, SemanticGate  # noqa: E402
from repro_torch.streaming import operators as ops  # noqa: E402
from repro_torch.streaming.mllm import StreamMLLM  # noqa: E402
from repro_torch.streaming.multiquery import MultiQueryRuntime  # noqa: E402
from repro_torch.streaming.operators import (MLLMExtractOp,  # noqa: E402
                                             OpContext, SinkOp, SkipOp,
                                             SourceOp)
from repro_torch.streaming.plan import Plan  # noqa: E402
from repro_torch.streaming.runtime import StreamRuntime  # noqa: E402

#: the reference's example workload (examples/multistream_serve.py)
FEEDS = (("tb-north", "tollbooth", 1234, ("Q2", "Q6", "Q8")),
         ("tb-south", "tollbooth", 4321, ("Q1", "Q5")),
         ("tb-east", "tollbooth", 2025, ("Q3", "Q9")),
         ("court-1", "volleyball", 1234, ("Q12", "Q13")))
FEED_QUERIES = [(name, q) for name, _, _, qids in FEEDS for q in qids]
N, MB = 48, 16
TASKS = ("present", "color", "plate")


@pytest.fixture(scope="module")
def contexts():
    """The smoke MLLM as the big variant: drawn by the reference, bridged
    into the port.  Key 12's present head fires on part of the TollBooth
    frames (key 0's on none), so filtered records are compared too."""
    jm = JaxMLLM(JAX_CFG, patch=16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(12))
    tm = StreamMLLM(CFG, patch=16, device="cpu")
    load_reference_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return (jops.OpContext(mllm=jm, mllm_params=params),
            OpContext(mllm=tm, device="cpu"))


@pytest.fixture(scope="module")
def ctx(contexts):
    return contexts[1]


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU runs on one thread, beside JAX's runtime and the suite's
    other worker processes; the colour count is exact at any thread count
    (``tests/test_torch_fused_prefix.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(ds, seed, jax_side=False):
    if jax_side:
        return JaxTollBooth(seed=seed) if ds == "tollbooth" \
            else JaxVolleyball(seed=seed)
    return TollBoothStream(seed=seed) if ds == "tollbooth" \
        else VolleyballStream(seed=seed)


def _skip_plan(qid, m=ops, get=get_query, plan_cls=Plan, amount=3):
    """A catalog plan with a Skip in front: a divergent signature prefix."""
    q = get(qid)
    chain = [m.SourceOp(stream_name=q.dataset), m.SkipOp(amount=amount),
             m.MLLMExtractOp(tasks=q.tasks, model="big")]
    return plan_cls(chain + q.tail() + [m.SinkOp()], query=f"{qid}s")


def _ms_feeds(jax_side=False):
    feed_cls = JaxFeed if jax_side else Feed
    get = jax_get_query if jax_side else get_query
    return [feed_cls(name, _stream(ds, seed, jax_side),
                     [get(q).naive_plan() for q in qids])
            for name, ds, seed, qids in FEEDS]


def _same(a, b):
    assert a.outputs == b.outputs
    assert a.window_results == b.window_results
    assert a.mllm_frames == b.mllm_frames
    assert a.labels == b.labels


# ---------------------------------------------------------------------------
# (a) the sharing-tree planner against the reference (model-free)
# ---------------------------------------------------------------------------

def _plan_sets(side):
    m, get, plan_cls = (jops, jax_get_query, JaxPlan) if side == "jax" \
        else (ops, get_query, Plan)

    def naive(*qids):
        return [get(q).naive_plan() for q in qids]

    def mixed_models():
        p_big, p_small = naive("Q2", "Q6")
        p_small.ops[1] = m.MLLMExtractOp(tasks=("present", "color"),
                                         model="small")
        return [p_big, p_small]

    return {
        "empty_global_prefix": (naive("Q2", "Q6", "Q12", "Q13"), {}),
        "divergent_prefixes": (naive("Q2", "Q6") + [
            _skip_plan("Q5", m, get, plan_cls),
            _skip_plan("Q9", m, get, plan_cls)], {}),
        "refuse_to_share": (naive("Q2", "Q6"), {"min_saving_us": 1e9}),
        "mixed_models": (mixed_models(), {}),
        "example_workload": (naive(*[q for _, q in FEED_QUERIES]), {}),
        "whole_catalog": (naive(*sorted(QUERIES)), {"micro_batch": 8}),
    }


def _forest_view(forest):
    return {stream: [(g.execution.queries,
                      [op.signature() for op in g.execution.prefix],
                      [[op.signature() for op in t]
                       for t in g.execution.tails],
                      g.is_shared, g.shared_cost_us, g.indep_cost_us)
                     for g in groups]
            for stream, groups in forest.streams.items()}


@pytest.mark.parametrize("case", list(_plan_sets("torch")))
def test_planner_equals_reference(case):
    plans, kw = _plan_sets("torch")[case]
    jplans, _ = _plan_sets("jax")[case]
    got = SharingTreePlanner(**kw).plan(plans)
    want = JaxPlanner(**kw).plan(jplans)
    assert got.notes == want.notes
    assert got.describe() == want.describe()
    gv, wv = _forest_view(got), _forest_view(want)
    assert gv.keys() == wv.keys()
    for stream in gv:
        assert len(gv[stream]) == len(wv[stream])
        for g, w in zip(gv[stream], wv[stream]):
            assert g[:4] == w[:4]
            assert g[4] == pytest.approx(w[4], abs=1e-9, rel=0)
            assert g[5] == pytest.approx(w[5], abs=1e-9, rel=0)


def test_share_key_groups_by_prefix_and_merge_identity():
    assert share_key(get_query("Q2").naive_plan()) == \
        share_key(get_query("Q8").naive_plan())
    assert share_key(get_query("Q2").naive_plan()) != \
        share_key(_skip_plan("Q2"))
    assert share_key(get_query("Q2").naive_plan()) != \
        share_key(get_query("Q12").naive_plan())


def test_planner_splits_divergent_prefixes_within_one_stream():
    plans = [get_query("Q2").naive_plan(), get_query("Q6").naive_plan(),
             _skip_plan("Q5"), _skip_plan("Q9")]
    forest = SharingTreePlanner().plan(plans)
    groups = forest.streams["tollbooth"]
    assert sorted(g.execution.queries for g in groups) == \
        [["Q2", "Q6"], ["Q5s", "Q9s"]]
    skip_group = next(g for g in groups if g.execution.queries[0] == "Q5s")
    assert any(isinstance(op, SkipOp) for op in skip_group.execution.prefix)
    assert forest.describe().count("shared") == 2


@pytest.mark.parametrize("gate_hit_rate", [0.0, 0.4])
def test_chain_cost_equals_reference_on_a_catalog(gate_hit_rate):
    from repro.core.costs import CostCatalog as JaxCatalog
    from repro.scheduler.sharing_tree import chain_cost_us as jax_chain_cost

    cats = (CostCatalog(), JaxCatalog())
    for cat in cats:
        cat.record("SkipOp", 7.5, pass_rate=0.25, direct=True)
        cat.record("mllm[big]", 900.0, overhead_us=120.0, direct=True)
        cat.record("FilterOp", 3.0, pass_rate=0.5, direct=True)
    for qid in ("Q2", "Q6", "Q8", "Q12"):
        got_ops = _skip_plan(qid).ops
        want_ops = _skip_plan(qid, jops, jax_get_query, JaxPlan).ops
        got_ops[0].cost_us = want_ops[0].cost_us = 0.0
        for mb in (1, 16):
            got = chain_cost_us(got_ops, cats[0], micro_batch=mb,
                                reach=0.5, gate_hit_rate=gate_hit_rate)
            want = jax_chain_cost(want_ops, cats[1], micro_batch=mb,
                                  reach=0.5, gate_hit_rate=gate_hit_rate)
            assert got == pytest.approx(want, abs=1e-9, rel=0)


# ---------------------------------------------------------------------------
# (b) the shared extract server
# ---------------------------------------------------------------------------

def test_server_backpressure_accounting_model_free():
    srv = SharedExtractServer(OpContext(device="cpu"), max_batch=32)
    f = np.zeros((5, 3, 8, 8), np.float32)
    srv.submit("big", f, feed="a")
    srv.submit("big", f, feed="a")
    srv.submit("small", f, feed="b")
    assert srv.pending_requests() == 3
    assert srv.pending_requests("a") == 2
    assert srv.pending_frames() == 15 and srv.pending_frames("b") == 5
    assert srv.stats["queue_depth"] == 3 and srv.stats["inflight"] == 0
    with pytest.raises(AssertionError):
        srv.submit("adaptive", f)
    with pytest.raises(AssertionError):
        srv.submit("big", np.zeros((0, 3, 8, 8), np.float32))


def test_runtime_defaults_to_cuda(monkeypatch):
    """``MultiStreamRuntime`` without a context resolves ``device=None`` to
    CUDA, which raises where CUDA is absent (never a silent CPU run)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        MultiStreamRuntime([Feed("a", TollBoothStream(seed=1),
                                 [get_query("Q2").naive_plan()])])


def _solo(ctx, frames):
    op = MLLMExtractOp(tasks=TASKS, model="big")
    op.open(ctx)
    return op.process({"frames": frames, "idx": np.arange(len(frames))})


def test_server_coalesces_and_matches_solo_path(ctx):
    srv = SharedExtractServer(ctx, max_batch=64)
    f1 = TollBoothStream(seed=3).batch(5)[0].astype(np.float32)
    f2 = TollBoothStream(seed=11).batch(9)[0].astype(np.float32)
    r1 = srv.submit("big", f1, feed="a")
    r2 = srv.submit("big", f2, feed="b")
    assert not r1.done
    assert srv.drain() == 1              # one coalesced forward for both
    assert r1.done and r2.done
    assert srv.stats["coalesced_batches"] == 1
    assert srv.stats["frames"] == 14 and srv.stats["padded_frames"] == 2
    for frames, req in ((f1, r1), (f2, r2)):
        out = _solo(ctx, frames)
        for task in TASKS:
            assert np.array_equal(out["attrs"][task], req.result[task])
            assert req.result[task].dtype == out["attrs"][task].dtype


def test_server_dispatch_poll_protocol_and_inflight_accounting(ctx):
    srv = SharedExtractServer(ctx, max_batch=4, max_inflight=2)
    frames = TollBoothStream(seed=3).batch(4)[0].astype(np.float32)
    reqs = [srv.submit("big", frames, feed="a") for _ in range(3)]
    assert srv.pending_requests() == 3 and srv.pending_frames() == 12
    assert srv.dispatch() == 2           # max_inflight caps dispatch-ahead
    assert srv.inflight == 2
    assert srv.pending_requests() == 1 and srv.pending_frames() == 4
    assert reqs[2].result is None        # still queued
    assert srv.wait() >= 1
    assert reqs[0].done
    assert srv.drain() >= 1
    assert all(r.done for r in reqs)
    assert srv.inflight == 0 and srv.pending_requests() == 0
    assert srv.stats["forwards"] == 3
    assert srv.stats["dispatches"] >= 2
    assert srv.stats["max_inflight_seen"] == 2
    assert srv.stats["staging_skipped"] == 3
    for task in TASKS:
        assert np.array_equal(reqs[0].result[task], reqs[1].result[task])
        assert np.array_equal(reqs[0].result[task], reqs[2].result[task])


def test_server_staging_buffers_reused_without_stale_leakage(ctx):
    srv = SharedExtractServer(ctx, max_batch=8, max_inflight=1)
    s = TollBoothStream(seed=5)
    f1 = s.batch(6)[0].astype(np.float32)     # bucket 8: staged + padded
    f2 = s.batch(6)[0].astype(np.float32)
    srv.submit("big", f1)
    srv.drain()
    assert srv.stats["staging_allocated"] == 1
    assert srv.stats["staging_reused"] == 0
    r2 = srv.submit("big", f2)                # same bucket: reuses buffer
    srv.drain()
    assert srv.stats["staging_allocated"] == 1
    assert srv.stats["staging_reused"] == 1
    out = _solo(ctx, f2)
    for task in TASKS:
        assert np.array_equal(out["attrs"][task], r2.result[task])
    # the reused buffer's padding rows were zeroed again
    (buf,) = srv._staging[(8, 3, 128, 256, "<f4")]
    assert not buf[6:].any() and np.array_equal(buf[:6], f2)
    f8 = s.batch(8)[0].astype(np.float32)
    srv.submit("big", f8)
    srv.drain()
    assert srv.stats["staging_skipped"] == 1
    assert srv.stats["staging_allocated"] == 1


def test_server_dispatch_defers_partial_buckets_while_device_fed(ctx):
    srv = SharedExtractServer(ctx, max_batch=8, max_inflight=2)
    s = TollBoothStream(seed=7)
    full = s.batch(8)[0].astype(np.float32)
    part = s.batch(6)[0].astype(np.float32)
    srv.submit("big", full)
    srv.submit("big", part)
    assert srv.dispatch() == 1                # full launches, partial waits
    assert srv.pending_requests() == 1
    srv.drain()
    assert srv.stats["forwards"] == 2
    srv.submit("big", part)
    assert srv.dispatch() == 1                # nothing in flight: launches
    srv.drain()
    srv.submit("big", full)
    srv.submit("big", full)
    assert srv.dispatch(budget=1) == 1
    assert srv.pending_requests() == 1
    srv.drain()
    srv.submit("big", full)
    srv.submit("big", part)
    assert srv.dispatch() == 1
    for _ in range(srv.MAX_PARTIAL_DEFERS - 1):
        assert srv.dispatch() == 0            # still deferred, counted
    assert srv.dispatch() == 1                # overdue: launches
    srv.drain()


def test_server_buckets_by_shape_and_respects_max_batch(ctx):
    srv = SharedExtractServer(ctx, max_batch=8)
    full, _ = TollBoothStream(seed=1).batch(6)
    crop = full[:, :, 64:128, :]
    srv.submit("big", full.astype(np.float32))
    srv.submit("big", crop.astype(np.float32))
    assert srv.drain() == 2              # shape buckets never mix
    srv.reset_stats()
    for _ in range(3):
        srv.submit("big", full.astype(np.float32))
    srv.drain()
    assert srv.stats["forwards"] == 3    # 6+6 > 8
    assert srv.stats["frames"] == 18
    # uint8 and float32 frames of one shape never share a forward
    srv.reset_stats()
    srv.submit("big", full)
    srv.submit("big", full.astype(np.float32))
    assert srv.drain() == 2


def test_server_stats_view_is_stable(ctx):
    srv = SharedExtractServer(ctx, max_batch=8)
    view = srv.stats
    srv.submit("big", np.zeros((2, 3, 16, 32), np.float32))
    assert view is srv.stats and view["queue_depth"] == 1
    srv.drain()
    srv.reset_stats()
    assert view is srv.stats and view["forwards"] == 0
    assert view["queue_depth"] == 0 and view["inflight"] == 0


# ---------------------------------------------------------------------------
# (c) the multi-stream runtime over the reference's example workload
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(contexts):
    jctx, tctx = contexts
    return {
        "pipelined": MultiStreamRuntime(_ms_feeds(), tctx,
                                        micro_batch=MB).run(N),
        "lockstep": MultiStreamRuntime(_ms_feeds(), tctx, micro_batch=MB,
                                       pipelined=False).run(N),
        "reference": JaxMultiStream(_ms_feeds(True), jctx, micro_batch=MB,
                                    pipelined=False).run(N),
    }


@pytest.fixture(scope="module")
def independent(ctx):
    out = {}
    for name, ds, seed, qids in FEEDS:
        for q in qids:
            out[(name, q)] = StreamRuntime(
                get_query(q).naive_plan(), ctx, micro_batch=MB).run(
                _stream(ds, seed), N)
    return out


@pytest.mark.parametrize("feed,qid", FEED_QUERIES)
def test_multistream_equals_reference(served, feed, qid):
    got = served["lockstep"].feeds[feed].per_query[qid]
    want = served["reference"].feeds[feed].per_query[qid]
    assert got.outputs == want.outputs
    assert got.window_results == want.window_results
    assert got.op_input_counts == want.op_input_counts
    assert got.mllm_frames == want.mllm_frames
    assert got.labels == want.labels
    assert get_query(qid).evaluate(got) == \
        jax_get_query(qid).evaluate(want)


@pytest.mark.parametrize("feed,qid", FEED_QUERIES)
def test_multistream_equals_independent_runs(served, independent,
                                             feed, qid):
    for mode in ("pipelined", "lockstep"):
        got = served[mode].feeds[feed].per_query[qid]
        solo = independent[(feed, qid)]
        _same(got, solo)
        assert list(got.op_input_counts.values()) == \
            list(solo.op_input_counts.values())
        assert get_query(qid).evaluate(got) == \
            get_query(qid).evaluate(solo)


@pytest.mark.parametrize("feed,qid", FEED_QUERIES)
def test_pipelined_equals_lockstep(served, feed, qid):
    a = served["pipelined"].feeds[feed].per_query[qid]
    b = served["lockstep"].feeds[feed].per_query[qid]
    _same(a, b)
    assert a.op_input_counts == b.op_input_counts


def test_lockstep_server_stats_equal_reference(served):
    got = served["lockstep"].server_stats
    want = served["reference"].server_stats
    for key in ("forwards", "frames", "padded_frames", "coalesced_batches",
                "requests", "dispatches"):
        assert got[key] == want[key], key
    assert served["lockstep"].mllm_frames == \
        served["reference"].mllm_frames == \
        served["pipelined"].mllm_frames == 4 * N
    for name, _, _, _ in FEEDS:
        assert served["lockstep"].feeds[name].mllm_frames == \
            served["reference"].feeds[name].mllm_frames
        assert served["lockstep"].feeds[name].plan == \
            served["reference"].feeds[name].plan


def test_multistream_serves_with_fewer_forwards(served, independent):
    forwards = served["pipelined"].server_stats["forwards"]
    indep = sum(-(-r.mllm_frames // MB) for r in independent.values())
    assert forwards < indep
    assert served["pipelined"].server_stats["coalesced_batches"] >= 1
    assert served["pipelined"].n_feeds == 4
    assert served["pipelined"].n_queries == 9


def test_multistream_run_is_repeatable_and_budgets(ctx):
    feeds = [Feed("a", TollBoothStream(seed=2),
                  [get_query(q).naive_plan() for q in ("Q2", "Q6")]),
             Feed("b", TollBoothStream(seed=9),
                  [get_query("Q8").naive_plan()])]
    ms = MultiStreamRuntime(feeds, ctx, micro_batch=MB, max_pending=1)
    r1 = ms.run({"a": 32, "b": 16})
    r2 = ms.run({"a": 32, "b": 16})
    for q in ("Q2", "Q6"):
        _same(r1.feeds["a"].per_query[q], r2.feeds["a"].per_query[q])
    assert r2.feeds["a"].n_frames == 32 and r2.feeds["b"].n_frames == 16
    solo = StreamRuntime(get_query("Q8").naive_plan(), ctx,
                         micro_batch=MB).run(TollBoothStream(seed=9), 16)
    _same(r2.feeds["b"].per_query["Q8"], solo)


def test_multistream_reduced_prefix_feed(ctx):
    """A feed whose plans share Q8's reduced prefix (Skip, fused
    preprocess, red filter): the server coalesces float32 crops, and each
    query equals its own run."""
    def plans():
        out = []
        for qid in ("Q8", "Q6", "Q2"):
            q = get_query(qid)
            out.append(Plan(
                [SourceOp("tollbooth"),
                 SkipOp(amount=3, threshold=0.02, regions=(4, 8)),
                 ops.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2),
                 ops.CheapColorFilterOp("red", min_frac=0.008),
                 MLLMExtractOp(q.tasks, "big")] + q.tail() + [SinkOp()],
                query=qid))
        return out

    res = MultiStreamRuntime(
        [Feed("r", TollBoothStream(seed=3), plans()),
         Feed("n", TollBoothStream(seed=3),
              [get_query("Q2").naive_plan()])],
        ctx, micro_batch=8).run(N)
    for p in plans():
        solo = StreamRuntime(p, ctx, micro_batch=8).run(
            TollBoothStream(seed=3), N)
        got = res.feeds["r"].per_query[p.query]
        _same(got, solo)
    assert res.feeds["r"].mllm_frames < N


# ---------------------------------------------------------------------------
# (d) MultiQueryRuntime through the server
# ---------------------------------------------------------------------------

MQ_QIDS = ("Q2", "Q6", "Q8")


def test_multiquery_server_path_equals_sync_and_reference(contexts):
    jctx, tctx = contexts
    plans = [get_query(q).naive_plan() for q in MQ_QIDS]
    srv = SharedExtractServer(tctx, max_batch=64)
    piped = MultiQueryRuntime(plans, tctx, micro_batch=8, server=srv).run(
        TollBoothStream(seed=5), 40)
    sync = MultiQueryRuntime([get_query(q).naive_plan() for q in MQ_QIDS],
                             tctx, micro_batch=8).run(
        TollBoothStream(seed=5), 40)
    ref = JaxMultiQuery([jax_get_query(q).naive_plan() for q in MQ_QIDS],
                        jctx, micro_batch=8,
                        server=JaxServer(jctx, max_batch=64)).run(
        JaxTollBooth(seed=5), 40)
    for q in MQ_QIDS:
        _same(piped.per_query[q], sync.per_query[q])
        assert piped.per_query[q].op_input_counts == \
            sync.per_query[q].op_input_counts
        want = ref.per_query[q]
        got = piped.per_query[q]
        assert got.outputs == want.outputs
        assert got.window_results == want.window_results
        assert got.op_input_counts == want.op_input_counts
    assert piped.mllm_frames == ref.mllm_frames == 40
    assert srv.stats["forwards"] == 5      # one a micro-batch


def test_multiquery_server_snapshot_restore_continues(ctx):
    plans = lambda: [get_query(q).naive_plan() for q in MQ_QIDS]  # noqa
    whole = MultiQueryRuntime(plans(), ctx, micro_batch=8,
                              server=SharedExtractServer(ctx)).run(
        TollBoothStream(seed=5), 32)
    rt = MultiQueryRuntime(plans(), ctx, micro_batch=8,
                           server=SharedExtractServer(ctx))
    stream = TollBoothStream(seed=5)
    first = rt.run(stream, 16, flush=False)
    st = rt.snapshot()
    rt2 = MultiQueryRuntime(plans(), ctx, micro_batch=8,
                            server=SharedExtractServer(ctx))
    rt2.restore(st)
    second = rt2.run(stream, 16)
    for q in MQ_QIDS:
        assert first.per_query[q].outputs + second.per_query[q].outputs \
            == whole.per_query[q].outputs
        assert first.per_query[q].window_results + \
            second.per_query[q].window_results == \
            whole.per_query[q].window_results


# ---------------------------------------------------------------------------
# (e) faults: server level, then the runtime's breaker
# ---------------------------------------------------------------------------

def test_server_retries_transient_forward_fault_bitwise(ctx):
    frames = TollBoothStream(seed=3).batch(4)[0].astype(np.float32)
    clean = SharedExtractServer(ctx, max_batch=8)
    want = clean.submit("big", frames, feed="a")
    clean.drain()
    inj = FaultInjector([FaultRule(site="forward", kind="error",
                                   param=1)], seed=0)
    srv = SharedExtractServer(ctx, max_batch=8, faults=inj)
    req = srv.submit("big", frames, feed="a")
    srv.drain()
    assert req.done and not req.failed
    assert srv.stats["forward_faults"] == 1
    assert srv.stats["retries"] == 1
    for task in TASKS:
        assert np.array_equal(req.result[task], want.result[task])


def test_server_exhausts_retry_budget_and_fails_request(ctx):
    inj = FaultInjector([FaultRule(site="forward", kind="error",
                                   feed="sick", param=99)], seed=0)
    srv = SharedExtractServer(ctx, max_batch=8, faults=inj,
                              retry=RetryPolicy(max_attempts=2))
    frames = TollBoothStream(seed=3).batch(2)[0].astype(np.float32)
    sick = srv.submit("big", frames, feed="sick")
    well = srv.submit("big", frames, feed="well")
    srv.drain()
    assert sick.failed and not sick.done
    with pytest.raises(ExtractFaultError):
        sick.result
    assert well.done and not well.failed
    assert srv.stats["retry_exhausted"] == 1
    assert srv.stats["forward_faults"] == 2
    assert srv.pending_requests() == 0


def test_server_injected_latency_is_bitwise_and_clock_free(ctx):
    frames = TollBoothStream(seed=3).batch(3)[0].astype(np.float32)
    clean = SharedExtractServer(ctx, max_batch=8)
    want = clean.submit("big", frames, feed="a")
    clean.drain()
    inj = FaultInjector([FaultRule(site="forward", kind="latency",
                                   param=3)], seed=0)
    srv = SharedExtractServer(ctx, max_batch=8, faults=inj)
    req = srv.submit("big", frames, feed="a")
    srv.dispatch()
    # the not-ready branch: the completion is observed exactly param
    # polls late
    assert srv.poll() == 0 and srv.poll() == 0 and srv.poll() == 0
    assert not req.done and req.result is None
    srv._inflight[0].block()
    assert srv.poll() == 1
    assert srv.stats["latency_faults"] == 1
    for task in TASKS:
        assert np.array_equal(req.result[task], want.result[task])


def test_watchdog_names_stuck_work():
    srv = SharedExtractServer(OpContext(device="cpu"), max_batch=8,
                              drain_timeout_s=0.0)
    req = srv.submit("big", np.zeros((2, 3, 8, 8), np.float32), feed="a")
    req.not_before = 10 ** 9
    with pytest.raises(ExtractStallError, match="feed='a'"):
        srv.drain()
    with pytest.raises(ExtractStallError, match="drain\\(\\)"):
        srv.drain()
    with pytest.raises(ExtractStallError, match="wait\\(\\)"):
        srv._inflight.append(_StuckChunk(req))
        srv.wait()


class _StuckChunk:
    """An in-flight chunk whose forward never completes."""

    delay_polls = 0
    variant = "big"

    def __init__(self, req):
        self.reqs = [req]

    def ready(self):
        return False

    def block(self):
        pass


def _chaos_feeds(jax_side=False):
    feed_cls = JaxFeed if jax_side else Feed
    get = jax_get_query if jax_side else get_query
    return [feed_cls("tb0", _stream("tollbooth", 42, jax_side),
                     [get("Q2").naive_plan()]),
            feed_cls("vb0", _stream("volleyball", 5, jax_side),
                     [get("Q12").naive_plan()])]


def _outputs(res, feed):
    return {q: r.outputs for q, r in res.feeds[feed].per_query.items()}


@pytest.fixture(scope="module")
def plain48(ctx):
    return MultiStreamRuntime(_chaos_feeds(), ctx, micro_batch=8).run(48)


def _rules(kind):
    from repro.faults import FaultRule as JaxRule

    specs = {
        "absorbed": [
            dict(site="forward", kind="error", feed="tb0", start=1,
                 every=3, count=2, param=1),
            dict(site="forward", kind="latency", start=0, every=4,
                 count=3, param=2),
            dict(site="source", kind="stall", feed="vb0", start=1,
                 every=2, count=3),
            dict(site="source", kind="corrupt", feed="vb0", start=4,
                 every=3, count=2, param=1)],
        "dead_source": [dict(site="source", kind="corrupt", feed="tb0",
                             start=1, every=1, param=99)],
        "outage": [dict(site="source", kind="corrupt", feed="tb0",
                        start=1, every=1, count=2, param=99)],
        "dead_extract": [dict(site="forward", kind="error", feed="tb0",
                              start=2, every=1, param=99)],
    }[kind]
    return [FaultRule(**s) for s in specs], [JaxRule(**s) for s in specs]


CHAOS = {"absorbed": (3, {}), "dead_source": (11, {}),
         "outage": (11, {"breaker_cooldown": 1})}


@pytest.fixture(scope="module")
def chaos_runs(contexts):
    from repro.faults import FaultInjector as JaxInjector

    jctx, tctx = contexts
    out = {}
    for kind, (seed, kw) in CHAOS.items():
        rules, jrules = _rules(kind)
        inj, jinj = FaultInjector(rules, seed=seed), \
            JaxInjector(jrules, seed=seed)
        # lock-step: the reference's pipelined retirements depend on
        # when its CPU backend reports a forward ready
        out[kind] = (
            MultiStreamRuntime(_chaos_feeds(), tctx, micro_batch=8,
                               faults=inj, pipelined=False, **kw).run(48),
            JaxMultiStream(_chaos_feeds(True), jctx, micro_batch=8,
                           faults=jinj, pipelined=False, **kw).run(48),
            inj, jinj)
    return out


@pytest.mark.parametrize("kind", list(CHAOS))
def test_fault_partitions_equal_reference(chaos_runs, kind):
    res, ref, inj, jinj = chaos_runs[kind]
    assert inj.log == jinj.log
    for feed in ("tb0", "vb0"):
        got, want = res.feeds[feed], ref.feeds[feed]
        assert (got.served, got.degraded, got.dropped) == \
            (want.served, want.degraded, want.dropped)
        assert got.served + got.degraded + got.dropped == 48
        assert got.breaker == want.breaker
        assert _outputs(res, feed) == _outputs(ref, feed)
        for q in got.per_query:
            assert got.per_query[q].window_results == \
                want.per_query[q].window_results
    for key in ("forward_faults", "retries", "retry_exhausted",
                "latency_faults"):
        assert res.server_stats[key] == ref.server_stats[key], key


def test_absorbed_faults_keep_outputs_bitwise(chaos_runs, plain48):
    res = chaos_runs["absorbed"][0]
    for f in ("tb0", "vb0"):
        assert _outputs(res, f) == _outputs(plain48, f)
        assert res.feeds[f].served == 48
        assert res.feeds[f].breaker["trips"] == 0
    assert res.server_stats["retries"] >= 1
    assert res.server_stats["latency_faults"] >= 1


def test_absorbed_faults_pipelined_equal_lockstep(ctx, chaos_runs):
    rules, _ = _rules("absorbed")
    res = MultiStreamRuntime(_chaos_feeds(), ctx, micro_batch=8,
                             faults=FaultInjector(rules, seed=3)).run(48)
    lock = chaos_runs["absorbed"][0]
    for f in ("tb0", "vb0"):
        assert _outputs(res, f) == _outputs(lock, f)
        assert res.feeds[f].served == 48


def test_null_faults_run_bitwise_identical(ctx, plain48):
    from repro_torch.faults import NULL_FAULTS

    res = MultiStreamRuntime(_chaos_feeds(), ctx, micro_batch=8,
                             faults=NULL_FAULTS).run(48)
    for f in ("tb0", "vb0"):
        assert _outputs(res, f) == _outputs(plain48, f)
        assert res.feeds[f].degraded == 0 and res.feeds[f].dropped == 0


def test_dead_source_trips_breaker_with_exact_accounting(chaos_runs,
                                                         plain48):
    res = chaos_runs["dead_source"][0]
    tb = res.feeds["tb0"]
    assert tb.breaker["trips"] == 1
    assert tb.served + tb.degraded + tb.dropped == 48
    assert tb.served > 0
    served_idx = [r["idx"] for r in tb.per_query["Q2"].outputs]
    assert len(served_idx) == len(set(served_idx))
    # the served frames are the stream's first ``served``: their records
    # are the fault-free run's there, and nothing beyond
    want, got = _outputs(plain48, "tb0"), _outputs(res, "tb0")
    for q in want:
        assert got[q] == [r for r in want[q] if r["idx"] < tb.served]
    assert got["Q2"]
    assert _outputs(res, "vb0") == _outputs(plain48, "vb0")
    assert res.feeds["vb0"].breaker["trips"] == 0


def test_bounded_outage_probes_replays_and_recovers(chaos_runs, plain48):
    res = chaos_runs["outage"][0]
    tb = res.feeds["tb0"]
    assert tb.breaker["trips"] == 1 and tb.breaker["recoveries"] >= 1
    assert tb.served + tb.degraded + tb.dropped == 48
    assert tb.dropped + tb.degraded <= 24
    want = {(q, r["idx"]): r for q, outs in _outputs(plain48, "tb0").items()
            for r in outs}
    seen = set()
    for q, outs in _outputs(res, "tb0").items():
        for r in outs:
            assert want[(q, r["idx"])] == r
            assert (q, r["idx"]) not in seen     # replay served nothing twice
            seen.add((q, r["idx"]))
    assert _outputs(res, "vb0") == _outputs(plain48, "vb0")


@pytest.mark.parametrize("pipelined", [False, True])
def test_exhausted_extract_trips_the_sick_feed_only(ctx, plain48,
                                                    pipelined):
    """Every tb0 forward from its third request on fails past the retry
    budget.  Lock-step included: the barrier leaves a feed holding a
    failed request to its breaker (the reference's lock-step run hangs
    there; the reference is compared in the other chaos cases only)."""
    rules, _ = _rules("dead_extract")
    res = MultiStreamRuntime(_chaos_feeds(), ctx, micro_batch=8,
                             faults=FaultInjector(rules, seed=5),
                             pipelined=pipelined,
                             breaker_cooldown=2).run(48)
    tb = res.feeds["tb0"]
    assert tb.breaker["trips"] >= 1
    assert res.server_stats["retry_exhausted"] >= 1
    assert (tb.served, tb.degraded, tb.dropped) == (16, 0, 32)
    want = _outputs(plain48, "tb0")
    for q, outs in _outputs(res, "tb0").items():
        assert outs == want[q][:len(outs)]
    assert _outputs(res, "vb0") == _outputs(plain48, "vb0")
    assert res.feeds["vb0"].served == 48


def test_replay_suppresses_sink_collection():
    sink = SinkOp()
    batch = {"frames": np.zeros((2, 1, 1, 1)), "idx": np.arange(2),
             "attrs": {"present": np.ones(2, np.int64)},
             "window_results": [{"window": (0, 2)}]}
    sink.process(dict(batch, _suppress_sink=True))
    assert sink.collected == [{"window": (0, 2)}]
    sink.process(batch)
    assert [r.get("idx") for r in sink.collected] == [None, 0, 1, None]


def test_gated_outage_serves_stale_keyframe_answers(ctx):
    gate = SemanticGate(GateConfig(threshold=0.12, revalidate_every=1000),
                        device="cpu")
    inj = FaultInjector(seed=7, rules=[
        FaultRule(site="source", kind="corrupt", feed="tb0",
                  start=2, every=1, param=99)])
    res = MultiStreamRuntime(_chaos_feeds(), ctx, micro_batch=8, faults=inj,
                             gate=gate, pipelined=False).run(48)
    tb = res.feeds["tb0"]
    assert tb.served + tb.degraded + tb.dropped == 48
    assert tb.degraded > 0
    assert len(tb.degraded_records) == tb.degraded
    for d in tb.degraded_records:
        assert d["stale"] is True and d["answer"]
    served_idx = {r["idx"] for r in tb.per_query["Q2"].outputs}
    assert served_idx.isdisjoint(d["idx"] for d in tb.degraded_records)


# ---------------------------------------------------------------------------
# (f) the semantic gate inside the server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(threshold=0.06),
    dict(threshold=0.12, revalidate_every=3, mismatch_min_tasks=1),
])
def test_server_gate_counters_equal_reference_on_its_signatures(contexts,
                                                                cfg):
    """Both servers' gates take the reference's signatures of the same
    frames (two feeds, 96 frames each in batches of 16); the model rows
    run through each package's server, lock-step."""
    from repro.semantic import GateConfig as JaxConfig
    from repro.semantic import SemanticGate as JaxGate

    jctx, tctx = contexts
    tsrv = SharedExtractServer(tctx, gate=SemanticGate(GateConfig(**cfg),
                                                       device="cpu"))
    jsrv = JaxServer(jctx, gate=JaxGate(JaxConfig(**cfg)))
    streams = {"a": JaxTollBooth(seed=11), "b": JaxTollBooth(seed=4321)}
    results = []
    for _ in range(6):
        reqs = []
        for feed, s in streams.items():
            frames = s.batch(16)[0].astype(np.float32)
            sig = jsrv.gate.signature.features(frames)
            sig = (np.asarray(sig[0]), np.asarray(sig[1]))
            reqs.append([srv.submit("big", frames, feed=feed,
                                    sig=(sig[0].copy(), sig[1].copy()))
                         for srv in (tsrv, jsrv)])
        tsrv.drain()
        jsrv.drain()
        for t, j in reqs:
            assert t.done and j.done
            results.append((t.result, j.result))
    for t, j in results:
        for task in TASKS:
            np.testing.assert_array_equal(t[task], np.asarray(j[task]))
    for key in ("cache_hits", "cache_misses", "revalidations",
                "cache_mismatches", "forwards", "frames", "padded_frames",
                "requests"):
        assert tsrv.stats[key] == jsrv.stats[key], key
    assert tsrv.stats["cache_hits"] > 0
    assert tsrv.gate.feed_counters == jsrv.gate.feed_counters


def test_fully_hit_batch_short_circuits_dispatch(ctx):
    gate = SemanticGate(GateConfig(threshold=0.06, revalidate_every=1000),
                        device="cpu")
    srv = SharedExtractServer(ctx, gate=gate)
    frames = TollBoothStream(seed=2).batch(8)[0].astype(np.float32)
    first = srv.submit("big", frames, feed="a")
    assert srv.pending_frames() > 0
    srv.drain()
    forwards = srv.stats["forwards"]
    again = srv.submit("big", frames.copy(), feed="a")
    assert again.inner is None and again.done     # every row hit
    assert srv.pending_frames() == 0 and srv.dispatch() == 0
    assert srv.stats["forwards"] == forwards
    for task in TASKS:
        assert np.array_equal(again.result[task], first.result[task])


def test_gate_at_threshold_zero_equals_ungated_serving(ctx, plain48):
    gate = SemanticGate(GateConfig(threshold=0.0), device="cpu")
    res = MultiStreamRuntime(_chaos_feeds(), ctx, micro_batch=8,
                             gate=gate).run(48)
    for f in ("tb0", "vb0"):
        assert _outputs(res, f) == _outputs(plain48, f)
    assert res.server_stats["cache_hits"] == 0


def test_multistream_gated_feeds_pay_fewer_forward_frames(ctx):
    gate = SemanticGate(GateConfig(threshold=0.06), device="cpu")
    res = MultiStreamRuntime(_chaos_feeds(), ctx, micro_batch=8,
                             gate=gate).run(48)
    st = res.server_stats
    assert st["cache_hits"] > 0
    assert st["frames"] == st["cache_misses"] + st["revalidations"] \
        < res.mllm_frames
    assert st["cache_hits"] + st["cache_misses"] + st["revalidations"] \
        == res.mllm_frames
