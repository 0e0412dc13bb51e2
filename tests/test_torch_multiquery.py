"""The port's multi-query shared execution.

Within the port: the shared ``MultiQueryRuntime`` equals each query's own
``StreamRuntime`` run bit for bit, with fewer MLLM frames; snapshot /
restore continues across the fan-out; partial windows flush.  Across
packages: each query's shared result equals the reference's
``MultiQueryRuntime`` result on the same bridged random weights.  The
model-free tests are the reference's own (``tests/test_multiquery.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.samsara_stream import STREAM_MLLM_CONFIG as JAX_BIG  # noqa: E402
from repro.data import TollBoothStream as JaxTollBooth  # noqa: E402
from repro.data import VolleyballStream as JaxVolleyball  # noqa: E402
from repro.queries import get_query as jax_get_query  # noqa: E402
from repro.streaming import operators as jops  # noqa: E402
from repro.streaming.mllm import StreamMLLM as JaxMLLM  # noqa: E402
from repro.streaming.multiquery import \
    MultiQueryRuntime as JaxMultiQuery  # noqa: E402
from repro.streaming.plan import Plan as JaxPlan  # noqa: E402

from repro_torch.bridge import load_reference_params  # noqa: E402
from repro_torch.configs.samsara_stream import STREAM_MLLM_CONFIG  # noqa: E402
from repro_torch.core.multiquery import (factor_plans,  # noqa: E402
                                         merge_mllm_column, share_key)
from repro_torch.core.physical import structured_prune  # noqa: E402
from repro_torch.data import TollBoothStream, VolleyballStream  # noqa: E402
from repro_torch.queries.catalog import get_query  # noqa: E402
from repro_torch.streaming import operators as ops  # noqa: E402
from repro_torch.streaming.mllm import StreamMLLM  # noqa: E402
from repro_torch.streaming.multiquery import (MultiQueryRuntime,  # noqa: E402
                                              fan_out_tails)
from repro_torch.streaming.operators import (MLLMExtractOp,  # noqa: E402
                                             OpContext, SinkOp, SkipOp,
                                             SourceOp, WindowAggOp)
from repro_torch.streaming.plan import Plan  # noqa: E402
from repro_torch.streaming.runtime import (StreamRuntime,  # noqa: E402
                                           flush_ops)

MQ_QIDS = ("Q2", "Q6", "Q8")          # filter-only, window, divergent filter
N, MB = 32, 8


@pytest.fixture(scope="module")
def contexts():
    jm = JaxMLLM(JAX_BIG, patch=16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device="cpu")
    load_reference_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return (jops.OpContext(mllm=jm, mllm_params=params),
            OpContext(mllm=tm, mllm_pruned=structured_prune(tm, 0.5),
                      device="cpu"))


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU runs on one thread, beside JAX's runtime and the suite's
    other worker processes; the colour count is exact at any thread count
    (``tests/test_torch_fused_prefix.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _indep(qid, ctx, seed, n, mb=MB):
    rt = StreamRuntime(get_query(qid).naive_plan(), ctx, micro_batch=mb)
    return rt.run(TollBoothStream(seed=seed), n)


def _same_run(a, b):
    assert a.outputs == b.outputs
    assert a.window_results == b.window_results
    assert a.op_input_counts == b.op_input_counts
    assert a.mllm_frames == b.mllm_frames
    assert a.labels == b.labels


def _same_as_solo(shared, solo):
    """A query's shared result against its own run: the merged extract
    has its own name (the union of the tasks), so operator counts are
    compared in plan order."""
    assert shared.outputs == solo.outputs
    assert shared.window_results == solo.window_results
    assert shared.mllm_frames == solo.mllm_frames
    assert list(shared.op_input_counts.values()) == \
        list(solo.op_input_counts.values())
    assert shared.labels == solo.labels


def reduced_plans(m):
    """Q8's reduced prefix (Skip, FusedPreprocess, CheapColor red) under
    the extracts and tails of Q8, Q6 and Q2: the shared reduced set."""
    get = jax_get_query if m is jops else get_query
    plan_cls = JaxPlan if m is jops else Plan
    out = []
    for qid in ("Q8", "Q6", "Q2"):
        q = get(qid)
        chain = [m.SourceOp("tollbooth"),
                 m.SkipOp(amount=3, threshold=0.02, regions=(4, 8)),
                 m.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2),
                 m.CheapColorFilterOp("red", min_frac=0.008),
                 m.MLLMExtractOp(q.tasks, "big")]
        out.append(plan_cls(chain + q.tail() + [m.SinkOp()], query=qid))
    return out


# ---------------------------------------------------------------------------
# planner pass (model-free)
# ---------------------------------------------------------------------------

def test_factor_plans_merges_mllm_union():
    plans = [get_query(q).naive_plan() for q in MQ_QIDS]
    sh = factor_plans(plans)
    assert [op.name for op in sh.prefix][0].startswith("source")
    merged = sh.prefix[1]
    assert isinstance(merged, MLLMExtractOp)
    assert set(merged.tasks) == {"present", "color", "plate"}
    assert len(sh.tails) == 3
    for tail in sh.tails:
        assert isinstance(tail[-1], SinkOp)


def test_factor_plans_stops_at_divergence_and_sink():
    p1, p2 = get_query("Q2").naive_plan(), get_query("Q2").naive_plan()
    sh = factor_plans([p1, p2])
    assert len(sh.prefix) == 3                      # source, mllm, filter
    assert all(len(t) == 1 and isinstance(t[0], SinkOp) for t in sh.tails)
    assert sh.queries == ["Q2", "Q2#1"]
    p3, p4, p5 = (get_query("Q2").naive_plan() for _ in range(3))
    p4.query = "Q2#1"
    ids = factor_plans([p3, p4, p5]).queries
    assert ids == ["Q2", "Q2#1", "Q2#2"] and len(set(ids)) == 3
    assert merge_mllm_column(
        [MLLMExtractOp(tasks=("present",), model="big"),
         MLLMExtractOp(tasks=("present",), model="small")]) is None


def test_factor_plans_rejects_mixed_streams():
    with pytest.raises(AssertionError):
        factor_plans([get_query("Q2").naive_plan(),
                      get_query("Q12").naive_plan()])


def test_plan_common_prefix_api():
    a = get_query("Q4").naive_plan()
    b = get_query("Q4").naive_plan()
    n = a.common_prefix(b)
    assert n == len(a.ops) - 1
    prefix, suffix = a.split_at(n)
    assert len(prefix) == n and isinstance(suffix[-1], SinkOp)
    assert get_query("Q1").naive_plan().common_prefix(
        get_query("Q2").naive_plan()) == 1


@pytest.mark.parametrize("qids", [("Q2", "Q6", "Q8"),
                                  tuple(f"Q{i}" for i in range(1, 10)),
                                  ("Q10", "Q11", "Q12", "Q13")])
def test_factoring_matches_reference(qids):
    """The same prefix, tails, query ids and share keys as the
    reference's planner pass."""
    from repro.core.multiquery import factor_plans as jax_factor
    from repro.core.multiquery import share_key as jax_share_key

    sh = factor_plans([get_query(q).naive_plan() for q in qids])
    jsh = jax_factor([jax_get_query(q).naive_plan() for q in qids])
    assert [o.signature() for o in sh.prefix] == \
        [o.signature() for o in jsh.prefix]
    assert [[o.signature() for o in t] for t in sh.tails] == \
        [[o.signature() for o in t] for t in jsh.tails]
    assert sh.queries == jsh.queries and sh.notes == jsh.notes
    assert sh.describe() == jsh.describe()
    for q in qids:
        assert share_key(get_query(q).naive_plan()) == \
            jax_share_key(jax_get_query(q).naive_plan())


def test_reduced_set_factors_through_the_merged_extract():
    sh = factor_plans(reduced_plans(ops))
    assert [type(o).__name__ for o in sh.prefix] == [
        "SourceOp", "SkipOp", "FusedPreprocessOp", "CheapColorFilterOp",
        "MLLMExtractOp"]
    assert set(sh.prefix[-1].tasks) == {"present", "color", "plate"}


def test_server_path_is_not_ported(contexts):
    """The name is historical: the server path (``server=``, a
    ``SharedExtractServer``) is ported now and equals the synchronous
    path bit for bit (``tests/test_torch_serving.py`` holds it against the
    reference)."""
    from repro_torch.scheduler import SharedExtractServer

    ctx = contexts[1]
    piped = MultiQueryRuntime([get_query(q).naive_plan() for q in MQ_QIDS],
                              ctx, micro_batch=MB,
                              server=SharedExtractServer(ctx)).run(
        TollBoothStream(seed=4), 16)
    sync = MultiQueryRuntime([get_query(q).naive_plan() for q in MQ_QIDS],
                             ctx, micro_batch=MB).run(
        TollBoothStream(seed=4), 16)
    for q in MQ_QIDS:
        _same_run(piped.per_query[q], sync.per_query[q])


def test_flush_ops_terminal_receives_propagated_batches():
    plan = Plan([SourceOp(), WindowAggOp(kind="top_color", window=32),
                 SinkOp()])
    w = plan.ops[1]
    w.process({"frames": np.zeros((5, 1, 1, 1)), "idx": np.arange(5),
               "attrs": {"color": np.zeros(5, np.int64)}})
    emitted, seen = [], []
    flush_ops(plan.ops, emitted.extend, terminal=seen.append)
    assert len(emitted) == 1 and emitted[0]["partial"]
    assert len(seen) == 1 and len(seen[0]["idx"]) == 0
    assert "window_results" not in seen[0]


def test_fan_out_parallel_equals_sequential():
    def tails():
        return [[WindowAggOp(kind=k, window=4), SinkOp()]
                for k in ("top_color", "top_brand", "count_distinct_plates")]

    r = np.random.RandomState(0)
    batches = [{"frames": np.zeros((6, 1, 1, 1)),
                "idx": np.arange(6 * i, 6 * i + 6),
                "attrs": {"color": r.randint(0, 6, 6),
                          "brand": r.randint(0, 6, 6),
                          "plate": r.randint(0, 36, (6, 6))}}
               for i in range(5)]
    got = []
    for parallel in (True, False):
        ts = tails()
        counts = [{op.name: 0 for op in t} for t in ts]
        windows = [[] for _ in ts]
        for b in batches:
            fan_out_tails(ts, b, counts, windows, parallel=parallel)
        got.append((counts, windows, [t[-1].collected for t in ts]))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# shared == independent within the port; shared == the reference's
# ---------------------------------------------------------------------------

def test_shared_matches_independent_bitwise(contexts):
    _, ctx = contexts
    plans = [get_query(q).naive_plan() for q in MQ_QIDS]
    shared = MultiQueryRuntime(plans, ctx, micro_batch=MB).run(
        TollBoothStream(seed=11), N)
    assert shared.n_queries == 3 and shared.mllm_frames == N
    indep_sum = 0
    for qid in MQ_QIDS:
        ind = _indep(qid, ctx, 11, N)
        indep_sum += ind.mllm_frames
        got = shared.per_query[qid]
        _same_as_solo(got, ind)
        assert get_query(qid).evaluate(got) == get_query(qid).evaluate(ind)
    assert shared.mllm_frames < indep_sum


@pytest.mark.parametrize("which", ["tollbooth", "volleyball", "reduced"])
def test_shared_matches_reference(contexts, which):
    """Each query's shared result equals the reference's shared result
    (the three sets ``chip_smoke.py`` phase 14 runs on the card, at 32
    frames), and the shared MLLM frames are the reference's."""
    jctx, ctx = contexts
    if which == "tollbooth":
        qids = [f"Q{i}" for i in range(1, 10)]
    elif which == "volleyball":
        qids = ["Q10", "Q11", "Q12", "Q13"]
    if which == "reduced":
        tplans, jplans = reduced_plans(ops), reduced_plans(jops)
        seed, tstream, jstream = 3, TollBoothStream, JaxTollBooth
    else:
        tplans = [get_query(q).naive_plan() for q in qids]
        jplans = [jax_get_query(q).naive_plan() for q in qids]
        if which == "tollbooth":
            seed, tstream, jstream = 11, TollBoothStream, JaxTollBooth
        else:
            seed, tstream, jstream = 3, VolleyballStream, JaxVolleyball
    got = MultiQueryRuntime(tplans, ctx, micro_batch=MB).run(
        tstream(seed=seed), 32)
    want = JaxMultiQuery(jplans, jctx, micro_batch=MB).run(
        jstream(seed=seed), 32)
    assert got.shared_plan == want.shared_plan
    assert got.mllm_frames == want.mllm_frames
    assert list(got.per_query) == list(want.per_query)
    for qid, res in got.per_query.items():
        _same_run(res, want.per_query[qid])
    if which == "reduced":
        assert 0 < got.mllm_frames < 32


def test_reduced_shared_matches_independent(contexts):
    _, ctx = contexts
    shared = MultiQueryRuntime(reduced_plans(ops), ctx, micro_batch=MB).run(
        TollBoothStream(seed=3), 32)
    total = 0
    for plan in reduced_plans(ops):
        ind = StreamRuntime(plan, ctx, micro_batch=MB).run(
            TollBoothStream(seed=3), 32)
        total += ind.mllm_frames
        _same_as_solo(shared.per_query[plan.query], ind)
    assert 0 < shared.mllm_frames < total


def test_snapshot_restore_roundtrip(contexts):
    _, ctx = contexts
    qids = ("Q6", "Q8")
    mq = MultiQueryRuntime([get_query(q).naive_plan() for q in qids], ctx,
                           micro_batch=MB)
    s = TollBoothStream(seed=13)
    mq.run(s, 24, warmup=1, flush=False)
    st = mq.snapshot()
    assert st["source_index"] == 24
    cont = mq.run(s, 24, warmup=0, flush=True)
    assert cont.mllm_frames == 24
    mq.restore(st)
    s2 = TollBoothStream(seed=13)
    s2.batch(24)
    resumed = mq.run(s2, 24, flush=True)
    for qid in qids:
        assert resumed.per_query[qid].outputs == cont.per_query[qid].outputs
        assert resumed.per_query[qid].window_results == \
            cont.per_query[qid].window_results


def test_multiquery_flushes_partial_window(contexts):
    _, ctx = contexts

    def window_plan(qid):
        return Plan([SourceOp(stream_name="tollbooth"),
                     MLLMExtractOp(tasks=("present", "color")),
                     WindowAggOp(kind="top_color", window=16), SinkOp()],
                    query=qid)

    mq = MultiQueryRuntime([window_plan("W1"), window_plan("W2")], ctx,
                           micro_batch=MB)
    shared = mq.run(TollBoothStream(seed=21), 40)
    for qid in ("W1", "W2"):
        wins = shared.per_query[qid].window_results
        assert [w["window"] for w in wins] == [(0, 16), (16, 32), (32, 48)]
        assert wins[-1].get("partial")


# ---------------------------------------------------------------------------
# flush and reset contracts (model-free), the reference's own
# ---------------------------------------------------------------------------

def test_window_flush_emits_final_partial():
    op = WindowAggOp(kind="top_color", window=16)
    b = {"frames": np.zeros((10, 1, 1, 1)), "idx": np.arange(10),
         "attrs": {"color": np.zeros(10, np.int64)}}
    out = op.process(b)
    assert "window_results" not in out
    res = op.flush()["window_results"][0]
    assert res["partial"] and res["window"] == (0, 16)
    assert res["top_color"] == "red" and res["n"] == 10
    b2 = {"frames": np.zeros((8, 1, 1, 1)), "idx": np.arange(10, 18),
          "attrs": {"color": np.ones(8, np.int64)}}
    closed = op.process(b2)["window_results"][0]
    assert closed["window"] == (0, 16) and "partial" not in closed
    assert closed["n"] == 16


def test_runtime_flushes_partial_window_model_free():
    plan = Plan([SourceOp(), WindowAggOp(kind="top_color", window=32),
                 SinkOp()])
    rt = StreamRuntime(plan, OpContext(device="cpu"), micro_batch=16)
    res = rt.run(TollBoothStream(seed=3), 40, warmup=0)
    assert [w["window"] for w in res.window_results] == [(0, 32), (32, 64)]
    assert res.window_results[-1]["partial"]


def test_segmented_flush_does_not_corrupt_windows():
    def make_rt():
        return StreamRuntime(
            Plan([SourceOp(), WindowAggOp(kind="top_color", window=32),
                  SinkOp()]), OpContext(device="cpu"), micro_batch=16)

    cont = make_rt().run(TollBoothStream(seed=9), 80, warmup=0)
    rt = make_rt()
    s = TollBoothStream(seed=9)
    seg1 = rt.run(s, 40, warmup=0, flush=True)
    seg2 = rt.run(s, 40, warmup=0, flush=True)
    seg_windows = seg1.window_results + seg2.window_results

    def closed(wins):
        return [w for w in wins if not w.get("partial")]

    assert closed(seg_windows) == closed(cont.window_results)
    assert seg_windows[-1] == cont.window_results[-1]


def test_partial_window_superseded_by_closed():
    from repro_torch.queries.catalog import _window_results

    r = type("R", (), {"window_results": [
        {"kind": "top_color", "window": (0, 32), "top_color": "red"},
        {"kind": "top_color", "window": (32, 64), "partial": True,
         "top_color": "blue"},
        {"kind": "top_color", "window": (32, 64), "top_color": "red"},
        {"kind": "top_color", "window": (64, 96), "partial": True,
         "top_color": "grey"},
    ]})()
    wins = _window_results(r, "top_color")
    assert [w["window"] for w in wins] == [(0, 32), (32, 64), (64, 96)]
    assert wins[1]["top_color"] == "red" and not wins[1].get("partial")
    assert wins[2].get("partial")


def test_reset_contract_model_free():
    skip = SkipOp(amount=3)
    skip._prev, skip._skip_left = np.zeros((3, 4, 4)), 2
    skip.reset()
    assert skip._prev is None and skip._skip_left == 0
    win = WindowAggOp(kind="top_color", window=8)
    win._buf, win._window_start = [{"idx": 1}], 8
    win.reset()
    assert win._buf == [] and win._window_start == 0
    mllm = MLLMExtractOp(tasks=("present",), model="adaptive")
    mllm.frames_processed, mllm._density_ema = 99, 0.01
    mllm.reset()
    assert mllm.frames_processed == 0 and mllm._density_ema == 0.5
    sink = SinkOp()
    sink.collected = [{"idx": 0}]
    sink.reset()
    assert sink.collected == []


def test_warmup_resets_adaptive_density_ema(contexts):
    _, ctx = contexts

    def make_plan():
        return Plan([SourceOp(), MLLMExtractOp(
            tasks=("present", "color"), model="adaptive"), SinkOp()])

    polluted = make_plan()
    rt1 = StreamRuntime(polluted, ctx, micro_batch=8)
    polluted.ops[1]._density_ema = 0.0
    res1 = rt1.run(TollBoothStream(seed=17), 16, warmup=1)
    fresh = make_plan()
    res2 = StreamRuntime(fresh, ctx, micro_batch=8).run(
        TollBoothStream(seed=17), 16, warmup=1)
    assert res1.outputs == res2.outputs
    assert polluted.ops[1]._density_ema == fresh.ops[1]._density_ema


def test_micro_batch_hint_threaded(contexts):
    _, ctx = contexts
    plan = get_query("Q2").naive_plan()
    StreamRuntime(plan, ctx, micro_batch=8)
    assert plan.ops[1]._micro_batch_hint == 8


def test_launch_counts_survive_concurrent_launches(monkeypatch):
    """A fan-out tail may launch kernels from the pool's threads: the
    launch count must lose no increment.  The C call is replaced by a stub
    (no card here); ``CudaKernel.launch`` itself runs."""
    import contextlib
    import sys
    import threading

    from repro_torch.kernels import _build

    stream = type("S", (), {"cuda_stream": 0})()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    k = _build.CudaKernel("stress", "stress_launch", [])
    _build.REGISTRY.pop("stress_launch")
    k._fn = lambda *args: 0
    n_threads, per_thread = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [k.launch(torch.device("cuda"))
                            for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert k.launches == n_threads * per_thread
