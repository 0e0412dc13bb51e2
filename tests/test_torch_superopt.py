"""The port's super-optimizer against the JAX package's.

The deterministic parts must equal the reference's: the semantic phase's
scene facts and operator selection, its back-off order, the logical
rewrites R2/R3, structured pruning's kept columns, the chain-cost model
and the cost catalog's bookkeeping.  Decisions priced from measured
timings (logical R1, physical model selection and prefix fusion) are held
for validity only.  Models are small (the small stream config) with
random weights; JAX weights come from ``init(PRNGKey)`` and the bridge.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.samsara_stream import \
    STREAM_MLLM_SMALL_CONFIG as JAX_SMALL  # noqa: E402
from repro.core import costs as jcosts  # noqa: E402
from repro.core import physical as jphysical  # noqa: E402
from repro.core import semantic as jsemantic  # noqa: E402
from repro.core.logical import LogicalOptimizer as JaxLogical  # noqa: E402
from repro.data import TollBoothStream as JaxTollBooth  # noqa: E402
from repro.data import VolleyballStream as JaxVolleyball  # noqa: E402
from repro.queries import get_query as jax_get_query  # noqa: E402
from repro.streaming import operators as jops  # noqa: E402
from repro.streaming.mllm import StreamMLLM as JaxMLLM  # noqa: E402
from repro.streaming.plan import Plan as JaxPlan  # noqa: E402

from repro_torch.bridge import (load_reference_params,  # noqa: E402
                                load_reference_pruned)
from repro_torch.configs.samsara_stream import \
    STREAM_MLLM_SMALL_CONFIG  # noqa: E402
from repro_torch.core import costs as tcosts  # noqa: E402
from repro_torch.core import physical as tphysical  # noqa: E402
from repro_torch.core import semantic as tsemantic  # noqa: E402
from repro_torch.core.logical import LogicalOptimizer  # noqa: E402
from repro_torch.core.superopt import SuperOptimizer  # noqa: E402
from repro_torch.data import TollBoothStream, VolleyballStream  # noqa: E402
from repro_torch.queries.catalog import get_query  # noqa: E402
from repro_torch.streaming import operators as ops  # noqa: E402
from repro_torch.streaming.detector import TinyDet  # noqa: E402
from repro_torch.streaming.fused import FusedPrefixOp  # noqa: E402
from repro_torch.streaming.mllm import StreamMLLM  # noqa: E402
from repro_torch.streaming.plan import Plan  # noqa: E402
from repro_torch.streaming.runtime import StreamRuntime  # noqa: E402

#: TinyDet seed whose random cascade keeps some of Q8's frames
DETECTOR_SEED = 129


@pytest.fixture(scope="module")
def small_models():
    """The small stream MLLM in both packages with the same weights."""
    jm = JaxMLLM(JAX_SMALL, patch=16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3))
    tm = load_reference_params(
        StreamMLLM(STREAM_MLLM_SMALL_CONFIG, patch=16, device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    return (jm, params), tm


def _streams(dataset, pkg):
    if dataset == "tollbooth":
        return JaxTollBooth if pkg == "jax" else TollBoothStream
    return JaxVolleyball if pkg == "jax" else VolleyballStream


@pytest.mark.parametrize("qid", ["Q2", "Q6", "Q8", "Q13"])
def test_semantic_knowledge_and_selection_match_reference(qid):
    q, jq = get_query(qid), jax_get_query(qid)
    ts, js = _streams(q.dataset, "torch")(seed=101), \
        _streams(q.dataset, "jax")(seed=101)
    frames, _ = ts.batch(256)
    jframes, _ = js.batch(256)
    assert np.array_equal(frames, jframes)
    know = tsemantic.extract_knowledge(frames, ts.metadata)
    jknow = jsemantic.extract_knowledge(jframes, js.metadata)
    assert know.facts == jknow.facts
    assert (know.empty_fraction, know.active_bbox, know.min_dwell,
            know.median_dwell) == (jknow.empty_fraction, jknow.active_bbox,
                                   jknow.min_dwell, jknow.median_dwell)
    chosen, log = tsemantic.SemanticReasoner().select(know, q)
    jchosen, jlog = jsemantic.SemanticReasoner().select(jknow, jq)
    assert log == jlog
    assert [o.signature() for o in chosen] == \
        [o.signature() for o in jchosen]


def test_semantic_back_off_order_matches_reference():
    def plan(m, P):
        return P([m.SourceOp(), m.SkipOp(amount=4),
                  m.CropOp(region=(64, 0, 64, 256)), m.DownscaleOp(4),
                  m.MLLMExtractOp(), m.SinkOp()])

    tp, jp = plan(ops, Plan), plan(jops, JaxPlan)
    topt, jopt = tsemantic.SemanticOptimizer(), jsemantic.SemanticOptimizer()
    while True:
        a, b = topt._back_off(tp), jopt._back_off(jp)
        assert a == b
        assert [o.signature() for o in tp.ops] == \
            [o.signature() for o in jp.ops]
        if a is None:
            break


@pytest.mark.parametrize("chain", ["down_crop", "grey_down", "crop_only"])
def test_logical_r2_r3_match_reference(chain):
    """Q6 has no colour conjunct, so R1 (timed) does not fire and the
    rewrite is deterministic: pushdown and fusion equal the reference's."""
    def plan(m, P):
        mid = {"down_crop": [m.DownscaleOp(2), m.CropOp((64, 0, 64, 256))],
               "grey_down": [m.GreyscaleOp(), m.DownscaleOp(2)],
               "crop_only": [m.CropOp((32, 0, 96, 256))]}[chain]
        return P([m.SourceOp()] + mid + [m.MLLMExtractOp(), m.SinkOp()])

    sample, _ = TollBoothStream(seed=404).batch(8)
    new, rep = LogicalOptimizer(ops.OpContext(device="cpu")).optimize(
        plan(ops, Plan), get_query("Q6"), sample)
    jnew, jrep = JaxLogical(jops.OpContext()).optimize(
        plan(jops, JaxPlan), jax_get_query("Q6"), sample)
    # the rule texts differ only in naming the kernel each package runs
    strip = lambda r: r.split(" (")[0]  # noqa: E731
    assert [strip(r) for r in rep.pop("rules")] == \
        [strip(r) for r in jrep.pop("rules")]
    assert rep == jrep
    assert [o.signature() for o in new.ops] == \
        [o.signature() for o in jnew.ops]
    assert new.notes == jnew.notes


def _kept_columns(w_full, w_pruned):
    """Indices of the columns of (L, d, f) ``w_full`` that (L, d, f')
    ``w_pruned`` holds, per layer (exact copies, so exact matches)."""
    out = []
    for layer, pl in zip(np.asarray(w_full), np.asarray(w_pruned)):
        out.append([int(np.flatnonzero((layer == pl[:, [j]]).all(axis=0))[0])
                    for j in range(pl.shape[1])])
    return out


def test_structured_prune_matches_reference(small_models):
    (jm, params), tm = small_models
    jp = jphysical.structured_prune(jm, params, rate=0.5)
    tp = tphysical.structured_prune(tm, rate=0.5)
    assert tp.cfg.d_ff == STREAM_MLLM_SMALL_CONFIG.d_ff // 2
    jw = jp["backbone"]["stack"]["i0"]["mlp"]
    jfull = params["backbone"]["stack"]["i0"]["mlp"]
    tw = tp.backbone.stack.i0.mlp
    tfull = tm.backbone.stack.i0.mlp
    assert _kept_columns(tfull.w_in.numpy(), tw.w_in.numpy()) == \
        _kept_columns(jfull["w_in"], jw["w_in"])
    for k in ("w_in", "w_gate", "w_out"):
        np.testing.assert_allclose(getattr(tw, k).numpy(),
                                   np.asarray(jw[k]), atol=1e-6, rtol=1e-6)
    # the bridge's pruned variant from the reference's pruned params is the
    # same model
    bridged = load_reference_pruned(tm, jax.tree_util.tree_map(np.asarray,
                                                               jp))
    assert bridged.cfg == tp.cfg
    for (n, a), (_, b) in zip(bridged.named_parameters(),
                              tp.named_parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=n)
    frames = np.random.RandomState(0).randn(2, 3, 32, 128).astype(
        np.float32)
    want = jm.forward(jp, jax.numpy.asarray(frames))
    with torch.no_grad():
        got = tp(torch.from_numpy(frames))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-4)


def _stub_ops(m):
    out = []
    for cost, over, rate in ((3.0, 10.0, 0.5), (-1.0, 4.0, 1.5),
                             (7.5, 0.0, 0.25), (2.0, -3.0, -0.1)):
        op = m.CropOp()
        op.cost_us, op.overhead_us, op.pass_rate = cost, over, rate
        out.append(op)
    return out


@pytest.mark.parametrize("n", [1, 16, 64])
def test_chain_cost_matches_reference(n):
    assert tphysical._chain_cost_us(_stub_ops(ops), n) == \
        jphysical._chain_cost_us(_stub_ops(jops), n)


def _stub_class(base):
    class Stub(base.Op):
        """Takes ``overhead + marginal·n`` seconds of a fake clock per call
        and keeps every other row."""
        overhead, marginal = 200e-6, 5e-6

        def __post_init__(self):
            self.name = "stub"

        def process(self, batch):
            CLOCK[0] += self.overhead + self.marginal * len(batch["idx"])
            keep = np.arange(len(batch["idx"])) % 2 == 0
            return base._mask_batch(batch, keep)

    return Stub


CLOCK = [0.0]


def test_calibrate_chain_fits_overhead_and_marginal(monkeypatch):
    frames = np.zeros((64, 3, 4, 4), np.uint8)
    rows = []
    for mod, base, ctx in ((tcosts, ops, ops.OpContext(device="cpu")),
                           (jcosts, jops, jops.OpContext())):
        monkeypatch.setattr(mod, "time", type("T", (), {
            "perf_counter": staticmethod(lambda: CLOCK[0])}))
        stub = _stub_class(base)
        chain = [stub(), stub()]
        CLOCK[0] = 0.0
        cat = mod.CostCatalog()
        cat.calibrate_chain(chain, frames, ctx)
        for op in chain:
            assert op.cost_us == pytest.approx(5.0)
            assert op.overhead_us == pytest.approx(200.0)
            assert op.pass_rate == 0.5
        rows.append(cat.rows())
    assert rows[0] == rows[1]


def test_cost_catalog_bookkeeping_matches_reference(tmp_path):
    cats = []
    for mod, m in ((tcosts, ops), (jcosts, jops)):
        cat = mod.CostCatalog()
        ex = m.MLLMExtractOp(model="small")
        cat.record("CropOp", 4.0, direct=False)
        cat.record("CropOp", 2.0, 0.5, direct=True, overhead_us=1.0)
        cat.record("CropOp", 9.0, direct=False)      # never clobbers direct
        cat.record_op(ex, 100.0, overhead_us=30.0)
        cat.record_run([ex, m.SinkOp()], 0.5, 250)
        stamped = [m.CropOp(), m.SkipOp(), ex]
        missing = cat.stamp(stamped)
        path = str(tmp_path / f"{mod.__name__}.json")
        cat.save(path)
        back = mod.CostCatalog.load(path)
        cats.append((cat.rows(), back.to_dict() == cat.to_dict(), missing,
                     [(o.cost_us, o.pass_rate, o.overhead_us)
                      for o in stamped], cat.lookup_op(ex),
                     cat.lookup_op_overhead(ex), len(cat),
                     mod.mllm_key("big", (3, 32, 128))))
    assert cats[0] == cats[1]
    assert cats[0][1]


@pytest.fixture(scope="module")
def cpu_ctx(small_models):
    _, tm = small_models
    det = TinyDet(device="cpu").init(
        torch.Generator().manual_seed(DETECTOR_SEED))
    return ops.OpContext(mllm=tm, mllm_small=tm,
                         mllm_pruned=tphysical.structured_prune(tm, 0.5),
                         detector=det, device="cpu")


def test_superoptimizer_optimize_on_cpu(cpu_ctx):
    """All three phases and the calibration run; the plan is valid, keeps
    the extract, carries the cascade (inside a FusedPrefixOp when the
    physical phase fused), and sends no more frames to the MLLM than the
    naive plan."""
    q = get_query("Q8")
    sf = lambda seed: TollBoothStream(seed=seed)  # noqa: E731
    plan, report = SuperOptimizer(cpu_ctx, val_frames=32).optimize(q, sf)
    assert [p["phase"] for p in report.phases] == \
        ["semantic", "logical", "physical"]
    assert set(report.phase_wall_s) == {"semantic", "logical", "physical",
                                        "calibration"}
    assert report.op_timings and "phase: physical" in report.describe()
    assert {r["kind"] for r in report.to_rows()} == {"phase_wall",
                                                     "op_timing"}
    assert isinstance(plan.ops[0], ops.SourceOp)
    assert isinstance(plan.ops[-1], ops.SinkOp)
    mi = plan.index_of(ops.MLLMExtractOp)
    assert mi is not None
    phys = report.phases[2]
    sel = phys["model_selection"]
    assert set(sel["accuracies"]) == {"big", "small", "pruned"}
    assert plan.ops[mi].model == sel["chosen"] and \
        sel["chosen"] in sel["viable"]
    info = phys["fused_prefix"]
    fused = [o for o in plan.ops if isinstance(o, FusedPrefixOp)]
    assert info["fused"] == bool(fused)
    members = fused[0].stage_ops if fused else plan.ops
    assert any(isinstance(o, ops.DetectOp) for o in members)
    assert all(0.0 <= p["validation"][-1]["accuracy"] <= 1.0
               for p in report.phases[:1])
    naive = StreamRuntime(q.naive_plan(), cpu_ctx).run(sf(99), 48)
    optim = StreamRuntime(plan, cpu_ctx).run(sf(99), 48)
    assert optim.n_frames == 48
    assert optim.mllm_frames <= naive.mllm_frames
