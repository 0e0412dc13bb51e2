"""The port's stream processor against the JAX package's, record for record.

Both packages run the same plans on the same ``TollBoothStream`` with the
same (bridged, random-init) MLLM weights; outputs, window results, operator
input counts and MLLM load must be equal.  Skip and colour-filter masks must
be exact, so the stream seeds are ones whose statistics keep clear of the
thresholds (Skip's 0.02 activity, the filter's RGB distance 70): the tests
assert a margin above 1e-5 before they compare.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.samsara_stream import STREAM_MLLM_CONFIG as JAX_BIG  # noqa: E402
from repro.data import TollBoothStream as JaxTollBooth  # noqa: E402
from repro.queries import get_query as jax_get_query  # noqa: E402
from repro.streaming import operators as jops  # noqa: E402
from repro.streaming.mllm import StreamMLLM as JaxMLLM  # noqa: E402
from repro.streaming.plan import Plan as JaxPlan  # noqa: E402
from repro.streaming.runtime import StreamRuntime as JaxRuntime  # noqa: E402

from repro_torch.bridge import load_reference_params  # noqa: E402
from repro_torch.configs.samsara_stream import STREAM_MLLM_CONFIG  # noqa: E402
from repro_torch.data import TollBoothStream  # noqa: E402
from repro_torch.data.tollbooth import COLOR_RGB  # noqa: E402
from repro_torch.data.volleyball import VolleyballStream  # noqa: E402
from repro.data import VolleyballStream as JaxVolleyball  # noqa: E402
from repro_torch.queries.catalog import QUERIES, get_query  # noqa: E402
from repro_torch.streaming import operators as ops  # noqa: E402
from repro_torch.streaming.mllm import StreamMLLM  # noqa: E402
from repro_torch.streaming.plan import Plan  # noqa: E402
from repro_torch.streaming.runtime import StreamRuntime  # noqa: E402

N_FRAMES, MICRO_BATCH = 64, 8
SKIP = dict(amount=3, threshold=0.02, regions=(4, 8))
CROP, FACTOR, MIN_FRAC = (64, 0, 64, 256), 2, 0.008


@pytest.fixture(scope="module")
def contexts():
    jm = JaxMLLM(JAX_BIG, patch=16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device="cpu")
    load_reference_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return (jops.OpContext(mllm=jm, mllm_params=params),
            ops.OpContext(mllm=tm, device="cpu"))


def reduced_plan(m, tail=True):
    """Q8's operator chain as the semantic + logical phases build it:
    Skip -> fused crop/downscale/normalize -> red-pixel filter -> extract
    -> Q8's filter (left out with ``tail=False``)."""
    q = (jax_get_query if m is jops else get_query)("Q8")
    chain = [m.SourceOp("tollbooth"), m.SkipOp(**SKIP),
             m.FusedPreprocessOp(crop=CROP, factor=FACTOR),
             m.CheapColorFilterOp("red", min_frac=MIN_FRAC),
             m.MLLMExtractOp(q.tasks, "big")]
    rest = q.tail() if tail else []
    return (JaxPlan if m is jops else Plan)(chain + rest + [m.SinkOp()],
                                            query="Q8")


def _same(a, b):
    assert a.n_frames == b.n_frames
    assert a.op_input_counts == b.op_input_counts
    assert a.mllm_frames == b.mllm_frames
    assert a.window_results == b.window_results
    assert a.outputs == b.outputs
    assert a.labels == b.labels


@pytest.mark.parametrize("qid", ["Q2", "Q8"])
def test_naive_plan_matches_reference(contexts, qid):
    jctx, tctx = contexts
    ref = JaxRuntime(jax_get_query(qid).naive_plan(), jctx,
                     micro_batch=MICRO_BATCH).run(JaxTollBooth(seed=11),
                                                  N_FRAMES)
    out = StreamRuntime(get_query(qid).naive_plan(), tctx,
                        micro_batch=MICRO_BATCH).run(TollBoothStream(seed=11),
                                                     N_FRAMES)
    assert out.mllm_frames == N_FRAMES
    _same(out, ref)


@pytest.mark.parametrize("seed", [11, 3])
def test_reduced_q8_plan_matches_reference(contexts, seed):
    """Seed 11 (the naive plans' stream) skips every frame of its first 64;
    seed 3 sends most of them through all five operators."""
    jctx, tctx = contexts
    ref = JaxRuntime(reduced_plan(jops), jctx, micro_batch=MICRO_BATCH).run(
        JaxTollBooth(seed=seed), N_FRAMES)
    out = StreamRuntime(reduced_plan(ops), tctx,
                        micro_batch=MICRO_BATCH).run(TollBoothStream(seed=seed),
                                                     N_FRAMES)
    _same(out, ref)
    if seed == 3:
        assert 0 < out.mllm_frames < N_FRAMES


def test_extracted_records_match_reference(contexts):
    """Q8's filter passes nothing under random weights, so the plans'
    outputs above are empty; without it every extracted record (present,
    color, plate per frame) reaches the sink and is compared."""
    jctx, tctx = contexts
    ref = JaxRuntime(reduced_plan(jops, tail=False), jctx,
                     micro_batch=MICRO_BATCH).run(JaxTollBooth(seed=3),
                                                  N_FRAMES)
    out = StreamRuntime(reduced_plan(ops, tail=False), tctx,
                        micro_batch=MICRO_BATCH).run(TollBoothStream(seed=3),
                                                     N_FRAMES)
    assert len(out.outputs) == out.mllm_frames > 0
    assert {"present", "color", "plate"} <= set(out.outputs[0])
    _same(out, ref)


@pytest.mark.parametrize("seed", [11, 3])
def test_stream_frames_match_reference(seed):
    """The port's own copy of the synthetic streams is byte-identical."""
    a, la = TollBoothStream(seed=seed).batch(96)
    b, lb = JaxTollBooth(seed=seed).batch(96)
    assert a.dtype == b.dtype and np.array_equal(a, b) and la == lb
    a, la = VolleyballStream(seed=seed).batch(32)
    b, lb = JaxVolleyball(seed=seed).batch(32)
    assert a.dtype == b.dtype and np.array_equal(a, b) and la == lb


def _batches(seed, n=N_FRAMES):
    frames, _ = TollBoothStream(seed=seed).batch(n)
    return [frames[i:i + MICRO_BATCH] for i in range(0, n, MICRO_BATCH)]


@pytest.mark.parametrize("seed", [11, 3])
def test_skip_masks_exact(seed):
    batches = _batches(seed)
    allf = np.concatenate(batches)
    d = np.abs(allf[1:].astype(np.float32) - allf[:-1].astype(np.float32))
    act = d.reshape(len(d), 3, 4, 32, 8, 32).mean(axis=(1, 3, 5)) / 255.0
    act = act.reshape(len(d), -1).max(axis=1)
    assert np.abs(act - SKIP["threshold"]).min() > 1e-5
    jop, top = jops.SkipOp(**SKIP), ops.SkipOp(**SKIP)
    jop.open(None)
    top.open(ops.OpContext(device="cpu"))
    for i, fr in enumerate(batches):
        idx = np.arange(i * MICRO_BATCH, i * MICRO_BATCH + len(fr))
        a = top.process({"frames": fr, "idx": idx})
        b = jop.process({"frames": fr, "idx": idx})
        np.testing.assert_array_equal(a["idx"], b["idx"])


@pytest.mark.parametrize("seed", [11, 3])
def test_color_filter_masks_exact(seed):
    """On the fused-preprocessed (normalized) road crop, as in the reduced
    plan, and on raw frames: the per-frame raw/normalized rule."""
    jpre = jops.FusedPreprocessOp(crop=CROP, factor=FACTOR)
    tpre = ops.FusedPreprocessOp(crop=CROP, factor=FACTOR)
    tctx = ops.OpContext(device="cpu")
    jpre.open(None)
    tpre.open(tctx)
    rgb = np.asarray(COLOR_RGB["red"], np.float32)
    jf = jops.CheapColorFilterOp("red", min_frac=MIN_FRAC)
    tf = ops.CheapColorFilterOp("red", min_frac=MIN_FRAC)
    jf.open(None)
    tf.open(tctx)
    for i, fr in enumerate(_batches(seed)):
        idx = np.arange(len(fr))
        tb = tpre.process({"frames": fr, "idx": idx})
        jb = jpre.process({"frames": fr, "idx": idx})
        np.testing.assert_allclose(tb["frames"], jb["frames"], atol=1e-5,
                                   rtol=1e-5)
        for frames in (tb["frames"], fr):
            x = frames.astype(np.float64)
            if frames.dtype != np.uint8:
                x = (x * 0.25 + 0.5) * 255.0
            dist = np.linalg.norm(x.transpose(0, 2, 3, 1) - rgb, axis=-1)
            assert np.abs(dist - 70.0).min() > 1e-5
            a = tf.process({"frames": frames, "idx": idx})
            b = jf.process({"frames": frames, "idx": idx})
            np.testing.assert_array_equal(a["idx"], b["idx"])


def test_catalog_has_every_query():
    from repro.queries.catalog import QUERIES as JAX_QUERIES

    assert list(QUERIES) == list(JAX_QUERIES)
    for qid, q in QUERIES.items():
        jq = JAX_QUERIES[qid]
        assert (q.dataset, q.tasks) == (jq.dataset, jq.tasks)
        assert [op.signature() for op in q.naive_plan().ops] == \
            [op.signature() for op in jq.naive_plan().ops]


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device argument the port asks for CUDA and raises where
    there is none; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ops.OpContext()
    with pytest.raises(RuntimeError, match="cuda"):
        StreamMLLM(STREAM_MLLM_CONFIG, patch=16)
    with pytest.raises(RuntimeError, match="cuda"):
        StreamRuntime(get_query("Q2").naive_plan())


def test_snapshot_restore_continues_exactly(contexts):
    """Aligned checkpoint: a run cut after 32 frames, snapshotted and
    restored into a fresh runtime, ends as the uninterrupted run does
    (Skip state, window buffers and the source offset carry over)."""
    _, tctx = contexts

    def plan():
        p = get_query("Q6").naive_plan()
        return p.insert_after_source(ops.SkipOp(**SKIP))

    full = StreamRuntime(plan(), tctx, micro_batch=MICRO_BATCH).run(
        TollBoothStream(seed=3), N_FRAMES)
    stream = TollBoothStream(seed=3)
    rt = StreamRuntime(plan(), tctx, micro_batch=MICRO_BATCH)
    first = rt.run(stream, 32, warmup=0, flush=False)
    rt2 = StreamRuntime(plan(), tctx, micro_batch=MICRO_BATCH)
    rt2.restore(rt.snapshot())
    second = rt2.run(stream, 32)
    assert first.outputs + second.outputs == full.outputs
    assert second.window_results == full.window_results
    assert first.mllm_frames + second.mllm_frames == full.mllm_frames


def _attrs(seed, n):
    r = np.random.RandomState(seed)
    return {"present": r.randint(0, 2, n), "color": r.randint(0, 6, n),
            "brand": r.randint(0, 6, n), "plate": r.randint(0, 36, (n, 6)),
            "action": r.randint(0, 4, n), "n_jumping": r.randint(0, 7, n)}


@pytest.mark.parametrize("kind", ["top_color", "top_brand",
                                  "top_brand_color", "count_distinct_plates",
                                  "repeated_plates", "count_jumping",
                                  "top_team", "top3_actions"])
def test_window_and_filter_ops_match_reference(kind):
    """The relational tail on synthetic extracted attributes (the MLLM's
    random weights leave Q8's filter and the windows all but empty)."""
    attrs = _attrs(5, 96)
    attrs["plate"][::7, :3] = [2, 19, 19]           # "CTT..." repeats
    preds = [("and", ("eq", "present", 1), ("eq", "color", "red")),
             ("or", ("ge", "n_jumping", 3), ("eq", "action", "spike")),
             ("prefix", "plate", "CTT")]
    jw, tw = jops.WindowAggOp(kind, 32), ops.WindowAggOp(kind, 32)
    jfs, tfs = [jops.FilterOp(p) for p in preds], \
        [ops.FilterOp(p) for p in preds]
    for lo in range(0, 90, 12):                      # ragged last batch
        idx = np.arange(lo, min(lo + 12, 90))
        batch = {"frames": np.zeros((len(idx), 1, 1, 1), np.float32),
                 "idx": idx, "attrs": {k: v[idx] for k, v in attrs.items()}}
        for jf, tf in zip(jfs, tfs):
            np.testing.assert_array_equal(tf.process(batch)["idx"],
                                          jf.process(batch)["idx"])
        a, b = tw.process(batch), jw.process(batch)
        assert a.get("window_results") == b.get("window_results")
    assert tw.flush()["window_results"] == jw.flush()["window_results"]


def test_pixel_ops_match_reference():
    frames, _ = TollBoothStream(seed=3).batch(8)
    batch = {"frames": frames, "idx": np.arange(8)}
    for jop, top in ((jops.CropOp((32, 64, 64, 128)),
                      ops.CropOp((32, 64, 64, 128))),
                     (jops.DownscaleOp(4), ops.DownscaleOp(4)),
                     (jops.GreyscaleOp(), ops.GreyscaleOp())):
        for b in (batch, {"frames": frames.astype(np.float32) / 255.0,
                          "idx": batch["idx"]}):
            a, r = top.process(b)["frames"], jop.process(b)["frames"]
            assert a.dtype == r.dtype and np.array_equal(a, r)


def test_adaptive_variant_resolution_matches_reference():
    jop = jops.MLLMExtractOp(model="adaptive")
    top = ops.MLLMExtractOp(model="adaptive")
    jop._micro_batch_hint = top._micro_batch_hint = 16
    for n in (16, 2, 0, 1, 0, 0, 9, 16, 16, 3):
        assert top.begin_extract(n) == jop.begin_extract(n)
    assert top.frames_processed == jop.frames_processed
