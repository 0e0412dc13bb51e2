"""The whole query catalog through both packages, query by query.

Every one of the 13 queries' naive plans runs on its own dataset
(TollBooth seed 11 for Q1-Q9, Volleyball seed 3 for Q10-Q13), 32 frames in
micro-batches of 8, with the same bridged random MLLM weights in both
packages.  The port's ``RunResult`` must equal the reference's field for
field, and the query's evaluator must score both exactly the same.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.samsara_stream import STREAM_MLLM_CONFIG as JAX_BIG  # noqa: E402
from repro.data import TollBoothStream as JaxTollBooth  # noqa: E402
from repro.data import VolleyballStream as JaxVolleyball  # noqa: E402
from repro.queries import get_query as jax_get_query  # noqa: E402
from repro.queries.catalog import QUERIES as JAX_QUERIES  # noqa: E402
from repro.streaming import operators as jops  # noqa: E402
from repro.streaming.mllm import StreamMLLM as JaxMLLM  # noqa: E402
from repro.streaming.runtime import StreamRuntime as JaxRuntime  # noqa: E402

from repro_torch.bridge import load_reference_params  # noqa: E402
from repro_torch.configs.samsara_stream import STREAM_MLLM_CONFIG  # noqa: E402
from repro_torch.data import TollBoothStream, VolleyballStream  # noqa: E402
from repro_torch.queries.catalog import QUERIES, get_query  # noqa: E402
from repro_torch.streaming import operators as ops  # noqa: E402
from repro_torch.streaming.mllm import StreamMLLM  # noqa: E402
from repro_torch.streaming.runtime import StreamRuntime  # noqa: E402

N_FRAMES, MICRO_BATCH = 32, 8
SEEDS = {"tollbooth": 11, "volleyball": 3}


@pytest.fixture(scope="module")
def contexts():
    jm = JaxMLLM(JAX_BIG, patch=16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = StreamMLLM(STREAM_MLLM_CONFIG, patch=16, device="cpu")
    load_reference_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return (jops.OpContext(mllm=jm, mllm_params=params),
            ops.OpContext(mllm=tm, device="cpu"))


def streams(dataset):
    seed = SEEDS[dataset]
    if dataset == "tollbooth":
        return TollBoothStream(seed=seed), JaxTollBooth(seed=seed)
    return VolleyballStream(seed=seed), JaxVolleyball(seed=seed)


def _same(a, b):
    assert a.n_frames == b.n_frames
    assert a.op_input_counts == b.op_input_counts
    assert a.mllm_frames == b.mllm_frames
    assert a.window_results == b.window_results
    assert a.outputs == b.outputs
    assert a.labels == b.labels


def test_catalog_covers_both_datasets():
    assert list(QUERIES) == list(JAX_QUERIES) == \
        [f"Q{i}" for i in range(1, 14)]
    assert {q.dataset for q in QUERIES.values()} == set(SEEDS)


@pytest.mark.parametrize("qid", list(QUERIES))
def test_naive_plan_and_score_match_reference(contexts, qid):
    jctx, tctx = contexts
    q, jq = get_query(qid), jax_get_query(qid)
    tstream, jstream = streams(q.dataset)
    ref = JaxRuntime(jq.naive_plan(), jctx,
                     micro_batch=MICRO_BATCH).run(jstream, N_FRAMES)
    out = StreamRuntime(q.naive_plan(), tctx,
                        micro_batch=MICRO_BATCH).run(tstream, N_FRAMES)
    assert out.mllm_frames == N_FRAMES
    _same(out, ref)
    score = q.evaluate(out)
    assert score == jq.evaluate(ref)
    assert np.isfinite(score)
