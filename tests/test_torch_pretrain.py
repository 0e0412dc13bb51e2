"""The port's stream-model pretraining against the JAX package's.

Both packages get the same inputs: the synthetic streams are numpy (the
port's copy draws the reference's numbers) and the weights are the
reference's seeded init, bridged.  Held:
  * ``_make_mllm_batches`` and the distillation batches equal to the
    reference's (frames and labels exactly; the teacher's logits within
    the big MLLM's 1e-3);
  * ``StreamMLLM.loss`` of the small model within 1e-4 relative,
    ``TinyDet.loss`` and the distillation loss within 1e-4; the big
    model's gradients within 1e-3 of each leaf's largest |g| (the big
    MLLM's logit tolerance: its residual stream reaches ~200 at init);
  * a short ``train_stream_models`` run on the CPU: its cache reloads bit
    for bit and its weights, read back out in the reference's layout, give
    the JAX package the port's logits.
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.samsara_stream import (  # noqa: E402
    STREAM_MLLM_CONFIG as JAX_BIG, STREAM_MLLM_SMALL_CONFIG as JAX_SMALL)
from repro.data import TollBoothStream as JaxTollBooth  # noqa: E402
from repro.data import VolleyballStream as JaxVolleyball  # noqa: E402
from repro.streaming import pretrain as jpre  # noqa: E402
from repro.streaming.detector import TinyDet as JaxTinyDet  # noqa: E402
from repro.streaming.mllm import StreamMLLM as JaxMLLM  # noqa: E402
from repro.streaming.mllm import distill_loss as jax_distill_loss  # noqa: E402

from repro_torch.bridge import (flatten, load_reference_detector_params,  # noqa: E402
                                load_reference_opt_state,
                                load_reference_params, reference_params)
from repro_torch.configs.samsara_stream import (  # noqa: E402
    STREAM_MLLM_CONFIG, STREAM_MLLM_SMALL_CONFIG)
from repro_torch.streaming import pretrain as tpre  # noqa: E402
from repro_torch.streaming.detector import TinyDet  # noqa: E402
from repro_torch.streaming.mllm import StreamMLLM  # noqa: E402

PATCH = 16


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """name -> (reference model, its params, the port's bridged model)."""
    out = {}
    for name, jcfg, tcfg, seed in (("big", JAX_BIG, STREAM_MLLM_CONFIG, 0),
                                   ("small", JAX_SMALL,
                                    STREAM_MLLM_SMALL_CONFIG, 1)):
        jm = JaxMLLM(jcfg, patch=PATCH)
        params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
        tm = StreamMLLM(tcfg, patch=PATCH, device="cpu")
        load_reference_params(tm, np_tree(params))
        out[name] = (jm, params, tm)
    jd = JaxTinyDet()
    dparams = jd.init(jax.random.PRNGKey(2))
    td = load_reference_detector_params(TinyDet(device="cpu"),
                                        np_tree(dparams))
    out["det"] = (jd, dparams, td)
    return out


def _assert_batch_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)


def test_mllm_batches_equal_reference():
    ref = jpre._make_mllm_batches(5, batch=4)
    port = tpre._make_mllm_batches(5, batch=4, device="cpu")
    for i in range(6):                # every mode: booth, crops, volleyball
        _assert_batch_equal(port(i), ref(i))


def test_distill_batches_equal_reference(models):
    """The reference builds them inside ``train_stream_models``; its draws
    are replayed here with its own streams and functions."""
    jm, params, tm = models["big"]
    seed = 4
    tb = JaxTollBooth(seed=seed + 7, car_rate=0.04)
    vb = JaxVolleyball(seed=seed + 7)
    port = tpre._make_distill_batches(seed, tm, device="cpu")
    for i in range(3):
        if i % 3 < 2:
            frames, labels = tb.booth_batch(16) if i % 3 == 0 \
                else tb.batch(16)
            x = jpre.preprocess_np(frames, jpre.CROP, 2)
            enc = jpre.encode_tollbooth_labels(labels)
        else:
            frames, labels = vb.batch(16)
            x = jpre.preprocess_np(frames, None, 2)
            enc = jpre.encode_volleyball_labels(labels)
        got = port(i)
        teacher = got.pop("teacher")
        _assert_batch_equal(got, {"frames": x, **enc})
        want = jax.jit(jm.forward)(params, jnp.asarray(x))
        for k, w in want.items():
            np.testing.assert_allclose(teacher[k].numpy(), np.asarray(w),
                                       atol=1e-3, rtol=1e-3, err_msg=k)


def _booth_batch(seed=9, n=4):
    frames, labels = JaxTollBooth(seed=seed).booth_batch(n)
    enc = jpre.encode_tollbooth_labels(labels)
    enc["mask_car"][0] = 0.0              # one frame without a readable car
    return {"frames": jpre.preprocess_np(frames, jpre.CROP, 2), **enc}


def _volley_batch(seed=9, n=4):
    frames, labels = JaxVolleyball(seed=seed).batch(n)
    return {"frames": jpre.preprocess_np(frames, None, 2),
            **jpre.encode_volleyball_labels(labels)}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("which", ["booth", "volleyball"])
def test_small_mllm_loss_matches_reference(models, which):
    jm, params, tm = models["small"]
    batch = _booth_batch() if which == "booth" else _volley_batch()
    want = float(jax.jit(jm.loss)(params,
                                  jax.tree_util.tree_map(jnp.asarray, batch)))
    got = float(tm.loss(_torch(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_big_mllm_gradients_match_reference(models):
    jm, params, tm = models["big"]
    batch = _booth_batch(n=2)
    want = flatten(np_tree(jax.jit(jax.grad(jm.loss))(
        params, jax.tree_util.tree_map(jnp.asarray, batch))))
    ours = dict(tm.named_parameters())
    for p in ours.values():
        p.requires_grad_(True)
    try:
        tm.loss(_torch(batch)).backward()
    finally:
        for p in ours.values():
            p.requires_grad_(False)
    for name, p in ours.items():
        w = want[name]
        if name in ("conv1", "conv2"):
            w = w.transpose(3, 2, 0, 1)           # HWIO -> OIHW
        # a head the batch has no labels for gets no gradient here, zeros
        # there
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.abs(g - w).max()
        assert err <= 1e-3 * np.abs(w).max(), (name, err)
        p.grad = None


def test_tinydet_loss_matches_reference(models):
    jd, dparams, td = models["det"]
    frames, labels = JaxTollBooth(seed=13, car_rate=0.3).batch(8)
    batch = {"frames": jpre.preprocess_np(frames, jpre.CROP, 2),
             "present": np.asarray([int(l["car_present"]) for l in labels],
                                   np.int32)}
    want = float(jd.loss(dparams, jax.tree_util.tree_map(jnp.asarray,
                                                         batch)))
    np.testing.assert_allclose(float(td.loss(_torch(batch))), want,
                               rtol=1e-4)


def test_distill_loss_matches_reference(models):
    jm, params, _ = models["big"]
    js, sparams, ts = models["small"]
    batch = _booth_batch()
    t_out = jax.jit(jm.forward)(params, jnp.asarray(batch["frames"]))

    @jax.jit
    def reference(sparams, t_out, batch):
        return jax_distill_loss(js, t_out, sparams, batch["frames"]) \
            + 0.5 * js.loss(sparams, batch)

    want = reference(sparams, t_out,
                     jax.tree_util.tree_map(jnp.asarray, batch))
    tb = _torch(batch)
    tb["teacher"] = {k: torch.tensor(np.asarray(v))
                     for k, v in t_out.items()}
    got = tpre.distill_loss(ts, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_conv_moments_bridge_transposed_and_int8_refused(models):
    _, params, tm = models["small"]
    rs = np.random.RandomState(0)
    m = jax.tree_util.tree_map(
        lambda p: {"m": rs.randn(*p.shape).astype(np.float32),
                   "v": rs.rand(*p.shape).astype(np.float32)},
        np_tree(params))
    state = load_reference_opt_state(tm, {"moments": m, "step": 3})
    np.testing.assert_array_equal(
        state["moments"]["conv1"]["m"].numpy(),
        m["conv1"]["m"].transpose(3, 2, 0, 1))
    assert int(state["step"]) == 3
    m["conv1"] = {"m_q": np.zeros((3, 3, 3, 48), np.int8)}
    with pytest.raises(ValueError, match="conv"):
        load_reference_opt_state(tm, {"moments": m, "step": 3})


def test_short_pretrain_cache_and_reference_readout():
    """Three MLLM steps, two distillation steps, two TinyDet steps on the
    CPU; the cache reloads bit for bit; the trained weights, read out in
    the reference's layout, give the JAX package the port's logits."""
    stats = {}
    with tempfile.TemporaryDirectory() as d:
        ctx = tpre.train_stream_models(steps_mllm=3, steps_small=2,
                                       steps_det=2, cache_dir=d,
                                       device="cpu", verbose=False,
                                       stats=stats)
        again = tpre.train_stream_models(cache_dir=d, device="cpu",
                                         verbose=False)
    assert [len(stats[k]["losses"]) for k in ("mllm", "distill",
                                               "tinydet")] == [3, 2, 2]
    assert all(np.isfinite(v["losses"]).all() and v["seconds"] > 0
               for v in stats.values())
    for a, b in ((ctx.mllm, again.mllm), (ctx.mllm_small, again.mllm_small),
                 (ctx.mllm_pruned, again.mllm_pruned),
                 (ctx.detector, again.detector)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert not any(p.requires_grad for p in b.parameters())
    assert not any(p.requires_grad for p in ctx.mllm.parameters())
    assert ctx.mllm_pruned.cfg.d_ff == STREAM_MLLM_CONFIG.d_ff // 2

    frames = _booth_batch()["frames"]
    js = JaxMLLM(JAX_SMALL, patch=PATCH)
    want = jax.jit(js.forward)(reference_params(ctx.mllm_small),
                               jnp.asarray(frames))
    with torch.no_grad():
        got = ctx.mllm_small(torch.from_numpy(frames))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    jd = JaxTinyDet()
    want = jd.forward(reference_params(ctx.detector), jnp.asarray(frames))
    with torch.no_grad():
        got = ctx.detector(torch.from_numpy(frames))
    np.testing.assert_allclose(got["present"].numpy(),
                               np.asarray(want["present"]), atol=1e-4,
                               rtol=1e-4)


def test_distill_loss_runs_the_student_once(models):
    """One forward of the student feeds both the KL term and its
    supervised loss; ``StreamMLLM.loss(batch, out=...)`` equals the loss
    that runs its own forward."""
    jm, params, _ = models["big"]
    _, _, ts = models["small"]
    batch = _booth_batch()
    t_out = jax.jit(jm.forward)(params, jnp.asarray(batch["frames"]))
    tb = _torch(batch)
    tb["teacher"] = {k: torch.tensor(np.asarray(v))
                     for k, v in t_out.items()}
    calls = []
    forward = ts.forward
    ts.forward = lambda frames: calls.append(1) or forward(frames)
    try:
        tpre.distill_loss(ts, tb)
        assert len(calls) == 1
        sup = {k: v for k, v in tb.items() if k != "teacher"}
        with torch.no_grad():
            assert float(ts.loss(sup, out=forward(sup["frames"]))) == \
                float(ts.loss(sup))
    finally:
        del ts.forward
