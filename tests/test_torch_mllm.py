"""The port's stream MLLM against the JAX package's, on bridged weights.

Reference parameters come from ``StreamMLLM(cfg, patch=16).init(key)``
(random, untrained: training would run again on every test worker), are
converted to numpy and loaded with ``repro_torch.bridge``.  Logits of every
head agree within the fp32 sum-order drift of the stack: atol = rtol = 1e-4
for the 2-layer small model; 1e-3 for the 4-layer big one, whose random-init
residual stream grows to ~200 so that a relative drift of ~5e-6 per layer
reaches up to 5.1e-4 in the logits (measured over weight seeds 0-3 at all
three frame sizes).  Argmax agrees exactly, which the test makes meaningful
by asserting that the seed's smallest top-2 logit margin is above 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.samsara_stream import (  # noqa: E402
    STREAM_MLLM_CONFIG as JAX_BIG, STREAM_MLLM_SMALL_CONFIG as JAX_SMALL)
from repro.data import TollBoothStream  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.streaming.mllm import StreamMLLM as JaxMLLM  # noqa: E402
from repro.streaming.mllm import make_extract_fn as jax_extract_fn  # noqa: E402

from repro_torch.bridge import flatten, load_reference_params  # noqa: E402
from repro_torch.configs.samsara_stream import (  # noqa: E402
    STREAM_MLLM_CONFIG, STREAM_MLLM_SMALL_CONFIG)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.streaming.mllm import StreamMLLM, make_extract_fn  # noqa: E402

PATCH = 16
TOL = 1e-4
LOGIT_TOL = {"big": 1e-3, "small": 1e-4}
CONFIGS = {"big": (JAX_BIG, STREAM_MLLM_CONFIG, 0),
           "small": (JAX_SMALL, STREAM_MLLM_SMALL_CONFIG, 1)}


def _models(name):
    jcfg, tcfg, seed = CONFIGS[name]
    jm = JaxMLLM(jcfg, patch=PATCH)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tm = StreamMLLM(tcfg, patch=PATCH, device="cpu")
    load_reference_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return {name: _models(name) for name in CONFIGS}


def _frames():
    """Normalized TollBooth frames at the three sizes the plans feed."""
    raw, _ = TollBoothStream(seed=3).batch(40)
    raw = raw[[5, 12, 20, 33]].astype(np.float32)      # cars and road
    x = (raw / 255.0 - 0.5) / 0.25
    crop = x[:, :, 64:128, :]
    half = crop.reshape(4, 3, 32, 2, 128, 2).mean(axis=(3, 5))
    return {"full": x, "crop": crop, "crop/2": half}


FRAMES = _frames()


@pytest.mark.parametrize("size", list(FRAMES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_reference(models, name, size):
    jm, params, tm = models[name]
    x = np.ascontiguousarray(FRAMES[size])
    ref = jax.jit(jm.forward)(params, jnp.asarray(x))
    with torch.inference_mode():
        out = tm(torch.from_numpy(x))
    assert set(out) == set(ref)
    for task, r in ref.items():
        r = np.asarray(r)
        o = out[task].numpy()
        assert o.shape == r.shape, task
        tol = LOGIT_TOL[name]
        np.testing.assert_allclose(o, r, atol=tol, rtol=tol, err_msg=task)
        top2 = np.sort(r, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > 1e-3, task
        np.testing.assert_array_equal(o.argmax(-1), r.argmax(-1))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_extract_fn_per_frame_normalization(models, name):
    """Raw uint8-range and already-normalized rows in one batch: the rule
    is per frame (max > 8), so each row's prediction is its solo one."""
    jm, params, tm = models[name]
    raw, _ = TollBoothStream(seed=3).batch(16)
    raw = raw[[12, 13]].astype(np.float32)
    mixed = np.stack([raw[0], (raw[1] / 255.0 - 0.5) / 0.25])
    ref = jax_extract_fn(jm, params)(jnp.asarray(mixed))
    out = make_extract_fn(tm)(torch.from_numpy(mixed))
    solo = make_extract_fn(tm)(torch.from_numpy(mixed[:1]))
    for task in ref:
        np.testing.assert_array_equal(out[task].numpy(),
                                      np.asarray(ref[task]))
        np.testing.assert_array_equal(out[task][:1].numpy(),
                                      solo[task].numpy())


def test_bridge_takes_shapes_from_arrays(models):
    """A reference tree with a smaller d_ff (a pruned variant) loads as it
    is: shapes come from the arrays, never from the config."""
    _, params, _ = models["big"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    mlp = tree["backbone"]["stack"]["i0"]["mlp"]
    mlp["w_in"], mlp["w_gate"] = mlp["w_in"][..., :384], \
        mlp["w_gate"][..., :384]
    mlp["w_out"] = mlp["w_out"][:, :384]
    tm = StreamMLLM(STREAM_MLLM_CONFIG, patch=PATCH, device="cpu")
    load_reference_params(tm, tree)
    assert tuple(tm.backbone.stack.i0.mlp.w_in.shape) == (4, 256, 384)
    with torch.inference_mode():
        out = tm(torch.from_numpy(np.ascontiguousarray(FRAMES["crop/2"])))
    assert out["plate"].shape == (4, 6, 36)
    names = set(dict(tm.named_parameters()))
    assert names == {k for k in flatten(tree)
                     if not k.startswith("backbone.embed.")}


def test_init_is_seeded_and_keeps_reference_shapes():
    a = StreamMLLM(STREAM_MLLM_CONFIG, patch=PATCH, device="cpu").init(
        torch.Generator().manual_seed(7))
    b = StreamMLLM(STREAM_MLLM_CONFIG, patch=PATCH, device="cpu").init(
        torch.Generator().manual_seed(7))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    ref = jax.eval_shape(lambda k: JaxMLLM(JAX_BIG, patch=PATCH).init(k),
                         jax.random.PRNGKey(0))
    ref = {k: v.shape for k, v in flatten(ref).items()
           if not k.startswith("backbone.embed.")}
    ours = {k: tuple(p.shape) for k, p in a.named_parameters()}
    for k in ("conv1", "conv2"):     # HWIO in the reference, OIHW here
        h, w, i, o = ref[k]
        ref[k] = (o, i, h, w)
    assert ours == ref
    # the reference's init scheme: ones for norms, zeros for conv biases,
    # 1/sqrt(fan_in) for projections
    assert torch.all(a.backbone.final_norm.scale == 1)
    assert torch.all(a.conv1_b == 0)
    std = a.backbone.stack.i0.mlp.w_in.std().item()
    assert abs(std - 256 ** -0.5) < 0.05 * 256 ** -0.5


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def test_rmsnorm_matches_reference():
    x, s = _randn(0, (2, 7, 64)), _randn(1, (64,))
    ref = jax_layers.apply_norm({"scale": jnp.asarray(s)}, jnp.asarray(x),
                                "rmsnorm")
    out = layers.apply_norm(torch.from_numpy(s), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
def test_rope_matches_reference(rotary_pct):
    x = _randn(2, (2, 140, 8, 32))
    pos = np.arange(140)[None, :]
    ref = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                rotary_pct, 1e4)
    out = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            rotary_pct, 1e4)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_gated_mlp_matches_reference():
    x = _randn(3, (2, 9, 64))
    w = {"w_in": _randn(4, (64, 96)), "w_gate": _randn(5, (64, 96)),
         "w_out": _randn(6, (96, 64))}
    ref = jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                               jnp.asarray(x))
    out = layers.apply_mlp(*(torch.from_numpy(w[k])
                             for k in ("w_in", "w_gate", "w_out")),
                           torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("s", [140, 76, 28])
def test_attend_prefill_matches_reference(s):
    att = JAX_BIG.attention
    d = JAX_BIG.d_model
    x = _randn(7, (2, s, d))
    p = {"wq": _randn(8, (d, 8, 32)) / 16, "wk": _randn(9, (d, 4, 32)) / 16,
         "wv": _randn(10, (d, 4, 32)) / 16, "wo": _randn(11, (8, 32, d)) / 16}
    pos = np.arange(s)[None, :]
    ref = jax.jit(jax_attn.attend_prefill, static_argnums=(1, 2),
                  static_argnames=("q_block",))(
        {k: jnp.asarray(v) for k, v in p.items()}, att, 1, jnp.asarray(x),
        jnp.asarray(pos), q_block=256)
    out = attn.attend_prefill({k: torch.from_numpy(v) for k, v in p.items()},
                              STREAM_MLLM_CONFIG.attention,
                              torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)
