"""The port's int8 weight path on the CPU against the JAX package: the
quantization helpers, the int8 product (plain version) against the Pallas
kernel in interpret mode and its jnp oracle, ``matmul_int8_dynamic``,
``tree_size_bytes`` and ``serving/quantize.py`` on chatglm3-smoke.

Inputs are made with numpy from a seed and handed to both packages.  Codes,
scales and stats must be equal bit for bit (the same fp32 divisions and
round-half-to-even on both sides).  The products are held to the reference
sweep's 1e-5, and equality is expected too: the integer sum is exact on
both sides, then converted to fp32 and multiplied by ``sx`` and ``sw`` in
the same order.  Dequantized logits are held to 1e-4, as the LM tests hold
logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.common.utils import tree_size_bytes as jax_tree_size_bytes  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.int8_matmul import ops as jax_ops  # noqa: E402
from repro.kernels.int8_matmul import ref as jax_ref  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import materialize  # noqa: E402
from repro.serving import quantize as jax_quantize  # noqa: E402

from repro_torch.bridge import flatten, load_reference_lm_params  # noqa: E402
from repro_torch.common.utils import tree_size_bytes  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels.int8_matmul.kernel import MAX_K, int8_matmul_cuda  # noqa: E402
from repro_torch.kernels.int8_matmul.ops import (int8_matmul,  # noqa: E402
                                                 matmul_int8_dynamic)
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_plain,  # noqa: E402
                                                 quantize_colwise,
                                                 quantize_rowwise)
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serving import quantize_params_int8  # noqa: E402
from repro_torch.serving.quantize import (MIN_QUANT_SIZE,  # noqa: E402
                                          dequantize_params, is_quant)

TOL = 1e-5
SWEEP = [(128, 256, 128), (256, 512, 256), (64, 128, 512)]
#: a decode tick, a ragged prefill, K and N off every multiple of 16
RAGGED = [(4, 256, 128), (37, 129, 67), (3, 1000, 13), (1, 7, 1)]


def randn(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def quantized(m, k, n, seed=0):
    """(x, w, x_q, sx, w_q, sw) from numpy, quantized by the port."""
    x, w = randn(seed, (m, k)), randn(seed + 1, (k, n))
    x_q, sx = quantize_rowwise(t(x))
    w_q, sw = quantize_colwise(t(w))
    return x, w, x_q, sx, w_q, sw


# ---------------------------------------------------------------------------
# quantization helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 2304), (7, 13), (128, 256)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_reference_bitwise(shape, seed):
    """Codes and scales of both helpers, including values on a rounding
    tie (half-integers times the scale) and an all-zero row / column."""
    x = randn(seed, shape, 3.0)
    x[1] = 0.0
    x[:, 2] = 0.0
    x[3, 3:6] = [127.0, 0.5, -0.5]      # amax 127: scale 1, ties at +-0.5
    for ours, ref in ((quantize_rowwise, jax_ref.quantize_rowwise),
                      (quantize_colwise, jax_ref.quantize_colwise)):
        q, s = ours(t(x))
        jq, js = ref(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# the product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", SWEEP)
def test_int8_matmul_matches_pallas_interpret(m, k, n):
    """The reference sweep's shapes: the plain version against the Pallas
    kernel in interpret mode and its jnp oracle; the quantization error
    against the fp32 product stays within the sweep's 5%."""
    x, w, x_q, sx, w_q, sw = quantized(m, k, n)
    out = int8_matmul(x_q, w_q, sx, sw).numpy()
    args = [jnp.asarray(a.numpy()) for a in (x_q, w_q, sx, sw)]
    pallas = np.asarray(jax_ops.int8_matmul(*args, interpret=True))
    oracle = np.asarray(jax_ref.int8_matmul_ref(*args))
    np.testing.assert_allclose(out, pallas, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(out, pallas)
    np.testing.assert_array_equal(out, oracle)
    exact = x @ w
    assert np.abs(out - exact).max() / np.abs(exact).max() < 0.05


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_int8_matmul_ragged_matches_oracle(m, k, n):
    """Shapes the Pallas wrapper's tiling refuses (M 4, K and N not
    multiples of 16): the plain version against the jnp oracle."""
    _, _, x_q, sx, w_q, sw = quantized(m, k, n, seed=3)
    args = [jnp.asarray(a.numpy()) for a in (x_q, w_q, sx, sw)]
    np.testing.assert_array_equal(int8_matmul(x_q, w_q, sx, sw).numpy(),
                                  np.asarray(jax_ref.int8_matmul_ref(*args)))


def jax_dynamic_eager(x, w_q, sw):
    """The reference's ``matmul_int8_dynamic`` step by step, unjitted."""
    x_q, sx = jax_ref.quantize_rowwise(jnp.asarray(x))
    return np.asarray(jax_ref.int8_matmul_ref(x_q, jnp.asarray(w_q), sx,
                                              jnp.asarray(sw)))


@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (16, 512, 64)])
def test_matmul_int8_dynamic_matches_reference(m, k, n):
    """Within 1e-5 of the reference's jitted op (interpret mode), and
    bitwise equal to its steps run unjitted.  Not bitwise equal to the
    jitted op: XLA computes ``amax / 127.0`` there as ``amax * (1/127)``,
    one ulp off the reference's own eager ``quantize_rowwise`` on some
    rows, and the port keeps the division its source writes."""
    x, w = randn(4, (m, k)), randn(5, (k, n))
    w_q, sw = quantize_colwise(t(w))
    out = matmul_int8_dynamic(t(x), w_q, sw).numpy()
    jw_q, jsw = jax_ref.quantize_colwise(jnp.asarray(w))
    ref = np.asarray(jax_ops.matmul_int8_dynamic(jnp.asarray(x), jw_q, jsw,
                                                 interpret=True))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(out, jax_dynamic_eager(x, w_q.numpy(),
                                                         sw.numpy()))
    exact = x @ w
    assert np.abs(out - exact).max() / np.abs(exact).max() < 0.05


@pytest.mark.parametrize("k", [1040, 1041, 13696])
def test_plain_product_is_exact_past_fp32(k):
    """The worst case, every code +-127: the integer sums pass 2^24 (where
    an fp32 product stops being exact) at K = 1041, and chatglm3-6b's w_out
    has K = 13696.  The plain version equals numpy's int64 product."""
    sign = np.where(np.random.RandomState(k).rand(2, k) < 0.9, 1, -1)
    x_q = (127 * sign[:1]).astype(np.int8)
    w_q = (127 * sign[1][:, None] * np.ones((1, 3))).astype(np.int8)
    acc = x_q.astype(np.int64) @ w_q.astype(np.int64)
    ones = torch.ones(1, 1), torch.ones(1, 3)
    got = int8_matmul_plain(t(x_q), t(w_q), *ones)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.float32))
    assert k <= MAX_K


@given(st.integers(0, 2**31 - 1), st.integers(8, 64), st.integers(8, 64))
@settings(max_examples=10, deadline=None)
def test_int8_matmul_error_bound(seed, m, k):
    """As the reference's property test: random normal operands, the
    quantized product within 8% of the fp32 one (scaled by its largest
    magnitude); and equal to the reference oracle on the same inputs."""
    rs = np.random.RandomState(seed % (2**32 - 1))
    x = rs.standard_normal((m, k)).astype(np.float32)
    w = rs.standard_normal((k, 16)).astype(np.float32)
    x_q, sx = quantize_rowwise(t(x))
    w_q, sw = quantize_colwise(t(w))
    out = int8_matmul_plain(x_q, w_q, sx, sw).numpy()
    ref = x @ w
    assert np.abs(out - ref).max() / (np.abs(ref).max() + 1e-6) < 0.08
    jx, jsx = jax_ref.quantize_rowwise(jnp.asarray(x))
    jw, jsw = jax_ref.quantize_colwise(jnp.asarray(w))
    np.testing.assert_array_equal(
        out, np.asarray(jax_ref.int8_matmul_ref(jx, jw, jsx, jsw)))


# ---------------------------------------------------------------------------
# dispatch and the kernel wrapper's refusals
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_launching():
    before = launch_counts()
    _, _, x_q, sx, w_q, sw = quantized(4, 64, 32)
    int8_matmul(x_q, w_q, sx, sw)
    matmul_int8_dynamic(t(randn(6, (4, 64))), w_q, sw)
    assert launch_counts() == before
    assert before["int8_matmul_f32"] == 0


@pytest.mark.parametrize("bad,match", [
    (dict(x_q=torch.float32), "int8 operands"),
    (dict(sw=torch.float64), "float32"),
    (dict(out_dtype=torch.bfloat16), "writes float32"),
    (dict(shape=(5, 1)), "sx"),
    (dict(), "CUDA")])
def test_kernel_wrapper_refuses(bad, match):
    """Other types, shapes or a CPU tensor raise: there is no fallback from
    the kernel to the plain version."""
    _, _, x_q, sx, w_q, sw = quantized(4, 64, 32)
    if "x_q" in bad:
        x_q = x_q.to(bad["x_q"])
    if "sw" in bad:
        sw = sw.to(bad["sw"])
    if "shape" in bad:
        sx = torch.ones(bad["shape"])
    with pytest.raises(ValueError, match=match):
        int8_matmul_cuda(x_q, w_q, sx, sw,
                         out_dtype=bad.get("out_dtype", torch.float32))


# ---------------------------------------------------------------------------
# serving/quantize.py on chatglm3-smoke
# ---------------------------------------------------------------------------

_MODEL = {}


def chatglm3():
    """(JAX LM, its params, the port's LM with the same weights)."""
    if not _MODEL:
        jlm = JaxLM(jax_smoke_config("chatglm3-6b"), tp=1)
        jp = materialize(jlm.spec(), jax.random.PRNGKey(0), jnp.float32)
        lm = LM(smoke_config("chatglm3-6b"), device="cpu")
        load_reference_lm_params(lm, jax.tree_util.tree_map(np.asarray, jp))
        _MODEL["m"] = (jlm, jp, lm)
    return _MODEL["m"]


def _flat_quant(tree, prefix=""):
    """{dotted path: leaf or quantized dict}."""
    for k, v in tree.items():
        if isinstance(v, dict) and not is_quant(v):
            yield from _flat_quant(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_tree_size_bytes_matches_reference():
    _, jp, lm = chatglm3()
    assert tree_size_bytes(lm.tree()) == jax_tree_size_bytes(jp)
    tree = {"a": np.zeros((3, 5), np.int8), "b": [torch.zeros(2, 2)],
            "c": (torch.zeros(4, dtype=torch.float64), True)}
    assert tree_size_bytes(tree) == 15 + 16 + 32


def test_quantize_params_matches_reference():
    """The same leaves quantized, with equal codes and scales (a stacked
    leaf's scale over every axis but the last), the rest untouched, and
    the same stats."""
    _, jp, lm = chatglm3()
    qp, stats = quantize_params_int8(lm.tree())
    jqp, jstats = jax_quantize.quantize_params_int8(jp)
    assert stats == jstats
    assert stats["ratio"] < 0.35
    ours = dict(_flat_quant(qp))
    ref = dict(_flat_quant(jqp))
    assert sorted(ours) == sorted(ref)
    n_quant = 0
    for key, r in ref.items():
        o = ours[key]
        if jax_quantize._is_quant(r):
            n_quant += 1
            assert is_quant(o), key
            assert o["q"].dtype == torch.int8
            assert o["scale"].shape == (1,) * (o["q"].dim() - 1) + \
                (o["q"].shape[-1],)
            np.testing.assert_array_equal(o["q"].numpy(), np.asarray(r["q"]))
            np.testing.assert_array_equal(o["scale"].numpy(),
                                          np.asarray(r["scale"]))
        else:
            assert not is_quant(o) and (o.dim() < 2
                                        or o.numel() < MIN_QUANT_SIZE), key
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    # the token table, wq/wk/wv/wo and the three MLP weights
    assert n_quant == 8


def test_dequantized_logits_match_reference():
    """Dequantized weights equal the reference's; served through the LM,
    their logits are within 1e-4 of the reference's dequantized logits,
    and keep the fp32 model's top-1 prediction on most positions (as the
    reference's own test asks, > 0.7)."""
    jlm, jp, lm = chatglm3()
    qp, _ = quantize_params_int8(lm.tree())
    dq = dequantize_params(qp)
    jdq = jax_quantize.dequantize_params(jax_quantize.quantize_params_int8(
        jp)[0])
    ref_flat = flatten(jax.tree_util.tree_map(np.asarray, jdq))
    for key, a in flatten(dq).items():
        np.testing.assert_array_equal(a.numpy(), ref_flat[key], err_msg=key)
    tokens = np.arange(64).reshape(2, 32) % lm.cfg.vocab_size
    fp32 = lm.logits_causal(t(tokens)).numpy()
    qlm = LM(lm.cfg, device="cpu")
    qlm.load_state_dict(flatten(dq), assign=True)
    got = qlm.logits_causal(t(tokens)).numpy()
    want, _ = jlm.logits_causal(jdq, {"tokens": jnp.asarray(tokens)},
                                jnp.float32)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    agree = float(np.mean(fp32.argmax(-1) == got.argmax(-1)))
    assert agree > 0.7


def test_quantized_projection_through_the_product():
    """One layer of chatglm3-smoke, as the card runs it: every quantized
    projection's layer slice reshaped to (K, N) (wq's per-head-dim scale
    tiled over the heads, wo's heads folded into K) through
    ``matmul_int8_dynamic``: within 5% of the fp32 product, and equal to
    the reference's dynamic product (unjitted) on the same codes."""
    _, _, lm = chatglm3()
    tree = lm.tree()
    qp, _ = quantize_params_int8(tree)
    x_all = randn(7, (5, 256))
    for name in ("wq", "wk", "wv", "wo"):
        w, qw = tree["stack"]["i0"]["mixer"][name][0], \
            qp["stack"]["i0"]["mixer"][name]
        k = w.shape[0] if name != "wo" else w.shape[0] * w.shape[1]
        w2 = w.reshape(k, -1)
        q2 = qw["q"][0].reshape(k, -1)
        sw = qw["scale"].reshape(1, -1).repeat(1, w2.shape[1]
                                               // qw["scale"].numel())
        x = t(x_all[:, :k].copy())
        out = matmul_int8_dynamic(x, q2, sw).numpy()
        exact = (x @ w2).numpy()
        assert np.abs(out - exact).max() / np.abs(exact).max() < 0.05, name
        np.testing.assert_array_equal(
            out, jax_dynamic_eager(x.numpy(), q2.numpy(), sw.numpy()))
