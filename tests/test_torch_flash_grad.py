"""flash_attention's gradient on the CPU: the plain version under autograd
against ``jax.vjp`` of the reference's plain attention
(``repro.models.attention.full_attention``, and ``_windowed_full_attention``
for a sliding window), on the same numpy inputs and output gradient; and
at Sq != Sk (cross attention) against ``chunked_bidir_attention``, the
reference's encoder and cross attention.

The port trains through this function on the CPU; on the card the same
gradient comes from the backward kernel (``FlashAttentionFn``), held to
this plain version by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
Tolerance: 2e-5 of each gradient's largest magnitude (fp32 sums of up to
S products in other orders on both sides).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import (_windowed_full_attention,  # noqa: E402
                                    chunked_bidir_attention,
                                    full_attention)

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

TOL = 2e-5

# (S, H, Hk, D, causal, cap, window): causal; bidirectional; cap 50;
# window 4; groups 1, 2 and 4; ragged S
CASES = [
    (16, 4, 2, 16, True, None, None),
    (16, 4, 2, 16, False, None, None),
    (16, 4, 2, 16, True, 50.0, None),
    (16, 4, 2, 16, True, None, 4),
    (12, 2, 2, 32, True, None, None),
    (12, 4, 1, 32, True, None, None),
    (12, 8, 2, 16, True, None, None),
    (13, 4, 2, 16, True, None, None),
    (21, 4, 4, 16, True, 50.0, 4),
]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(causal, cap, window):
    if window is not None:
        return lambda q, k, v: _windowed_full_attention(q, k, v,
                                                        window=window,
                                                        cap=cap)
    return lambda q, k, v: full_attention(q, k, v, causal=causal, cap=cap)


@pytest.mark.parametrize("s,h,hk,d,causal,cap,window", CASES)
def test_plain_gradient_matches_reference(s, h, hk, d, causal, cap, window):
    rs = np.random.RandomState(s * 100 + h * 10 + hk + d)
    q = rs.randn(2, s, h, d).astype(np.float32)
    k = rs.randn(2, s, hk, d).astype(np.float32)
    v = rs.randn(2, s, hk, d).astype(np.float32)
    dout = rs.randn(2, s, h, d).astype(np.float32)

    out_j, vjp = jax.vjp(_reference(causal, cap, window), jnp.asarray(q),
                         jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(dout))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, cap=cap, window=window)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=TOL, rtol=TOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), grads_j):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= TOL * np.abs(want).max(), (name, err)


def test_cpu_tensors_never_take_the_kernel_function():
    """A CPU tensor that requires grad takes the plain version, whose graph
    is autograd's own (no ``FlashAttentionFn`` node)."""
    q = torch.randn(1, 5, 2, 16, requires_grad=True)
    k = torch.randn(1, 5, 1, 16)
    out = flash_attention(q, k, k.clone())
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


# (Sq, Sk, H, Hk, D, cap, q_block): decoder tokens against more frames,
# fewer, a group of 2, a cap, and the reference's q-block scan (Sq a
# multiple of its q_block)
CROSS_CASES = [
    (8, 37, 4, 4, 16, None, 1024),
    (21, 6, 4, 2, 16, None, 1024),
    (12, 40, 8, 2, 32, 30.0, 1024),
    (32, 19, 4, 4, 16, None, 16),
]


@pytest.mark.parametrize("sq,sk,h,hk,d,cap,q_block", CROSS_CASES)
def test_rectangular_gradient_matches_reference(sq, sk, h, hk, d, cap,
                                                q_block):
    """The plain version at Sq != Sk (``causal=False``) and its gradient
    against ``jax.vjp`` of ``chunked_bidir_attention``."""
    rs = np.random.RandomState(sq * 100 + sk)
    q = rs.randn(2, sq, h, d).astype(np.float32)
    k = rs.randn(2, sk, hk, d).astype(np.float32)
    v = rs.randn(2, sk, hk, d).astype(np.float32)
    dout = rs.randn(2, sq, h, d).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda q, k, v: chunked_bidir_attention(q, k, v, cap=cap,
                                                q_block=q_block),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(dout))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=False, cap=cap)
    assert out.shape == (2, sq, h, d)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=TOL, rtol=TOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), grads_j):
        want = np.asarray(want)
        assert got.shape == want.shape
        err = np.abs(got.numpy() - want).max()
        assert err <= TOL * np.abs(want).max(), (name, err)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False,
                                                        window=4)])
def test_rectangular_with_a_mask_raises(kw):
    """A causal mask or a window over queries and keys of different
    lengths has no meaning: the plain version refuses it, as the kernels'
    wrappers do."""
    q, k = torch.zeros(1, 8, 2, 16), torch.zeros(1, 12, 2, 16)
    with pytest.raises(ValueError, match="causal=False and no window"):
        flash_attention(q, k, k, **kw)
