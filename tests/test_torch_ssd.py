"""The port's chunked SSD and Mamba2 mixer (plain versions, on the CPU)
against the JAX package: its Pallas ``ssd_scan`` kernel in interpret mode,
its ``ssd`` op, its model's ``_ssd_chunked`` and a sequential recurrence.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance 1e-4, the reference sweep's (tests/test_kernels.py): the
within-chunk terms sum up to 256 products of order 1 in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.config import SSMConfig as JaxSSMConfig  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_scan_kernel  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd as jax_ssd  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402

from repro_torch.common.config import SSMConfig  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = 1e-4
# one compiled program per shape is cheaper than op-by-op eager dispatch
_prefill_jit = jax.jit(jax_ssm.mamba_prefill_with_cache, static_argnums=(1, 2))
_decode_jit = jax.jit(jax_ssm.mamba_decode, static_argnums=(1, 2))


def randn(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


def inputs(b, l, h, p, g, n):
    x = randn(0, (b, l, h, p))
    dt = softplus(randn(1, (b, l, h)))
    a = -np.exp(randn(2, (h,), 0.2))
    bm, cm = randn(3, (b, l, g, n), 0.3), randn(4, (b, l, g, n), 0.3)
    return x, dt, a, bm, cm, np.ones((h,), np.float32)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


# the reference sweep's shapes, plus one ragged chunk (an exact-length
# prefill of 13 tokens is one chunk of Q = 13) and Mamba2-130m's head
# layout over one short chunk
SHAPES = [(2, 128, 4, 16, 2, 8, 32), (1, 64, 2, 32, 1, 16, 16),
          (2, 256, 8, 16, 4, 8, 64), (1, 13, 4, 16, 2, 8, 13),
          (1, 13, 24, 64, 1, 128, 13)]


@pytest.mark.parametrize("b,l,h,p,g,n,q", SHAPES)
def test_ssd_matches_reference(b, l, h, p, g, n, q):
    args = inputs(b, l, h, p, g, n)
    y, s = ssd(*map(torch.from_numpy, args), chunk=q)
    jargs = list(map(jnp.asarray, args))
    y0, s0 = jax_ssm._ssd_chunked(*jargs, q)
    close(y.numpy(), y0)
    close(s.numpy(), s0)
    y1, s1 = jax_ssd(*jargs, chunk=q, interpret=True)
    close(y.numpy(), y1)
    close(s.numpy(), s1)


@pytest.mark.parametrize("bc,h,g,q,p,n", [(4, 4, 2, 32, 16, 8),
                                          (2, 8, 4, 64, 16, 8),
                                          (1, 24, 1, 13, 64, 128)])
def test_within_chunk_terms_match_pallas_kernel(bc, h, g, q, p, n):
    """Kernel layout: the plain version against the Pallas kernel in
    interpret mode and its jnp oracle."""
    x = randn(5, (bc, h, q, p))
    bm, cm = randn(6, (bc, g, q, n), 0.3), randn(7, (bc, g, q, n), 0.3)
    dt = softplus(randn(8, (bc, h, 1, q)))
    a = -np.exp(randn(9, (h,), 0.2))
    cs = np.cumsum(dt * a[None, :, None, None], axis=-1).astype(np.float32)
    y, s = ssd_scan_ref(*map(torch.from_numpy, (x, bm, cm, cs, dt)))
    jargs = list(map(jnp.asarray, (x, bm, cm, cs, dt)))
    for yw, sw in (ssd_scan_kernel(*jargs, n_groups=g, interpret=True),
                   jax_ssd_scan_ref(*jargs, n_groups=g)):
        close(y.numpy(), yw)
        close(s.numpy(), sw)


@pytest.mark.parametrize("q", [16, 64])
def test_ssd_matches_sequential_recurrence(q):
    b, l, h, p, g, n = 1, 64, 2, 8, 1, 4
    x, dt, a, bm, cm, d = inputs(b, l, h, p, g, n)
    y, state = ssd(*map(torch.from_numpy, (x, dt, a, bm, cm, d)), chunk=q)
    bh, ch = np.repeat(bm, h // g, 2), np.repeat(cm, h // g, 2)
    st = np.zeros((b, h, n, p))
    ys = np.zeros((b, l, h, p))
    for t in range(l):
        da = np.exp(dt[:, t] * a)
        st = da[:, :, None, None] * st + (
            dt[:, t][:, :, None, None] * bh[:, t][:, :, :, None]
            * x[:, t][:, :, None, :])
        ys[:, t] = np.einsum("bhn,bhnp->bhp", ch[:, t], st) + x[:, t]
    close(y.numpy(), ys)
    close(state.numpy(), np.swapaxes(st, -1, -2))


SMOKE = dict(d_state=16, d_conv=4, head_dim=16, expand=2, n_groups=1,
             chunk=32)


def _mamba_params(d_model):
    """Random Mamba2 weights in the reference's layout (non-trivial A, dt
    bias, conv biases)."""
    spec = ssm.mamba_spec(d_model, SSMConfig(**SMOKE))
    out = {}
    for i, (name, s) in enumerate(sorted(spec.items())):
        scale = {"A_log": 0.5, "dt_bias": 0.5}.get(name, 0.2)
        out[name] = randn(30 + i, s.shape, scale)
    return out


@pytest.mark.parametrize("length", [13, 32, 64])
def test_mamba_prefill_and_decode_match_reference(length):
    """The mixer's prefill with cache (the SSD kernel's path) and three
    decode steps after it, against the JAX mixer."""
    d_model = 64
    p = _mamba_params(d_model)
    x = randn(50, (2, length + 3, d_model))
    jcfg = JaxSSMConfig(**SMOKE)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    y0, jcache = _prefill_jit(jp, jcfg, 1, jnp.asarray(x[:, :length]))
    cache = {k: torch.zeros(s) for k, s in ssm.mamba_decode_cache_spec(
        d_model, SSMConfig(**SMOKE), 2).items()}
    y = ssm.mamba_prefill_with_cache(tp, SSMConfig(**SMOKE),
                                     torch.from_numpy(x[:, :length]), cache)
    close(y.numpy(), y0)
    for k in cache:
        close(cache[k].numpy(), jcache[k])
    close(ssm.mamba_prefill(tp, SSMConfig(**SMOKE),
                            torch.from_numpy(x[:, :length])).numpy(), y0)
    for t in range(length, length + 3):
        y0, jcache = _decode_jit(jp, jcfg, 1, jnp.asarray(x[:, t:t + 1]),
                                 jcache)
        y = ssm.mamba_decode(tp, SSMConfig(**SMOKE),
                             torch.from_numpy(x[:, t:t + 1]), cache)
        close(y.numpy(), y0)


@pytest.mark.parametrize("length", [40, 300])
def test_mamba_prefill_refuses_what_the_reference_cannot_compute(length):
    """The reference reshapes by L // chunk: it computes lengths up to one
    chunk or whole chunks only.  The port says so instead of computing
    something the reference cannot."""
    cfg = SSMConfig(**SMOKE) if length == 40 else SSMConfig()
    d_model = 64
    tp = {k: torch.from_numpy(v) for k, v in _mamba_params(d_model).items()}
    if length == 300:
        tp = {k: torch.zeros(s.shape) for k, s in
              ssm.mamba_spec(d_model, cfg).items()}
    with pytest.raises(ValueError, match="multiples"):
        ssm.mamba_prefill(tp, cfg, torch.zeros(1, length, d_model))
