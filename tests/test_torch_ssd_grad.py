"""Gradients of the port's chunked SSD (plain versions, on the CPU) against
the JAX package, and the repaired plain version's gradient where the
reference's is not finite.

``kernels/ssd_scan/ref.py`` masks the segment sums above the diagonal
before ``exp``: there they are positive sums of -dt·A (~180 over a chunk
of 256 at mamba2's init), ``exp`` overflows to inf, and the zero gradient
of a ``where`` after it times inf is NaN.  The reference keeps that fault
(``repro.models.ssm._ssd_chunked`` and ``repro.kernels.ssd_scan.ref``), so
parity with ``jax.grad`` is checked at the smoke configs' chunks (16, 32),
where its gradients are finite.  Inputs are made with numpy from a seed.

Tolerances: the ``ssd`` op's gradients within 1e-5 of each one's largest
magnitude (fp32 sums of up to 32 products a term in another order); the
mamba2-smoke loss within 1e-5 and its gradients within 1e-4 of each leaf's
largest |g| (two layers of projections, convolutions and norms in fp32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd as jax_ssd  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import materialize  # noqa: E402

from repro_torch.bridge import flatten, load_reference_lm_params  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

OP_TOL = 1e-5
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def randn(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def softplus(x):
    return np.log1p(np.exp(x)).astype(np.float32)


def kernel_inputs(q, decay, bc=2, h=4, g=2, p=8, n=8, seed=0):
    """x, B, C, cs, dt in kernel layout: dt = softplus(N(0, 1)) (~0.7),
    A = -decay, cs the cumsum of dt·A along the chunk."""
    dt = softplus(randn(seed, (bc, h, 1, q)))
    cs = np.cumsum(-decay * dt, axis=-1).astype(np.float32)
    return [torch.from_numpy(a) for a in (
        randn(seed + 1, (bc, h, q, p)), randn(seed + 2, (bc, g, q, n), 0.3),
        randn(seed + 3, (bc, g, q, n), 0.3), cs, dt)]


def grads_of(fn, args, seed=7):
    """(outputs, gradients) of ``fn`` at seeded output gradients."""
    leaves = [a.clone().requires_grad_(True) for a in args]
    outs = fn(*leaves)
    cots = [torch.from_numpy(randn(seed + i, tuple(o.shape)))
            for i, o in enumerate(outs)]
    torch.autograd.backward(outs, cots)
    return [o.detach() for o in outs], [t.grad for t in leaves]


def _old_ssd_scan_ref(x, bmat, cmat, cs, dt):
    """The plain within-chunk terms as they were before the repair: exp
    of the unmasked segment sums, then the mask."""
    rep = x.shape[1] // bmat.shape[1]
    bh = torch.repeat_interleave(bmat, rep, dim=1)
    ch = torch.repeat_interleave(cmat, rep, dim=1)
    cs2, dt2 = cs[:, :, 0, :], dt[:, :, 0, :]
    seg = cs2[..., :, None] - cs2[..., None, :]
    q = x.shape[2]
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool))
    lmat = torch.where(causal, torch.exp(seg), torch.zeros_like(seg))
    w = torch.einsum("bhin,bhjn->bhij", ch, bh) * lmat * dt2[..., None, :]
    y = torch.einsum("bhij,bhjp->bhip", w, x)
    decay_end = torch.exp(cs2[..., -1:] - cs2) * dt2
    s = torch.einsum("bhqn,bhq,bhqp->bhnp", bh, decay_end, x)
    return y, s


@pytest.mark.parametrize("q,decay", [(256, 1.0), (13, 1.0), (64, 0.01)])
def test_repaired_ssd_scan_ref_forward_is_bit_for_bit_the_old(q, decay):
    args = kernel_inputs(q, decay)
    for got, want in zip(ssd_scan_ref(*args), _old_ssd_scan_ref(*args)):
        assert torch.equal(got, want)


def test_repaired_ssd_scan_ref_gradients_are_finite_past_exp_range():
    """At Q 256 with dt 0.7 and A -1, seg above the diagonal reaches ~178
    (past exp's ~88): the old formula's cs gradient (dt's through the
    cumsum) is NaN, the repaired one's are all finite."""
    bc, h, g, q, p, n = 1, 2, 1, 256, 8, 8
    dt = np.full((bc, h, 1, q), 0.7, np.float32)
    args = [torch.from_numpy(a) for a in (
        randn(1, (bc, h, q, p)), randn(2, (bc, g, q, n)),
        randn(3, (bc, g, q, n)), np.cumsum(-dt, axis=-1).astype(np.float32),
        dt)]
    seg = args[3][..., 0] - args[3][..., -1]
    assert seg.max().item() > 88
    _, old = grads_of(_old_ssd_scan_ref, args)
    assert not torch.isfinite(old[3]).all()
    outs, grads = grads_of(ssd_scan_ref, args)
    for t in outs + grads:
        assert torch.isfinite(t).all()


def _ssd_inputs(b, l, h, p, g, n, seed=0):
    x = randn(seed, (b, l, h, p))
    dt = softplus(randn(seed + 1, (b, l, h)))
    a = -np.exp(randn(seed + 2, (h,), 0.2))
    bm, cm = randn(seed + 3, (b, l, g, n), 0.3), randn(seed + 4,
                                                       (b, l, g, n), 0.3)
    d = 1.0 + randn(seed + 5, (h,), 0.1)
    return x, dt, a, bm, cm, d


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_gradients_match_jax_grad(chunk, g):
    """The whole chunked SSD's gradients in x, dt, A, B, C and D (two
    chunks: the inter-chunk recurrence is differentiated too) against
    ``jax.grad`` of the reference op, within 1e-5 of each one's largest
    magnitude."""
    b, l, h, p, n = 2, 2 * chunk, 4, 8, 8
    arrays = _ssd_inputs(b, l, h, p, g, n)
    wy = randn(11, (b, l, h, p))
    ws = randn(12, (b, h, p, n))

    def jax_loss(*args):
        y, s = jax_ssd(*args, chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(s * ws)

    want = jax.grad(jax_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, s = ssd(*leaves, chunk=chunk)
    (torch.sum(y * torch.from_numpy(wy))
     + torch.sum(s * torch.from_numpy(ws))).backward()
    for name, t, w in zip(("x", "dt", "A", "B", "C", "D"), leaves, want):
        w = np.asarray(w)
        assert np.isfinite(w).all(), name
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= OP_TOL * np.abs(w).max(), (name, err)


def test_mamba2_smoke_loss_and_gradients_match_reference():
    """mamba2-smoke's training loss and every parameter's gradient against
    ``jax.grad`` of the reference ``LM.loss`` on the same weights and
    batch (64 tokens: two chunks of 32)."""
    cfg = jax_smoke_config("mamba2-130m")
    jlm = JaxLM(cfg, tp=1, q_block=16)
    jp = materialize(jlm.spec(), jax.random.PRNGKey(3), jnp.float32)
    tokens = np.random.RandomState(0).randint(0, 512, (2, 64))
    labels = np.random.RandomState(1).randint(0, 512, (2, 64))
    batch = {"tokens": jnp.asarray(tokens, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)}
    jloss, jgrad = jax.value_and_grad(
        lambda p: jlm.loss(p, batch, jnp.float32))(jp)

    lm = LM(smoke_config("mamba2-130m"), device="cpu")
    load_reference_lm_params(lm, jax.tree_util.tree_map(np.asarray, jp))
    for prm in lm.parameters():
        prm.requires_grad_(True)
    loss = lm.loss({"tokens": torch.from_numpy(tokens),
                    "labels": torch.from_numpy(labels)})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    want = flatten(jax.tree_util.tree_map(np.asarray, jgrad))
    got = dict(lm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        assert np.isfinite(g).all(), name
        assert np.abs(g - w).max() <= GRAD_TOL * max(np.abs(w).max(),
                                                     1e-30), name
