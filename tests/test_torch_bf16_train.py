"""``LM.loss(batch, dtype=torch.bfloat16)``'s gradients on the CPU against
``jax.grad`` of the reference's loss at bf16, for the smoke configs of
chatglm3 (GQA), gemma2 (attention soft-cap 50 and a window of 16, shorter
than the sequence), moonshot (MoE), mamba2 (SSD) and seamless (an encoder
and cross attention).

The reference's ``LM.loss(params, batch, jnp.bfloat16)`` is the loss its
dry run differentiates: fp32 parameters, each matmul weight cast at use,
fp32 gradients.  bf16 rounds at other places in XLA (which keeps fused
intermediates in fp32) and in PyTorch (which rounds every op), so the two
bf16 gradients are not held to a fixed tolerance.  The witness is the
reference's own distance between its bf16 and its fp32 gradient of each
leaf: the port's bf16 gradient must be no farther from the reference's
fp32 gradient than twice that distance (or one bf16 ulp of the leaf's
largest |g|, where the witness is smaller), as
``tests/test_torch_bf16.py`` holds the bf16 logits.  (Measured: at most
1.83 times the witness, mamba2's ``D``.)  It must also lie within three
times the witness of the reference's bf16 gradient, the bound the
triangle inequality gives (measured: at most 2.18 times it, mamba2's
``D``, two bf16 computations that round at different places).  The
losses agree within 3e-2, the reference sweep's bf16 tolerance, and the
port's bf16 loss and gradients differ from its own fp32 run's: a port
that computed in fp32 whatever the dtype would pass the distances from
the fp32 gradient, and fails here.

Two port-only properties of the bf16 step: ``layers.cast_matmul`` (the
weight cast inside the product's autograd function) keeps plain
autograd's bits and saves no bf16 copy of the weight, and
``LM.loss(..., remat=True)`` keeps the loss and gradients bit for bit.

Weights follow the reference's init scheme (``ParamSpec.init``: fan-in
normals, small normals, zeros, ones), drawn with numpy from a seed and
carried across by ``repro_torch.bridge``, as are tokens, labels and
frames.  Torch runs on one thread.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models.param import ParamSpec  # noqa: E402

from repro_torch.bridge import flatten, load_reference_lm_params  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

ARCHS = ["chatglm3-6b", "gemma2-2b", "moonshot-v1-16b-a3b", "mamba2-130m",
         "seamless-m4t-medium"]
B, S, T = 2, 32, 12
WITNESS = 2.0
#: the bound on the distance from the reference's bf16 gradient: the
#: witness plus WITNESS times it (the triangle inequality)
WITNESS_BF16 = 3.0
ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(spec, rs):
    """The reference's ``materialize`` scheme in numpy, leaf by leaf in
    tree order."""
    if isinstance(spec, ParamSpec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        std = {"small": 0.02 * spec.scale, "normal": spec.scale}.get(
            spec.init, spec.scale / np.sqrt(max(
                spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1],
                1)))
        return (std * rs.standard_normal(spec.shape)).astype(np.float32)
    return {k: _init(v, rs) for k, v in sorted(spec.items())}


def _batch(cfg):
    rs = np.random.RandomState(11)
    out = {"tokens": rs.randint(2, cfg.vocab_size, (B, S)),
           "labels": rs.randint(0, cfg.vocab_size, (B, S))}
    if cfg.encoder_decoder:
        out["frames"] = rs.standard_normal((B, T, cfg.d_model)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_gradients_match_reference(arch):
    jcfg = jax_smoke_config(arch)
    jlm = JaxLM(jcfg, tp=1, q_block=16)
    params_np = _init(jlm.spec(), np.random.RandomState(0))
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = {}
    for name, dt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: jlm.loss(p, jb, dt)))(jp)
        grads[name] = (float(loss), flatten(_np(g)))

    lm = LM(smoke_config(arch), device="cpu")
    load_reference_lm_params(lm, params_np)
    params = dict(lm.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss32 = lm.loss(tb, dtype=torch.float32)
    loss32.backward()
    own32 = {n: p.grad.clone() for n, p in params.items()}
    for p in params.values():
        p.grad = None
    loss = lm.loss(tb, dtype=torch.bfloat16)
    loss.backward()
    assert loss.dtype == torch.float32
    assert abs(loss.item() - grads["bf16"][0]) <= 3e-2
    assert loss.item() != loss32.item()
    assert any(not torch.equal(p.grad, own32[n]) for n, p in params.items())

    want, ref32 = grads["bf16"][1], grads["fp32"][1]
    assert set(want) == set(params)
    for name, w in want.items():
        g = params[name].grad
        assert g is not None and g.dtype == torch.float32, name
        witness = np.abs(w - ref32[name]).max()
        floor = ULP * np.abs(w).max()
        err = np.abs(g.numpy() - ref32[name]).max()
        assert err <= max(WITNESS * witness, floor), (name, err, witness)
        err_bf16 = np.abs(g.numpy() - w).max()
        assert err_bf16 <= max(WITNESS_BF16 * witness, floor), \
            (name, err_bf16, witness)


def _saved_dtypes(fn):
    """(dtype, numel) of every tensor the graph of ``fn()`` saves for the
    backward, and ``fn()``."""
    saved = []

    def pack(t):
        saved.append((t.dtype, t.numel()))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return saved, out


@pytest.mark.parametrize("case", ["folded", "column_major", "matrix", "bmm"])
def test_cast_matmul_saves_no_cast_copy_and_keeps_gradient_bits(case):
    """``layers.cast_matmul`` against ``mm(x, w.to(bf16))`` under plain
    autograd: the same output and x, w gradients bit for bit, and the
    graph saves no bf16 copy of the fp32 weight (the plain graph saves
    one, 2 bytes a weight value held to the end of the backward)."""
    from repro_torch.models.layers import cast_matmul

    gen = torch.Generator().manual_seed(3)
    shapes = {"folded": ((2, 5, 24), (24, 40)),
              "column_major": ((2, 5, 24), (40, 24)),
              "matrix": ((7, 24), (24, 40)),
              "bmm": ((3, 5, 24), (3, 24, 40))}[case]
    x0 = torch.randn(shapes[0], generator=gen).to(torch.bfloat16)
    w0 = torch.randn(shapes[1], generator=gen)
    mm = torch.bmm if case == "bmm" else torch.matmul
    grads = []
    for cast in (True, False):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        wt = w.t() if case == "column_major" else w
        saved, y = _saved_dtypes(
            (lambda: cast_matmul(x, wt, mm)) if cast else
            (lambda: mm(x, wt.to(torch.bfloat16))))
        y.backward(torch.randn(y.shape, generator=torch.Generator()
                               .manual_seed(4)).to(torch.bfloat16))
        copy = (torch.bfloat16, w.numel()) in saved
        assert copy != cast, (case, cast, saved)
        grads.append((y.detach(), x.grad, w.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.equal(got, want), case


@pytest.mark.parametrize("arch", ["chatglm3-6b", "moonshot-v1-16b-a3b",
                                  "mamba2-130m", "seamless-m4t-medium"])
def test_remat_keeps_the_loss_and_gradients_bit_for_bit(arch):
    """``LM.loss(..., remat=True)`` (each period recomputed in the
    backward, the dry run's train step) against the stack kept whole: the
    same bf16 loss and fp32 gradients bit for bit, with fewer tensors
    saved for the backward."""
    jcfg = jax_smoke_config(arch)
    params_np = _init(JaxLM(jcfg, tp=1, q_block=16).spec(),
                      np.random.RandomState(0))
    tb = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    lm = LM(smoke_config(arch), device="cpu")
    load_reference_lm_params(lm, params_np)
    params = dict(lm.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    runs = []
    for remat in (False, True):
        for p in params.values():
            p.grad = None
        saved, loss = _saved_dtypes(
            lambda: lm.loss(tb, dtype=torch.bfloat16, remat=remat))
        loss.backward()
        runs.append((len(saved), loss.item(),
                     {n: p.grad.clone() for n, p in params.items()}))
    (n_whole, loss_whole, g_whole), (n_remat, loss_remat, g_remat) = runs
    assert n_remat < n_whole
    assert loss_remat == loss_whole
    for name, g in g_whole.items():
        assert torch.equal(g_remat[name], g), name
