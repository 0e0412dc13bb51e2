"""The port's MoE slice on the CPU against the JAX package: routing, the
capacity drop, the MoE layer, the three MoE models' (moonshot-v1-16b-a3b,
qwen3-moe-235b-a22b, jamba-1.5-large-398b) smoke configs' logits, losses
and gradients, their engine tokens, and a trainer's steps.

Weights are the reference's ``materialize`` loaded through
``repro_torch.bridge``; inputs are made with numpy.  Routing indices and
keep masks must be equal (the same experts and the same drops); the
router's weights, the layer's output and aux within 1e-5; logits within
1e-4 and the loss within 1e-5 relative (fp32 through a few layers, as
``test_torch_lm_serving.py`` holds the dense zoo); gradients within 1e-4
of each leaf's largest |g|; tokens equal; the trainer's losses within
1e-4 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.config import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import materialize  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.param import ParamSpec as JaxParamSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.training import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.training import TokenStream as JaxTokenStream  # noqa: E402
from repro.training import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402

from repro_torch.bridge import flatten, load_reference_lm_params  # noqa: E402
from repro_torch.common.config import MoEConfig  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.param import ParamSpec  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training import (OptimizerConfig, TokenStream,  # noqa: E402
                                  TrainConfig, Trainer)

MOE_ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
             "jamba-1.5-large-398b"]
FLOAT_TOL, LOGIT_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-4


def randn(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_MODELS = {}


def models(arch):
    """(JAX LM, its params, the port's LM with the same weights) for the
    arch's smoke config, built once per process."""
    if arch not in _MODELS:
        jlm = JaxLM(jax_smoke_config(arch), tp=1, q_block=16)
        jp = materialize(jlm.spec(), jax.random.PRNGKey(0), jnp.float32)
        lm = LM(smoke_config(arch), device="cpu")
        load_reference_lm_params(lm, np_tree(jp))
        _MODELS[arch] = (jlm, jp, lm)
    return _MODELS[arch]


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

def _flat_specs(tree, cls, prefix=""):
    if isinstance(tree, cls):
        yield prefix[:-1], tree
        return
    for k, v in tree.items():
        yield from _flat_specs(v, cls, f"{prefix}{k}.")


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_moe_configs_and_specs_match_reference(arch, which):
    """Every config field the port holds, and every parameter at the
    reference's path with its shape and init (router, experts, shared
    experts, q/k norms, the unembedding), at full width too (specs only)."""
    ours = get_config(arch) if which == "full" else smoke_config(arch)
    ref = jax_get_config(arch) if which == "full" else jax_smoke_config(arch)
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    for prop in ("padded_vocab", "n_periods", "has_mamba", "has_moe"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    got = dict(_flat_specs(LM.spec(ours), ParamSpec))
    want = dict(_flat_specs(JaxLM(ref, tp=1).spec(), JaxParamSpec))
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].shape, got[k].init, got[k].scale) == \
            (want[k].shape, want[k].init, want[k].scale), k


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _layer(cf, shared, seed=0, d=32, e=8, k=2, f=48):
    cfg = dict(n_experts=e, top_k=k, d_ff_expert=f, n_shared_experts=shared,
               capacity_factor=cf)
    spec = jax_moe.moe_spec(d, JaxMoEConfig(**cfg))
    params = materialize(spec, jax.random.PRNGKey(seed), jnp.float32)
    tparams = {name: torch.from_numpy(np.array(v))
               for name, v in params.items()}
    return JaxMoEConfig(**cfg), MoEConfig(**cfg), params, tparams


def _reference_keep(idx, e, cap):
    """The reference's keep mask (``_moe_local``), from its indices."""
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.max(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    return np.asarray((pos >= 0) & (pos < cap))


@pytest.mark.parametrize("cf,shared", [(1.25, 0), (1.25, 1), (0.5, 2)])
def test_route_dispatch_and_layer_match_reference(cf, shared):
    """Top-k indices and the keep mask equal the reference's (a few
    assignments overflow at capacity_factor 1.25, many at 0.5), the
    renormalised weights, the layer's output and its aux within 1e-5."""
    jcfg, cfg, params, tparams = _layer(cf, shared)
    x = randn(5, (2, 24, 32))
    x2d = x.reshape(-1, 32)
    jidx, jw, jaux = jax_moe._route(params["router"], jnp.asarray(x2d),
                                    jcfg)
    idx, w, aux = moe._route(tparams["router"], torch.from_numpy(x2d), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=FLOAT_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=FLOAT_TOL,
                               rtol=FLOAT_TOL)
    cap = moe.capacity(cfg, x2d.shape[0])
    want_cap = int(max(1, -(-jcfg.top_k * x2d.shape[0] // jcfg.n_experts))
                   * cf) + 1
    assert cap == want_cap
    _, keep = moe.dispatch_slots(idx, cfg.n_experts, cap)
    want_keep = _reference_keep(jidx, jcfg.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf < 1:
        assert 0 < (~want_keep).sum() < want_keep.size
    jy, jaux2 = jax_moe.apply_moe(params, jnp.asarray(x), jcfg)
    y, aux2 = moe.apply_moe(tparams, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=FLOAT_TOL,
                               rtol=FLOAT_TOL)
    np.testing.assert_allclose(aux2.item(), float(jaux2), atol=FLOAT_TOL,
                               rtol=FLOAT_TOL)


# ---------------------------------------------------------------------------
# the MoE models
# ---------------------------------------------------------------------------

def _batch(arch, seq):
    tokens = np.random.RandomState(0).randint(0, 512, (2, seq))
    labels = np.random.RandomState(1).randint(0, 512, (2, seq))
    return tokens, labels


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_logits_loss_and_gradients_match_reference(arch):
    """Causal logits, the MoE aux, the training loss (nll + z-loss + aux)
    and every parameter's gradient against the reference ``LM`` (jamba at
    64 tokens: two SSD chunks of 32)."""
    jlm, jp, _ = models(arch)
    tokens, labels = _batch(arch, 64 if arch.startswith("jamba") else 32)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    jlogits, jaux = jlm.logits_causal(jp, jb, jnp.float32)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jlm.loss(p, jb, jnp.float32))(jp)

    lm = LM(smoke_config(arch), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    with torch.no_grad():
        logits, aux = lm.logits_and_aux(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert float(jaux) > 0
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=FLOAT_TOL)
    for p in lm.parameters():
        p.requires_grad_(True)
    loss = lm.loss({"tokens": torch.from_numpy(tokens),
                    "labels": torch.from_numpy(labels)})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= FLOAT_TOL * abs(float(jloss))
    want = flatten(np_tree(jgrad))
    got = dict(lm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-30), (name, err)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_matches_reference(arch):
    """Seven requests of the launcher's generator through three slots,
    greedy: a prefill's bucket padding and a decode tick's free slot are
    routed beside the live rows, as in the reference, so the tokens,
    finish order and stats equal the JAX engine's."""
    _, jp, lm = models(arch)
    reqs = serve.make_requests(lm.cfg, 7, 6)
    jeng = JaxServingEngine(jax_smoke_config(arch), jp, max_slots=3,
                            s_max=64, eos_id=-1)
    want = jeng.run([JaxRequest(r.uid, list(r.prompt), r.max_new_tokens)
                     for r in reqs])
    eng = ServingEngine(lm, max_slots=3, s_max=64, eos_id=-1)
    got = eng.run(reqs)
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.output for r in got] == [r.output for r in want]
    assert eng.stats == jeng.stats


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_trainer_steps_match_reference(arch):
    """Two steps of the trainer (AdamW, two micro-batches a step) from the
    same weights on the same token stream: losses within 1e-4 relative."""
    jlm, jp, _ = models(arch)
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=50)
    ref = JaxTrainer(lambda p, b: jlm.loss(p, b, jnp.float32),
                     jax.tree_util.tree_map(jnp.array, jp),
                     JaxOptimizerConfig(**opt),
                     JaxTrainConfig(steps=2, grad_accum=2, log_every=0),
                     JaxTokenStream(512, 4, 16, seed=0)).train()
    lm = LM(smoke_config(arch), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    port = Trainer(lm.loss, dict(lm.named_parameters()),
                   OptimizerConfig(**opt),
                   TrainConfig(steps=2, grad_accum=2, log_every=0),
                   TokenStream(512, 4, 16, seed=0, device="cpu")).train()
    np.testing.assert_allclose(port["history"], ref["history"], rtol=1e-4)
