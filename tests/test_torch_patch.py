"""The port's patch-frontend slice on the CPU (plain kernel versions)
against the JAX package, at pixtral-12b's smoke config (2 layers, d_model
64, 4 query heads over 2 kv heads of 16, an untied unembedding): patch
embeddings added at their positions (a repeated position adds up), the
causal logits, prefill and decode with patches, the engine's tokens (from
prompts' tokens, as the reference serves pixtral), the loss and every
leaf's gradient, a trainer's steps on batches that carry patches, and the
serving launcher.

Weights are the reference's ``materialize`` (PRNGKey 0) loaded through
``repro_torch.bridge``; tokens and patches are made with numpy.
Tolerances are the LM tests' (``test_torch_lm_serving.py``,
``test_torch_moe.py``): the embedding within 1e-6, logits within 1e-4,
the loss within 1e-5 relative, gradients within 1e-4 of each leaf's
largest |g|, the trainer's losses within 1e-4 relative, the port's own
prefill + decode within 2e-5 of its causal forward; tokens equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import materialize  # noqa: E402
from repro.models.param import ParamSpec as JaxParamSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.training import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.training import TokenStream as JaxTokenStream  # noqa: E402
from repro.training import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402

from repro_torch.bridge import flatten, load_reference_lm_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.param import ParamSpec  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training import (OptimizerConfig, TokenStream,  # noqa: E402
                                  TrainConfig, Trainer)

ARCH = "pixtral-12b"
EMBED_TOL, FLOAT_TOL, LOGIT_TOL, GRAD_TOL, CAUSAL_TOL = \
    1e-6, 1e-5, 1e-4, 1e-4, 2e-5
B, S, P = 2, 24, 6


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_MODELS = {}


def models():
    """(JAX LM, its params, the port's LM with the same weights), built
    once per process."""
    if not _MODELS:
        jlm = JaxLM(jax_smoke_config(ARCH), tp=1, q_block=16)
        jp = materialize(jlm.spec(), jax.random.PRNGKey(0), jnp.float32)
        lm = LM(smoke_config(ARCH), device="cpu")
        load_reference_lm_params(lm, np_tree(jp))
        _MODELS.update(jlm=jlm, jp=jp, lm=lm)
    return _MODELS["jlm"], _MODELS["jp"], _MODELS["lm"]


def inputs(seed=0, b=B, s=S, p=P):
    """Tokens (B, S), patch embeddings (B, P, d) (0.02 a normal draw, as
    the reference's tests make them) and their positions (B, P), the
    first row's position 3 given twice."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, smoke_config(ARCH).vocab_size, (b, s))
    pe = (0.02 * rs.standard_normal((b, p, smoke_config(ARCH).d_model))
          ).astype(np.float32)
    pos = rs.randint(0, s - 4, (b, p))
    pos[0, :2] = 3
    return tokens, pe, pos


def jbatch(tokens, pe, pos):
    return {"tokens": jnp.asarray(tokens), "patch_embeds": jnp.asarray(pe),
            "patch_pos": jnp.asarray(pos, jnp.int32)}


def tbatch(pe, pos):
    return {"patch_embeds": torch.from_numpy(pe),
            "patch_pos": torch.from_numpy(pos)}


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _flat_specs(tree, cls, prefix=""):
    if isinstance(tree, cls):
        yield prefix[:-1], tree
        return
    for k, v in tree.items():
        yield from _flat_specs(v, cls, f"{prefix}{k}.")


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_param_spec_matches_reference(which):
    """Every parameter at the reference's path with its shape and init (an
    unembedding of its own), at full width too (specs only)."""
    cfg = get_config(ARCH) if which == "full" else smoke_config(ARCH)
    jcfg = jax_get_config(ARCH) if which == "full" else \
        jax_smoke_config(ARCH)
    ours = dict(_flat_specs(LM.spec(cfg), ParamSpec))
    ref = dict(_flat_specs(JaxLM(jcfg, tp=1).spec(), JaxParamSpec))
    assert sorted(ours) == sorted(ref)
    assert "embed.unembed" in ours
    for k in ref:
        assert (ours[k].shape, ours[k].init, ours[k].scale) == \
            (ref[k].shape, ref[k].init, ref[k].scale), k


def test_bridge_round_trips_every_leaf():
    _, jp, lm = models()
    ref = flatten(np_tree(jp))
    ours = dict(lm.named_parameters())
    assert sorted(ours) == sorted(ref)
    for k, a in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), a, err_msg=k)


def test_embed_adds_patches_with_a_repeated_position():
    """``_embed`` adds each patch at its position; the two patches at one
    position both add (``.at[].add`` in the reference)."""
    jlm, jp, lm = models()
    tokens, pe, pos = inputs()
    want = jlm._embed(jp, jnp.asarray(tokens), jbatch(tokens, pe, pos),
                      jnp.float32)
    params = lm.tree()
    got = lm._embed(params, torch.from_numpy(tokens), **tbatch(pe, pos))
    close(got.numpy(), want, EMBED_TOL)
    plain = lm._embed(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(
        (got - plain)[0, 3].numpy(), pe[0, 0] + pe[0, 1], atol=EMBED_TOL)


def test_logits_causal_with_patches_match_reference():
    jlm, jp, lm = models()
    tokens, pe, pos = inputs(1)
    want, _ = jlm.logits_causal(jp, jbatch(tokens, pe, pos), jnp.float32)
    got = lm.logits_causal(torch.from_numpy(tokens), **tbatch(pe, pos))
    close(got.numpy(), want, LOGIT_TOL)


def test_prefill_and_decode_with_patches_match_reference():
    """Prefill with patches in the prompt, then three decode steps, logits
    against the JAX LM's."""
    jlm, jp, lm = models()
    tokens, pe, pos = inputs(2)
    p = S - 4
    jb = jbatch(tokens[:, :p], pe, pos)
    jc = jlm.init_cache(B, S, dtype=jnp.float32)
    want, jc = jlm.prefill(jp, jb, jc, dtype=jnp.float32)
    cache = lm.init_cache(B, S)
    got, cache = lm.prefill(torch.from_numpy(tokens[:, :p]), cache,
                            **tbatch(pe, pos))
    close(got.numpy(), want, LOGIT_TOL)
    for t in range(p, p + 3):
        want, jc = jlm.decode(jp, jnp.asarray(tokens[:, t:t + 1]), jc,
                              jnp.int32(t), dtype=jnp.float32)
        got, cache = lm.decode(torch.from_numpy(tokens[:, t:t + 1]), cache,
                               torch.tensor(t))
        close(got.numpy(), want, LOGIT_TOL)


def test_decode_matches_causal():
    """The port's own prefill (with the patches) + decode continuation ==
    its causal forward (the reference's test_decode_matches_causal)."""
    _, _, lm = models()
    tokens, pe, pos = inputs(3, s=32)
    full = lm.logits_causal(torch.from_numpy(tokens), **tbatch(pe, pos))
    p = 28
    cache = lm.init_cache(B, 32)
    lg, cache = lm.prefill(torch.from_numpy(tokens[:, :p]), cache,
                           **tbatch(pe, pos))
    close(lg[:, 0].numpy(), full[:, p - 1].numpy(), CAUSAL_TOL)
    for t in range(3):
        lg, cache = lm.decode(torch.from_numpy(tokens[:, p + t:p + t + 1]),
                              cache, torch.tensor(p + t))
        close(lg[:, 0].numpy(), full[:, p + t].numpy(), CAUSAL_TOL)


@pytest.mark.parametrize("slots", [2, 4])
def test_engine_matches_reference(slots):
    """Seven requests of the launcher's generator through the engine (it
    serves pixtral from the prompts' tokens, as the reference's does),
    greedy: the same tokens, finish order and stats as the JAX engine."""
    _, jp, lm = models()
    reqs = serve.make_requests(lm.cfg, 7, 6)
    jeng = JaxServingEngine(jax_smoke_config(ARCH), jp, max_slots=slots,
                            s_max=64, eos_id=-1)
    want = jeng.run([JaxRequest(r.uid, list(r.prompt), r.max_new_tokens)
                     for r in reqs])
    eng = ServingEngine(lm, max_slots=slots, s_max=64, eos_id=-1)
    got = eng.run(reqs)
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.output for r in got] == [r.output for r in want]
    assert eng.stats == jeng.stats


def test_loss_and_gradients_match_reference():
    """The training loss on a batch with patches, and every parameter's
    gradient against ``jax.grad``."""
    jlm, jp, _ = models()
    tokens, pe, pos = inputs(4)
    labels = np.random.RandomState(5).randint(0, 512, (B, S))
    jb = {**jbatch(tokens, pe, pos),
          "labels": jnp.asarray(labels, jnp.int32)}
    jloss, jgrad = jax.value_and_grad(
        lambda p: jlm.loss(p, jb, jnp.float32))(jp)
    lm = LM(smoke_config(ARCH), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    for p in lm.parameters():
        p.requires_grad_(True)
    loss = lm.loss({"tokens": torch.from_numpy(tokens),
                    "labels": torch.from_numpy(labels), **tbatch(pe, pos)})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= FLOAT_TOL * abs(float(jloss))
    want = flatten(np_tree(jgrad))
    got = dict(lm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-30), (name, err)


def _patches_fn(rs, b):
    return {"patch_embeds": (0.02 * rs.standard_normal((b, 3, 64))).astype(
        np.float32), "patch_pos": rs.randint(0, 16, (b, 3)).astype(np.int32)}


def test_trainer_steps_match_reference():
    """Two trainer steps (AdamW, two micro-batches a step) on a token
    stream whose batches carry patches (its ``extra_fn``, the same numpy
    draws in both packages): losses within 1e-4 relative."""
    jlm, jp, _ = models()
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=50)
    ref = JaxTrainer(lambda p, b: jlm.loss(p, b, jnp.float32),
                     jax.tree_util.tree_map(jnp.array, jp),
                     JaxOptimizerConfig(**opt),
                     JaxTrainConfig(steps=2, grad_accum=2, log_every=0),
                     JaxTokenStream(512, 4, 16, seed=0,
                                    extra_fn=_patches_fn)).train()
    lm = LM(smoke_config(ARCH), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    port = Trainer(lm.loss, dict(lm.named_parameters()),
                   OptimizerConfig(**opt),
                   TrainConfig(steps=2, grad_accum=2, log_every=0),
                   TokenStream(512, 4, 16, seed=0, extra_fn=_patches_fn,
                               device="cpu")).train()
    np.testing.assert_allclose(port["history"], ref["history"], rtol=1e-4)


def test_patches_take_the_patch_frontend_and_positions():
    _, _, lm = models()
    tokens, pe, pos = inputs(6)
    with pytest.raises(ValueError, match="positions"):
        lm.logits_causal(torch.from_numpy(tokens),
                         patch_embeds=torch.from_numpy(pe))
    dense = LM(smoke_config("chatglm3-6b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="patch frontend"):
        dense.logits_causal(torch.from_numpy(tokens), **tbatch(pe, pos))


def test_launcher_serves_pixtral_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.startswith("served 3 requests, 12 tokens")
    assert "'finished': 3" in out
