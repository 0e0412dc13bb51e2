"""The port's encoder-decoder slice on the CPU (plain kernel versions)
against the JAX package, at seamless-m4t-medium's smoke config (2 encoder
and 2 decoder layers, d_model 64, 4 heads of 16, LayerNorm, an ungated
SiLU MLP): the parameter tree and the bridge, the encoder's output, the
cross K/V, the causal logits with frames, prefill (with frames, and
without, on the cache's cross K/V) and decode, the loss and every leaf's
gradient, a trainer's steps on batches that carry frames, and the engine's
and the launcher's refusals.

Weights are the reference's ``materialize`` (PRNGKey 0) loaded through
``repro_torch.bridge``; tokens and frames are made with numpy.  Tolerances
are the LM tests' (``test_torch_lm_serving.py``, ``test_torch_moe.py``):
the encoder's output within 1e-5, cache leaves (the cross K/V, the self
K/V) within 5e-5 of their largest magnitude, logits within 1e-4, the loss
within 1e-5 relative, the trainer's losses within 1e-4 relative, and the
port's own prefill + decode within 2e-5 of its causal forward.  Gradients
are held to 5e-4 of each leaf's largest |g| (the MoE family's 1e-4 does
not hold here): under the reference's init the attention scores have a
standard deviation of ~16 at this width, so each softmax is near an
argmax, and frames scaled by 1 + 1e-7 (about one fp32 rounding) move a
leaf of the port's own gradient by 2.1e-4 of its largest |g| on the CPU.
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
from repro.training import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.training import TokenStream as JaxTokenStream  # noqa: E402
from repro.training import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402

from repro_torch.bridge import flatten, load_reference_lm_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.param import ParamSpec  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.training import (OptimizerConfig, TokenStream,  # noqa: E402
                                  TrainConfig, Trainer)

ARCH = "seamless-m4t-medium"
FLOAT_TOL, LOGIT_TOL, GRAD_TOL, CAUSAL_TOL = 1e-5, 1e-4, 5e-4, 2e-5
#: a cache leaf, relative to its largest magnitude
CACHE_TOL = 5e-5
B, S, T = 2, 24, 13


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


def inputs(seed=0, b=B, s=S, t=T):
    """Tokens (B, S) and stub frames (B, T, d) from a numpy seed."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, smoke_config(ARCH).vocab_size, (b, s))
    frames = rs.standard_normal((b, t, smoke_config(ARCH).d_model)).astype(
        np.float32)
    return tokens, frames


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def cache_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=CACHE_TOL * np.abs(want).max())


def _flat_specs(tree, cls, prefix=""):
    if isinstance(tree, cls):
        yield prefix[:-1], tree
        return
    for k, v in tree.items():
        yield from _flat_specs(v, cls, f"{prefix}{k}.")


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_param_spec_matches_reference(which):
    """Every parameter at the reference's path with its shape and init,
    the encoder's stack and the decoder's cross attention included (no
    qk-norm on cross), at full width too (specs only)."""
    cfg = get_config(ARCH) if which == "full" else smoke_config(ARCH)
    jcfg = jax_get_config(ARCH) if which == "full" else \
        jax_smoke_config(ARCH)
    ours = dict(_flat_specs(LM.spec(cfg), ParamSpec))
    ref = dict(_flat_specs(JaxLM(jcfg, tp=1).spec(), JaxParamSpec))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert (ours[k].shape, ours[k].init, ours[k].scale) == \
            (ref[k].shape, ref[k].init, ref[k].scale), k


def test_bridge_key_sets():
    """The reference's tree loads key for key, nothing missing or
    unexpected in either direction, every leaf equal."""
    _, jp, lm = models()
    ref = flatten(np_tree(jp))
    ours = dict(lm.named_parameters())
    assert sorted(ours) == sorted(ref)
    for key in ("encoder.stack.i0.mixer.wq", "encoder.final_norm.bias",
                "stack.i0.cross.wk", "stack.i0.cross_norm.bias"):
        assert key in ours, key
    assert not any(".cross.q_norm" in k for k in ours)
    for k, a in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), a, err_msg=k)
    with pytest.raises(KeyError, match="missing"):
        load_reference_lm_params(
            LM(smoke_config(ARCH), device="cpu"),
            {k: v for k, v in np_tree(jp).items() if k != "encoder"})


def test_encoder_and_cross_kv_match_reference():
    """The encoder's output (its stack in encode mode, bidirectional, and
    its final norm) and each decoder period's cross (K, V)."""
    jlm, jp, lm = models()
    _, frames = inputs()
    want = jlm._encode(jp, jnp.asarray(frames))
    with torch.no_grad():
        params = lm.tree()
        got = lm._encode(params, torch.from_numpy(frames))
        cross = lm._cross_kv_stack(params, got)
    close(got.numpy(), want, FLOAT_TOL)
    ref = jlm._cross_kv_stack(jp, want)
    assert len(cross) == lm.cfg.n_periods
    for i, period in enumerate(cross):
        for key, pair in period.items():
            for got_, want_ in zip(pair, ref[key]):
                cache_close(got_.numpy(), np.asarray(want_)[i])


def test_logits_causal_with_frames_matches_reference():
    jlm, jp, lm = models()
    tokens, frames = inputs(1)
    want, _ = jlm.logits_causal(
        jp, {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
        jnp.float32)
    got = lm.logits_causal(torch.from_numpy(tokens),
                           frames=torch.from_numpy(frames))
    close(got.numpy(), want, LOGIT_TOL)


def test_prefill_and_decode_match_reference():
    """Prefill with frames, then three decode steps (the cross attention
    through the decode kernel's plain version at kv_len T), logits against
    the JAX LM's; the cache's cross K/V and self K/V agree too."""
    jlm, jp, lm = models()
    tokens, frames = inputs(2)
    p = S - 4
    jc = jlm.init_cache(B, S, t_src=T, dtype=jnp.float32)
    want, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tokens[:, :p]),
                                "frames": jnp.asarray(frames)}, jc,
                           dtype=jnp.float32)
    cache = lm.init_cache(B, S, t_src=T)
    got, cache = lm.prefill(torch.from_numpy(tokens[:, :p]), cache,
                            frames=torch.from_numpy(frames))
    close(got.numpy(), want, LOGIT_TOL)
    for t in range(p, p + 3):
        want, jc = jlm.decode(jp, jnp.asarray(tokens[:, t:t + 1]), jc,
                              jnp.int32(t), dtype=jnp.float32)
        got, cache = lm.decode(torch.from_numpy(tokens[:, t:t + 1]), cache,
                               torch.tensor(t))
        close(got.numpy(), want, LOGIT_TOL)
    for key, kv in cache["cross"].items():
        cache_close(kv["k"].numpy(), jc["cross"][key][0])
        cache_close(kv["v"].numpy(), jc["cross"][key][1])
    for key, leaves in cache["layers"].items():
        for leaf, a in leaves.items():
            cache_close(a.numpy(), jc["layers"][key][leaf])


def test_prefill_without_frames_reuses_the_cache_cross():
    """A prefill without frames reads the cross K/V already in the cache
    (the reference's rule): equal to the prefill that encoded them, and to
    the reference's prefill without frames on the same cache."""
    jlm, jp, lm = models()
    tokens, frames = inputs(3)
    first = lm.init_cache(B, S, t_src=T)
    a, first = lm.prefill(torch.from_numpy(tokens), first,
                          frames=torch.from_numpy(frames))
    again = lm.init_cache(B, S, t_src=T)
    again["cross"] = first["cross"]
    b, _ = lm.prefill(torch.from_numpy(tokens), again)
    assert torch.equal(a, b)
    jc = jlm.init_cache(B, S, t_src=T, dtype=jnp.float32)
    _, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tokens),
                             "frames": jnp.asarray(frames)}, jc,
                        dtype=jnp.float32)
    jc2 = jlm.init_cache(B, S, t_src=T, dtype=jnp.float32)
    jc2["cross"] = jc["cross"]
    want, _ = jlm.prefill(jp, {"tokens": jnp.asarray(tokens)}, jc2,
                          dtype=jnp.float32)
    close(b.numpy(), want, LOGIT_TOL)


def test_decode_matches_causal():
    """The port's own prefill + decode continuation == its causal forward
    with the same frames (the reference's test_decode_matches_causal)."""
    _, _, lm = models()
    tokens, frames = inputs(4, s=32)
    full = lm.logits_causal(torch.from_numpy(tokens),
                            frames=torch.from_numpy(frames))
    p = 28
    cache = lm.init_cache(B, 32, t_src=T)
    lg, cache = lm.prefill(torch.from_numpy(tokens[:, :p]), cache,
                           frames=torch.from_numpy(frames))
    close(lg[:, 0].numpy(), full[:, p - 1].numpy(), CAUSAL_TOL)
    for t in range(3):
        lg, cache = lm.decode(torch.from_numpy(tokens[:, p + t:p + t + 1]),
                              cache, torch.tensor(p + t))
        close(lg[:, 0].numpy(), full[:, p + t].numpy(), CAUSAL_TOL)


def test_loss_and_gradients_match_reference():
    """The training loss on a batch with frames, and every parameter's
    gradient (the encoder's and the cross attention's included) against
    ``jax.grad``."""
    jlm, jp, _ = models()
    tokens, frames = inputs(5)
    labels = np.random.RandomState(6).randint(0, 512, (B, S))
    jb = {"tokens": jnp.asarray(tokens, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32),
          "frames": jnp.asarray(frames)}
    jloss, jgrad = jax.value_and_grad(
        lambda p: jlm.loss(p, jb, jnp.float32))(jp)
    lm = LM(smoke_config(ARCH), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    for p in lm.parameters():
        p.requires_grad_(True)
    loss = lm.loss({"tokens": torch.from_numpy(tokens),
                    "labels": torch.from_numpy(labels),
                    "frames": torch.from_numpy(frames)})
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= FLOAT_TOL * abs(float(jloss))
    want = flatten(np_tree(jgrad))
    got = dict(lm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].grad.numpy()
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-30), (name, err)


def _frames_fn(rs, b):
    return {"frames": rs.standard_normal((b, 8, 64)).astype(np.float32)}


def test_trainer_steps_match_reference():
    """Two trainer steps (AdamW, two micro-batches a step) from the same
    weights on the same token stream, whose batches carry frames (its
    ``extra_fn``, the same numpy draws in both packages): losses within
    1e-4 relative."""
    jlm, jp, _ = models()
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=50)
    ref = JaxTrainer(lambda p, b: jlm.loss(p, b, jnp.float32),
                     jax.tree_util.tree_map(jnp.array, jp),
                     JaxOptimizerConfig(**opt),
                     JaxTrainConfig(steps=2, grad_accum=2, log_every=0),
                     JaxTokenStream(512, 4, 16, seed=0,
                                    extra_fn=_frames_fn)).train()
    lm = LM(smoke_config(ARCH), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    port = Trainer(lm.loss, dict(lm.named_parameters()),
                   OptimizerConfig(**opt),
                   TrainConfig(steps=2, grad_accum=2, log_every=0),
                   TokenStream(512, 4, 16, seed=0, extra_fn=_frames_fn,
                               device="cpu")).train()
    np.testing.assert_allclose(port["history"], ref["history"], rtol=1e-4)


def test_frames_are_required_and_refused_where_they_do_not_belong():
    _, _, lm = models()
    tokens, frames = inputs(7)
    with pytest.raises(ValueError, match="frames"):
        lm.logits_causal(torch.from_numpy(tokens))
    dense = LM(smoke_config("chatglm3-6b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="encoder"):
        dense.logits_causal(torch.from_numpy(tokens),
                            frames=torch.from_numpy(frames))


def test_engine_and_launcher_refuse_the_encoder_decoder():
    """The engine serves decoder-only archs (the reference asserts so); the
    training launcher's token stream carries no frames, and it says so."""
    _, _, lm = models()
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(lm, max_slots=2, s_max=32)
    with pytest.raises(ValueError, match="frames"):
        train_launcher.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--steps", "1"])


def test_full_config_sizes():
    """seamless-m4t-medium at full width: 12 + 12 layers, the vocab padded
    to 256256 and tied, ~615M parameters (specs only)."""
    cfg = get_config(ARCH)
    specs = dict(_flat_specs(LM.spec(cfg), ParamSpec))
    n = sum(int(np.prod(s.shape)) for s in specs.values())
    assert cfg.padded_vocab == 256256 and cfg.tie_embeddings
    assert cfg.n_encoder_layers == cfg.n_layers == 12
    assert specs["encoder.stack.i0.mixer.wq"].shape[0] == 12
    assert specs["stack.i0.cross.wq"].shape[0] == 12
    assert 0.60e9 < n < 0.63e9
