"""The port's LM serving slice on the CPU (plain versions) against the JAX
package: configs, parameter specs and init, the bridge, layers, the LM's
causal / prefill / decode logits, and the continuous-batching engine's
tokens and stats for gemma2-smoke, mamba2-smoke and the dense zoo's smoke
configs (chatglm3, glm4, phi3-mini).

Weights are the reference's ``materialize`` (PRNGKey 0) loaded through
``repro_torch.bridge``; token inputs are made with numpy.  Logit tolerance
1e-4 absolute: fp32 through a few layers, measured drift 1.6e-5 for
gemma2-smoke (its residual grows with the sqrt(d) embedding scale) and
5e-7 for mamba2-smoke.  Cache leaves are held to 5e-5 of their largest
magnitude: the second period's K/V reach ~23 under random weights and
drift up to 2.4e-5 of that (5.5e-4) from fp32 sum order, while the logits
after the final norm and soft-cap stay within 2.2e-5.  Tokens must be
equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import materialize  # noqa: E402
from repro.models.param import ParamSpec as JaxParamSpec  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402

from repro_torch.bridge import flatten, load_reference_lm_params  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.models.param import ParamSpec  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine, _bucket  # noqa: E402
from repro_torch.serving.sampler import sample_logits  # noqa: E402

#: gemma2 (windows, soft-caps), mamba2 (SSD), and the dense zoo: chatglm3
#: and glm4 (partial rotary at 0.5, 4 query heads over 2 kv heads in the
#: smoke configs, 32 over 2 at full width) and phi3-mini (full MHA)
DENSE_ZOO = ["chatglm3-6b", "glm4-9b", "phi3-mini-3.8b"]
ARCHS = ["gemma2-2b", "mamba2-130m"] + DENSE_ZOO
#: the configs held to the reference's here: ARCHS, the encoder-decoder
#: and the patch frontend (the MoE family's are in test_torch_moe.py); the
#: engine refuses the encoder-decoder, so it has a list of its own
CONFIG_ARCHS = ARCHS + ["seamless-m4t-medium", "pixtral-12b"]
TOL = 1e-4


def randn(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


_MODELS = {}


def models(arch):
    """(JAX LM, its params, the port's LM with the same weights) for the
    arch's smoke config, built once per process."""
    if arch not in _MODELS:
        jlm = JaxLM(jax_smoke_config(arch), tp=1, q_block=16)
        jp = materialize(jlm.spec(), jax.random.PRNGKey(0), jnp.float32)
        lm = LM(smoke_config(arch), device="cpu")
        load_reference_lm_params(lm, jax.tree_util.tree_map(np.asarray, jp))
        _MODELS[arch] = (jlm, jp, lm)
    return _MODELS[arch]


# ---------------------------------------------------------------------------
# configs, specs, init, bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CONFIG_ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_configs_match_reference(arch, which):
    ours = get_config(arch) if which == "full" else smoke_config(arch)
    ref = jax_get_config(arch) if which == "full" else jax_smoke_config(arch)
    for f in dataclasses.fields(ours):
        if f.name == "notes":       # prose about the reference's TP padding
            continue
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    for prop in ("padded_vocab", "n_periods", "has_mamba", "has_moe"):
        assert getattr(ours, prop) == getattr(ref, prop), prop


def test_unknown_arch_raises():
    for lookup in (get_config, smoke_config):
        with pytest.raises(KeyError, match="unknown"):
            lookup("no-such-arch")


def _flat_specs(tree, cls, prefix=""):
    if isinstance(tree, cls):
        yield prefix[:-1], tree
        return
    for k, v in tree.items():
        yield from _flat_specs(v, cls, f"{prefix}{k}.")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_param_spec_matches_reference(arch, which):
    """Every parameter at the reference's path, with its shape and init
    kind, at full width too (specs only: nothing is allocated)."""
    cfg = get_config(arch) if which == "full" else smoke_config(arch)
    jcfg = jax_get_config(arch) if which == "full" else \
        jax_smoke_config(arch)
    ours = dict(_flat_specs(LM.spec(cfg), ParamSpec))
    ref = dict(_flat_specs(JaxLM(jcfg, tp=1).spec(), JaxParamSpec))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert (ours[k].shape, ours[k].init, ours[k].scale) == \
            (ref[k].shape, ref[k].init, ref[k].scale), k


def test_init_kinds_follow_the_reference_scheme():
    """ones / zeros / small (0.02) / fan_in over the second-to-last dim
    (for wq (d, H, Dh) that is H, not d), from an explicit generator."""
    lm = LM(smoke_config("gemma2-2b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    t = lm.tree()
    blk = t["stack"]["i0"]
    assert torch.all(blk["pre_norm"]["scale"] == 1)
    assert abs(t["embed"]["table"].std().item() - 0.02) < 0.002
    wq = blk["mixer"]["wq"]                         # (periods, 64, 4, 16)
    assert abs(wq.std().item() - 4 ** -0.5) < 0.05 * 4 ** -0.5
    w_in = blk["mlp"]["w_in"]                       # (periods, 64, 128)
    assert abs(w_in.std().item() - 64 ** -0.5) < 0.05 * 64 ** -0.5
    m = LM(smoke_config("mamba2-130m"), device="cpu").init(
        torch.Generator().manual_seed(0)).tree()["stack"]["i0"]["mixer"]
    assert torch.all(m["dt_bias"] == 0) and torch.all(m["D"] == 1)
    again = LM(smoke_config("gemma2-2b"), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in
               zip(lm.parameters(), again.parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_every_leaf(arch):
    _, jp, lm = models(arch)
    ref = flatten(jax.tree_util.tree_map(np.asarray, jp))
    ours = dict(lm.named_parameters())
    assert sorted(ours) == sorted(ref)
    for k, a in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), a, err_msg=k)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("gelu", False)])
def test_mlp_matches_reference(act, gated):
    x = randn(0, (2, 5, 32))
    w = {"w_in": randn(1, (32, 48), 0.2), "w_out": randn(2, (48, 32), 0.2)}
    if gated:
        w["w_gate"] = randn(3, (32, 48), 0.2)
    ref = jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in w.items()},
                               jnp.asarray(x), gated, act)
    out = layers.apply_mlp(torch.from_numpy(w["w_in"]),
                           torch.from_numpy(w["w_gate"]) if gated else None,
                           torch.from_numpy(w["w_out"]), torch.from_numpy(x),
                           act)
    close(out.numpy(), ref, 1e-5)


def test_norms_softcap_and_embedding_match_reference():
    x, s, b = randn(4, (2, 3, 16)), randn(5, (16,)), randn(6, (16,))
    for kind, p in (("rmsnorm", {"scale": s}),
                    ("layernorm", {"scale": s, "bias": b})):
        ref = jax_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), kind)
        out = layers.norm({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), kind)
        close(out.numpy(), ref, 1e-5)
    close(layers.softcap(torch.from_numpy(40 * x), 30.0).numpy(),
          jax_layers.softcap(jnp.asarray(40 * x), 30.0), 1e-5)
    table = {"table": randn(7, (64, 16))}
    tokens = np.asarray([[3, 0, 63]])
    ref = jax_layers.embed_tokens({"table": jnp.asarray(table["table"])},
                                  jnp.asarray(tokens), jnp.float32, 4.0)
    out = layers.embed_tokens({"table": torch.from_numpy(table["table"])},
                              torch.from_numpy(tokens), 4.0)
    close(out.numpy(), ref, 1e-6)
    ref = jax_layers.unembed({"table": jnp.asarray(table["table"])},
                             jnp.asarray(x), 30.0)
    out = layers.unembed({"table": torch.from_numpy(table["table"])},
                         torch.from_numpy(x), 30.0)
    close(out.numpy(), ref, 1e-5)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def _tokens(arch, b, s, seed=0):
    return np.random.RandomState(seed).randint(
        0, smoke_config(arch).vocab_size, (b, s))


@pytest.mark.parametrize("arch,s", [("gemma2-2b", 40), ("mamba2-130m", 64)]
                         + [(a, 40) for a in DENSE_ZOO])
def test_logits_causal_matches_reference(arch, s):
    """gemma2-smoke at 40 tokens, longer than its window of 16 (the local
    layers mask it in prefill); mamba2-smoke over two chunks; the dense
    zoo at 40 (chatglm3 and glm4 rotate half of each head)."""
    jlm, jp, lm = models(arch)
    toks = _tokens(arch, 2, s)
    ref, _ = jlm.logits_causal(jp, {"tokens": jnp.asarray(toks)},
                               jnp.float32)
    close(lm.logits_causal(torch.from_numpy(toks)).numpy(), ref)


@pytest.mark.parametrize("arch,s", [("gemma2-2b", 36), ("gemma2-2b", 12),
                                    ("mamba2-130m", 32)]
                         + [(a, 21) for a in DENSE_ZOO])
def test_prefill_and_decode_match_reference(arch, s):
    """Prefill (longer and shorter than gemma's window of 16) then four
    decode steps, logits against the JAX LM; the cache leaves agree too."""
    jlm, jp, lm = models(arch)
    toks = _tokens(arch, 2, s + 4, seed=1)
    jc = jlm.init_cache(2, s + 8, dtype=jnp.float32)
    ref, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc,
                          dtype=jnp.float32)
    cache = lm.init_cache(2, s + 8)
    got, cache = lm.prefill(torch.from_numpy(toks[:, :s]), cache)
    close(got.numpy(), ref)
    for t in range(s, s + 4):
        ref, jc = jlm.decode(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                             jnp.int32(t), dtype=jnp.float32)
        got, cache = lm.decode(torch.from_numpy(toks[:, t:t + 1]), cache,
                               torch.tensor(t))
        close(got.numpy(), ref)
    for key, leaves in cache["layers"].items():
        for leaf, a in leaves.items():
            want = np.asarray(jc["layers"][key][leaf])
            np.testing.assert_allclose(a.numpy(), want, rtol=0,
                                       atol=5e-5 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_causal(arch):
    """The port's own prefill + decode continuation == its full causal
    forward (as the reference's test_models.py holds its own)."""
    _, _, lm = models(arch)
    s = 32
    toks = torch.from_numpy(_tokens(arch, 2, s, seed=2))
    full = lm.logits_causal(toks)
    p = s - 4
    cache = lm.init_cache(2, s)
    lg, cache = lm.prefill(toks[:, :p], cache)
    close(lg[:, 0].numpy(), full[:, p - 1].numpy(), 2e-5)
    for t in range(3):
        lg, cache = lm.decode(toks[:, p + t:p + t + 1], cache,
                              torch.tensor(p + t))
        close(lg[:, 0].numpy(), full[:, p + t].numpy(), 2e-5)


def test_right_padded_prefill_reads_the_last_prompt_position():
    """``last_pos`` picks the prompt's last row from a padded bucket: equal
    to the unpadded prefill's logits (causal rows never see the padding)."""
    _, _, lm = models("gemma2-2b")
    toks = _tokens("gemma2-2b", 1, 21, seed=3)
    padded = np.zeros((1, _bucket(21)), np.int64)
    padded[0, :21] = toks[0]
    a, _ = lm.prefill(torch.from_numpy(toks), lm.init_cache(1, 64))
    b, _ = lm.prefill(torch.from_numpy(padded), lm.init_cache(1, 64),
                      last_pos=torch.tensor([20]))
    close(b.numpy(), a.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("slots", [2, 4])
def test_engine_matches_reference(arch, slots):
    """Seven requests (the launcher's generator: prompts of 4-23 tokens,
    some past gemma's window and past the first bucket) through fewer slots
    than requests, greedy: the same tokens, finish order and stats as the
    JAX engine on the same weights."""
    _, jp, lm = models(arch)
    reqs = serve.make_requests(lm.cfg, 7, 6)
    jeng = JaxServingEngine(jax_smoke_config(arch), jp, max_slots=slots,
                            s_max=64, eos_id=-1)
    want = jeng.run([JaxRequest(r.uid, list(r.prompt), r.max_new_tokens)
                     for r in reqs])
    eng = ServingEngine(lm, max_slots=slots, s_max=64, eos_id=-1)
    got = eng.run(reqs)
    assert [r.uid for r in got] == [r.uid for r in want]
    assert [r.output for r in got] == [r.output for r in want]
    assert eng.stats == jeng.stats
    assert all(len(r.output) == 6 and r.done for r in got)


def test_engine_eos_and_refusals():
    _, _, lm = models("gemma2-2b")
    eng = ServingEngine(lm, max_slots=2, s_max=32, eos_id=-1)
    with pytest.raises(ValueError, match="s_max"):
        eng.run([Request(uid=0, prompt=list(range(2, 30)),
                         max_new_tokens=8)])
    first = ServingEngine(lm, max_slots=1, s_max=32, eos_id=-1).run(
        [Request(uid=1, prompt=[5, 6, 7, 8], max_new_tokens=4)])[0].output
    stop = ServingEngine(lm, max_slots=1, s_max=32, eos_id=first[1]).run(
        [Request(uid=1, prompt=[5, 6, 7, 8], max_new_tokens=4)])[0].output
    assert stop == first[:2]


def test_sampler_modes():
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    assert sample_logits(logits).tolist() == [1]
    assert sample_logits(logits).dtype == torch.int32
    gen = torch.Generator().manual_seed(0)
    t = sample_logits(logits.repeat(64, 1), gen, temperature=1.0, top_k=2)
    assert set(t.tolist()) <= {1, 2} and len(set(t.tolist())) == 2


def test_launcher_serves_on_the_cpu(capsys):
    serve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.startswith("served 3 requests, 12 tokens")
    assert "'finished': 3" in out


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        LM(smoke_config("mamba2-130m"))
