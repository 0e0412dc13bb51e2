"""The port's bf16 half on the CPU against the JAX package at bf16: the
attention kernels' plain versions against the Pallas kernels in interpret
mode, the LM's compute dtype (``logits_causal``, ``prefill``, ``decode``,
the cache) for five smoke configs, the engine at ``dtype=bf16``, the
one-time cast and ``dequantize_params``, and the trainer's bf16 step
(``REPRO_CAST_BF16_STEP=1``).

Weights are the reference's ``materialize`` (PRNGKey 0) loaded through
``repro_torch.bridge``; tokens, frames and kernel inputs are made with
numpy.  Tolerances:

* kernels: the reference sweep's own bf16 tolerances, 2e-2 (flash) and
  3e-2 (decode), absolute and relative;
* LM logits: no farther from the reference's fp32 logits than twice the
  reference's bf16 ones (``WITNESS``), for all five configs; and within
  3e-2 of the reference's bf16 logits for chatglm3, mamba2 and moonshot.
  bf16 rounds at other places in XLA (which keeps fused intermediates in
  fp32) and in PyTorch (which rounds every op).  gemma2-smoke and
  seamless-smoke amplify that: the reference's own bf16 logits are 0.11-
  0.18 and 0.05-0.43 from its fp32 ones (at most ~0.66 in magnitude), and
  the port's bf16 logits 0.03-0.14 from the reference's, so for them the
  two runs are held block by block instead: every block (and encoder
  block) at bf16, from the same bf16 input and weights, within one bf16
  ulp of the block output's largest magnitude (measured: 0.5-1 ulp in all
  five configs);
* the engine's tokens: equal wherever the reference's top-2 logit margin
  at that step exceeds ``MARGIN`` (a bf16 ulp of the smoke logits is
  ~4e-3 to 1.6e-2); a request is compared up to its first near tie, past
  which the two contexts differ;
* the cast and ``dequantize_params``: bit for bit;
* the bf16 step: losses within the LM trainer test's rtol 1e-4; each
  leaf's step-1 gradient within one bf16 ulp of its largest |g| (2^-8:
  both gradients are rounded to bf16 on their way back through the cast,
  from fp32 sums in other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.decode_attention.ops import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_kernel  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import materialize  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.quantize import dequantize_params as jax_dequantize  # noqa: E402
from repro.serving.quantize import quantize_params_int8 as jax_quantize  # noqa: E402
from repro.serving.sampler import sample_logits as jax_sample  # noqa: E402
from repro.training import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.training import TokenStream as JaxTokenStream  # noqa: E402
from repro.training.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro.training.trainer import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.bridge import flatten, load_reference_lm_params  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.models.model import LM, cast_leaf  # noqa: E402
from repro_torch.models.param import cast_step  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.quantize import (dequantize_params,  # noqa: E402
                                          quantize_params_int8)
from repro_torch.training import (OptimizerConfig, TokenStream,  # noqa: E402
                                  TrainConfig, Trainer)

BF16 = torch.bfloat16
LOGIT_TOL, WITNESS, MARGIN = 3e-2, 2.0, 6e-2
ARCHS = ["gemma2-2b", "chatglm3-6b", "mamba2-130m", "moonshot-v1-16b-a3b",
         "seamless-m4t-medium"]
#: the configs whose bf16 logits amplify rounding past LOGIT_TOL in the
#: reference itself: held block by block (module docstring)
ILL_CONDITIONED = ("gemma2-2b", "seamless-m4t-medium")
B, S, T, S_MAX, STEPS = 2, 16, 12, 32, 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_MODELS = {}


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX LM, its fp32 params, the port's fp32 LM with the same
    weights), each built once for the module."""
    def get(arch):
        if arch not in _MODELS:
            jlm = JaxLM(jax_smoke_config(arch), tp=1, q_block=16)
            jp = materialize(jlm.spec(), jax.random.PRNGKey(0), jnp.float32)
            lm = LM(smoke_config(arch), device="cpu")
            load_reference_lm_params(lm, np_tree(jp))
            _MODELS[arch] = (jlm, jp, lm)
        return _MODELS[arch]
    return get


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ---------------------------------------------------------------------------
# (a) the kernels' plain versions against the Pallas kernels at bf16
# ---------------------------------------------------------------------------

def rnd(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("b,hk,g,s,d", [(1, 1, 1, 64, 32),
                                        (2, 2, 2, 128, 32)])
@pytest.mark.parametrize("mode", ["causal", "softcap", "window", "bidir"])
def test_flash_attention_plain_bf16_matches_pallas(b, hk, g, s, d, mode):
    q, k, v = rnd(0, (b, hk, g, s, d)), rnd(1, (b, hk, s, d)), \
        rnd(2, (b, hk, s, d))
    kw = {"causal": dict(causal=True), "softcap": dict(causal=True, cap=20.0),
          "window": dict(causal=True, window=s // 4),
          "bidir": dict(causal=False)}[mode]
    got = flash_attention_ref(*(torch.from_numpy(a).to(BF16)
                                for a in (q, k, v)), **kw)
    assert got.dtype == BF16
    want = flash_attention_kernel(*(jnp.asarray(a, jnp.bfloat16)
                                    for a in (q, k, v)),
                                  bq=32, bk=32, interpret=True, **kw)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,s,h,hk,d,nsplit", [
    (2, 256, 4, 2, 32, 4), (1, 512, 8, 8, 64, 8), (3, 128, 4, 1, 32, 2)])
def test_decode_attention_plain_bf16_matches_pallas(b, s, h, hk, d, nsplit):
    q, k, v = rnd(3, (b, 1, h, d)), rnd(4, (b, s, hk, d)), \
        rnd(5, (b, s, hk, d))
    kv_len = np.random.RandomState(6).randint(1, s + 1, (b, 1)).astype(
        np.int32)
    got = decode_attention(*(torch.from_numpy(a).to(BF16)
                             for a in (q, k, v)), torch.from_numpy(kv_len))
    assert got.dtype == BF16
    want = jax_decode(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                      jnp.asarray(kv_len), nsplit=nsplit, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), atol=3e-2, rtol=3e-2)


# ---------------------------------------------------------------------------
# (b) the LM at bf16 against the reference at bf16
# ---------------------------------------------------------------------------

def lm_inputs(arch):
    """Prompt tokens (B, S), decode tokens (STEPS, B, 1) and, for the
    encoder-decoder, frames (B, T, d), from a numpy seed."""
    cfg = smoke_config(arch)
    rs = np.random.RandomState(7)
    tokens = rs.randint(2, cfg.vocab_size, (B, S))
    steps = rs.randint(2, cfg.vocab_size, (STEPS, B, 1))
    frames = rs.standard_normal((B, T, cfg.d_model)).astype(np.float32) \
        if cfg.encoder_decoder else None
    return tokens, steps, frames


def reference_run(jlm, jp, arch, dtype):
    """The reference's causal logits, prefill logits and STEPS decode
    logits at ``dtype``, and its cache's K leaf dtype."""
    tokens, steps, frames = lm_inputs(arch)
    batch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    t_src = 0
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
        t_src = T
    causal, _ = jax.jit(jlm.logits_causal, static_argnums=2)(jp, batch,
                                                             dtype)
    cache = jlm.init_cache(B, S_MAX, t_src, dtype=dtype)
    logits, cache = jax.jit(jlm.prefill, static_argnums=3)(jp, batch, cache,
                                                          dtype)
    out = [logits]
    decode = jax.jit(jlm.decode, static_argnums=4)
    for i, tok in enumerate(steps):
        logits, cache = decode(jp, jnp.asarray(tok, jnp.int32), cache,
                               jnp.full((B,), S + i, jnp.int32), dtype)
        out.append(logits)
    leaf = jax.tree_util.tree_leaves(cache["layers"])[0]
    return [f32(causal)] + [f32(x) for x in out], leaf.dtype


def port_run(lm, arch, dtype):
    tokens, steps, frames = lm_inputs(arch)
    tok = torch.from_numpy(tokens)
    fr = {} if frames is None else {"frames": torch.from_numpy(frames)}
    causal = lm.logits_causal(tok, dtype=dtype, **fr)
    cache = lm.init_cache(B, S_MAX, T if fr else 0, dtype=dtype)
    logits, cache = lm.prefill(tok, cache, dtype=dtype, **fr)
    out = [causal, logits]
    for i, t in enumerate(steps):
        logits, cache = lm.decode(torch.from_numpy(t), cache,
                                  torch.full((B,), S + i), dtype=dtype)
        out.append(logits)
    assert all(x.dtype == dtype for x in out)
    leaf = next(iter(next(iter(cache["layers"].values())).values()))
    return [f32(x) for x in out], leaf.dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_bf16_logits_match_reference(models, arch):
    """Causal logits, prefill and three decode steps at bf16: no farther
    from the reference's fp32 run than WITNESS times the reference's bf16
    run, and within LOGIT_TOL of it where the config allows it; the caches
    in bf16."""
    jlm, jp, lm = models(arch)
    got, got_dtype = port_run(lm, arch, BF16)
    want, want_dtype = reference_run(jlm, jp, arch, jnp.bfloat16)
    exact, _ = reference_run(jlm, jp, arch, jnp.float32)
    assert got_dtype == BF16 and want_dtype == jnp.bfloat16
    for i, (g, w, e) in enumerate(zip(got, want, exact)):
        if arch not in ILL_CONDITIONED:
            np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=f"{arch} output {i}")
        ours, theirs = np.abs(g - e).max(), np.abs(w - e).max()
        assert ours <= WITNESS * theirs, (arch, i, ours, theirs)


def _blocks(jp, cfg):
    """(stack key, mode, period, block index, kind, the period's block
    params) of every block of the decoder and the encoder."""
    stacks = [(jp["stack"], "causal")]
    if cfg.encoder_decoder:
        stacks.append((jp["encoder"]["stack"], "encode"))
    for stacked, mode in stacks:
        n = jax.tree_util.tree_leaves(stacked)[0].shape[0]
        for i in range(n):
            period = jax.tree_util.tree_map(lambda a: a[i], stacked)
            for j, kind in enumerate(cfg.block_pattern):
                yield mode, i, kind, period[f"i{j}"]


def _to_torch(tree):
    """A reference tree of arrays as torch tensors of the same dtypes."""
    def one(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(f32(a)).to(BF16)
        return torch.from_numpy(np.array(a))
    return jax.tree_util.tree_map(one, tree)


@pytest.mark.parametrize("arch", ILL_CONDITIONED)
def test_lm_bf16_blocks_match_reference(models, arch):
    """Every block at bf16 (the MLP or experts, the mixer, a decoder
    block's cross attention against bf16 K/V) from the same bf16 input:
    within one bf16 ulp of the block output's largest magnitude."""
    from repro.models import attention as jax_attn
    from repro.models import blocks as jax_blocks
    from repro_torch.models import blocks

    jlm, jp, _ = models(arch)
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    rs = np.random.RandomState(9)
    x = jnp.asarray(rs.standard_normal((B, S, cfg.d_model)),
                    jnp.bfloat16)
    enc = jnp.asarray(rs.standard_normal((B, T, cfg.d_model)),
                      jnp.bfloat16)
    pos = np.arange(S)[None]
    for mode, i, kind, p in _blocks(jp, cfg):
        cross = None
        if "cross" in p:
            cross = jax_attn.cross_kv(p["cross"], jcfg.attention, 1, enc)
        want, _, _ = jax_blocks.apply_block(
            jcfg, kind, 1, p, x, mode=mode, positions=jnp.asarray(pos),
            q_block=16, cross_kv=cross)
        got = blocks.apply_block(
            cfg, kind, _to_torch(p), _to_torch(x), mode=mode,
            positions=torch.from_numpy(pos),
            cross_kv=None if cross is None else _to_torch(cross))
        assert got.dtype == BF16
        want = f32(want)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        err = np.abs(f32(got) - want).max()
        assert err <= ulp, (arch, mode, i, kind, err, ulp)


def test_lm_bf16_on_a_cast_model_equals_the_cast_at_use(models):
    """``LM.cast_`` then bf16 calls give the fp32 model's bf16 calls (the
    weights cast at every use) bit for bit, and a call at fp32 is refused."""
    jlm, jp, _ = models("chatglm3-6b")
    lm = LM(smoke_config("chatglm3-6b"), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    want, _ = port_run(lm, "chatglm3-6b", BF16)
    lm.cast_(BF16)
    got, _ = port_run(lm, "chatglm3-6b", BF16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="cast to"):
        lm.logits_causal(torch.zeros((1, 4), dtype=torch.long))


# ---------------------------------------------------------------------------
# (c) the engine at bf16
# ---------------------------------------------------------------------------

class MarginEngine(JaxServingEngine):
    """The reference engine, recording each request's top-2 logit margin
    at every sampled token (prefills in queue order, then each decode
    step's active slots)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.margins = {}
        self._order = []
        prefill = self._prefill

        def recorded_prefill(params, tokens, last_pos):
            logits, cache1 = prefill(params, tokens, last_pos)
            self.margins[self._order.pop(0)] = [_margin(logits[0])]
            return logits, cache1

        lm, dtype = self.lm, self.dtype

        def impl(params, tokens, cache, lens, active):
            logits, cache = lm.decode(params, tokens, cache, lens,
                                      dtype=dtype)
            return (logits, jax_sample(logits[:, 0]), cache,
                    jnp.where(active, lens + 1, lens))

        step = jax.jit(impl)

        def recorded_decode(params, tokens, cache, lens, active):
            logits, tok, cache, lens = step(params, tokens, cache, lens,
                                            active)
            for i, r in enumerate(self.slot_req):
                if r is not None:
                    self.margins[r.uid].append(_margin(logits[i, 0]))
            return tok, cache, lens

        self._prefill, self._decode_step = recorded_prefill, recorded_decode

    def submit(self, req):
        self._order.append(req.uid)
        super().submit(req)


def _margin(logits):
    top = np.sort(f32(logits))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("arch", ["gemma2-2b", "chatglm3-6b",
                                  "mamba2-130m"])
def test_engine_bf16_tokens_match_reference(models, arch):
    jlm, jp, lm = models(arch)
    cfg = smoke_config(arch)
    rs = np.random.RandomState(8)
    prompts = [list(rs.randint(2, cfg.vocab_size, n)) for n in (5, 11, 3)]
    kw = dict(max_slots=2, s_max=S_MAX, eos_id=-1)
    ref = MarginEngine(jax_smoke_config(arch), jp, dtype=jnp.bfloat16,
                       q_block=16, **kw)
    want = {r.uid: r.output for r in ref.run(
        [JaxRequest(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])}
    eng = ServingEngine(lm, dtype=BF16, **kw)
    assert eng.cache["layers"]["i0"][next(iter(
        eng.cache["layers"]["i0"]))].dtype == BF16
    got = {r.uid: r.output for r in eng.run(
        [Request(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])}
    decisive = 0
    for uid, toks in want.items():
        for t, (a, b) in enumerate(zip(got[uid], toks)):
            margin = ref.margins[uid][t]
            decisive += margin > MARGIN
            if a != b:
                # only a near tie may part them; the contexts differ after
                assert margin <= MARGIN, (arch, uid, t, margin)
                break
    print(f"{arch}: {decisive} tokens past the margin, margins "
          f"{ {u: np.round(m, 3).tolist() for u, m in ref.margins.items()} }")
    assert decisive > 0


# ---------------------------------------------------------------------------
# (d) the one-time cast and dequantize_params at bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-130m", "moonshot-v1-16b-a3b",
                                  "seamless-m4t-medium"])
def test_cast_equals_reference_astype(models, arch):
    """Each cast leaf equals ``jnp.asarray(w).astype(bfloat16)`` bit for
    bit; the others (norms, router, A_log, D, dt_bias) stay fp32."""
    _, jp, _ = models(arch)
    lm = LM(smoke_config(arch), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    lm.cast_(BF16)
    ref = flatten(np_tree(jp))
    kept = set()
    for name, p in lm.named_parameters():
        if cast_leaf(name):
            want = np.asarray(jnp.asarray(ref[name]).astype(jnp.bfloat16))
            assert p.dtype == BF16, name
            np.testing.assert_array_equal(
                p.view(torch.int16).numpy(), want.view(np.int16),
                err_msg=name)
        else:
            assert p.dtype == torch.float32, name
            np.testing.assert_array_equal(p.numpy(), ref[name])
            kept.add(name.rsplit(".", 1)[-1])
    assert "scale" in kept
    assert kept & {"router", "A_log", "D", "dt_bias", "norm_scale"} or \
        arch == "seamless-m4t-medium"


def test_bf16_build_draws_in_fp32_and_rounds():
    """``LM(cfg, dtype=bf16).init(g)`` holds the cast leaves in bf16, the
    rounding of the fp32 model's draw at the same seed (each leaf of this
    size in one draw), and the others in fp32, equal to it."""
    cfg = smoke_config("moonshot-v1-16b-a3b")
    a = LM(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    b = LM(cfg, device="cpu", dtype=BF16).init(
        torch.Generator().manual_seed(1))
    pa = dict(a.named_parameters())
    for name, p in b.named_parameters():
        want = pa[name].to(BF16) if cast_leaf(name) else pa[name]
        assert p.dtype == want.dtype and torch.equal(p, want), name
    with pytest.raises(ValueError, match="cast to"):
        ServingEngine(b, max_slots=1, s_max=8)


def test_dequantize_params_bf16_equals_reference(models):
    _, jp, lm = models("chatglm3-6b")
    q, _ = quantize_params_int8(lm.tree())
    got = flatten(dequantize_params(q, BF16))
    want = flatten(np_tree(jax_dequantize(jax_quantize(jp)[0],
                                          jnp.bfloat16)))
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if w.dtype == np.float32:       # a leaf left as it was
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
            continue
        assert g.dtype == BF16, name
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      w.view(np.int16), err_msg=name)


# ---------------------------------------------------------------------------
# (e) the trainer's bf16 step
# ---------------------------------------------------------------------------

def test_bf16_step_matches_reference(models, monkeypatch):
    """Two steps under ``REPRO_CAST_BF16_STEP=1`` against the reference's
    ``make_train_step`` under the same env (fp32 loss, bf16 weights inside
    the differentiated function): the step-1 gradients of every leaf
    (a period-stacked one's in its ``.grad``), then both steps' losses."""
    monkeypatch.setenv("REPRO_CAST_BF16_STEP", "1")
    arch = "chatglm3-6b"
    jlm, jp, _ = models(arch)
    cfg = jax_smoke_config(arch)
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=50)

    def cast(p):
        return jax.tree_util.tree_map(
            lambda w: w.astype(jnp.bfloat16)
            if w.dtype == jnp.float32 and w.ndim >= 2 else w, p)

    stream = TokenStream(cfg.vocab_size, 4, 16, seed=0, device="cpu")
    batch = stream.next_batch()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = flatten(np_tree(jax.grad(
        lambda p: jlm.loss(cast(p), jb, jnp.float32))(jp)))
    lm = LM(smoke_config(arch), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    params = dict(lm.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    with cast_step(BF16):
        lm.loss(batch).backward()
    assert params["stack.i0.mixer.wq"].grad is not None
    for name, w in want.items():
        g = params[name].grad
        assert g is not None and g.dtype == torch.float32, name
        err = np.abs(g.numpy() - w).max()
        assert err <= 2.0 ** -8 * np.abs(w).max(), (name, err)

    step = jax_make_train_step(lambda p, b: jlm.loss(p, b, jnp.float32),
                               JaxOptimizerConfig(**opt), donate=False)
    jparams = jax.tree_util.tree_map(jnp.array, jp)
    state = jax_adamw_init(jparams, JaxOptimizerConfig(**opt))
    jstream = JaxTokenStream(cfg.vocab_size, 4, 16, seed=0)
    ref_losses = []
    for _ in range(2):
        jparams, state, m = step(jparams, state, jstream.next_batch())
        ref_losses.append(float(m["loss"]))
    lm = LM(smoke_config(arch), device="cpu")
    load_reference_lm_params(lm, np_tree(jp))
    out = Trainer(lm.loss, dict(lm.named_parameters()),
                  OptimizerConfig(**opt),
                  TrainConfig(steps=2, grad_accum=1, log_every=0),
                  TokenStream(cfg.vocab_size, 4, 16, seed=0, device="cpu")
                  ).train()
    np.testing.assert_allclose(out["history"], ref_losses, rtol=1e-4)
