"""The port's training substrate against the JAX package's.

Inputs are numpy arrays (or the reference's seeded init, bridged); both
packages get the same values.  What is held, and how tightly:
  * ``lr_schedule`` within 1e-7;
  * the int8 moment codes and scales exactly against the reference's eager
    ``_q8``/``_q8_v``; against the jitted ``adamw_update`` (where XLA
    computes ``/127`` as ``*(1/127)``) scales within one ulp and codes
    within one step;
  * one ``adamw_update`` from identical params, gradients and state within
    1e-6 relative (fp32 and int8 moments);
  * checkpoints: a round trip bit for bit, keep-N with no ``.tmp`` left,
    the reference's saved tree read back, the reference's stream-model
    cache refused;
  * ``TokenStream`` batches equal to the reference's, and resumable;
  * the LM trainer on the chatglm3-6b smoke config from the bridged init:
    step-1 gradients within 1e-4 of each leaf's largest |g|, three steps'
    losses (grad_accum 2) within 1e-4 relative with fp32 moments, 1e-3
    with int8 ones.  Parameters are not compared after several steps:
    AdamW's first step is close to a sign step, so a leaf whose gradient
    is near zero may step either way in either package;
  * the port's restore-and-replay within the reference test's rtol 1e-4.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import LM as JaxLM  # noqa: E402
from repro.models import materialize  # noqa: E402
from repro.training import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.training import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.training import TokenStream as JaxTokenStream  # noqa: E402
from repro.training import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402

from repro_torch.bridge import (flatten, load_reference_lm_params,  # noqa: E402
                                load_reference_opt_state)
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.training import (CheckpointManager, OptimizerConfig,  # noqa: E402
                                  TokenStream, TrainConfig, Trainer,
                                  make_train_step)
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.data import DistillBatcher, distill_loss_fn  # noqa: E402

ARCH = "chatglm3-6b"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference_lm():
    cfg = jax_smoke_config(ARCH)
    lm = JaxLM(cfg, tp=1)
    params = materialize(lm.spec(), jax.random.PRNGKey(0), jnp.float32)
    return cfg, lm, params


def port_lm(params):
    lm = LM(smoke_config(ARCH), device="cpu")
    load_reference_lm_params(lm, np_tree(params))
    return lm


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 140])
def test_lr_schedule_matches_reference(step):
    for cfg in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                     min_lr_frac=0.1),
                dict(lr=3e-4, warmup_steps=20, total_steps=140)):
        want = float(jopt.lr_schedule(JaxOptimizerConfig(**cfg),
                                      jnp.asarray(step)))
        got = float(topt.lr_schedule(OptimizerConfig(**cfg),
                                     torch.tensor(step)))
        assert abs(got - want) <= 1e-7 * max(1.0, abs(want)), (got, want)


def _moment_rows(seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(6, 40) * np.exp(rs.randn(6, 1) * 3)).astype(np.float32)
    x[0, :5] = 0.0
    x[1] = 0.0                    # an all-zero row: the 1e-12 floor
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["m", "v"])
def test_int8_codes_and_scales_exact_against_eager_reference(seed, kind):
    x = _moment_rows(seed)
    if kind == "v":
        x = np.abs(x) ** 2
        q_j, s_j = jopt._q8_v(jnp.asarray(x))
        q_t, s_t = topt._q8_v(torch.from_numpy(x))
        back_j, back_t = jopt._dq8_v(q_j, s_j), topt._dq8_v(q_t, s_t)
    else:
        q_j, s_j = jopt._q8(jnp.asarray(x))
        q_t, s_t = topt._q8(torch.from_numpy(x))
        back_j, back_t = jopt._dq8(q_j, s_j), topt._dq8(q_t, s_t)
    assert q_t.dtype == torch.int8 and s_t.shape == (6, 1)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))


def _opt_inputs(quant, seed=0):
    """Params, grads and a mid-training state (step 4, moments nonzero) as
    numpy trees in the reference's layout, plus the port's flat views."""
    rs = np.random.RandomState(seed)
    params = {"w": rs.randn(3, 8, 16).astype(np.float32),
              "b": rs.randn(16).astype(np.float32),
              "norm": {"scale": (1 + 0.1 * rs.randn(3, 16)).astype(
                  np.float32)}}
    grads = jax.tree_util.tree_map(
        lambda p: (rs.randn(*p.shape) * 0.3).astype(np.float32), params)
    cfg = JaxOptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=20,
                             quantized_state=quant)

    def moments(p):
        m = (rs.randn(*p.shape) * 0.05).astype(np.float32)
        v = (rs.rand(*p.shape) * 0.01).astype(np.float32)
        if quant and p.ndim >= 2:
            m_q, m_s = jopt._q8(jnp.asarray(m))
            v_q, v_s = jopt._q8_v(jnp.asarray(v))
            return {"m_q": m_q, "m_s": m_s, "v_q": v_q, "v_s": v_s}
        return {"m": m, "v": v}

    state = {"moments": jax.tree_util.tree_map(moments, params),
             "step": np.asarray(4, np.int32)}
    return cfg, params, grads, np_tree(state)


class _Holder(torch.nn.Module):
    """A module whose dotted parameter names are a tree's paths."""

    def __init__(self, tree, prefix=""):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Holder(v))
            else:
                self.register_parameter(k, torch.nn.Parameter(
                    torch.tensor(v), requires_grad=False))
        self.device = torch.device("cpu")


@pytest.mark.parametrize("quant", [False, True])
def test_one_adamw_update_matches_reference(quant):
    cfg, params, grads, state = _opt_inputs(quant)
    new_j, state_j, metrics_j = jopt.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, state), cfg)
    holder = _Holder(params)
    tparams = dict(holder.named_parameters())
    tstate = load_reference_opt_state(holder, state)
    tgrads = {k: torch.from_numpy(v) for k, v in flatten(grads).items()}
    tcfg = OptimizerConfig(**{f: getattr(cfg, f) for f in
                              cfg.__dataclass_fields__})
    tstate, metrics = topt.adamw_update(tparams, tgrads, tstate, tcfg)
    assert int(tstate["step"]) == int(state_j["step"]) == 5
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(metrics_j["grad_norm"]), rtol=1e-6)
    for name, want in flatten(np_tree(new_j)).items():
        np.testing.assert_allclose(tparams[name].numpy(), want, rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    moments_j = flatten(np_tree(state_j["moments"]))
    for key, want in moments_j.items():
        name, _, leaf = key.rpartition(".")
        got = tstate["moments"][name][leaf].numpy()
        if leaf.endswith("_q"):
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9,
                                       err_msg=key)


def test_int8_state_against_jitted_reference_update():
    """XLA rewrites the scale's ``/127`` as ``*(1/127)``: the jitted
    update's scales are within one ulp of the port's, and a code moves by
    at most one step where its row's scale differs."""
    cfg, params, grads, state = _opt_inputs(True, seed=3)
    _, state_j, _ = jax.jit(jopt.adamw_update, static_argnums=3)(
        params, grads, state, cfg)
    holder = _Holder(params)
    tstate = load_reference_opt_state(holder, state)
    tcfg = OptimizerConfig(**{f: getattr(cfg, f) for f in
                              cfg.__dataclass_fields__})
    tstate, _ = topt.adamw_update(
        dict(holder.named_parameters()),
        {k: torch.from_numpy(v) for k, v in flatten(grads).items()},
        tstate, tcfg)
    for name in ("w", "norm.scale"):
        ref = flatten(np_tree(state_j["moments"]))
        for m in ("m", "v"):
            s_t = tstate["moments"][name][f"{m}_s"].numpy()
            s_j = ref[f"{name}.{m}_s"]
            np.testing.assert_array_max_ulp(s_t, s_j, maxulp=1)
            q_t = tstate["moments"][name][f"{m}_q"].numpy().astype(int)
            q_j = ref[f"{name}.{m}_q"].astype(int)
            same_row = np.broadcast_to(s_t == s_j, q_t.shape)
            assert np.abs(q_t - q_j).max() <= 1
            assert (q_t == q_j)[same_row].mean() > 0.99


def test_none_gradient_is_a_zero_gradient():
    """A leaf without a gradient still decays its moments and its weight
    (the reference updates every leaf every step)."""
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=0, weight_decay=0.1)
    w = torch.ones(4, 4)
    state = topt.adamw_init({"w": w}, cfg)
    state["moments"]["w"]["m"].fill_(0.5)
    state, _ = topt.adamw_update({"w": w}, {"w": None}, state, cfg)
    assert torch.all(state["moments"]["w"]["m"] == 0.9 * 0.5)
    assert torch.all(w < 1.0)


def test_update_in_slices_equals_whole_update(monkeypatch):
    """A leaf updated a leading-axis slice at a time gives the whole-leaf
    update bit for bit (scales run along the last axis).  The clip is off:
    the global norm's sum runs slice by slice too, in another order."""
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=1, quantized_state=True,
                          grad_clip=1e9)
    gen = torch.Generator().manual_seed(4)
    w0 = torch.randn(4, 6, 32, generator=gen)
    g = torch.randn(4, 6, 32, generator=gen)
    runs = []
    for chunk in (1 << 24, 6 * 32):
        monkeypatch.setattr(topt, "CHUNK", chunk)
        w = w0.clone()
        state = topt.adamw_init({"w": w}, cfg)
        for _ in range(2):
            state, _ = topt.adamw_update({"w": w}, {"w": g}, state, cfg)
        runs.append((w, state["moments"]["w"]))
    assert torch.equal(runs[0][0], runs[1][0])
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_bitwise():
    gen = torch.Generator().manual_seed(2)
    tree = {"params": {"a": torch.randn(3, 4, generator=gen),
                       "n": {"b": torch.randn(5, generator=gen)}},
            "opt": {"q": torch.randint(-127, 128, (2, 3), generator=gen,
                                       dtype=torch.int8),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "list": [torch.zeros(2), torch.ones(1)]}
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, device="cpu")
        ck.save(3, tree)
        back = ck.restore(3)
        assert ck.manifest(3)["package"] == "repro_torch"
    flat, back_flat = flatten(tree["params"]), flatten(back["params"])
    assert set(flat) == set(back_flat)
    for k in flat:
        assert torch.equal(flat[k], back_flat[k])
    assert back["opt"]["q"].dtype == torch.int8
    assert torch.equal(back["opt"]["q"], tree["opt"]["q"])
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 7
    assert isinstance(back["list"], list) and len(back["list"]) == 2


def test_checkpoint_gc_keeps_last_n_and_no_tmp():
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2, device="cpu")
        for s in (1, 2, 3):
            ck.save(s, {"a": torch.ones(4) * s,
                        "n": {"b": torch.zeros(2, 2)}})
        assert ck.list_steps() == [2, 3]
        assert ck.latest_step() == 3
        assert torch.equal(ck.restore(3)["a"], 3 * torch.ones(4))
        assert not any(p.endswith(".tmp") for p in os.listdir(d))


def test_reference_checkpoint_loads_in_the_port(reference_lm):
    cfg, _, params = reference_lm
    with tempfile.TemporaryDirectory() as d:
        JaxCheckpointManager(d).save(1, {"params": params})
        tree = CheckpointManager(d, device="cpu").restore(1)
    lm = LM(smoke_config(ARCH), device="cpu")
    lm.load_state_dict(flatten(tree["params"]))
    for name, want in flatten(np_tree(params)).items():
        np.testing.assert_array_equal(
            dict(lm.named_parameters())[name].numpy(), want)


def test_port_refuses_the_reference_stream_model_cache():
    from repro_torch.streaming.pretrain import train_stream_models

    with tempfile.TemporaryDirectory() as d:
        JaxCheckpointManager(d, keep=1).save(
            1, {"mllm": {"conv1": jnp.zeros((3, 3, 3, 48))},
                "small": {}, "pruned": {}, "det": {}})
        with pytest.raises(ValueError, match="repro_torch"):
            train_stream_models(cache_dir=d, device="cpu", verbose=False)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_token_stream_equals_reference_and_resumes():
    ref = JaxTokenStream(512, 4, 16, seed=3)
    port = TokenStream(512, 4, 16, seed=3, device="cpu")
    for _ in range(3):
        a, b = ref.next_batch(), port.next_batch()
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(b[key].numpy(), np.asarray(a[key]))
    again = TokenStream(512, 4, 16, seed=3, device="cpu")
    again.set_state(port.state())
    assert again.index == 3
    port.set_state({"index": np.asarray(2), "seed": np.asarray(3)})
    b2 = port.next_batch()
    fresh = TokenStream(512, 4, 16, seed=3, device="cpu")
    [fresh.next_batch() for _ in range(2)]
    assert torch.equal(b2["tokens"], fresh.next_batch()["tokens"])


def test_distill_loss_matches_reference(reference_lm):
    cfg, jlm, params = reference_lm
    lm = port_lm(params)
    rs = np.random.RandomState(5)
    teacher = rs.randn(2, 16, lm.cfg.padded_vocab).astype(np.float32)
    stream = TokenStream(cfg.vocab_size, 2, 16, seed=1, device="cpu")
    batch = DistillBatcher(stream, lambda b: torch.from_numpy(teacher)
                           ).next_batch()
    want = jax_data.distill_loss_fn(jlm)(params, {
        "tokens": jnp.asarray(batch["tokens"].numpy()),
        "labels": jnp.asarray(batch["labels"].numpy()),
        "teacher_logits": jnp.asarray(teacher)})
    got = distill_loss_fn(lm)(batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# the LM trainer
# ---------------------------------------------------------------------------

def test_lm_step1_gradients_match_reference(reference_lm):
    """grad_accum 2: the mean of the two micro-batches' gradients."""
    cfg, jlm, params = reference_lm
    batch = TokenStream(cfg.vocab_size, 4, 16, seed=0, device="cpu"
                        ).next_batch()
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    grad_fn = jax.grad(lambda p, b: jlm.loss(p, b, jnp.float32))
    g1 = grad_fn(params, {k: v[:2] for k, v in jb.items()})
    g2 = grad_fn(params, {k: v[2:] for k, v in jb.items()})
    want = flatten(np_tree(jax.tree_util.tree_map(
        lambda a, b: (a + b) / 2, g1, g2)))

    lm = port_lm(params)
    tparams = dict(lm.named_parameters())
    for p in tparams.values():
        p.requires_grad_(True)
    for half in (slice(0, 2), slice(2, 4)):
        lm.loss({k: v[half] for k, v in batch.items()}).backward()
    assert set(want) == set(tparams)
    for name, w in want.items():
        got = tparams[name].grad.numpy() / 2
        err = np.abs(got - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("quant,rtol", [(False, 1e-4), (True, 1e-3)])
def test_lm_trainer_losses_match_reference(reference_lm, quant, rtol):
    cfg, jlm, params = reference_lm
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=50,
               quantized_state=quant)
    # the reference's step donates its parameters: hand it a copy
    ref = JaxTrainer(lambda p, b: jlm.loss(p, b, jnp.float32),
                     jax.tree_util.tree_map(jnp.array, params),
                     JaxOptimizerConfig(**opt),
                     JaxTrainConfig(steps=3, grad_accum=2, log_every=0),
                     JaxTokenStream(cfg.vocab_size, 4, 16, seed=0)).train()
    lm = port_lm(params)
    port = Trainer(lm.loss, dict(lm.named_parameters()),
                   OptimizerConfig(**opt),
                   TrainConfig(steps=3, grad_accum=2, log_every=0),
                   TokenStream(cfg.vocab_size, 4, 16, seed=0, device="cpu")
                   ).train()
    np.testing.assert_allclose(port["history"], ref["history"], rtol=rtol)


def test_trainer_restore_replays_exactly(reference_lm):
    cfg, _, params = reference_lm
    opt = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, keep=2, device="cpu")
        lm = port_lm(params)
        tr = Trainer(lm.loss, dict(lm.named_parameters()), opt,
                     TrainConfig(steps=6, grad_accum=1, ckpt_every=3,
                                 log_every=0),
                     TokenStream(cfg.vocab_size, 4, 16, seed=0,
                                 device="cpu"), ck)
        tr.train()
        assert ck.latest_step() == 6
        more = tr.train(4)
        lm2 = port_lm(params)           # fresh weights: restore must set them
        tr2 = Trainer(lm2.loss, dict(lm2.named_parameters()), opt,
                      TrainConfig(steps=4, grad_accum=1, log_every=0),
                      TokenStream(cfg.vocab_size, 4, 16, seed=0,
                                  device="cpu"), ck)
        assert tr2.restore(step=6)
        assert tr2.step == 6 and tr2.data.index == 6
        assert int(tr2.opt_state["step"]) == 6
        out2 = tr2.train(4)
    np.testing.assert_allclose(out2["history"], more["history"][-4:],
                               rtol=1e-4, atol=1e-5)


def test_bf16_step_is_refused(monkeypatch):
    """The bf16 step is ported for the LM (``tests/test_torch_bf16.py``);
    the stream models' pretraining, whose layers do not take the cast,
    refuses it before any step."""
    from repro_torch.streaming import pretrain

    monkeypatch.setenv("REPRO_CAST_BF16_STEP", "1")
    with pytest.raises(NotImplementedError, match="bf16"):
        pretrain._train(lambda b: b, {}, lambda i: {}, 1)


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    """The launcher's smoke run, then a resume from its checkpoint."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "10",
            "--batch", "4", "--seq", "16", "--int8-opt",
            "--ckpt-dir", str(tmp_path)]
    out = train_launcher.main(argv)
    assert out["step"] == 10 and np.all(np.isfinite(out["losses"]))
    assert CheckpointManager(str(tmp_path), device="cpu").latest_step() == 10
    again = train_launcher.main(argv[:6] + ["2"] + argv[7:] + ["--resume"])
    assert "resumed from step 10" in capsys.readouterr().out
    assert again["step"] == 12 and len(again["losses"]) == 2


def test_period_gradients_land_as_each_period_finishes(monkeypatch):
    """A stacked leaf's period slice passes its gradient into ``.grad``
    right after that period's backward, before the period below it runs:
    autograd runs later-made nodes first, so slices made before the whole
    stack would hold every period's gradient until the end (23 GB at
    chatglm3-6b)."""
    from repro_torch.models import blocks

    log = []
    slice_backward = blocks._PeriodSlice.backward

    def backward(ctx, g):
        log.append(("slice", ctx.i))
        return slice_backward(ctx, g)

    block = blocks.apply_block

    def apply_block(*args, **kw):
        y = block(*args, **kw)
        i = sum(1 for e in log if e[0] == "forward")
        log.append(("forward", i))
        y.register_hook(lambda g, i=i: log.append(("grad", i)))
        return y

    monkeypatch.setattr(blocks._PeriodSlice, "backward",
                        staticmethod(backward))
    monkeypatch.setattr(blocks, "apply_block", apply_block)
    cfg = smoke_config(ARCH).replace(n_layers=3)
    lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for p in lm.parameters():
        p.requires_grad_(True)
    lm.loss(TokenStream(cfg.vocab_size, 2, 8, device="cpu").next_batch()
            ).backward()
    order = [e for e in log if e[0] != "forward"]
    for i in (2, 1, 0):
        at = order.index(("grad", i))
        slices = [e for e in order[at + 1:] if e[0] == "slice"]
        below = order.index(("grad", i - 1)) if i else len(order)
        assert all(e == ("slice", i) for e in order[at + 1:below]), order
        assert len(slices) and slices[0] == ("slice", i)


def test_train_launcher_depth_cuts_the_stack(tmp_path):
    """``--depth`` trains the config with that many layers, its width
    unchanged: the checkpointed stacked weights (saved at step 10) have
    one period."""
    full = smoke_config(ARCH)
    assert full.n_layers > 1
    out = train_launcher.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "10",
         "--batch", "2", "--seq", "8", "--depth", "1",
         "--ckpt-dir", str(tmp_path)])
    assert out["n_layers"] == 1 and out["step"] == 10
    assert np.all(np.isfinite(out["losses"]))
    ck = CheckpointManager(str(tmp_path), device="cpu")
    flat = flatten(ck.restore(ck.latest_step()))
    scales = [k for k in flat if k.startswith("params.")
              and k.endswith("pre_norm.scale")]
    assert scales
    for k in scales:
        assert tuple(flat[k].shape) == (1, full.d_model), k


def _select_periods(tree, n):
    """``blocks._periods`` by plain autograd: period i is ``leaf[i]``."""
    if isinstance(tree, dict):
        subs = {k: _select_periods(v, n) for k, v in tree.items()}
        return lambda i: {k: f(i) for k, f in subs.items()}
    return lambda i: tree[i]


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma2-2b"])
def test_period_slices_equal_select_autograd(monkeypatch, arch):
    """``.grad`` after ``loss.backward()`` through ``_PeriodSlice`` (which
    adds a period's gradient into ``.grad`` from inside autograd) equals
    plain autograd through ``leaf[i]``, bit for bit, over two accumulated
    micro-batches; gemma2's period holds two blocks and ties its
    embedding."""
    from repro_torch.models import blocks

    cfg = smoke_config(arch)
    data = TokenStream(cfg.vocab_size, 2, 8, device="cpu")
    batches = [data.next_batch() for _ in range(2)]

    def grads():
        lm = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        for p in lm.parameters():
            p.requires_grad_(True)
        for b in batches:
            lm.loss(b).backward()
        return {k: p.grad for k, p in lm.named_parameters()}

    got = grads()
    monkeypatch.setattr(blocks, "_periods", _select_periods)
    want = grads()
    assert got.keys() == want.keys()
    stacked = [k for k, g in got.items() if g.dim() and g.shape[0] ==
               cfg.n_layers // len(cfg.block_pattern) and "stack" in k]
    assert stacked
    for k in got:
        assert torch.equal(got[k], want[k]), k
