"""The port's decode attention (plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode, its jnp oracle and the JAX
model's own decode attention.

Inputs are made with numpy from a seed and handed to both packages.  fp32
tolerance 2e-5 (the reference sweep's): the two packages sum in different
orders; bf16 3e-2, as the reference sweep holds its own kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.common.config import AttentionConfig as JaxAttentionConfig  # noqa: E402
from repro.kernels.decode_attention.ops import decode_attention as jax_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402

from repro_torch.common.config import AttentionConfig  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    BF16_GROUP, BF16_MAX_CLUSTER, BF16_MAX_CLUSTERS, BF16_MIN_KEYS,
    BF16_STAGE, MAX_SPLITS, MIN_KEYS_PER_SPLIT, TILE, bf16_blocks,
    bf16_cluster, bf16_grid, bf16_plan, grid_waves, split_blocks,
    split_plan)
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

TOL = 2e-5
jax_decode_ref = jax.jit(jax_decode_ref, static_argnames=("cap", "window"))


def randn(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).standard_normal(shape)
            ).astype(np.float32)


def lengths(seed, b, s):
    return np.random.RandomState(seed).randint(1, s + 1, (b, 1)).astype(
        np.int32)


def port(q, k, v, kv_len, **kw):
    return decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(kv_len),
                            **kw).numpy()


def oracle(q, k, v, kv_len, **kw):
    b, _, h, d = q.shape
    hk = k.shape[2]
    out = jax_decode_ref(jnp.asarray(q[:, 0].reshape(b, hk, h // hk, d)),
                         jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
                         **kw)
    return np.asarray(out).reshape(b, 1, h, d)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


# the reference sweep's shapes (tests/test_kernels.py)
SWEEP = [(2, 256, 4, 2, 32, 4), (1, 512, 8, 8, 64, 8), (3, 128, 4, 1, 32, 2)]


@pytest.mark.parametrize("b,s,h,hk,d,nsplit", SWEEP)
@pytest.mark.parametrize("kw", [{}, {"cap": 50.0}, {"window": 64},
                                {"cap": 50.0, "window": 64}],
                         ids=["plain", "cap", "window", "cap+window"])
def test_decode_attention_sweep(b, s, h, hk, d, nsplit, kw):
    q, k, v = randn(0, (b, 1, h, d)), randn(1, (b, s, hk, d)), \
        randn(2, (b, s, hk, d))
    kv_len = lengths(0, b, s)
    got = port(q, k, v, kv_len, **kw)
    close(got, jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(kv_len), nsplit=nsplit,
                          interpret=True, **kw))
    close(got, oracle(q, k, v, kv_len, **kw))


@pytest.mark.parametrize("b,s,h,hk,d,nsplit", SWEEP)
def test_decode_attention_bf16(b, s, h, hk, d, nsplit):
    """bf16 inputs: the plain version (fp32 inside) against the Pallas
    kernel at the reference sweep's bf16 tolerance.  The CUDA kernel's
    bf16 entry point is held to this plain version on the card
    (``tests/test_torch_cuda.py``)."""
    q, k, v = randn(0, (b, 1, h, d)), randn(1, (b, s, hk, d)), \
        randn(2, (b, s, hk, d))
    kv_len = lengths(0, b, s)
    got = decode_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                             for a in (q, k, v)), torch.from_numpy(kv_len))
    assert got.dtype == torch.bfloat16
    want = jax_decode(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                      jnp.asarray(kv_len), nsplit=nsplit, interpret=True)
    close(got.float().numpy(), want, tol=3e-2)


@pytest.mark.parametrize("case", ["kv_len_1", "window_longer_than_len",
                                  "g1", "d64", "s_max_300", "gemma_shape",
                                  "chatglm3_heads", "phi3_heads"])
def test_decode_attention_ragged(case):
    """Shapes the engine gives: a slot of one key, a window longer than the
    slot, no grouping, D = 64, a cache length that is not a multiple of the
    Pallas kernel's tiles, gemma2's heads (H/Hk 8/4, D 256, cap 50,
    window 4096) over a short cache, chatglm3 / glm4's (32/2, D 128: a
    group of 16) and phi3-mini's (32/32, D 96)."""
    b, s, h, hk, d, kw, lens = {
        "kv_len_1": (2, 64, 4, 2, 32, {}, [1, 1]),
        "window_longer_than_len": (2, 64, 4, 2, 32, {"window": 100},
                                   [5, 64]),
        "g1": (2, 64, 4, 4, 32, {"cap": 20.0}, [17, 3]),
        "d64": (3, 96, 8, 2, 64, {"window": 8}, [1, 9, 96]),
        "s_max_300": (2, 300, 4, 2, 32, {"window": 50}, [299, 300]),
        "gemma_shape": (2, 40, 8, 4, 256, {"cap": 50.0, "window": 4096},
                        [7, 30]),
        "chatglm3_heads": (2, 40, 32, 2, 128, {}, [7, 40]),
        "phi3_heads": (2, 40, 32, 32, 96, {}, [1, 23]),
    }[case]
    q, k, v = randn(3, (b, 1, h, d)), randn(4, (b, s, hk, d)), \
        randn(5, (b, s, hk, d))
    kv_len = np.asarray(lens, np.int32)[:, None]
    close(port(q, k, v, kv_len, **kw), oracle(q, k, v, kv_len, **kw))


def test_keys_at_or_beyond_kv_len_are_never_visible():
    """Right-padded prefill leaves keys past a slot's length in its cache:
    changing them changes nothing."""
    b, s, h, hk, d = 2, 64, 4, 2, 32
    q, k, v = randn(6, (b, 1, h, d)), randn(7, (b, s, hk, d)), \
        randn(8, (b, s, hk, d))
    kv_len = np.asarray([[10], [33]], np.int32)
    k2, v2 = k.copy(), v.copy()
    for i, n in enumerate(kv_len[:, 0]):
        k2[i, n:] = 1e4
        v2[i, n:] = -1e4
    np.testing.assert_array_equal(port(q, k, v, kv_len),
                                  port(q, k2, v2, kv_len))


@pytest.mark.parametrize("window", [3, 8, 16])
def test_decode_window_equals_prefill_window_at_the_last_row(window):
    """The decode mask (kpos > kv_len - 1 - window) and the prefill mask
    (kpos > qpos - window) agree at qpos = kv_len - 1, on both sides of the
    window's edge: decode row t of a cache equals row t of windowed causal
    prefill attention over the same keys."""
    s, h, hk, d = 24, 4, 2, 32
    q, k, v = randn(9, (1, s, h, d)), randn(10, (1, s, hk, d)), \
        randn(11, (1, s, hk, d))
    pre = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, cap=50.0,
                          window=window).numpy()
    for t in range(s):
        got = port(q[:, t:t + 1], k, v, np.asarray([[t + 1]], np.int32),
                   cap=50.0, window=window)
        close(got[:, 0], pre[:, t])


def test_plain_version_kernel_layout_vs_oracle():
    b, s, hk, g, d = 2, 128, 2, 3, 32
    q, k, v = randn(12, (b, hk, g, d)), randn(13, (b, s, hk, d)), \
        randn(14, (b, s, hk, d))
    kv_len = lengths(1, b, s)
    got = decode_attention_ref(*(torch.from_numpy(a)
                                 for a in (q, k, v, kv_len)), window=40)
    close(got.numpy(), jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(kv_len),
                                      window=40))


@pytest.mark.parametrize("local", [False, True])
def test_attend_decode_matches_reference(local):
    """The model's decode attention with per-slot lengths: the new k/v are
    written at each slot's length and attention reads the slot's live keys
    (its window on a local layer), as JAX ``attend_decode`` computes."""
    d_model, b, s_max = 64, 3, 48
    jatt = JaxAttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              softcap=50.0, window=16)
    att = AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                          softcap=50.0, window=16)
    p = {"wq": randn(20, (d_model, 4, 16), 0.125),
         "wk": randn(21, (d_model, 2, 16), 0.125),
         "wv": randn(22, (d_model, 2, 16), 0.125),
         "wo": randn(23, (4, 16, d_model), 0.25)}
    x = randn(24, (b, 1, d_model))
    ck, cv = randn(25, (b, s_max, 2, 16)), randn(26, (b, s_max, 2, 16))
    lens = np.asarray([0, 20, 47], np.int32)
    y, jk, jv = jax_attn.attend_decode(
        {n: jnp.asarray(a) for n, a in p.items()}, jatt, 1, jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(lens), local=local)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = attn.attend_decode({n: torch.from_numpy(a) for n, a in p.items()},
                             att, torch.from_numpy(x), tk, tv,
                             torch.from_numpy(lens).long(), local=local)
    close(got.numpy(), y)
    close(tk.numpy(), jk)
    close(tv.numpy(), jv)


def test_num_splits_cover_the_cache():
    """The kernel's split rule (mirrored by ``split_plan``): a kv head's
    budget of blocks is shared over the sequences by their live keys, not
    by the cache's size.  Each sequence's splits cover its live range
    exactly in whole 32-key tiles, at most one per MIN_KEYS_PER_SPLIT keys;
    the splits fit the budget (or one a sequence where the budget is
    smaller); a decode tick's short slots are one split each.  The budget
    is the blocks the card holds at once over the kv heads, in one wave or
    in two where an SM holds two blocks or more."""
    for nb in (1, 3, 8, 17, 33, 66, 200):
        for lives in ([0], [1, 4, 35, 127], [7, 23, 30, 4206],
                      [7, 30, 4100, 4250], [128, 129, 300, 4096],
                      [8192] * 4, [1 << 20, 5], list(range(0, 600, 37))):
            plan = split_plan(lives, nb)
            for live, (n, chunk) in zip(lives, plan):
                assert chunk % TILE == 0 and 1 <= n <= MAX_SPLITS
                assert chunk * (n - 1) < max(live, 1) <= chunk * n
                assert n <= max(1, -(-live // MIN_KEYS_PER_SPLIT))
            assert sum(n for n, _ in plan) <= max(nb, len(lives))
    assert [n for n, _ in split_plan([6, 14, 23, 35], 66)] == [1] * 4
    # chatglm3-6b and gemma2-2b (one block an SM of 132: one wave) and
    # phi3-mini (two an SM: two waves) at 4 slots of 8192
    assert split_blocks(4, 2, 8192, None, 132, 1) == 66
    assert split_blocks(4, 4, 8192, None, 132, 1) == 33
    assert split_blocks(4, 4, 8192, 4096, 132, 1) == 33
    assert split_blocks(4, 32, 8192, None, 132, 2) == 16
    assert [grid_waves(n) for n in (1, 2, 3)] == [1, 2, 2]
    # the served tick, one long slot beside three short ones: the long slot
    # takes the budget (chatglm3 up to one split per 128 keys), and the
    # blocks fit the budget's waves of the card
    for hk, per_sm, lives, long_plan in (
            (2, 1, [7, 23, 30, 4206], (33, 128)),
            (4, 1, [7, 23, 30, 4206], (27, 160)),
            (4, 1, [7, 23, 30, 4096], (26, 160)),    # gemma2's window
            (32, 2, [7, 23, 30, 4206], (12, 352)),
            (2, 1, [7, 30, 4100, 4250], (27, 160)),
            (4, 1, [7, 30, 4100, 4250], (15, 288))):
        plan = split_plan(lives, split_blocks(4, hk, 8192, None, 132, per_sm))
        assert plan[-1] == long_plan and plan[0] == (1, TILE)
        blocks = hk * sum(n for n, _ in plan)
        assert blocks <= grid_waves(per_sm) * 132 * per_sm
    # never more than the cache can hold live
    assert split_blocks(1, 1, 300, None, 132, 1) == 3
    assert split_blocks(1, 1, 64, None, 132, 1) == 1
    assert split_blocks(1, 1, 1 << 20, None, 132, 1) == MAX_SPLITS

# ---------------------------------------------------------------------------
# the bf16 kernel's plan (decode_attention_bf16.cu), mirrored on the host
# ---------------------------------------------------------------------------

def _ideal_clusters(sms, per_sm):
    """Clusters of 2, 4 and 8 blocks a card of ``sms`` SMs holding
    ``per_sm`` blocks each runs at once, where clusters pack perfectly."""
    return {c: sms * per_sm // c for c in (2, 4, 8)}


def _blocks_of(lives, ncl, c):
    """The kernel's own walk of its grid (one kv head): cluster x is
    sequence x's first where x < B, else the next of the sequences' other
    clusters in order; rank r of a sequence's cluster ci takes split
    ci * c + r.  Returns {(cluster, rank): (b, key range)} for the blocks
    with a split."""
    b_n = len(lives)
    plan = bf16_plan(lives, ncl, c)
    owner = {i: (i, 0) for i in range(b_n)}
    x = b_n
    for i, (n, _, _) in enumerate(plan):
        for ci in range(1, n):
            owner[x] = (i, ci)
            x += 1
    assert x <= max(ncl, b_n)
    out = {}
    for xcl, (i, ci) in owner.items():
        _, chunk, used = plan[i]
        for r in range(c):
            si = ci * c + r
            if si < used:
                lo = si * chunk
                out[(xcl, r)] = (i, range(lo, min(lives[i], lo + chunk)))
    return out


BF16_LIVES = ([0], [1], [1, 4, 35, 127], [7, 23, 30, 4206],
              [7, 30, 4100, 4250], [6, 14, 23, 35], [64, 65, 128, 129],
              [8192] * 4, [1 << 20, 5], list(range(0, 600, 37)),
              [1 + (37 * i) % 700 for i in range(40)])


@pytest.mark.parametrize("nb", [1, 3, 8, 16, 32, 33, 64, 128, 132, 264])
@pytest.mark.parametrize("lives", BF16_LIVES,
                         ids=lambda x: f"B{len(x)}-{max(x)}")
def test_bf16_plan_covers_every_live_key(nb, lives):
    """Every live key of every sequence is in exactly one block's split;
    splits are whole 8-key groups of at least a stage (one shorter only
    where the sequence is), each sequence's clusters hold its splits, and
    the clusters fit the grid."""
    c, ncl = bf16_grid(len(lives), nb)
    assert c in (1, 2, 4, 8) and c <= BF16_MAX_CLUSTER
    assert ncl >= len(lives) and (ncl == len(lives) or ncl * c <= nb)
    plan = bf16_plan(lives, ncl, c)
    assert sum(n for n, _, _ in plan) <= ncl
    for live, (n, chunk, used) in zip(lives, plan):
        assert chunk % BF16_GROUP == 0 and chunk >= BF16_MIN_KEYS
        assert 1 <= n <= BF16_MAX_CLUSTERS and n == -(-used // c)
        assert chunk * (used - 1) < max(live, 1) <= chunk * used
    seen = [np.zeros(live, np.int64) for live in lives]
    for (xcl, rank), (i, keys) in _blocks_of(lives, ncl, c).items():
        assert 0 <= xcl < ncl and 0 <= rank < c
        seen[i][list(keys)] += 1
    assert all((s_ == 1).all() for s_ in seen)


@pytest.mark.parametrize("hk,per_sm,window", [
    (2, 1, None), (2, 2, None), (4, 1, 4096), (4, 1, None), (32, 2, None),
    (32, 3, None), (16, 2, None), (16, 1, None)])
def test_bf16_grid_fits_the_card(hk, per_sm, window):
    """The wrapper's budget (``bf16_blocks``) and the launch's grid
    (``bf16_grid``): at the served ticks (4 slots of an 8192-row cache) the
    grid is one wave of the card (132 SMs) at the cluster size it takes,
    a short slot is one cluster, and a tick of short slots has one
    cluster a slot."""
    sms = 132
    clusters = _ideal_clusters(sms, per_sm)
    nb = bf16_blocks(4, hk, 8192, window, sms, per_sm, clusters)
    c, ncl = bf16_grid(4, nb)
    assert ncl * c * hk <= sms * per_sm
    if c > 1:
        assert ncl * hk <= clusters[c]
    for lives in ([7, 23, 30, 4206], [6, 14, 23, 35]):
        plan = bf16_plan(lives, ncl, c)
        assert [n for n, _, _ in plan][:3] == [1, 1, 1]
        assert sum(n for n, _, _ in plan) <= ncl
    assert [n for n, _, _ in bf16_plan([6, 14, 23, 35], ncl, c)] == [1] * 4


@pytest.mark.parametrize("per_sm,clusters8", [(2, None), (2, 30), (2, 28),
                                              (3, None)])
def test_bf16_long_tick_covers_every_sm(per_sm, clusters8):
    """chatglm3-6b's long tick (2 kv heads, slots of 7, 23, 30 and 4206
    keys) on 132 SMs, two blocks an SM (the instance's launch bounds) or
    more: the long slot's splits are at least as many as the SMs, a stage
    or so each, so no block walks more than two stages; also where
    clusters of 8 pack worse than perfectly (``clusters8``)."""
    sms = 132
    clusters = _ideal_clusters(sms, per_sm)
    if clusters8 is not None:
        clusters[8] = clusters8
    nb = bf16_blocks(4, 2, 8192, None, sms, per_sm, clusters)
    c, ncl = bf16_grid(4, nb)
    n, chunk, used = bf16_plan([7, 23, 30, 4206], ncl, c)[-1]
    assert 2 * used >= sms
    assert chunk <= 2 * BF16_STAGE


def test_bf16_cluster_rule():
    """A cluster size is the largest whose one cluster a sequence takes at
    most a third of the budget: 8 at chatglm3's tick two blocks an SM, 2
    at gemma2-2b's (4 kv heads, one block an SM), none at phi3-mini's and
    moonshot's (32 and 16 kv heads)."""
    assert bf16_cluster(4, 120) == 8 and bf16_cluster(4, 95) == 4
    assert bf16_cluster(4, 32) == 2 and bf16_cluster(4, 23) == 1
    assert bf16_cluster(4, 8) == 1 and bf16_cluster(1, 1) == 1
    assert bf16_grid(4, 128) == (8, 16) and bf16_grid(40, 8) == (1, 40)
    # a sequence with no live key: one empty split
    assert bf16_plan([0, 10], 4, 1) == [(1, BF16_MIN_KEYS, 1),
                                        (1, BF16_MIN_KEYS, 1)]
