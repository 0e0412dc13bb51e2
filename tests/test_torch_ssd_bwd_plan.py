"""The ssd_scan backward's launch plan and its decomposition, on the CPU.

``kernels/ssd_scan/kernel.py::bwd_plan`` chooses from the shape alone how many
splits of a group's heads ``csrc/ssd_scan_bwd.cu`` takes (a block per chunk,
group, split and key tile), its shared memory and its scratch.  At every shape
the card runs the backward at (``chip_smoke.SSD_BWD_SHAPES``), and at each of
those chunk shapes for groups of 1, 2 and 8 with 1, 3, 16 and 24 heads a group:
the split count is the fewest that fills the card two blocks an SM, else one
head a split; every head of a group falls in exactly one split, in head
order; the shared memory fits a block (two blocks an SM at mamba2-130m's
training shape); the scratch matches the split count; the sums run in the
first launch's clusters where a chunk and group's blocks fit one, else in a
second launch; the grids keep within CUDA's limits; the training shape
fills the card; the same shape always gives the same plan.

``model_bwd`` is the kernel's decomposition written out in float64: 32-row
tiles, the group's heads cut into splits, C·Bᵀ once a pair, S summed over
a split's heads then over the splits, dC and dB from the summed S tiles,
B's 16-wide slices for the s_local terms (u_j = B_j·E_j), and dcs's row
sums merged by key tile.  It must give autograd's gradient of
``ssd_scan_ref`` in float64 (within 1e-10 of the largest magnitude), at a
ragged chunk and at groups the split count does not divide: an algebra
error shows here before the card.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan.kernel import (  # noqa: E402
    BWD_CB, BWD_SL, BWD_TILE, FUSED_TILES, H100_SMS, MAX_CLUSTER,
    SMEM_BLOCK, SMEM_SM, SUM_TILES, _bwd_plan, bwd_plan, bwd_smem,
    split_heads)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MAX_GRID_X, MAX_GRID_YZ = 2 ** 31 - 1, 65535
#: two blocks an SM: each takes at most half an SM's shared memory, less
#: the 1 KB the card reserves a block
TWO_A_SM = SMEM_SM // 2 - 1024


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SSD_SHAPES = _module("chip_smoke", ROOT / "chip_smoke.py").SSD_BWD_SHAPES
#: (BC, H, G, Q, P, N): the card's shapes, and each with groups of 1, 2
#: and 8 of 1, 3, 16 and 24 heads
SHAPES = sorted({tuple(s) for s in SSD_SHAPES.values()}
                | {(bc, g * hg, g, q, p, n)
                   for bc, _, _, q, p, n in SSD_SHAPES.values()
                   for g in (1, 2, 8) for hg in (1, 3, 16, 24)})


def check_plan(bc, h, g, q, p, n):
    plan = bwd_plan(bc, h, g, q, p, n)
    hg, splits = h // g, plan["splits"]
    assert 1 <= splits <= hg
    nt = -(-q // BWD_TILE)

    def fills(count):           # the card full, two blocks an SM
        return bwd_smem(p, n, -(-hg // count)) <= TWO_A_SM \
            and bc * g * count * nt >= 2 * H100_SMS

    # the fewest splits that fill the card; else one head a split
    if any(fills(c) for c in range(1, hg + 1)):
        assert fills(splits)
        assert not any(fills(c) for c in range(1, splits))
    else:
        assert splits == hg
    heads = [list(split_heads(hg, splits, sp)) for sp in range(splits)]
    assert [x for hs in heads for x in hs] == list(range(hg))
    assert all(heads)
    assert plan["hs"] == max(map(len, heads))
    assert plan["smem"] == bwd_smem(p, n, plan["hs"]) <= SMEM_BLOCK
    assert plan["per_sm"] == (2 if plan["smem"] <= TWO_A_SM else 1)
    assert plan["nt"] == nt
    assert plan["s_part"] == splits * bc * g * nt * (nt + 1) // 2 \
        * BWD_TILE ** 2
    assert plan["db_part"] == splits * bc * g * q * n
    assert plan["dcs_row"] == bc * h * q * nt
    assert plan["esum"] == bc * h * nt
    assert plan["grid"] == (bc * g * splits, nt)
    assert plan["blocks"] == bc * g * splits * nt
    assert plan["grid"][0] <= MAX_GRID_X and plan["grid"][1] <= MAX_GRID_YZ
    tiles = -(-n // 8)
    parts = plan["parts"]
    per = -(-tiles // parts)
    assert 1 <= parts <= tiles and (parts - 1) * per < tiles
    # one launch of clusters where a chunk and group's blocks fit one; its
    # sums tasks (dC's and dB's ranges) no more than the cluster's blocks
    # where N allows, else a second launch of about a wave
    assert plan["fused"] == (splits * nt <= MAX_CLUSTER)
    if plan["fused"]:
        assert per <= FUSED_TILES and plan["grid2"] is None
        assert parts <= max(-(-tiles // FUSED_TILES), splits // 2)
    else:
        assert per <= SUM_TILES
        assert parts == 1 or 2 * nt * parts * bc * g <= H100_SMS
        assert plan["grid2"] == (nt, 2 * parts, bc * g)
    assert bc * g <= MAX_GRID_YZ
    _bwd_plan.cache_clear()
    assert bwd_plan(bc, h, g, q, p, n) == plan
    return plan


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["BC{}-H{}-G{}-Q{}-P{}-N{}".format(*s)
                              for s in SHAPES])
def test_plan(shape):
    check_plan(*shape)


def test_plan_at_mamba2_training_fills_the_card_two_blocks_an_sm():
    plan = check_plan(*SSD_SHAPES["mamba2_train"])
    assert plan["smem"] <= TWO_A_SM and plan["per_sm"] == 2
    assert plan["blocks"] >= 2 * H100_SMS


def test_forced_splits():
    """The timing probes' forced plans: the count asked for, the shared
    memory of the most heads a split; a count whose split does not fit a
    block (24 heads at P 64: one or two splits) is refused."""
    for splits in (3, 4, 6, 8, 24):
        plan = bwd_plan(8, 24, 1, 256, 64, 128, splits=splits)
        assert plan["splits"] == splits
        assert plan["smem"] == bwd_smem(64, 128, -(-24 // splits))
    for splits in (1, 2):
        with pytest.raises(ValueError):
            bwd_plan(8, 24, 1, 256, 64, 128, splits=splits)


def model_bwd(x, bm, cm, cs, dt, dy, ds, splits):
    """The kernel's decomposition in float64 numpy (kernel layout, cs and
    dt as (BC, H, Q)): (dx, dB, dC, dcs, ddt)."""
    bc, h, q, p = x.shape
    g, n = bm.shape[1], bm.shape[3]
    hg, t = h // g, BWD_TILE
    nt = -(-q // t)
    qp, nk = nt * t, -(-n // BWD_SL) * BWD_SL

    def pad(a, axes_sizes):
        w = [(0, 0)] * a.ndim
        for ax, size in axes_sizes:
            w[ax] = (0, size - a.shape[ax])
        return np.pad(a, w)

    x, dy = pad(x, [(2, qp)]), pad(dy, [(2, qp)])
    bm, cm = pad(bm, [(2, qp), (3, nk)]), pad(cm, [(2, qp), (3, nk)])
    cs, dt = pad(cs, [(2, qp)]), pad(dt, [(2, qp)])
    ds = pad(ds, [(2, nk)])
    rows = np.arange(qp)
    dx = np.zeros_like(x)
    ddt, dcs_col = np.zeros((bc, h, qp)), np.zeros((bc, h, qp))
    rowpart, esum = np.zeros((bc, h, qp, nt)), np.zeros((bc, h, nt))
    s_part = np.zeros((splits, bc, g, nt, nt, t, t))
    db_part = np.zeros((splits, bc, g, qp, nk))
    # the first launch: a block a (chunk, group, split, key tile)
    for b in range(bc):
        for gg in range(g):
            for sp in range(splits):
                heads = [gg * hg + k for k in split_heads(hg, splits, sp)]
                for jt in range(nt):
                    J = slice(jt * t, jt * t + t)
                    jr = rows[J]
                    bj = bm[b, gg, J]
                    ok = jr < q
                    ej = {hd: np.where(ok, np.exp(cs[b, hd, q - 1]
                                                  - cs[b, hd, J]), 0.0)
                          for hd in heads}
                    wj = {hd: ej[hd] * dt[b, hd, J] for hd in heads}
                    acc = {hd: np.zeros((t, p)) for hd in heads}
                    col = {hd: np.zeros(t) for hd in heads}
                    u = {hd: np.zeros(t) for hd in heads}
                    for it in range(jt, nt):
                        I = slice(it * t, it * t + t)
                        ir = rows[I]
                        cb = sum(cm[b, gg, I, c:c + BWD_CB]
                                 @ bj[:, c:c + BWD_CB].T
                                 for c in range(0, nk, BWD_CB))
                        mask = (ir[:, None] < q) & (jr[None, :] <= ir[:, None])
                        s_acc = np.zeros((t, t))
                        for hd in heads:
                            csi, csj = cs[b, hd, I], cs[b, hd, J]
                            dtj = dt[b, hd, J]
                            seg = np.where(mask, csi[:, None] - csj[None, :],
                                           0.0)
                            lm = np.where(mask, np.exp(seg), 0.0)
                            dm = dy[b, hd, I] @ x[b, hd, J].T
                            w = cb * lm * dtj
                            s_acc += dm * lm * dtj
                            tm = dm * cb * lm
                            acc[hd] += w.T @ dy[b, hd, I]
                            col[hd] += tm.sum(0)
                            rowpart[b, hd, I, jt] = (tm * dtj).sum(1)
                        s_part[sp, b, gg, it, jt] = s_acc
                    for c in range(0, nk, BWD_SL):
                        C = slice(c, c + BWD_SL)
                        dbl = np.zeros((t, BWD_SL))
                        for hd in heads:
                            dsc = ds[b, hd, C]
                            acc[hd] += wj[hd][:, None] * (bj[:, C] @ dsc)
                            e = x[b, hd, J] @ dsc.T
                            dbl += wj[hd][:, None] * e
                            u[hd] += (bj[:, C] * e).sum(1)
                        db_part[sp, b, gg, J, C] = dbl
                    for hd in heads:
                        dx[b, hd, J] = acc[hd]
                        ddt[b, hd, J] = col[hd] + ej[hd] * u[hd]
                        dcs_col[b, hd, J] = -dt[b, hd, J] * col[hd] \
                            - wj[hd] * u[hd]
                        esum[b, hd, jt] = (wj[hd] * u[hd]).sum()
    # the second launch: a block a (chunk, group, tile)
    db, dc = np.zeros_like(bm), np.zeros_like(cm)
    dcs = np.zeros((bc, h, qp))
    for b in range(bc):
        for gg in range(g):
            s_sum = s_part[:, b, gg].sum(0)           # in split order
            for tt in range(nt):
                T = slice(tt * t, tt * t + t)
                dc[b, gg, T] = sum(s_sum[tt, j] @ bm[b, gg, j * t:j * t + t]
                                   for j in range(tt + 1))
                db[b, gg, T] = sum(s_sum[i, tt].T @ cm[b, gg, i * t:i * t + t]
                                   for i in range(tt, nt)) \
                    + db_part[:, b, gg, T].sum(0)
                for hd in range(gg * hg, gg * hg + hg):
                    dcs[b, hd, T] = dcs_col[b, hd, T] \
                        + rowpart[b, hd, T, :tt + 1].sum(1)
    dcs[:, :, q - 1] += esum.sum(-1)
    return (dx[:, :, :q], db[:, :, :q, :n], dc[:, :, :q, :n],
            dcs[:, :, :q], ddt[:, :, :q])


def _inputs(bc, h, g, q, p, n, decay, seed):
    rng = np.random.RandomState(seed)
    dt = np.log1p(np.exp(rng.randn(bc, h, q)))          # softplus
    a = -decay * np.exp(0.2 * rng.randn(h))
    cs = np.cumsum(dt * a[None, :, None], axis=-1)
    x = rng.randn(bc, h, q, p)
    bm, cm = 0.3 * rng.randn(bc, g, q, n), 0.3 * rng.randn(bc, g, q, n)
    return x, bm, cm, cs, dt, rng.randn(bc, h, q, p), rng.randn(bc, h, n, p)


@pytest.mark.parametrize("bc,h,g,q,p,n,splits,decay", [
    (2, 4, 2, 45, 16, 13, 2, 0.05),     # ragged Q and N, one head a split
    (1, 5, 1, 70, 8, 24, 2, 0.05),      # 5 heads in 2 splits
    (1, 5, 1, 70, 8, 24, 3, 1.0),       # in 3; seg past exp's range
    (1, 3, 1, 256, 8, 16, 2, 0.01)],    # a whole chunk, 3 heads in 2
    ids=lambda v: str(v))
def test_decomposition_equals_autograd_in_float64(bc, h, g, q, p, n, splits,
                                                  decay):
    x, bm, cm, cs, dt, dy, ds = _inputs(bc, h, g, q, p, n, decay, q + n)
    got = model_bwd(x, bm, cm, cs, dt, dy, ds, splits)
    leaves = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for v in (x, bm, cm, cs[:, :, None], dt[:, :, None])]
    y, s = ssd_scan_ref(*leaves, dtype=torch.float64)
    torch.autograd.backward((y, s), (torch.tensor(dy), torch.tensor(ds)))
    for name, mine, leaf in zip(("dx", "dB", "dC", "dcs", "ddt"), got,
                                leaves):
        want = leaf.grad.numpy().reshape(mine.shape)
        assert np.isfinite(want).all()
        err = np.abs(mine - want).max()
        assert err <= 1e-10 * max(1.0, np.abs(want).max()), (name, err)
