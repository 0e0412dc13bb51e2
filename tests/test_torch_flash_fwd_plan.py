"""The bf16 flash forward's launch plan, checked on the CPU.

``kernels/flash_attention/kernel.py::fwd_bf16_plan`` mirrors what
``csrc/flash_attention.cu`` (``CfgB``, ``launch_bf16``) launches at a
shape: the rows a block, the keys a tile, the ring's stages, the TMA boxes
and their swizzle, the shared memory and the grid (the card checks the
mirror against the library's ``flash_attention_bf16_config``).  At every
shape the card runs it at (``chip_smoke.bf16_flash_cases``, the timed
shapes ``chip_smoke.BF16_TIMED``, ``chip_smoke.CROSS_SHAPES``) and at those
lengths for every head dim and group of 1, 2, 4, 8, 16 and 64: the shared
memory fits a block and keeps every tile on its swizzle atom; the wgmma
shapes keep wgmma's rules (64-row warpgroup tiles, N a multiple of 8 up to
256, k steps of 16); the TMA boxes keep TMA's (each box dimension at most
256, the inner one the swizzle's span, 16-byte multiples, strides in
16-byte multiples); every query row lies in exactly one block's tile; the
grid keeps within CUDA's limits; and the same shape always gives the same
plan.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    BF16_CONFIG_KEYS, HEAD_DIMS, MAX_GROUP, SMEM_BLOCK, fwd_bf16_plan)

ROOT = Path(__file__).resolve().parents[1]
#: CUDA's limits on a grid's dimensions
MAX_GRID = (2 ** 31 - 1, 65535, 65535)
#: groups of the card's shapes, and 3 and 6, which leave a tile's last
#: rows unloaded
GROUPS = (1, 2, 3, 4, 6, 8, 16, 64)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _module("chip_smoke", ROOT / "chip_smoke.py")
#: (B, Sq, Sk, H, Hk, D) of every shape the card runs the kernel at
CARD = sorted({c[:6] for c in SMOKE.bf16_flash_cases()}
              | {(b, s, s, h, hk, d)
                 for b, s, h, hk, d, _ in SMOKE.BF16_TIMED.values()}
              | {c[:6] for c in SMOKE.CROSS_SHAPES.values()})
#: (B, Sq, Sk) of those shapes, for every head dim and group
LENGTHS = sorted({c[:3] for c in CARD})


def check_plan(b, sq, sk, h, hk, d):
    plan = fwd_bf16_plan(b, sq, sk, h, hk, d)
    g = h // hk
    rows, keys, span = plan["rows"], plan["keys"], plan["swizzle"]
    # shared memory: within a block's limit; Q's boxes of 128 rows, then
    # the ring's K and V, each on a whole swizzle atom (8 rows of the span)
    assert plan["smem"] <= SMEM_BLOCK
    q_bytes = plan["boxes"] * rows * span
    kv_bytes = plan["boxes"] * keys * span
    assert 2 <= plan["stages"] <= 4
    assert plan["smem"] == (1024 + q_bytes + 2 * plan["stages"] * kv_bytes
                            + 8 * (1 + 3 * plan["stages"]))
    for offset in (rows * span, keys * span, q_bytes, kv_bytes,
                   64 * span, 16 * span):
        assert offset % (8 * span) == 0
    # wgmma: 64-row warpgroup tiles; N (keys for Q.K^T, the padded head dim
    # for P.V) a multiple of 8 up to 256; k steps of 16 over D and the keys
    assert rows == 64 * plan["warpgroups"] == 128
    assert plan["threads"] == 128 * (1 + plan["warpgroups"])
    for n in (keys, plan["pv_n"]):
        assert n % 8 == 0 and 8 <= n <= 256
    assert plan["qk_steps"] * 16 == d and plan["pv_steps"] * 16 == keys
    assert d <= plan["pv_n"] == plan["boxes"] * plan["box_cols"] < d + 64
    # TMA: the boxes (columns, heads, rows, 1) of q and of k and v
    for box in ((plan["box_cols"], g, plan["bq"], 1),
                (plan["box_cols"], 1, keys, 1)):
        assert all(1 <= x <= 256 for x in box)
    assert 2 * plan["box_cols"] == span in (32, 64, 128)
    assert span % 16 == 0 and (2 * d) % 16 == 0
    # the registers setmaxnreg hands out fit the SM's 65,536
    assert plan["producer_regs"] % 8 == 0 and plan["consumer_regs"] % 8 == 0
    assert 128 * (plan["producer_regs"] + plan["warpgroups"]
                  * plan["consumer_regs"]) <= 65536
    # every query row in exactly one block's tile (the kernel's map: block
    # x takes positions q0 .. q0 + bq - 1, q0 = (grid x - 1 - x) bq; row r
    # is position q0 + r // G of head r % G)
    bq, nq = plan["bq"], plan["grid"][0]
    assert plan["q_rows"] == g * bq <= rows
    r = np.arange(plan["q_rows"])[None, :]
    pos = (nq - 1 - np.arange(nq))[:, None] * bq + r // g
    live = pos < sq
    seen = np.bincount((pos * g + r % g)[live], minlength=sq * g)
    assert seen.size == sq * g and (seen == 1).all()
    assert plan["grid"][1:] == (hk, b)
    assert all(0 < n <= m for n, m in zip(plan["grid"], MAX_GRID))
    assert fwd_bf16_plan(b, sq, sk, h, hk, d) == plan
    return plan


@pytest.mark.parametrize("shape", CARD,
                         ids=["B{}-Sq{}-Sk{}-H{}-Hk{}-D{}".format(*s)
                              for s in CARD])
def test_plan_at_the_card_shapes(shape):
    check_plan(*shape)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plan_at_every_head_dim_and_group(d, g):
    """Every card shape's batch and lengths at head dim ``d`` with groups
    of ``g`` (one and two kv heads)."""
    for b, sq, sk in LENGTHS:
        for hk in (1, 2):
            check_plan(b, sq, sk, g * hk, hk, d)


def test_tiles_per_head_dim():
    """128-key tiles up to D 128 and 64 at D 256; one box of D columns
    with the matching swizzle at D 16 and 32, 64-column boxes with the
    128-byte swizzle from D 64 (D 96 two, its last 32 columns past D);
    the figures the library exports, in its order; other head dims and
    groups past ``MAX_GROUP`` refused."""
    want = {16: (128, 1, 32), 32: (128, 1, 64), 64: (128, 1, 128),
            96: (128, 2, 128), 128: (128, 2, 128), 256: (64, 4, 128)}
    for d in HEAD_DIMS:
        p = fwd_bf16_plan(1, 8192, 8192, 32, 2, d)
        assert (p["keys"], p["boxes"], p["swizzle"]) == want[d]
        assert all(k in p for k in BF16_CONFIG_KEYS)
    assert fwd_bf16_plan(1, 8, 8, 8, 8, 96)["pv_n"] == 128
    with pytest.raises(ValueError):
        fwd_bf16_plan(1, 8, 8, 2, 2, 48)
    with pytest.raises(ValueError):
        fwd_bf16_plan(1, 8, 8, 2 * (MAX_GROUP + 1), 2, 64)
