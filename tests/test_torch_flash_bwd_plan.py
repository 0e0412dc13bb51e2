"""The flash backward's split decision, checked on the CPU.

``kernels/flash_attention/kernel.py::bwd_plan`` chooses from the shape
alone how many splits of a group's heads the dK/dV kernel of
``csrc/flash_attention_bwd.cu`` takes (a block per key tile, kv head,
split and batch row), and the size of the splits' scratch; the C source
owns the tiles and grids, and ``bwd_tiles`` mirrors what the decision
needs of them (the card checks the mirror against the built library).  At
the shapes the card runs (``chip_smoke.BWD_PATH``,
``tests/test_torch_cuda.py::BWD_CASES``), and at each of those batch and
sequence sizes for every head dim and groups of 1, 2, 16 and 64: the split
count lies in 1 .. G, so the C source's head ranges put every head of a
group in exactly one split, in head order; a split plan's dK/dV blocks fit
the card at once; the shared memory fits a block; the scratch holds each
split's dK and dV (none with one split); the launch's blocks keep within
CUDA's grid limit; and the same shape always gives the same plan.  The
rectangular shapes (cross attention, ``chip_smoke.CROSS_SHAPES``: Sq
queries against Sk keys) are held to the same rules, the dK/dV blocks
tiling the keys, the dQ blocks the queries and the scratch the keys.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    H100_SMS, HEAD_DIMS, SMEM_BLOCK, bwd_plan, bwd_tiles)

#: CUDA's limit on a grid's x dimension (the C source launches 1-D grids)
MAX_GRID_X = 2 ** 31 - 1
ROOT = Path(__file__).resolve().parents[1]


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _module("chip_smoke", ROOT / "chip_smoke.py")
PATH = SMOKE.BWD_PATH
#: (B, Sq, Sk, H, Hk, D) of the rectangular shapes the card runs
CROSS = {label: c[:6] for label, c in SMOKE.CROSS_SHAPES.items()}
CASES = _module("_torch_cuda_cases",
                ROOT / "tests" / "test_torch_cuda.py").BWD_CASES
#: (B, S, H, Hk, D) of every shape the card runs the backward at
SHAPES = sorted({tuple(s) for s in PATH.values()}
                | {tuple(c.values[:5]) for c in CASES})
GROUPS = (1, 2, 16, 64)


def check_plan(b, s, h, hk, d, sk=None):
    """The plan at ``s`` queries against ``sk`` keys (default ``s``)."""
    sk = s if sk is None else sk
    plan = bwd_plan(b, s, sk, h, hk, d)
    g, splits = h // hk, plan["splits"]
    assert 1 <= splits <= g
    # the C source's ranges (dkdv_block's g0, g1): each head in exactly
    # one split, the splits in head order, none empty
    heads = [(sp * g // splits, (sp + 1) * g // splits)
             for sp in range(splits)]
    assert [x for lo, hi in heads for x in range(lo, hi)] == list(range(g))
    assert all(lo < hi for lo, hi in heads)
    t = bwd_tiles(d)
    assert t["smem"] <= SMEM_BLOCK
    n = b * sk * hk * d
    assert plan["scratch"] == (2 * splits * n if splits > 1 else 0)
    tiles, q_tiles = -(-sk // t["rows"]), -(-s // t["rows"])
    # the main launch: the dK/dV blocks, then the dQ blocks; the merge
    # pass: 256 threads a block, four elements a thread
    assert 0 < (tiles * splits * hk + q_tiles * h) * b <= MAX_GRID_X
    assert -(-n // 1024) <= MAX_GRID_X
    # the dK/dV blocks of a split plan fit the card at once
    if splits > 1:
        assert tiles * splits * hk * b <= H100_SMS * t["per_sm"]
    assert bwd_plan(b, s, sk, h, hk, d) == plan
    return plan


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["B{}-S{}-H{}-Hk{}-D{}".format(*s)
                              for s in SHAPES])
def test_plan_at_the_card_shapes(shape):
    check_plan(*shape)


@pytest.mark.parametrize("label", sorted(CROSS))
def test_plan_at_the_cross_shapes(label):
    """The rectangular shapes, and each with its two lengths swapped."""
    b, sq, sk, h, hk, d = CROSS[label]
    check_plan(b, sq, h, hk, d, sk=sk)
    check_plan(b, sk, h, hk, d, sk=sq)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plan_at_every_head_dim_and_group(d, g):
    """Each card shape's batch and length at head dim ``d`` with groups of
    ``g`` (one and two kv heads)."""
    for b, s, *_ in SHAPES:
        for hk in (1, 2):
            check_plan(b, s, g * hk, hk, d)


def test_chatglm3_micro_batch_fills_the_card():
    """B 8, S 64, H 32 over 2, D 128: the group of 16 is split so that the
    dK/dV kernel has at least as many blocks as the card has SMs (one
    split had 32 blocks)."""
    b, s, h, hk, d = PATH["chatglm3_b8_s64"]
    splits = bwd_plan(b, s, s, h, hk, d)["splits"]
    tiles = -(-s // bwd_tiles(d)["rows"])
    assert splits > 1 and tiles * splits * hk * b >= H100_SMS


def test_one_split_where_the_blocks_fill_the_card():
    """The stream MLLMs' shapes (G 1 and 2) add no pass: one split, no
    scratch."""
    for label, shape in PATH.items():
        if label.startswith(("mllm", "small")):
            b, s, h, hk, d = shape
            plan = bwd_plan(b, s, s, h, hk, d)
            assert plan["splits"] == 1 and plan["scratch"] == 0, label


def test_tiles_per_head_dim():
    """Shared memory within a block's limit and two blocks an SM (the
    launch bounds' registers) at every head dim, 16-key and 8-query tiles
    at D 256, and rows a block in 16-row groups, streamed rows in 8-row
    column groups."""
    for d in HEAD_DIMS:
        t = bwd_tiles(d)
        assert t["smem"] <= SMEM_BLOCK and t["per_sm"] == 2
        assert t["rows"] % 16 == 0 and t["cols"] % 8 == 0
    assert bwd_tiles(256)["rows"] == 16 and bwd_tiles(256)["cols"] == 8
    with pytest.raises(ValueError):
        bwd_tiles(48)
    with pytest.raises(ValueError):
        bwd_plan(1, 8, 8, 130, 2, 32)
