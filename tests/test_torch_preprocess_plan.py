"""The fused_preprocess kernel's host-side plan, replayed on the CPU.

``kernels/fused_preprocess/kernel.py::preprocess_plan`` fixes the launch
of ``csrc/fused_preprocess.cu``: the bands of output rows, the block's
threads, and what a block stages in shared memory.  ``replay`` walks that
launch as the kernel does (every block, the staging loop, every thread's
groups of outputs) over numpy frames, with the kernel's arithmetic in
float32 (an exact integer window sum, then preprocess.cuh's divisions,
each rounded), and checks that every output is written exactly once, that
every word it stages lies inside the frame and the staged row, and that
every window lies inside the staged, aligned source range.  Its output
must equal the same arithmetic taken straight from the frames bit for
bit, and the plain version within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_preprocess.kernel import (  # noqa: E402
    H100_SMS, MAX_GRID_Y, MAX_THREADS, SMEM_BUDGET, V, preprocess_plan)
from repro_torch.kernels.fused_preprocess.ref import LUMA, fused_preprocess_ref  # noqa: E402

MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
F32 = np.float32


def _normalize(s, f, mean, std):
    """preprocess.cuh: area_mean then normalize, each division rounded."""
    m = (s.astype(F32) / F32(255.0)) / F32(f * f)
    return (m - F32(mean)) / F32(std)


def _luma(r, g, b):
    return (r * F32(LUMA[0]) + g * F32(LUMA[1])) + b * F32(LUMA[2])


def direct(frames, crop, f, grey, mean=MEAN, std=STD):
    """The kernel's arithmetic straight from the frames, no plan."""
    b, c, _, _ = frames.shape
    y0, x0, ch, cw = crop
    win = frames[:, :, y0:y0 + ch, x0:x0 + cw].astype(np.uint32)
    s = win.reshape(b, c, ch // f, f, cw // f, f).sum(axis=(3, 5))
    n = [_normalize(s[:, i], f, mean[i], std[i]) for i in range(c)]
    return _luma(*n)[:, None] if grey else np.stack(n, axis=1)


def replay(frames, crop, f, grey, plan, mean=MEAN, std=STD):
    """Run ``plan``'s launch over numpy frames as the kernel does; returns
    its output after checking coverage, staging and windows."""
    B, C, H, W = frames.shape
    y0, x0, ch, cw = crop
    ho, wo = ch // f, cw // f
    cout = 1 if grey else C
    rows, tx, xa, words, unit, pitch = (plan[k] for k in (
        "rows", "tx", "xa", "words", "unit", "pitch"))
    bands, gy = plan["grid"]
    assert plan["block"] == (tx, rows, cout)
    assert plan["threads"] == tx * rows * cout <= MAX_THREADS
    assert plan["smem"] == C * rows * f * pitch <= SMEM_BUDGET
    assert bands == -(-ho // rows) and gy == min(B, MAX_GRID_Y)
    assert unit in (16, 4, 1) and W % unit == 0 and xa % unit == 0
    assert 0 <= x0 - xa < unit
    assert pitch % 16 == 0 and words * unit <= pitch
    assert plan["vec"] == (wo % V == 0)
    # the frames the grid's y dimension takes, each once
    order = [b for by in range(gy) for b in range(by, B, gy)]
    assert sorted(order) == list(range(B))
    out = np.zeros((B, cout, ho, wo), F32)
    writes = np.zeros(out.shape, np.int64)
    for band in range(bands):
        r0 = band * rows
        nrows = min(rows, ho - r0)
        srows = nrows * f
        # the staging loop: word i of the band's C * srows rows
        sm = np.zeros((B, C, rows * f, pitch), np.uint8)
        staged = np.zeros((C, rows * f, pitch), bool)
        i = np.arange(C * srows * words)
        row, w = i // words, i % words
        c, j = row // srows, row % srows
        col = xa + w * unit
        assert col.min(initial=0) >= 0 and (col + unit).max(initial=0) <= W
        assert (y0 + r0 * f + j).max(initial=0) < H
        for d in range(unit):
            sm[:, c, j, w * unit + d] = frames[:, c, y0 + r0 * f + j,
                                               col + d]
            staged[c, j, w * unit + d] = True
        # thread (x, y, z): outputs V at a time from column V * x, stepping
        # by V * tx
        x = np.arange(tx)
        for y in range(nrows):
            for z in range(cout):
                for step in range(-(-wo // (V * tx))):
                    ox = (x[:, None] * V + step * tx * V
                          + np.arange(V)[None, :]).ravel()
                    ox = ox[ox < wo]
                    if not ox.size:
                        continue
                    dy = np.arange(f)
                    wr = y * f + dy                         # window rows
                    wc = (x0 - xa) + ox[:, None] * f + dy[None, :]
                    assert wr.max() < srows
                    assert 0 <= wc.min() and wc.max() < words * unit
                    chans = range(3) if grey else [z]
                    n = []
                    for ci in chans:
                        assert staged[ci][np.ix_(wr, wc.ravel())].all()
                        win = sm[:, ci][:, wr][:, :, wc]    # (B, f, n, f)
                        s = win.astype(np.uint32).sum(axis=(1, 3))
                        n.append(_normalize(s, f, mean[ci], std[ci]))
                    out[:, z, r0 + y, ox] = _luma(*n) if grey else n[0]
                    writes[:, z, r0 + y, ox] += 1
    assert (writes == 1).all(), "an output written other than once"
    return out


def _frames(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _check(frames, crop, f, grey, mean=MEAN, std=STD, **plan_kw):
    plan = preprocess_plan(frames.shape, crop, f, grey, **plan_kw)
    got = replay(frames, crop, f, grey, plan, mean, std)
    np.testing.assert_array_equal(got, direct(frames, crop, f, grey, mean,
                                              std))
    want = fused_preprocess_ref(torch.from_numpy(frames), crop=crop,
                                factor=f, mean=mean, std=std,
                                grey=grey).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    return plan


@pytest.mark.parametrize("b", [1, 16, 64])
@pytest.mark.parametrize("crop,grey", [
    ((64, 0, 64, 256), False),      # the reduced plan's crop
    ((96, 0, 32, 256), False),      # the optimized plan's crop
    ((64, 0, 64, 256), True),       # the grey spec fused_prefix is held to
])
def test_replay_path_crops(b, crop, grey):
    plan = _check(_frames(b, (b, 3, 128, 256)), crop, 2, grey)
    blocks = plan["grid"][0] * plan["grid"][1]
    # a block for every SM, or one output row a band
    assert blocks >= H100_SMS or plan["rows"] == 1
    assert plan["unit"] == 16 and plan["vec"]


@pytest.mark.parametrize("crop,f,grey", [
    ((33, 17, 30, 98), 2, True),    # odd offsets, a ragged output row
    ((1, 3, 63, 125), 1, False),
    ((5, 7, 96, 60), 3, False),
    ((96, 0, 32, 256), 4, False),
    ((0, 64, 128, 128), 4, True),
    ((3, 5, 90, 150), 5, False),    # the generic-f instantiation
    ((0, 0, 128, 256), 1, False),
])
def test_replay_odd_crops(crop, f, grey):
    _check(_frames(7, (16, 3, 128, 256)), crop, f, grey)


@pytest.mark.parametrize("shape,align,unit", [
    ((4, 3, 30, 50), 16, 1),        # rows not 4-byte aligned: byte copies
    ((4, 3, 40, 100), 16, 4),       # 4-byte rows
    ((4, 3, 64, 128), 4, 4),        # a frame pointer aligned to 4 bytes
    ((4, 3, 64, 128), 1, 1),        # to 1 byte
])
def test_replay_unaligned_frames(shape, align, unit):
    _, _, h, w = shape
    crop = (1, 3, h - 4, w - 6)
    plan = _check(_frames(8, shape), crop, 2, False, align=align)
    assert plan["unit"] == unit


def test_replay_rows_wider_than_a_block():
    """512 groups of outputs a row over 170 threads: each steps 4 times."""
    plan = _check(_frames(13, (2, 3, 8, 2048)), (0, 0, 8, 2048), 1, False)
    assert plan["tx"] == 170 and plan["threads"] == 510


def test_replay_channels_and_affine():
    """One and four channels, each with its own mean and std."""
    _check(_frames(9, (4, 4, 32, 64)), (2, 6, 28, 56), 2, False,
           mean=(0.1, 0.2, 0.3, 0.4), std=(0.5, 0.25, 0.125, 2.0))
    _check(_frames(10, (4, 1, 32, 64)), (0, 0, 32, 64), 4, False,
           mean=(0.3,), std=(0.7,))


def test_replay_more_frames_than_the_grid():
    """Past 65535 frames the grid's blocks loop over the rest."""
    plan = _check(_frames(11, (MAX_GRID_Y + 3, 3, 2, 16)), (0, 0, 2, 16), 2,
                  True)
    assert plan["grid"] == (1, MAX_GRID_Y)


def test_plan_bands_within_the_shared_memory_budget():
    """A band's rows stop at the budget; one output row above it raises."""
    plan = _check(_frames(12, (1, 3, 2048, 256)), (0, 0, 2048, 256), 16,
                  True, sms=1)
    assert plan["smem"] <= SMEM_BUDGET < plan["smem"] + 3 * 16 * 256
    assert plan["rows"] == SMEM_BUDGET // (3 * 16 * 256)
    with pytest.raises(ValueError, match="budget of 231424 bytes"):
        preprocess_plan((1, 4, 64, 8192), (0, 0, 64, 8192), 8, False)
