"""The split arithmetic of ``csrc/flash_attention.cu`` against fp32, on the
CPU.

The kernel runs fp32 attention on TF32 tensor cores by splitting each
operand into TF32 parts: Q.K^T as hi*hi + hi*lo + lo*hi (3xTF32), P.V with
P and V in three parts and six terms.  This file emulates TF32 in numpy
(round to nearest, 10 mantissa bits, for the parts the kernel rounds; the
tensor cores' truncation for the part they read as it is), takes each
product and sum exactly in float64, rounds the result to fp32, and holds
it to float64 within ``MAG_WITNESS`` times fp32's own distance (PyTorch's
fp32 product on the same inputs), at the dense zoo's magnitudes
(``MAG_SHAPES``, where scores reach the hundreds).  It checks the scheme's
arithmetic, not the hardware's accumulation: ``chip_smoke.py`` holds the
kernel itself to the plain version and to float64 on the card.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
MAG_SHAPES, MAG_WITNESS = chip_smoke.MAG_SHAPES, chip_smoke.MAG_WITNESS
N = 256        # query rows and keys of each product


def tf32_round(x):
    """fp32 values rounded to nearest (ties to even) at 10 mantissa bits."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return u.astype(np.uint32).view(np.float32)


def tf32_read(x):
    """What the tensor cores read of an fp32 register: its top 19 bits."""
    u = np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return u.view(np.float32)


def parts2(x):
    """The kernel's two-part split: hi rounded to TF32, the exact rest as
    the tensor cores read it."""
    hi = tf32_round(x)
    return [hi, tf32_read(x - hi)]


def parts3(x):
    """The kernel's three-part split, exact: hi and mid rounded to TF32,
    lo the last 2 bits."""
    hi = tf32_round(x)
    rest = (x - hi).astype(np.float32)
    mid = tf32_round(rest)
    return [hi, mid, (rest - mid).astype(np.float32)]


def scheme_product(a, b, terms):
    """sum over ``terms`` (i, j) of part_i(a) @ part_j(b), in float64,
    rounded to fp32 as the kernel writes it."""
    split = parts3 if max(max(t) for t in terms) > 1 else parts2
    pa = [p.astype(np.float64) for p in split(a)]
    pb = [p.astype(np.float64) for p in split(b)]
    return sum(pa[i] @ pb[j] for i, j in terms).astype(np.float32)


QK_TERMS = ((0, 0), (0, 1), (1, 0))                  # 3xTF32
PV_TERMS = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))


def distance(got, exact):
    """Largest error relative to the largest |exact|."""
    return np.abs(got.astype(np.float64) - exact).max() / np.abs(exact).max()


def operands(shape, d, seed):
    """q, k, v at the magnitudes the reference's init gives them after a
    norm (``MAG_SHAPES``), fp32, from a numpy seed."""
    dm, h, hk, _ = MAG_SHAPES[shape]
    rs = np.random.RandomState(seed)
    q = np.sqrt(dm / h) * rs.standard_normal((N, d))
    k, v = (np.sqrt(dm / hk) * rs.standard_normal((N, d)) for _ in range(2))
    return [x.astype(np.float32) for x in (q, k, v)]


def check(a, b, terms, label):
    exact = a.astype(np.float64) @ b.astype(np.float64)
    fp32 = (torch.from_numpy(a) @ torch.from_numpy(b)).numpy()
    mine = distance(scheme_product(a, b, terms), exact)
    theirs = distance(fp32, exact)
    assert mine <= MAG_WITNESS * theirs, (
        f"{label}: the split is {mine:.3e} from float64, fp32 {theirs:.3e}")


@pytest.mark.parametrize("shape", sorted(MAG_SHAPES))
@pytest.mark.parametrize("d", [32, 96, 128, 256])
def test_qk_split_within_fp32(shape, d):
    """Q.K^T's 3xTF32 sums: each of D products is off by about 2^-22, fp32's
    sum of them rounds more than that."""
    q, k, _ = operands(shape, d, seed=d)
    check(q, k.T.copy(), QK_TERMS, f"{shape} D{d} Q.K^T")


@pytest.mark.parametrize("shape", sorted(MAG_SHAPES))
@pytest.mark.parametrize("d", [32, 96, 128, 256])
def test_pv_split_within_fp32(shape, d):
    """P.V's six terms on three-part P and V, P the fp32 softmax of the
    scaled scores: at scores in the hundreds most rows have one dominant
    key, an output is one product, and fp32 rounds it once (the two-part
    3xTF32 of Q.K^T, off by about 2^-22 a product, misses here)."""
    q, k, v = operands(shape, d, seed=d + 1)
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) / np.sqrt(d)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p = (p / p.sum(axis=1, keepdims=True)).astype(np.float32)
    check(p, v, PV_TERMS, f"{shape} D{d} P.V")


def test_splits_are_exact_tf32_parts():
    """hi + mid + lo == x exactly, each part a TF32 value; two parts hold
    x to about 2^-22."""
    x = np.random.RandomState(0).standard_normal(4096).astype(np.float32)
    hi, mid, lo = parts3(x)
    for part in (hi, mid, lo):
        np.testing.assert_array_equal(tf32_read(part), part)
    np.testing.assert_array_equal(
        hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64),
        x.astype(np.float64))
    two = sum(t.astype(np.float64) for t in parts2(x))
    assert np.abs(two - x).max() <= 2.0 ** -21 * np.abs(x).max()
