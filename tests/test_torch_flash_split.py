"""The split arithmetic of ``csrc/flash_attention.cu`` against fp32, on the
CPU.

The kernel (and ``csrc/decode_attention.cu``, at decode's shapes) runs
fp32 attention on TF32 tensor cores by splitting each operand into TF32
parts: Q.K^T as hi*hi + hi*lo + lo*hi (3xTF32), P.V with P and V in
three parts and six terms; ``csrc/ssd_scan.cu`` runs its C.B^T and its
output products the same way.  This file emulates TF32 in numpy
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
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402

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


def scheme_sum(a, b, terms):
    """sum over ``terms`` (i, j) of part_i(a) @ part_j(b), in float64."""
    split = parts3 if max(max(t) for t in terms) > 1 else parts2
    pa = [p.astype(np.float64) for p in split(a)]
    pb = [p.astype(np.float64) for p in split(b)]
    return sum(pa[i] @ pb[j] for i, j in terms)


def scheme_product(a, b, terms):
    """``scheme_sum`` rounded to fp32 as the kernel writes it."""
    return scheme_sum(a, b, terms).astype(np.float32)


QK_TERMS = ((0, 0), (0, 1), (1, 0))                  # 3xTF32
PV_TERMS = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))


def distance(got, exact):
    """Largest error relative to the largest |exact|."""
    return np.abs(got.astype(np.float64) - exact).max() / np.abs(exact).max()


def operands(shape, d, seed, rows=N, keys=N):
    """q (rows, d), k and v (keys, d) at the magnitudes the reference's init
    gives them after a norm (``MAG_SHAPES``), fp32, from a numpy seed."""
    dm, h, hk, _ = MAG_SHAPES[shape]
    rs = np.random.RandomState(seed)
    q = np.sqrt(dm / h) * rs.standard_normal((rows, d))
    k, v = (np.sqrt(dm / hk) * rs.standard_normal((keys, d))
            for _ in range(2))
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


#: decode_attention.cu runs the same scheme with one query token: a
#: group's G query rows (16 for chatglm3-6b, 1 for phi3-mini) against one
#: slot's keys (phase 2's long slot of 4250, a short one of 35)
DECODE = [("chatglm3", 16), ("phi3", 1)]


@pytest.mark.parametrize("keys", [35, 4250])
@pytest.mark.parametrize("shape,rows", DECODE)
def test_decode_qk_split_within_fp32(shape, rows, keys):
    d = MAG_SHAPES[shape][3]
    q, k, _ = operands(shape, d, seed=rows + keys, rows=rows, keys=keys)
    check(q, k.T.copy(), QK_TERMS, f"{shape} decode G{rows} {keys} keys Q.K^T")


@pytest.mark.parametrize("keys", [35, 4250])
@pytest.mark.parametrize("shape,rows", DECODE)
def test_decode_pv_split_within_fp32(shape, rows, keys):
    d = MAG_SHAPES[shape][3]
    q, k, v = operands(shape, d, seed=rows + keys + 1, rows=rows, keys=keys)
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) / np.sqrt(d)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p = (p / p.sum(axis=1, keepdims=True)).astype(np.float32)
    check(p, v, PV_TERMS, f"{shape} decode G{rows} {keys} keys P.V")


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


def ssd_operands(q, seed, h=8, p=64, n=128):
    """One chunk of mamba2-130m's SSD terms (P 64, N 128, one group), with
    the inputs ``chip_smoke.py`` checks the kernel on, from a numpy seed:
    x, B, C (Q rows), cs and dt per head."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((h, q, p)).astype(np.float32)
    bm, cm = (0.3 * rs.standard_normal((q, n)).astype(np.float32)
              for _ in range(2))
    dt = np.log1p(np.exp(rs.standard_normal((h, q)))).astype(np.float32)
    a = -np.exp(0.2 * rs.standard_normal((h, 1))).astype(np.float32)
    cs = np.cumsum(dt * a, axis=1, dtype=np.float32)
    return x, bm, cm, cs, dt


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("q", [13, 256])
def test_ssd_scan_split_within_fp32(q, seed):
    """csrc/ssd_scan.cu's scheme: C.B^T in 3xTF32, y_diag's coefficients
    in fp32 as the kernel forms them, s_local's in float64 kept as two
    floats (the rounded value and its rest), the output products in six
    terms on
    three-part operands (and the rest times x's hi part).  Over the chunk's
    heads, both terms within ``MAG_WITNESS`` of fp32's distance from
    float64 (the plain version's own products)."""
    x, bm, cm, cs, dt = ssd_operands(q, seed)
    cb = scheme_product(cm, bm.T.copy(), QK_TERMS)
    causal = np.tril(np.ones((q, q), dtype=bool))
    x64, b64 = x.astype(np.float64), bm.astype(np.float64)
    c64 = cm.astype(np.float64)
    exact = {"y_diag": [], "s_local": []}
    mine = {"y_diag": [], "s_local": []}
    for i in range(x.shape[0]):
        c, d = cs[i], dt[i]
        seg = np.where(causal, c[:, None] - c[None, :], -np.inf)
        coef = np.where(causal, (cb * np.exp(seg).astype(np.float32))
                        * d[None, :], 0).astype(np.float32)
        s_exact = b64.T * (np.exp(c[-1].astype(np.float64) - c)
                           * d)[None, :]
        s_coef = s_exact.astype(np.float32)
        s_rest = (s_exact - s_coef).astype(np.float32)
        seg64 = np.where(causal, c[:, None].astype(np.float64) - c[None, :],
                         -np.inf)
        exact["y_diag"].append(((c64 @ b64.T) * np.exp(seg64) * d[None, :])
                               @ x64[i])
        exact["s_local"].append(s_exact @ x64[i])
        mine["y_diag"].append(scheme_product(coef, x[i], PV_TERMS))
        mine["s_local"].append((scheme_sum(s_coef, x[i], PV_TERMS)
                                + tf32_read(s_rest).astype(np.float64)
                                @ tf32_round(x[i]).astype(np.float64)
                                ).astype(np.float32))
    fp32 = ssd_scan_ref(*(torch.from_numpy(t) for t in (
        x[None], bm[None, None], cm[None, None], cs[None, :, None],
        dt[None, :, None])))
    for term, theirs in zip(("y_diag", "s_local"), fp32):
        want = np.stack(exact[term])
        ours = distance(np.stack(mine[term]), want)
        theirs = distance(theirs[0].numpy(), want)
        assert ours <= MAG_WITNESS * theirs, (
            f"Q{q} {term}: the split is {ours:.3e} from float64, fp32 "
            f"{theirs:.3e}")
