"""The port's fused prefix, signature and TinyDet against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
JAX fused prefix runs its Pallas kernel in interpret mode and its plain
reference.  Float results agree within 1e-5 (the reference's own kernel
sweep tolerance), masks and counts exactly.  Inside the port, the fused
op equals the unfused chain bit for bit on the CPU (its own contract),
and the CUDA kernel's host-side plan (the stage descriptor, and its
layout over a thread-block cluster's banded shared memory) is rehearsed
here by replaying it with the plain stage functions.
"""
import copy
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_prefix.kernel import \
    out_frame_shape as jax_out_frame_shape  # noqa: E402
from repro.kernels.fused_prefix.ops import fused_prefix as jax_fused_prefix  # noqa: E402
from repro.kernels.fused_prefix.ref import \
    fused_prefix_ref as jax_fused_prefix_ref  # noqa: E402
from repro.semantic.signature import TemporalSignature as JaxSignature  # noqa: E402
from repro.semantic.signature import signature_layout as jax_layout  # noqa: E402
from repro.streaming import fused as jfused  # noqa: E402
from repro.streaming import operators as jops  # noqa: E402
from repro.streaming.detector import TinyDet as JaxDet  # noqa: E402

from repro_torch.bridge import load_reference_detector_params  # noqa: E402
from repro_torch.data import TollBoothStream  # noqa: E402
from repro_torch.kernels.fused_prefix import kernel as pk  # noqa: E402
from repro_torch.kernels.fused_prefix.ref import (  # noqa: E402
    color_frac, fused_prefix_ref, signature_feats)
from repro_torch.kernels.frame_diff.ref import frame_diff_ref  # noqa: E402
from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref  # noqa: E402
from repro_torch.semantic.signature import (EMB_DIM, TemporalSignature,  # noqa: E402
                                            signature_layout)
from repro_torch.streaming import fused as tfused  # noqa: E402
from repro_torch.streaming import operators as ops  # noqa: E402
from repro_torch.streaming.detector import TinyDet  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)

#: the four specs of the reference's sweep (tests/test_kernels.py)
SPECS = [
    (("diff", (4, 8)), ("color", (190., 40., 40.), None),
     ("preprocess", (64, 0, 64, 256), 2, False)),
    (("diff", (4, 4)), ("crop", (32, 0, 64, 256)),
     ("preprocess", (0, 0, 64, 256), 2, True)),
    (("color", (190., 40., 40.), (0, 0, 64, 128)),
     ("color", (40., 40., 190.), None)),
    (("crop", (0, 64, 128, 128)), ("preprocess", (0, 0, 128, 128), 4, False)),
]


@pytest.fixture(scope="module")
def detectors():
    jdet = JaxDet()
    params = jax.jit(jdet.init)(jax.random.PRNGKey(1))
    tdet = load_reference_detector_params(
        TinyDet(device="cpu"), jax.tree_util.tree_map(np.asarray, params))
    return (jdet, params), tdet


def _inputs(seed, b=4, shape=(3, 128, 256), dtype=np.uint8):
    r = np.random.RandomState(seed)
    f, p = (r.randint(0, 256, (b,) + shape).astype(dtype) for _ in range(2))
    return f, p


def _with_sig(spec, shape=(3, 128, 256)):
    gy, gx, _, proj = signature_layout(pk.out_frame_shape(spec, shape))
    return spec + (("signature", (gy, gx)),), proj


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("case", range(len(SPECS) + 1))
def test_fused_prefix_ref_matches_reference(case):
    """The four reference sweep specs (uint8) and the first on float32
    frames, each with its signature stage: the port's plain version against
    the JAX kernel (interpret mode) and the JAX plain reference."""
    spec = SPECS[case % len(SPECS)]
    dtype = np.float32 if case == len(SPECS) else np.uint8
    f, p = _inputs(2 + case, dtype=dtype)
    spec, proj = _with_sig(spec)
    has_diff = spec[0][0] == "diff"
    prevs = p if has_diff else None
    got = fused_prefix_ref(torch.from_numpy(f),
                           torch.from_numpy(p) if has_diff else None,
                           torch.from_numpy(proj), spec=spec)
    jprevs = jnp.asarray(prevs) if has_diff else None
    for want in (jax_fused_prefix(jnp.asarray(f), jprevs, jnp.asarray(proj),
                                  spec=spec, interpret=True),
                 jax_fused_prefix_ref(jnp.asarray(f), jprevs,
                                      jnp.asarray(proj), spec=spec)):
        for name, o, r in zip(("d", "fracs", "x", "feats", "emb"), got,
                              want):
            if r is None:
                assert o is None, name
            elif name == "fracs":
                assert len(o) == len(r)
                for a, bb in zip(o, r):
                    _close(a, bb)
            else:
                assert tuple(o.shape) == tuple(r.shape), name
                assert str(o.dtype).split(".")[-1] == str(r.dtype), name
                _close(o, r)


def _threshold_frames():
    """Two raw frames of pixels at squared distance 4899, 4900 and 4901
    from (190, 40, 40), and two normalized frames whose red channel steps
    through consecutive float32 values across distance 70; the exact count
    of each (numpy's float32 arithmetic in the colour filter's order, and
    its correctly rounded square root)."""
    a = np.arange(256)
    d = ((a[:, None, None] - 190) ** 2 + (a[None, :, None] - 40) ** 2
         + (a[None, None, :] - 40) ** 2)
    px = np.concatenate([np.argwhere(d == t) for t in (4899, 4900, 4901)])
    raw = np.resize(px, (2, 128 * 256, 3)).transpose(0, 2, 1)
    raw = raw.reshape(2, 3, 128, 256).astype(np.uint8)
    at = np.float32((120.0 / 255.0 - 0.5) / 0.25)
    steps = np.arange(-(64 * 256), 64 * 256, dtype=np.int32)
    red = (at.view(np.int32) + steps).view(np.float32)
    norm = np.empty((2, 3, 128, 256), np.float32)
    norm[:, 0] = red.reshape(128, 256)
    norm[:, 1:] = np.float32((40.0 / 255.0 - 0.5) / 0.25)
    counts = []
    for f in (raw, norm):
        x = f.astype(np.float32)
        if f.dtype == np.float32:
            x = (x * np.float32(0.25) + np.float32(0.5)) * np.float32(255.0)
        d2 = (x[:, 0] - np.float32(190.0)) ** 2
        d2 = d2 + (x[:, 1] - np.float32(40.0)) ** 2
        d2 = d2 + (x[:, 2] - np.float32(40.0)) ** 2
        counts.append((np.sqrt(d2) < np.float32(70.0)).sum(axis=(1, 2)))
    return (raw, norm), counts


@pytest.mark.parametrize("threads", [1, 4])
def test_color_frac_counts_the_threshold_exactly(threads):
    """The plain colour count equals the exact one (the CUDA kernel's
    IEEE ``sqrtf(d2) < 70``) at the threshold, on one thread and on
    several."""
    frames, counts = _threshold_frames()
    assert all(0 < c.min() and c.max() < 128 * 256 for c in counts)
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        for f, want in zip(frames, counts):
            got = color_frac(torch.from_numpy(f), (190., 40., 40.))
            assert np.array_equal(np.rint(got.numpy() * 128 * 256), want)
    finally:
        torch.set_num_threads(n)


def test_color_frac_first_multithreaded_call_is_exact():
    """A process's first multithreaded colour count, where PyTorch's CPU
    ``sqrt`` has been seen to return sqrt(4900) as 69.983 (on all of a
    thread's rows, in about one process in ten on 8 threads): four fresh
    interpreters, on PyTorch's default thread count, each count the
    threshold frames on their first call."""
    code = ("import sys, numpy as np, torch;"
            "from repro_torch.kernels.fused_prefix.ref import color_frac;"
            "f = np.load(sys.argv[1]);"
            "print(int((color_frac(torch.from_numpy(f), (190., 40., 40.))"
            " * f.shape[2] * f.shape[3]).round().sum()))")
    frames, counts = _threshold_frames()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for i, f in enumerate(frames * 2):
            path = os.path.join(tmp, f"f{i}.npy")
            np.save(path, f)
            runs.append((subprocess.Popen(
                [sys.executable, "-c", code, path], env=env,
                stdout=subprocess.PIPE, text=True), counts[i % 2].sum()))
        for proc, want in runs:
            out, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0 and int(out) == want


def test_out_frame_shape_matches_reference():
    for spec in SPECS:
        assert pk.out_frame_shape(spec, (3, 128, 256)) == \
            jax_out_frame_shape(spec, (3, 128, 256))


@pytest.mark.parametrize("shape", [(3, 128, 256), (3, 32, 128),
                                   (3, 64, 256), (3, 30, 98)])
def test_signature_matches_reference(shape):
    gy, gx, d, proj = signature_layout(shape)
    jgy, jgx, jd, jproj = jax_layout(shape)
    assert (gy, gx, d) == (jgy, jgx, jd) and proj.shape == (d, EMB_DIM)
    assert np.array_equal(proj, jproj)
    r = np.random.RandomState(7)
    raw = r.randint(0, 256, (5,) + shape).astype(np.uint8)
    norm = ((raw / 255.0 - 0.5) / 0.25).astype(np.float32)
    mixed = np.concatenate([raw.astype(np.float32)[:2], norm[2:]])
    tsig, jsig = TemporalSignature(device="cpu"), JaxSignature()
    for frames in (raw, norm, mixed):
        (tf, te), (jf, je) = tsig.features(frames), jsig.features(frames)
        _close(tf, jf)
        _close(te, je)
    assert TemporalSignature.distance(tf[0], te[0], tf[1], te[1]) == \
        pytest.approx(JaxSignature.distance(jf[0], je[0], jf[1], je[1]),
                      rel=1e-5)
    assert TemporalSignature.bucket(te[0] * 0 + 1.5, 0.5) == \
        JaxSignature.bucket(je[0] * 0 + 1.5, 0.5)


def test_tinydet_and_detect_op_match_reference(detectors):
    """Logits on full frames as DetectOp normalizes them, on the plans'
    preprocessed crops and on a ragged size ("SAME" padding); the cascade's
    masks at thresholds that keep clear of every probability."""
    (jdet, params), tdet = detectors
    raw, _ = TollBoothStream(seed=3).batch(16)
    crop = fused_preprocess_ref(torch.from_numpy(raw),
                                crop=(64, 0, 64, 256), factor=2).numpy()
    det_in = raw.astype(np.float32) / 255.0 - 0.5     # DetectOp's input
    for x in (det_in, crop, det_in[:, :, :30, :98]):
        want = jdet.forward(params, jnp.asarray(x))
        with torch.no_grad():
            got = tdet(torch.from_numpy(np.ascontiguousarray(x)))
        for k in ("present", "grid"):
            _close(got[k].numpy(), want[k])
    jop, top = jops.DetectOp(), ops.DetectOp()
    jop.open(jops.OpContext(detector=jdet, detector_params=params))
    top.open(ops.OpContext(detector=tdet, device="cpu"))
    for frames in (raw, crop):
        p = np.asarray(jop._run(jnp.asarray(frames)))
        cuts = np.sort(p)
        mids = (cuts[1:] + cuts[:-1]) / 2
        for thr in mids[np.diff(cuts) > 1e-4][:3]:
            jop.threshold = top.threshold = float(thr)
            batch = {"frames": frames, "idx": np.arange(len(frames))}
            a, b = top.process(batch), jop.process(batch)
            np.testing.assert_array_equal(a["idx"], b["idx"])


def _prefix_ops(m, det_threshold):
    return [m.SkipOp(amount=3, threshold=0.02, regions=(4, 8)),
            m.FusedPreprocessOp(crop=(64, 0, 64, 256), factor=2),
            m.CheapColorFilterOp("red", min_frac=0.008),
            m.DetectOp(threshold=det_threshold)]


def test_fused_prefix_op_matches_reference(detectors):
    """Q8's fused prefix over a stream with Skip's carry across batches:
    kept rows and per-stage counts exact; frames and signature within
    tolerance.  The detect threshold keeps clear of every probability."""
    (jdet, params), tdet = detectors
    frames, _ = TollBoothStream(seed=3).batch(48)
    batches = [frames[i:i + 16] for i in range(0, 48, 16)]
    jctx = jops.OpContext(detector=jdet, detector_params=params)
    tctx = ops.OpContext(detector=tdet, device="cpu")
    det = ops.DetectOp()
    det.open(tctx)
    pre = fused_preprocess_ref(torch.from_numpy(frames),
                               crop=(64, 0, 64, 256), factor=2)
    p = np.sort(ops.detect_prob(tdet, pre).numpy())
    gaps = np.diff(p)
    i = int(np.argmax(gaps))
    thr = float((p[i] + p[i + 1]) / 2)
    assert gaps[i] > 1e-3
    jop = jfused.FusedPrefixOp(stage_ops=tuple(_prefix_ops(jops, thr)))
    top = tfused.FusedPrefixOp(stage_ops=tuple(_prefix_ops(ops, thr)))
    jop.open(jctx)
    top.open(tctx)
    kept = 0
    for k, fr in enumerate(batches):
        idx = np.arange(16 * k, 16 * k + len(fr))
        a = top.process({"frames": fr, "idx": idx})
        b = jop.process({"frames": fr, "idx": idx})
        np.testing.assert_array_equal(a["idx"], b["idx"])
        assert top.last_stage_counts == jop.last_stage_counts
        _close(a["frames"], b["frames"])
        for x, y in zip(a["_sig"], b["_sig"]):
            _close(x, y)
        kept += len(a["idx"])
    assert kept > 0


# ---------------------------------------------------------------------------
# fused == unfused, bitwise, inside the port (CPU)
# ---------------------------------------------------------------------------

_HWS = [(128, 256), (64, 128)]
_ROIS = {(128, 256): [None, (0, 0, 64, 128), (32, 96, 32, 64)],
         (64, 128): [None, (0, 0, 32, 64)]}
_CROPS = {(128, 256): [(0, 0, 128, 256), (64, 0, 64, 256),
                       (32, 128, 64, 128)],
          (64, 128): [(0, 0, 64, 128), (32, 0, 32, 128), (16, 64, 32, 64)]}


def _draw_chain(pick, hw):
    """A random fusable chain (>= 2 ops) for (3, H, W) frames."""
    chain = []
    if pick([False, True]):
        chain.append(ops.SkipOp())
    for _ in range(pick([0, 1, 2])):
        chain.append(ops.CheapColorFilterOp(
            color=pick(["red", "blue"]), min_frac=pick([0.0, 0.001, 0.01]),
            roi=pick(_ROIS[hw])))
    if pick([False, True]):
        chain.append(ops.CropOp(region=pick(_CROPS[hw])))
    if pick([False, True]):
        ch, cw = chain[-1].region[2:] \
            if chain and isinstance(chain[-1], ops.CropOp) else hw
        crop = pick([(0, 0, ch, cw), (ch // 2, 0, ch // 2, cw),
                     (ch // 4, cw // 4, ch // 2, cw // 2)])
        factor = pick([f for f in (1, 2, 4)
                       if crop[2] % f == 0 and crop[3] % f == 0])
        chain.append(ops.FusedPreprocessOp(crop=crop, factor=factor,
                                           grey=pick([False, True])))
    if pick([False, True]):
        chain.append(ops.DetectOp(threshold=pick([0.0, 0.3, 0.5, 0.9])))
    if len(chain) < 2:
        chain = [ops.SkipOp(), ops.CropOp(region=_CROPS[hw][1])] + chain
    assert tfused.fusable_segment(chain)
    return chain


@pytest.mark.parametrize("seed", range(8))
def test_fused_equals_unfused_bitwise(detectors, seed):
    """A random chain over three micro-batches with Skip's carry: the fused
    op keeps the same rows and writes the same frames and signatures as
    the unfused chain followed by ``TemporalSignature``, bit for bit."""
    _, tdet = detectors
    rng = np.random.RandomState(1000 + seed)
    pick = lambda opts: opts[rng.randint(len(opts))]  # noqa: E731
    hw = _HWS[seed % 2]
    dtype = [np.uint8, np.float32][(seed // 2) % 2]
    chain = _draw_chain(pick, hw)
    batches = []
    for _ in range(3):
        n = pick(list(range(1, 13)))
        fr = rng.randint(0, 256, (n, 3) + hw).astype(np.uint8)
        for i in range(1, n):                  # repeated frames: Skip drops
            if pick([False, True]):
                fr[i] = fr[i - 1]
        batches.append(fr.astype(dtype))
    ctx = ops.OpContext(detector=tdet, device="cpu")
    unfused = [copy.deepcopy(o) for o in chain]
    for o in unfused:
        o.open(ctx)
    fused = tfused.FusedPrefixOp(stage_ops=tuple(copy.deepcopy(chain)))
    fused.open(ctx)
    sig = TemporalSignature(device="cpu")
    for fr in batches:
        bu = {"frames": fr, "idx": np.arange(len(fr))}
        for o in unfused:
            if bu["frames"].shape[0] == 0:
                break
            bu = o.process(bu)
        bf = fused.process({"frames": fr, "idx": np.arange(len(fr))})
        feats, emb = bf.pop("_sig")
        np.testing.assert_array_equal(bf["idx"], bu["idx"])
        assert [s[0] for s in fused.last_stage_counts] == \
            [o.name for o in chain]
        if len(bu["idx"]) == 0:
            assert feats.shape[0] == 0 and emb.shape[0] == 0
            continue
        assert bf["frames"].dtype == bu["frames"].dtype
        assert np.array_equal(bf["frames"], bu["frames"])
        ref_feats, ref_emb = sig.features(bu["frames"])
        assert np.array_equal(feats, ref_feats)
        assert np.array_equal(emb, ref_emb)


def test_fusable_segment_verdicts_match_reference():
    def chains(m):
        skip, det = m.SkipOp(), m.DetectOp()
        crop, col = m.CropOp(region=(0, 0, 64, 256)), \
            m.CheapColorFilterOp(color="red")
        pre = m.FusedPreprocessOp(crop=(0, 0, 128, 256), factor=2)
        return [[skip, col, pre, det], [], [crop, skip], [det, crop],
                [skip, m.SourceOp()], [skip, skip], [col, det, det],
                [pre, crop, col], [m.DownscaleOp(2), det], [det],
                [skip, m.MLLMExtractOp()], [crop, pre, pre, col]]

    got = [tfused.fusable_segment(c) for c in chains(ops)]
    assert got == [jfused.fusable_segment(c) for c in chains(jops)]
    assert got[0] and not got[2]


def test_unfuse_and_signature():
    chain = [ops.SkipOp(), ops.CropOp(region=(64, 0, 64, 256)),
             ops.FusedPreprocessOp(crop=(0, 0, 64, 256), factor=2),
             ops.DetectOp()]
    fop = tfused.FusedPrefixOp(stage_ops=tuple(chain))
    assert [o.signature() for o in fop.unfuse()] == \
        [o.signature() for o in chain]
    hash(fop.signature())
    jchain = [jops.SkipOp(), jops.CropOp(region=(64, 0, 64, 256)),
              jops.FusedPreprocessOp(crop=(0, 0, 64, 256), factor=2),
              jops.DetectOp()]
    # the same tuple as the reference's, ("sig", ...) last, both ways
    assert fop.signature()[-1] == ("sig", True)
    for sig in (True, False):
        assert tfused.FusedPrefixOp(stage_ops=tuple(chain),
                                    sig=sig).signature() == \
            jfused.FusedPrefixOp(stage_ops=tuple(jchain),
                                 sig=sig).signature()
    with pytest.raises(ValueError):
        tfused.FusedPrefixOp(stage_ops=(ops.DetectOp(), ops.SkipOp()))


def test_fused_snapshot_restore_continues_exactly(detectors):
    """The member Skip's carry goes through snapshot / restore."""
    _, tdet = detectors
    frames, _ = TollBoothStream(seed=3).batch(32)
    ctx = ops.OpContext(detector=tdet, device="cpu")

    def op():
        o = tfused.FusedPrefixOp(stage_ops=tuple(_prefix_ops(ops, 0.5)))
        o.open(ctx)
        return o

    whole = op()
    want = [whole.process({"frames": frames[i:i + 8],
                           "idx": np.arange(i, i + 8)})["idx"]
            for i in range(0, 32, 8)]
    first = op()
    got = [first.process({"frames": frames[i:i + 8],
                          "idx": np.arange(i, i + 8)})["idx"]
           for i in (0, 8)]
    second = op()
    second.restore(first.snapshot())
    got += [second.process({"frames": frames[i:i + 8],
                            "idx": np.arange(i, i + 8)})["idx"]
            for i in (16, 24)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the CUDA kernel's stage descriptor, replayed on the CPU
# ---------------------------------------------------------------------------

def _replay(stages, frames, prevs):
    """Walk the resolved kernel stages as the CUDA kernel does (windows of
    four buffers, preprocess into x or a scratch frame, a final copy),
    computing each stage with the plain stage functions."""
    bufs = {pk.INPUT: frames}
    d, fracs, feats = None, {}, None

    def window(s):
        src = bufs[s["src"]]
        assert src.shape[2:] == (s["src_h"], s["src_w"])
        return src[:, :, s["y0"]:s["y0"] + s["h"], s["x0"]:s["x0"] + s["w"]]

    for s in stages:
        if s["kind"] == pk.DIFF:
            d = frame_diff_ref(frames, prevs, regions=(s["a"], s["b"]))
        elif s["kind"] == pk.COLOR:
            fracs[s["idx"]] = color_frac(window(s), s["rgb"])
        elif s["kind"] == pk.PREPROCESS:
            assert s["dst"] != s["src"]
            out = fused_preprocess_ref(
                bufs[s["src"]], crop=(s["y0"], s["x0"], s["h"], s["w"]),
                factor=s["factor"], grey=bool(s["grey"]))
            if s["grey"]:
                out = out.repeat(1, 3, 1, 1)
            assert out.shape[2:] == (s["dst_h"], s["dst_w"])
            bufs[s["dst"]] = out
        elif s["kind"] == pk.SIGNATURE:
            feats = signature_feats(window(s), s["a"], s["b"])
        else:
            bufs[pk.XOUT] = window(s).clone()
    return d, tuple(fracs[i] for i in range(len(fracs))), bufs[pk.XOUT], \
        feats


class _Cluster:
    """A cluster's shared memory as ``cluster_plan`` lays it out: for each
    held buffer, one flat array a block (B frames at once), a mask of the
    elements written, and the layout (h, w, band) they were written in.
    Every read checks that it falls inside the buffer the plan gives it."""

    def __init__(self, plan, b, in_dtype):
        self.plan, self.k = plan, plan["blocks"]
        self.data, self.written, self.layout = {}, {}, {}
        for buf, nbytes in plan["bytes"].items():
            dt = in_dtype if buf in (pk.INPUT, pk.PREV) else torch.float32
            n = nbytes // torch.empty((), dtype=dt).element_size()
            self.data[buf] = torch.zeros((b, self.k, n), dtype=dt)
            self.written[buf] = torch.zeros((self.k, n), dtype=torch.bool)

    def _index(self, c, h, w, band, y0=0, x0=0, hh=None, ww=None):
        """Block and flat index of every element (c, y0 + y, x0 + x) of a
        (c, h, w) buffer in bands of ``band`` rows."""
        hh, ww = hh or h, ww or w
        cc, yy, xx = torch.meshgrid(torch.arange(c), y0 + torch.arange(hh),
                                    x0 + torch.arange(ww), indexing="ij")
        q = yy // band
        return q, (cc * band + yy - q * band) * w + xx

    def write(self, buf, frames, band):
        c, h, w = frames.shape[1:]
        q, i = self._index(c, h, w, band)
        assert band * self.k >= h and int(q.max()) < self.k
        assert int(i.max()) < self.data[buf].shape[2], "band beyond buffer"
        self.data[buf][:, q.flatten(), i.flatten()] = \
            frames.reshape(frames.shape[0], -1).to(self.data[buf].dtype)
        self.written[buf][q.flatten(), i.flatten()] = True
        self.layout[buf] = (h, w, band)

    def read(self, buf, h, w, band, y0, x0, hh, ww, c=3):
        assert buf in self.data, f"buffer {buf} not held"
        assert self.layout[buf] == (h, w, band), "read in another layout"
        q, i = self._index(c, h, w, band, y0, x0, hh, ww)
        assert int(q.max()) < self.k and int(i.max()) < \
            self.data[buf].shape[2], "read outside the buffer"
        assert bool(self.written[buf][q, i].all()), "read before written"
        return self.data[buf][:, q, i]

    def window(self, s):
        return self.read(s["src"], s["src_h"], s["src_w"], s["src_band"],
                         s["y0"], s["x0"], s["h"], s["w"])


def _window(s):
    return tuple(s[f] for f in ("src", "src_h", "src_w", "y0", "x0", "h",
                                "w"))


def _disjoint(plan):
    spans = [(plan["off"][buf], n) for buf, n in plan["bytes"].items()]
    spans += [(plan[name], n) for name, n in plan["area_bytes"].items()]
    spans.sort()
    assert all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] <= plan["smem"] <= pk.SMEM_BUDGET
    assert all(plan["off"][buf] % pk.ALIGN == 0 for buf in plan["bytes"])


def _replay_cluster(plan, frames, prevs):
    """Walk the cluster plan as the CUDA kernel does: each block loads its
    band of the frames, each stage reads through the bands (checking
    ownership, layout and the cluster.sync() flags), each block takes the
    items its band owns, and each stage is computed with the plain stage
    functions.  Returns ``(d, fracs, x, feats)``."""
    b, c, h, w = frames.shape
    k = plan["blocks"]
    cl = _Cluster(plan, b, frames.dtype)
    band = pk.band_rows(h, k)
    cl.write(pk.INPUT, frames, band)
    if pk.PREV in plan["bytes"]:
        cl.write(pk.PREV, prevs, band)
    dirty, read = {pk.INPUT, pk.PREV}, set()
    d, fracs, feats, x = None, {}, None, None
    windows = {}        # colour idx -> its window, while unwritten

    def covers(ranges, n):      # the blocks' items partition [0, n)
        lo = 0
        for a, z in ranges:
            assert a == lo or a == z
            lo = max(lo, z)
        assert lo == n

    for s in plan["stages"]:
        reads = {pk.INPUT, pk.PREV} if s["kind"] == pk.DIFF else {s["src"]}
        writes = {s["dst"]} if s["kind"] == pk.PREPROCESS else set()
        if s["sync"]:
            dirty, read = set(), set()
        assert not reads & dirty, "a band read before a cluster.sync()"
        assert not writes & (dirty | read), "a band rewritten before a sync"
        dirty |= writes
        read |= reads
        if s["kind"] == pk.DIFF:
            ry, rx = s["a"], s["b"]
            rh, rw = h // ry, w // rx
            cur = cl.window(dict(s, src=pk.INPUT)).to(torch.int64)
            prv = cl.window(dict(s, src=pk.PREV)).to(torch.int64)
            ad = (cur - prv).abs().reshape(b, c, ry, rh, rx, rw)
            whole = ad.sum(dim=(1, 3, 5))
            parts = torch.zeros_like(whole)
            for q in range(k):      # each block's band rows, region rows met
                r0, r1 = q * s["src_band"], min(h, (q + 1) * s["src_band"])
                if r0 >= r1:
                    continue
                for yy in range(r0 // rh, (r1 - 1) // rh + 1):
                    ya, yb = max(r0, yy * rh), min(r1, (yy + 1) * rh)
                    parts[:, yy] += ad[:, :, yy, ya - yy * rh:yb - yy * rh] \
                        .sum(dim=(1, 2, 4))
            assert torch.equal(parts, whole)
            d = frame_diff_ref(cur.to(frames.dtype), prv.to(frames.dtype),
                               regions=(ry, rx))
        elif s["kind"] == pk.COLOR:
            windows[s["idx"]] = _window(s)
            covers([pk.owned_items(q, s["src_band"], s["y0"], 1, s["h"])
                    for q in range(k)], s["h"])
            fracs[s["idx"]] = color_frac(cl.window(s), s["rgb"])
        elif s["kind"] == pk.PREPROCESS:
            out = fused_preprocess_ref(
                cl.window(s), crop=(0, 0, s["h"], s["w"]),
                factor=s["factor"], grey=bool(s["grey"]))
            if s["grey"]:
                out = out.repeat(1, 3, 1, 1)
            assert out.shape[2:] == (s["dst_h"], s["dst_w"])
            covers([(min(s["dst_h"], q * s["dst_band"]),
                     min(s["dst_h"], (q + 1) * s["dst_band"]))
                    for q in range(k)], s["dst_h"])
            elem = frames.element_size() if s["src"] == pk.INPUT else 4
            need = c * s["dst_band"] * s["factor"] ** 2 * s["dst_w"] * elem
            if "gather" in plan["area_bytes"]:      # a block's source rows
                assert need <= plan["area_bytes"]["gather"]
            else:       # in the predecessor's band, dead after the diff
                assert plan["stages"][0]["kind"] == pk.DIFF
                assert plan["gather"] == plan["off"][pk.PREV]
                assert need <= plan["bytes"][pk.PREV]
            cl.write(s["dst"], out, s["dst_band"])
            windows = {i: w for i, w in windows.items() if w[0] != s["dst"]}
        elif s["kind"] == pk.SIGNATURE:
            gy, gx = s["a"], s["b"]
            ph = s["h"] // gy
            owned = [pk.owned_items(q, s["src_band"], s["y0"], ph, gy)
                     for q in range(k)]
            covers(owned, gy)
            if s["idx"] < 0:        # its own pass for the window's max
                assert plan["area_bytes"]["sig_slots"] == 4 * k
            else:       # a colour's on the same, unwritten window
                assert windows[s["idx"]] == _window(s)
                assert plan["area_bytes"]["color_slots"] == 16 * k * len(
                    windows)
            feats = signature_feats(cl.window(s), gy, gx)
        else:
            covers([pk.owned_items(q, s["src_band"], s["y0"], 1, s["h"])
                    for q in range(k)], s["h"])
            x = cl.window(s).clone()
    if plan["x_band"]:
        assert x is None
        x = cl.read(pk.XOUT, plan["x_h"], plan["x_w"], plan["x_band"], 0, 0,
                    plan["x_h"], plan["x_w"])
    _disjoint(plan)
    return d, tuple(fracs[i] for i in range(len(fracs))), x, feats


_PATH_SPEC = (("diff", (4, 8)), ("preprocess", (64, 0, 64, 256), 2, False),
              ("color", (190., 40., 40.), None))


def _check_replay(got, want, spec):
    d, fracs, x, feats = got
    assert (d is None) == (want[0] is None)
    if d is not None:
        assert torch.equal(d, want[0])
    assert len(fracs) == len(want[1])
    assert all(torch.equal(a, b) for a, b in zip(fracs, want[1]))
    assert x.dtype == want[2].dtype and torch.equal(x, want[2])
    assert torch.equal(feats, signature_feats(want[2], *spec[-1][1]))


@pytest.mark.parametrize("spec", SPECS + [
    (("crop", (16, 32, 96, 192)), ("preprocess", (0, 0, 96, 192), 2, False),
     ("color", (190., 40., 40.), (8, 8, 32, 64)),
     ("preprocess", (0, 0, 48, 96), 2, True), ("crop", (4, 8, 16, 32))),
    (("diff", (4, 8)), ("color", (190., 40., 40.), (10, 20, 30, 40))),
    (("preprocess", (0, 0, 128, 256), 2, False),
     ("preprocess", (0, 0, 64, 128), 2, False),
     ("preprocess", (0, 0, 32, 64), 2, False)),
    _PATH_SPEC])
def test_kernel_descriptor_replays_the_plain_version(spec):
    """The stage descriptor walked over whole buffers, then the cluster
    plan walked over banded buffers (uint8 and float32 frames): both equal
    the plain version."""
    f, p = _inputs(9)
    spec, _ = _with_sig(spec)
    stages, scratch = pk.compile_spec(spec, (3, 128, 256))
    assert len(stages) <= pk.MAX_STAGES
    assert scratch == 0 or any(s.get("dst") in (pk.SCRATCH0, pk.SCRATCH1)
                               for s in stages)
    ft, pt = torch.from_numpy(f), torch.from_numpy(p)
    ff, pf = ft.to(torch.float32), pt.to(torch.float32)
    plan = pk.cluster_plan(stages, (3, 128, 256), 1)
    plan32 = pk.cluster_plan(stages, (3, 128, 256), 4)
    want = fused_prefix_ref(ft, pt, None, spec=spec[:-1])
    _check_replay(_replay(stages, ft, pt), want, spec)
    _check_replay(_replay_cluster(plan, ft, pt), want, spec)
    _check_replay(_replay_cluster(plan32, ff, pf),
                  fused_prefix_ref(ff, pf, None, spec=spec[:-1]), spec)
    struct = pk._spec_struct(plan)
    assert struct.n == len(stages) and struct.st[0].kind == stages[0]["kind"]
    assert struct.blocks == pk.BLOCKS and struct.smem == plan["smem"]
    assert list(struct.off) == plan["off"] and struct.st[0].sync == 1


@pytest.mark.parametrize("shape,spec", [
    ((3, 127, 256), (("diff", (1, 8)), ("preprocess", (63, 0, 64, 256), 2,
                                         False), ("color", (190., 40., 40.),
                                                  None))),
    ((3, 30, 50), (("diff", (3, 5)), ("color", (40., 40., 190.),
                                      (5, 9, 20, 30)),
                   ("preprocess", (0, 0, 30, 50), 2, True))),
    ((3, 30, 50), (("crop", (1, 2, 27, 45)),
                   ("preprocess", (0, 0, 27, 45), 3, False),
                   ("preprocess", (0, 0, 9, 15), 3, False))),
    ((3, 5, 40), (("diff", (1, 1)), ("crop", (1, 0, 3, 40))))])
@pytest.mark.parametrize("blocks", [8, 4])
def test_cluster_plan_replays_ragged_frames(shape, spec, blocks):
    """Frames whose rows do not divide by the cluster's blocks (some bands
    short or empty): the banded replay equals the plain version."""
    r = np.random.RandomState(17)
    f, p = (torch.from_numpy(r.randint(0, 256, (2,) + shape).astype(
        np.uint8)) for _ in range(2))
    spec, _ = _with_sig(spec, shape)
    stages, _ = pk.compile_spec(spec, shape)
    plan = pk.cluster_plan(stages, shape, 1, blocks=blocks)
    _check_replay(_replay_cluster(plan, f, p),
                  fused_prefix_ref(f, p, None, spec=spec[:-1]), spec)


def test_cluster_plan_refuses_a_frame_beyond_the_budget():
    """3x256x512 frames with a diff fit a cluster's shared memory as uint8
    (two 48 KB bands a block) but not as float32."""
    spec = (("diff", (4, 8)), ("preprocess", (0, 0, 256, 512), 2, False))
    stages, _ = pk.compile_spec(spec, (3, 256, 512))
    assert pk.cluster_plan(stages, (3, 256, 512), 1)["smem"] \
        <= pk.SMEM_BUDGET
    with pytest.raises(ValueError, match="budget"):
        pk.cluster_plan(stages, (3, 256, 512), 4)
    with pytest.raises(ValueError, match="budget"):
        pk.cluster_plan(pk.compile_spec((("crop", (0, 0, 8, 8)),),
                                        (3, 1024, 1024))[0],
                        (3, 1024, 1024), 1)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="outside"):
        pk.compile_spec((("crop", (0, 0, 200, 10)),), (3, 128, 256))
    with pytest.raises(ValueError, match="divisible"):
        pk.compile_spec((("preprocess", (0, 0, 63, 256), 2, False),),
                        (3, 128, 256))
    with pytest.raises(ValueError, match="at most"):
        pk.compile_spec((("color", (1., 2., 3.), None),) * 17,
                        (3, 128, 256))
    with pytest.raises(ValueError, match="CUDA"):
        pk.fused_prefix_cuda(torch.zeros(1, 3, 8, 8, dtype=torch.uint8),
                             spec=(("crop", (0, 0, 4, 4)),))
