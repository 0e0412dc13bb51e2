"""The port's fused prefix, signature and TinyDet against the JAX package's.

Inputs are made with numpy from a seed and handed to both packages; the
JAX fused prefix runs its Pallas kernel in interpret mode and its plain
reference.  Float results agree within 1e-5 (the reference's own kernel
sweep tolerance), masks and counts exactly.  Inside the port, the fused
op equals the unfused chain bit for bit on the CPU (its own contract),
and the CUDA kernel's host-side stage descriptor is rehearsed here by
replaying it with the plain stage functions.
"""
import copy

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
    # the port always emits the signature: the reference's sig=True
    assert fop.signature() + (("sig", True),) == \
        jfused.FusedPrefixOp(stage_ops=tuple(jchain), sig=True).signature()
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


@pytest.mark.parametrize("spec", SPECS + [
    (("crop", (16, 32, 96, 192)), ("preprocess", (0, 0, 96, 192), 2, False),
     ("color", (190., 40., 40.), (8, 8, 32, 64)),
     ("preprocess", (0, 0, 48, 96), 2, True), ("crop", (4, 8, 16, 32))),
    (("diff", (4, 8)), ("color", (190., 40., 40.), (10, 20, 30, 40))),
    (("preprocess", (0, 0, 128, 256), 2, False),
     ("preprocess", (0, 0, 64, 128), 2, False),
     ("preprocess", (0, 0, 32, 64), 2, False))])
def test_kernel_descriptor_replays_the_plain_version(spec):
    f, p = _inputs(9)
    spec, _ = _with_sig(spec)
    stages, scratch = pk.compile_spec(spec, (3, 128, 256))
    assert len(stages) <= pk.MAX_STAGES
    assert scratch == 0 or any(s.get("dst") in (pk.SCRATCH0, pk.SCRATCH1)
                               for s in stages)
    ft, pt = torch.from_numpy(f), torch.from_numpy(p)
    d, fracs, x, feats = _replay(stages, ft, pt)
    want = fused_prefix_ref(ft, pt, None, spec=spec[:-1])
    assert (d is None) == (want[0] is None)
    if d is not None:
        assert torch.equal(d, want[0])
    assert len(fracs) == len(want[1])
    assert all(torch.equal(a, b) for a, b in zip(fracs, want[1]))
    assert x.dtype == want[2].dtype and torch.equal(x, want[2])
    assert torch.equal(feats, signature_feats(want[2], *spec[-1][1]))
    struct = pk._spec_struct(stages)
    assert struct.n == len(stages) and struct.st[0].kind == stages[0]["kind"]


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
