"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (the check runs inside the test, never at import).  This file imports
no JAX, so it also runs on a GPU host without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.frame_diff.kernel import frame_diff_cuda  # noqa: E402
from repro_torch.kernels.frame_diff.ref import frame_diff_ref  # noqa: E402
from repro_torch.kernels.fused_preprocess.kernel import fused_preprocess_cuda  # noqa: E402
from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref  # noqa: E402
from repro_torch.kernels.fused_prefix.kernel import (fused_prefix_cuda,  # noqa: E402
                                                     out_frame_shape,
                                                     prefix_kernel)
from repro_torch.kernels.fused_prefix.ref import fused_prefix_ref  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dk  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_cuda  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import (int8_matmul_plain,  # noqa: E402
                                                 quantize_colwise,
                                                 quantize_rowwise)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.semantic.signature import signature_layout  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _frames(gen, shape):
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)


@pytest.mark.parametrize("shape,regions", [
    ((16, 3, 128, 256), (4, 8)), ((2, 3, 128, 256), (1, 1)),
    ((3, 3, 30, 50), (3, 5)), ((1, 3, 128, 256), (4, 8)),
    ((64, 3, 128, 256), (4, 8)), ((16, 3, 128, 256), (1, 1))])
def test_frame_diff_kernel(dev, shape, regions):
    g = torch.Generator().manual_seed(0)
    a, b = _frames(g, shape), _frames(g, shape)
    reset_launch_counts()
    got = frame_diff_cuda(a.to(dev), b.to(dev), regions=regions).cpu()
    assert launch_counts()["frame_diff_u8"] == 1
    torch.testing.assert_close(got, frame_diff_ref(a, b, regions=regions),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("b,crop,factor,grey", [
    (4, (64, 0, 64, 256), 2, False), (4, (33, 17, 30, 98), 2, True),
    (4, (5, 7, 96, 60), 3, False),
    (4, (0, 0, 128, 250), 2, False),    # a ragged output row (125 values)
    (4, (64, 3, 64, 250), 2, False),    # an odd x0
    (16, (96, 0, 32, 256), 4, False),   # f = 4
    (4, (3, 5, 90, 150), 5, False),     # the generic-f instantiation
    (1, (64, 0, 64, 256), 2, False), (64, (64, 0, 64, 256), 2, False),
    (16, (64, 0, 64, 256), 2, True),    # grey at the path crop
    (16, (96, 0, 32, 256), 2, False)])  # the optimized plan's crop
def test_fused_preprocess_kernel(dev, b, crop, factor, grey):
    x = _frames(torch.Generator().manual_seed(1), (b, 3, 128, 256))
    reset_launch_counts()
    got = fused_preprocess_cuda(x.to(dev), crop=crop, factor=factor,
                                grey=grey).cpu()
    assert launch_counts()["fused_preprocess_u8"] == 1
    want = fused_preprocess_ref(x, crop=crop, factor=factor, grey=grey)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,offset", [
    ((4, 3, 30, 50), 0),        # rows not 4-byte aligned: byte copies
    ((4, 3, 40, 100), 0),       # 4-byte rows
    ((4, 3, 64, 128), 4),       # a frame pointer 4 bytes past 16
    ((4, 3, 64, 128), 1)])      # one byte past
def test_fused_preprocess_kernel_unaligned_frames(dev, shape, offset):
    x = _frames(torch.Generator().manual_seed(5), shape)
    raw = torch.empty(x.numel() + offset, dtype=torch.uint8, device=dev)
    xd = raw[offset:].view(shape)
    xd.copy_(x)
    crop = (1, 3, shape[2] - 4, shape[3] - 6)
    got = fused_preprocess_cuda(xd, crop=crop, factor=2).cpu()
    torch.testing.assert_close(got, fused_preprocess_ref(x, crop=crop,
                                                         factor=2),
                               atol=1e-5, rtol=1e-5)


def _preprocess_f32(frames, f, grey, mean, std):
    """preprocess.cuh's arithmetic in numpy float32, each operation rounded
    (IEEE): area_mean, normalize and luma of every f x f window."""
    b, c, h, w = frames.shape
    s = frames.astype(np.uint32).reshape(b, c, h // f, f, w // f, f).sum(
        axis=(3, 5))
    f32 = np.float32
    with np.errstate(over="ignore", invalid="ignore"):
        n = [((s[:, i].astype(f32) / f32(255.0)) / f32(f * f) - f32(mean[i]))
             / f32(std[i]) for i in range(c)]
        if grey:
            return ((n[0] * f32(0.299) + n[1] * f32(0.587))
                    + n[2] * f32(0.114))[:, None]
    return np.stack(n, axis=1)


@pytest.mark.parametrize("grey", [False, True])
@pytest.mark.parametrize("factor", [1, 2, 3, 4, 5])
def test_fused_preprocess_kernel_every_sum_bitwise(dev, factor, grey):
    """Every window sum a factor can give, in each channel, through mean
    and std sets that keep every division on the kernel's fast path (the
    defaults, ImageNet's) and one that does not (stds of 1e-36 and 3e30, a
    subnormal mean: those threads take preprocess.cuh's own division):
    the kernel equals preprocess.cuh's arithmetic in IEEE float32 bit for
    bit, as the earlier kernel and fused_prefix's x do."""
    f, per_row = factor, 128
    sums = np.arange(255 * f * f + 1)
    rows = -(-sums.size // per_row)
    sums = np.resize(sums, rows * per_row)
    # a window of sum s: s // 255 bytes of 255, one of s % 255, then zeros
    k = np.arange(f * f)
    win = np.where(k[None] < sums[:, None] // 255, 255,
                   np.where(k[None] == sums[:, None] // 255,
                            sums[:, None] % 255, 0))
    plane = win.reshape(rows, per_row, f, f).transpose(0, 2, 1, 3).reshape(
        rows * f, per_row * f)
    frames = np.stack([np.roll(plane, 37 * i, axis=1) for i in range(3)])
    frames = frames[None].astype(np.uint8)
    x = torch.from_numpy(frames).to(dev)
    crop = (0, 0) + frames.shape[2:]
    for mean, std in [((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)),
                      ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
                      ((0.0, 3e-39, 1e30), (1e-36, 3e30, -0.5))]:
        got = fused_preprocess_cuda(x, crop=crop, factor=f, mean=mean,
                                    std=std, grey=grey).cpu().numpy()
        np.testing.assert_array_equal(
            got, _preprocess_f32(frames, f, grey, mean, std))


@pytest.mark.parametrize("s", [140, 76, 28, 1, 257])
@pytest.mark.parametrize("g", [1, 2])
def test_flash_attention_kernel(dev, s, g):
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(3, s, 4 * g, 32, generator=gen)
    k = torch.randn(3, s, 4, 32, generator=gen)
    v = torch.randn(3, s, 4, 32, generator=gen)
    reset_launch_counts()
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev)).cpu()
    assert launch_counts()["flash_attention_f32"] == 1
    torch.testing.assert_close(got, flash_attention(q, k, v), atol=2e-5,
                               rtol=2e-5)


RED, BLUE = (190., 40., 40.), (40., 40., 190.)
PREFIX_CASES = {
    # the reference sweep's four specs (tests/test_kernels.py)
    "sweep_diff_color_pre": (("diff", (4, 8)), ("color", RED, None),
                             ("preprocess", (64, 0, 64, 256), 2, False)),
    "sweep_crop_grey": (("diff", (4, 4)), ("crop", (32, 0, 64, 256)),
                        ("preprocess", (0, 0, 64, 256), 2, True)),
    "sweep_two_colors": (("color", RED, (0, 0, 64, 128)),
                         ("color", BLUE, None)),
    "sweep_transform_only": (("crop", (0, 64, 128, 128)),
                             ("preprocess", (0, 0, 128, 128), 4, False)),
    # the main path's prefix: colour on the preprocessed frame
    "path": (("diff", (4, 8)), ("preprocess", (64, 0, 64, 256), 2, False),
             ("color", RED, None)),
    "roi_color_after_pre": (("preprocess", (0, 0, 128, 256), 2, False),
                            ("color", RED, (5, 9, 30, 50))),
    "odd_crop_chain": (("diff", (2, 2)), ("crop", (3, 5, 90, 150)),
                       ("preprocess", (1, 0, 87, 147), 3, True),
                       ("color", BLUE, None), ("crop", (2, 4, 20, 30))),
    "two_preprocess": (("preprocess", (0, 0, 128, 256), 2, False),
                       ("preprocess", (0, 0, 64, 128), 2, False)),
}


#: frames whose rows do not divide by the cluster's 8 blocks, one frame,
#: and more clusters than the card runs at once: (shape, batch, spec)
RAGGED_CASES = {
    "rows_127": ((3, 127, 256), 4, (("diff", (1, 8)),
                                    ("preprocess", (63, 0, 64, 256), 2, False),
                                    ("color", RED, None))),
    "frame_30x50": ((3, 30, 50), 4, (("diff", (3, 5)),
                                     ("color", BLUE, (5, 9, 20, 30)),
                                     ("preprocess", (0, 0, 30, 50), 2, True))),
    "frame_30x50_chain": ((3, 30, 50), 4, (
        ("crop", (1, 2, 27, 45)), ("preprocess", (0, 0, 27, 45), 3, False),
        ("preprocess", (0, 0, 9, 15), 3, False))),
    "path_b1": ((3, 128, 256), 1, PREFIX_CASES["path"]),
    "path_b40": ((3, 128, 256), 40, PREFIX_CASES["path"]),
}


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("case", sorted(PREFIX_CASES) + sorted(RAGGED_CASES))
def test_fused_prefix_kernel(dev, case, dtype):
    if case in RAGGED_CASES:
        shape, b, spec = RAGGED_CASES[case]
    else:
        shape, b, spec = (3, 128, 256), 16 if case == "path" else 4, \
            PREFIX_CASES[case]
    g = torch.Generator().manual_seed(3)
    f = _frames(g, (b,) + shape).to(dtype)
    p = _frames(g, (b,) + shape).to(dtype)
    gy, gx, _, proj = signature_layout(out_frame_shape(spec, shape))
    spec = spec + (("signature", (gy, gx)),)
    proj = torch.from_numpy(proj)
    has_diff = spec[0][0] == "diff"
    reset_launch_counts()
    got = fused_prefix_cuda(f.to(dev), p.to(dev) if has_diff else None,
                            proj.to(dev), spec=spec)
    torch.cuda.synchronize()
    assert launch_counts()["fused_prefix_launch"] == 1
    want = fused_prefix_ref(f.to(dev), p.to(dev) if has_diff else None,
                            proj.to(dev), spec=spec)
    for name, a, r in zip(("d", "fracs", "x", "feats", "emb"), got, want):
        if r is None:
            assert a is None, name
            continue
        for x, y in (zip(a, r) if name == "fracs" else [(a, r)]):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            torch.testing.assert_close(x.float().cpu(), y.float().cpu(),
                                       atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("case", ["path", "grey", "optimized"])
def test_fused_prefix_equals_the_unfused_kernels(dev, case):
    """fused_prefix's d and x are the unfused kernels' bit for bit (Skip's
    keep decisions and the extract's frames in a fused plan and its
    unfused twin rest on it); each call one launch of its entry point."""
    spec = {"path": PREFIX_CASES["path"],
            "grey": (("diff", (4, 8)), ("preprocess", (64, 0, 64, 256), 2,
                                        True), ("color", BLUE, None)),
            "optimized": (("diff", (4, 8)), ("preprocess", (96, 0, 32, 256),
                                             2, False),
                          ("color", RED, None))}[case]
    g = torch.Generator().manual_seed(4)
    f, p = (_frames(g, (16, 3, 128, 256)).to(dev) for _ in range(2))
    crop, factor, grey = spec[1][1:]
    reset_launch_counts()
    d, _, x, _ = prefix_kernel(f, p, spec=spec)
    want_d = frame_diff_cuda(f, p, regions=spec[0][1])
    want_x = fused_preprocess_cuda(f, crop=crop, factor=factor, grey=grey)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_prefix_launch"] == counts["frame_diff_u8"] == \
        counts["fused_preprocess_u8"] == 1
    assert torch.equal(d, want_d)
    assert torch.equal(x, want_x.expand(-1, 3, -1, -1) if grey else want_x)


@pytest.mark.parametrize("b,s,h,hk,d,lens,kw", [
    # gemma2-2b's decode shape: 4 slots of an 8192-row cache
    (4, 8192, 8, 4, 256, [7, 30, 4100, 4250], dict(cap=50.0, window=4096)),
    (4, 8192, 8, 4, 256, [7, 30, 4100, 4250], dict(cap=50.0)),
    (2, 64, 4, 2, 32, [1, 1], {}),
    (2, 64, 4, 2, 32, [5, 64], dict(window=100)),
    (2, 64, 4, 4, 32, [17, 3], dict(cap=20.0)),
    (3, 300, 8, 2, 64, [1, 9, 300], dict(window=8)),
    (1, 512, 8, 1, 128, [333], dict(cap=20.0, window=64)),
    # chatglm3-6b / glm4-9b: 32 query heads over 2 kv heads (G = 16)
    (4, 512, 32, 2, 128, [7, 30, 300, 512], {}),
    # phi3-mini-3.8b: 32 heads of 96
    (2, 300, 32, 32, 96, [1, 299], {}),
    # a decode tick's short slots in an 8192-row cache: one split each, at
    # G 2 (gemma2-2b), 16 (chatglm3-6b) and 1 (phi3-mini)
    (4, 8192, 8, 4, 256, [4, 17, 23, 35], dict(cap=50.0, window=4096)),
    (4, 8192, 32, 2, 128, [5, 12, 30, 35], {}),
    (4, 8192, 32, 32, 96, [4, 9, 21, 33], {}),
    # the served paths' long tick: the long request's slot beside three
    # short ones, at G 2, 16 and 1
    (4, 8192, 8, 4, 256, [7, 23, 30, 4206], dict(cap=50.0, window=4096)),
    (4, 8192, 32, 2, 128, [7, 23, 30, 4206], {}),
    (4, 8192, 32, 32, 96, [7, 23, 30, 4206], {}),
    # more sequences than a kv head's budget of blocks
    (40, 700, 32, 32, 64, [1 + (37 * i) % 700 for i in range(40)], {}),
    # every slot at one key
    (4, 8192, 32, 2, 128, [1, 1, 1, 1], {}),
    # a window longer than every slot's live range
    (4, 8192, 8, 4, 256, [40, 300, 1000, 2000], dict(cap=50.0, window=4096)),
    # glm4-9b's decode shape (32/2 heads of 128), slots of many splits
    (4, 8192, 32, 2, 128, [6, 129, 2049, 8192], {}),
    # splits that end mid-tile, a window that starts mid-split
    (2, 1000, 8, 8, 16, [999, 161], dict(window=517)),
    # a group of 16 at head dim 256, a group of 3
    (1, 300, 32, 2, 256, [300], dict(cap=50.0)),
    (2, 100, 6, 2, 64, [100, 37], {})])
def test_decode_attention_kernel(dev, b, s, h, hk, d, lens, kw):
    """The kernel against its plain version; keys at or past kv_len are
    NaN in the cache and must never be read.  One launch a call."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(b, 1, h, d, generator=gen)
    k = torch.randn(b, s, hk, d, generator=gen)
    v = torch.randn(b, s, hk, d, generator=gen)
    kv_len = torch.tensor(lens, dtype=torch.int32)[:, None]
    want = decode_attention(q, k, v, kv_len, **kw)
    for i, n in enumerate(lens):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    reset_launch_counts()
    got = decode_attention_cuda(q.to(dev), k.to(dev), v.to(dev),
                                kv_len.to(dev), **kw).cpu()
    assert launch_counts() == _counts(decode_attention_f32=1)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_decode_attention_kernel_repeats(dev):
    """The merge counters are left at zero: the same call three times on
    one stream gives the same bits."""
    gen = torch.Generator().manual_seed(14)
    q = torch.randn(4, 1, 32, 128, generator=gen).to(dev)
    k, v = (torch.randn(4, 4096, 2, 128, generator=gen).to(dev)
            for _ in range(2))
    kv_len = torch.tensor([[4096], [3000], [7], [1500]], dtype=torch.int32,
                          device=dev)
    outs = [decode_attention_cuda(q, k, v, kv_len) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("bc,h,g,q,p,n", [
    (2, 24, 1, 256, 64, 128), (1, 24, 1, 13, 64, 128),   # mamba2-130m
    (4, 8, 4, 64, 16, 8), (2, 4, 2, 32, 16, 8),          # reference sweep
    (1, 24, 2, 13, 64, 128),          # a short prompt's chunk, G 2
    (2, 8, 2, 200, 128, 256),         # P 128, N 256, an odd row-tile count
    (1, 6, 3, 77, 24, 13)])           # N off 4: 4-byte copies
def test_ssd_scan_kernel(dev, bc, h, g, q, p, n):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(bc, h, q, p, generator=gen)
    bm = 0.3 * torch.randn(bc, g, q, n, generator=gen)
    cm = 0.3 * torch.randn(bc, g, q, n, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(bc, h, 1, q, generator=gen))
    a = -torch.exp(0.2 * torch.randn(h, generator=gen))
    cs = torch.cumsum(dt * a[None, :, None, None], dim=-1)
    want = ssd_scan_ref(x, bm, cm, cs, dt)
    reset_launch_counts()
    got = ssd_scan_cuda(*(t.to(dev).contiguous() for t in (x, bm, cm, cs, dt)))
    assert launch_counts() == _counts(ssd_scan_f32=1)
    for a_, b_ in zip(got, want):
        torch.testing.assert_close(a_.cpu(), b_, atol=1e-4, rtol=1e-4)


def _counts(**launched):
    """Every kernel's launch count: ``launched`` and 0 for the others."""
    counts = {name: 0 for name in launch_counts()}
    counts.update(launched)
    return counts


@pytest.mark.parametrize("call", ["decode_attention", "ssd_scan",
                                  "flash_attention"])
def test_kernels_refuse_inputs_that_require_grad(dev, call):
    """A kernel has no backward: an input that requires grad, with grad
    mode on, raises before the launch; under no_grad the same call runs."""
    gen = torch.Generator().manual_seed(15)
    if call == "ssd_scan":
        x = torch.randn(1, 2, 16, 8, generator=gen)
        bm = torch.randn(1, 1, 16, 8, generator=gen)
        cs = torch.cumsum(-torch.rand(1, 2, 1, 16, generator=gen), dim=-1)
        args = [x, bm, bm.clone(), cs, torch.rand(1, 2, 1, 16,
                                                  generator=gen)]
        fn = ssd_scan_cuda
    else:
        q = torch.randn(1, 1 if call == "decode_attention" else 9, 4, 32,
                        generator=gen)
        k = torch.randn(1, 9, 2, 32, generator=gen)
        args = [q, k, k.clone()]
        fn = flash_attention_cuda
        if call == "decode_attention":
            args.append(torch.tensor([[9]], dtype=torch.int32))
            fn = decode_attention_cuda
    args = [t.to(dev) for t in args]
    args[0].requires_grad_(True)
    reset_launch_counts()
    with pytest.raises(ValueError, match="requires grad"):
        fn(*args)
    assert not any(launch_counts().values())
    with torch.no_grad():
        fn(*args)
    assert sum(launch_counts().values()) == 1


@pytest.mark.parametrize("s,kw", [(300, dict(cap=50.0)),
                                  (600, dict(cap=50.0, window=256))])
def test_flash_attention_kernel_d256(dev, s, kw):
    gen = torch.Generator().manual_seed(6)
    q = torch.randn(1, s, 8, 256, generator=gen)
    k = torch.randn(1, s, 4, 256, generator=gen)
    v = torch.randn(1, s, 4, 256, generator=gen)
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw).cpu()
    torch.testing.assert_close(got, flash_attention(q, k, v, **kw),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,h,hk,d", [(300, 32, 2, 128), (257, 32, 32, 96),
                                       (64, 8, 8, 96)])
def test_flash_attention_kernel_dense_zoo(dev, s, h, hk, d):
    """chatglm3 / glm4's group of 16 (4 positions per tile) and phi3-mini's
    head dim 96 (three columns per lane)."""
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(1, s, h, d, generator=gen)
    k = torch.randn(1, s, hk, d, generator=gen)
    v = torch.randn(1, s, hk, d, generator=gen)
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev)).cpu()
    torch.testing.assert_close(got, flash_attention(q, k, v), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("s,h,hk,d,kw", [
    (65, 64, 1, 16, {}),                                  # G 64, D 16
    (33, 128, 2, 96, dict(window=5)),                     # window < a tile
    (70, 64, 1, 256, dict(causal=False, cap=30.0)),       # cap, both ways
    (257, 32, 2, 256, dict(window=20, cap=50.0)),
    (129, 16, 4, 96, dict(causal=False)),
    (1, 64, 1, 128, {}), (100, 3, 1, 16, dict(window=7))])  # S 1, G 3
def test_flash_attention_kernel_tensor_core_cases(dev, s, h, hk, d, kw):
    """The tensor-core kernel's edges: a group of 64 (one position per
    tile), head dims 16, 96 and 256, a window shorter than a key tile, the
    cap with bidirectional attention, a group that does not divide the
    64-row tile."""
    gen = torch.Generator().manual_seed(13)
    q = torch.randn(2, s, h, d, generator=gen)
    k = torch.randn(2, s, hk, d, generator=gen)
    v = torch.randn(2, s, hk, d, generator=gen)
    reset_launch_counts()
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw).cpu()
    assert launch_counts()["flash_attention_f32"] == 1
    torch.testing.assert_close(got, flash_attention(q, k, v, **kw),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("m,k,n", [
    (128, 256, 128), (256, 512, 256), (64, 128, 512),   # reference sweep
    (4, 4096, 256), (4200, 256, 96),                     # decode, prefill
    (37, 129, 67), (3, 1000, 13), (1, 7, 1), (65, 4099, 70),  # ragged
    # off every tile: K off multiples of 32 and 16, N of 8, M of the
    # product's 128 rows
    (200, 100, 13), (129, 33, 257), (64, 1, 1), (300, 4096, 1000),
    (63, 512, 129)])
def test_int8_matmul_kernel(dev, m, k, n):
    """The kernel against its plain version: equal (exact int32 sums,
    the same two fp32 multiplies), one launch of the pre-pass and one of
    the product."""
    gen = torch.Generator().manual_seed(8)
    x_q, sx = quantize_rowwise(torch.randn(m, k, generator=gen))
    w_q, sw = quantize_colwise(torch.randn(k, n, generator=gen))
    want = int8_matmul_plain(x_q, w_q, sx, sw)
    reset_launch_counts()
    got = int8_matmul_cuda(*(t.to(dev) for t in (x_q, w_q, sx, sw))).cpu()
    assert launch_counts() == _int8_counts()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def _int8_counts():
    """Every kernel's launch count after one int8 product: the transpose
    and the tensor-core product once each, nothing else."""
    return _counts(int8_transpose_kn=1, int8_mma_f32=1)


def test_int8_matmul_mma_route_exact_at_full_codes(dev):
    """Codes of +-127 over chatglm3-6b's K = 13696 at a prefill's M = 4200
    on the tensor cores, one row and one column of one sign: the
    int32 sums reach -13696 * 127^2 and equal the plain version."""
    gen = torch.Generator(device=dev).manual_seed(12)
    m, k, n = 4200, 13696, 136
    sign = [torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1
            for shape in ((m, k), (k, n))]
    x_q = (127 * sign[0]).to(torch.int8)
    w_q = (127 * sign[1]).to(torch.int8)
    x_q[0], w_q[:, 0] = 127, -127
    sx, sw = torch.ones(m, 1, device=dev), torch.ones(1, n, device=dev)
    reset_launch_counts()
    got = int8_matmul_cuda(x_q, w_q, sx, sw)
    assert launch_counts() == _int8_counts()
    assert torch.equal(got, int8_matmul_plain(x_q, w_q, sx, sw))
    assert got[0, 0].item() == float(-13696 * 127 * 127)


def test_int8_matmul_kernel_exact_at_full_codes(dev):
    """Every code 127 over chatglm3-6b's K = 13696: the int32 sum is
    exact past fp32's 2^24 and the plain version on the card agrees."""
    x_q = torch.full((4, 13696), 127, dtype=torch.int8, device=dev)
    w_q = torch.full((13696, 40), -127, dtype=torch.int8, device=dev)
    sx, sw = torch.ones(4, 1, device=dev), torch.ones(1, 40, device=dev)
    got = int8_matmul_cuda(x_q, w_q, sx, sw)
    want = int8_matmul_plain(x_q, w_q, sx, sw)
    assert torch.equal(got, want)
    assert got[0, 0].item() == float(-13696 * 127 * 127)


def test_int8_quantization_card_equals_cpu(dev):
    """Codes, scales and dequantized weights on the card equal the CPU's
    bit for bit (the scale is a true division by 127 on both)."""
    from repro_torch.serving.quantize import (dequantize_params,
                                              quantize_params_int8)

    gen = torch.Generator().manual_seed(9)
    x = torch.randn(64, 1000, generator=gen) * 3.7
    for fn in (quantize_rowwise, quantize_colwise):
        for a, b in zip(fn(x.to(dev)), fn(x)):
            assert torch.equal(a.cpu(), b)
    tree = {"w": torch.randn(4, 300, 2, 64, generator=gen) * 45.0,
            "norm": torch.randn(64, generator=gen)}
    card, _ = quantize_params_int8({k: t.to(dev) for k, t in tree.items()})
    cpu, _ = quantize_params_int8(tree)
    assert torch.equal(card["w"]["q"].cpu(), cpu["w"]["q"])
    assert torch.equal(card["w"]["scale"].cpu(), cpu["w"]["scale"])
    assert torch.equal(dequantize_params(card)["w"].cpu(),
                       dequantize_params(cpu)["w"])


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m", "chatglm3-6b",
                                  "glm4-9b", "phi3-mini-3.8b",
                                  "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b", "pixtral-12b"])
def test_lm_serving_card_equals_cpu(dev, arch):
    """The smoke LMs through the engine on the card and on the CPU, same
    weights: the same tokens."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.model import LM
    from repro_torch.serving.engine import ServingEngine

    cfg = smoke_config(arch)
    cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = LM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    outs = []
    for lm in (cpu, card):
        eng = ServingEngine(lm, max_slots=2, s_max=64, eos_id=-1)
        outs.append([r.output for r in eng.run(make_requests(cfg, 4, 6))])
    assert outs[0] == outs[1]


def _bwd_case(b, s, h, hk, d, kw):
    """A backward case, its id naming the plan's split count (pure Python:
    the same ids on every worker, card or not)."""
    from repro_torch.kernels.flash_attention.kernel import bwd_plan

    splits = bwd_plan(b, s, s, h, hk, d)["splits"]
    opts = "-".join(f"{k}{v}" for k, v in kw.items())
    return pytest.param(b, s, h, hk, d, kw,
                        id=f"B{b}-S{s}-H{h}-Hk{hk}-D{d}-{opts}-splits{splits}")


#: the backward's cases: the stream MLLM's frame sizes (G 2), chatglm3's
#: group of 16 at D 128, each head dim, G 64, ragged S, bidirectional,
#: capped and windowed; and the split's edges: a group of 7 in two splits
#: (3 and 4 heads: the plan never leaves a group of 6 unevenly split, a
#: smaller even split being as short), G 64 at S 130 (64 splits), D 256
#: windowed at S 129 (two splits, 16-key tiles)
BWD_CASES = [_bwd_case(*c) for c in [
    *[(4, s, 8, 4, 32, dict(causal=True)) for s in (140, 76, 28)],
    (2, 64, 32, 2, 128, dict(causal=True)),
    (1, 33, 64, 1, 16, dict(causal=True)),
    (2, 45, 4, 2, 64, dict(causal=False)),
    (2, 45, 4, 2, 96, dict(causal=True, cap=20.0)),
    (2, 45, 4, 2, 256, dict(causal=True, window=7)),
    (1, 1, 2, 1, 32, dict(causal=True)),
    (32, 64, 14, 2, 128, dict(causal=True)),
    (2, 64, 12, 2, 128, dict(causal=True)),
    (1, 130, 64, 1, 64, dict(causal=True)),
    (2, 129, 8, 2, 256, dict(causal=True, window=7))]]


@pytest.mark.parametrize("b,s,h,hk,d,kw", BWD_CASES)
def test_flash_attention_backward_kernel(dev, b, s, h, hk, d, kw):
    """``flash_attention`` on CUDA inputs that require grad: one launch of
    the forward with its log-sum-exp and one of the backward; the output
    and dQ, dK, dV against the plain version's autograd on the card
    (2e-5 of each gradient's largest magnitude, the forward's tolerance:
    fp32 sums in another order); a second backward equal bit for bit."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    gen = torch.Generator().manual_seed(s + d)
    q = torch.randn(b, s, h, d, generator=gen).to(dev)
    k = torch.randn(b, s, hk, d, generator=gen).to(dev)
    v = torch.randn(b, s, hk, d, generator=gen).to(dev)
    dout = torch.randn(b, s, h, d, generator=gen).to(dev)
    grads = []
    for fn in (flash_attention, flash_attention_plain, flash_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        reset_launch_counts()
        out = fn(*leaves, **kw)
        out.backward(dout)
        torch.cuda.synchronize()
        counts = launch_counts()
        if fn is flash_attention:
            assert counts["flash_attention_lse_f32"] == 1
            assert counts["flash_attention_bwd_f32"] == 1
            assert counts["flash_attention_f32"] == 0
        else:
            assert not any(counts.values())
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(grads[0], grads[1]):
        err = (got - want).abs().max().item()
        assert err <= 2e-5 * max(want.abs().max().item(), 1.0), err
    for a, c in zip(grads[0], grads[2]):
        assert torch.equal(a, c)


#: the rectangular kernels' cases (cross attention: Sq queries against Sk
#: keys, no mask), (B, Sq, Sk, H, Hk, D, options): seamless-m4t-medium's
#: prefill and training cross attention, a ragged one, a capped one and
#: fewer keys than queries (chip_smoke.CROSS_SHAPES)
CROSS_CASES = [
    pytest.param(4, 16, 1024, 16, 16, 64, {}, id="seamless-prefill-cross"),
    pytest.param(4, 128, 512, 16, 16, 64, {}, id="seamless-train-cross"),
    pytest.param(2, 45, 130, 8, 4, 32, {}, id="ragged"),
    pytest.param(2, 33, 257, 4, 2, 128, dict(cap=20.0), id="capped"),
    pytest.param(2, 200, 77, 8, 8, 64, {}, id="sk-below-sq")]


def _cross_inputs(b, sq, sk, h, hk, d, dev):
    gen = torch.Generator().manual_seed(sq * sk + d)
    return [torch.randn(shape, generator=gen).to(dev) for shape in
            ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d), (b, sq, h, d))]


@pytest.mark.parametrize("b,sq,sk,h,hk,d,kw", CROSS_CASES)
def test_flash_attention_cross_kernel(dev, b, sq, sk, h, hk, d, kw):
    """The forward at Sq != Sk (``causal=False``) against its plain
    version (2e-5), one launch a call, with and without the log-sum-exp
    (the same output bit for bit); ``causal=True`` there is refused."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_plain, flash_attention_plain)

    q, k, v, _ = _cross_inputs(b, sq, sk, h, hk, d, dev)
    reset_launch_counts()
    got = flash_attention_cuda(q, k, v, causal=False, **kw)
    assert launch_counts()["flash_attention_f32"] == 1
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v, causal=False, **kw), atol=2e-5,
        rtol=2e-5)
    out, lse = flash_attention_cuda(q, k, v, causal=False, lse=True, **kw)
    assert torch.equal(out, got) and lse.shape == (b, h, sq)
    torch.testing.assert_close(
        lse, flash_attention_lse_plain(q, k, v, causal=False, **kw)[1],
        atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="causal=False"):
        flash_attention_cuda(q, k, v, causal=True)


@pytest.mark.parametrize("b,sq,sk,h,hk,d,kw", CROSS_CASES)
def test_flash_attention_cross_backward_kernel(dev, b, sq, sk, h, hk, d,
                                               kw):
    """The backward at Sq != Sk: one launch of the forward with its
    log-sum-exp and one of the backward; dQ, dK, dV against the plain
    version's autograd (2e-5 of each gradient's largest magnitude); a
    second backward equal bit for bit."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    q, k, v, dout = _cross_inputs(b, sq, sk, h, hk, d, dev)
    grads = []
    for fn in (flash_attention, flash_attention_plain, flash_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        reset_launch_counts()
        out = fn(*leaves, causal=False, **kw)
        out.backward(dout)
        torch.cuda.synchronize()
        counts = launch_counts()
        if fn is flash_attention:
            assert counts["flash_attention_lse_f32"] == 1
            assert counts["flash_attention_bwd_f32"] == 1
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(grads[0], grads[1]):
        assert got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= 2e-5 * max(want.abs().max().item(), 1.0), err
    for a, c in zip(grads[0], grads[2]):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,s,h,d", [(4, 1024, 16, 64), (2, 77, 4, 64)])
def test_decode_attention_cross_kernel(dev, b, s, h, d):
    """decode_attention at G 1, D 64 with every row's kv_len the cache's
    whole length (a decode step's cross attention to the encoder's
    frames), against its plain version (2e-5), one launch."""
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_plain

    gen = torch.Generator().manual_seed(s)
    q = torch.randn(b, 1, h, d, generator=gen).to(dev)
    k = torch.randn(b, s, h, d, generator=gen).to(dev)
    v = torch.randn(b, s, h, d, generator=gen).to(dev)
    kv_len = torch.full((b, 1), s, dtype=torch.int32, device=dev)
    reset_launch_counts()
    got = decode_attention_cuda(q, k, v, kv_len)
    assert launch_counts()["decode_attention_f32"] == 1
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, kv_len),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_encdec_and_patch_card_equals_cpu(dev, arch):
    """The smoke encoder-decoder (frames) and patch-frontend (patches at
    positions with a repeat) LMs on the card and on the CPU, same weights
    and inputs: causal logits (1e-4), prefill and two greedy decode steps'
    tokens equal; the loss's gradients held to a float64 run on the CPU,
    each leaf within 1e-4 of its largest |g| or no farther than twice the
    CPU's fp32 gradient (the random-weight attention is near an argmax,
    so fp32 rounding moves a leaf: seamless-smoke's CPU fp32 gradient is
    up to 8e-4 of a leaf's largest |g| from float64)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import LM

    cfg = smoke_config(arch)
    cpu = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = LM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    tokens = torch.from_numpy(rs.randint(0, cfg.vocab_size, (2, 24)))
    if cfg.encoder_decoder:
        inputs = {"frames": torch.from_numpy(
            rs.standard_normal((2, 40, cfg.d_model)).astype(np.float32))}
    else:
        inputs = {"patch_embeds": torch.from_numpy(
            rs.standard_normal((2, 5, cfg.d_model)).astype(np.float32)),
            "patch_pos": torch.tensor([[0, 3, 3, 9, 20], [1, 1, 1, 5, 6]])}
    outs = []
    cpu64 = LM(cfg, device="cpu")
    cpu64.load_state_dict(cpu.state_dict())
    cpu64.double()
    for p in cpu64.parameters():
        p.requires_grad_(True)
    cpu64.loss({"tokens": tokens, "labels": tokens.roll(-1, 1),
                **{k: v.double() if v.is_floating_point() else v
                   for k, v in inputs.items()}}).backward()
    exact = {n: p.grad for n, p in cpu64.named_parameters()}
    for lm in (cpu, card):
        on = {k: v.to(lm.device) for k, v in inputs.items()}
        logits = lm.logits_causal(tokens.to(lm.device), **on).cpu()
        cache = lm.init_cache(2, 32, t_src=40)
        lg, cache = lm.prefill(tokens.to(lm.device), cache, **on)
        toks = [lg[:, 0].argmax(-1)]
        for t in range(2):
            lg, cache = lm.decode(toks[-1][:, None], cache,
                                  torch.tensor(24 + t))
            toks.append(lg[:, 0].argmax(-1))
        for p in lm.parameters():
            p.requires_grad_(True)
        lm.loss({"tokens": tokens.to(lm.device),
                 "labels": tokens.roll(-1, 1).to(lm.device), **on}).backward()
        grads = {n: p.grad.cpu() for n, p in lm.named_parameters()}
        outs.append((logits, torch.stack(toks, 1).cpu(), grads))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-4)
    assert torch.equal(outs[1][1], outs[0][1])
    for n, g in exact.items():
        top = max(g.abs().max().item(), 1e-30)
        far_cpu, far_card = ((o[2][n].double() - g).abs().max().item() / top
                             for o in outs)
        assert far_card <= max(1e-4, 2 * far_cpu), (n, far_card, far_cpu)


def test_flash_attention_lse_forward_equals_serving_forward(dev):
    """The training entry point writes the serving entry point's output
    bit for bit, and each row's log-sum-exp within 2e-5 of the plain one."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_lse_plain

    gen = torch.Generator().manual_seed(8)
    q = torch.randn(2, 77, 8, 32, generator=gen).to(dev)
    k = torch.randn(2, 77, 4, 32, generator=gen).to(dev)
    v = torch.randn(2, 77, 4, 32, generator=gen).to(dev)
    out, lse = flash_attention_cuda(q, k, v, cap=30.0, lse=True)
    assert torch.equal(out, flash_attention_cuda(q, k, v, cap=30.0))
    torch.testing.assert_close(
        lse, flash_attention_lse_plain(q, k, v, cap=30.0)[1], atol=2e-5,
        rtol=2e-5)


def test_ssd_on_inputs_that_require_grad_runs_the_backward(dev):
    """The public SSD op on CUDA inputs that require grad goes through
    ``SSDScanFn``: one forward and one backward launch a chunk batch, and
    every gradient (x, dt, A, B, C, D; two chunks of 64, 8 heads in 2
    groups) within 1e-4 of its largest magnitude of the repaired plain
    version's autograd on the CPU; a second run equal bit for bit."""
    from repro_torch.kernels.ssd_scan.ops import ssd

    gen = torch.Generator().manual_seed(16)
    b, l, h, p, g, n = 2, 128, 8, 32, 2, 16
    cpu = [torch.randn(b, l, h, p, generator=gen),
           torch.nn.functional.softplus(torch.randn(b, l, h, generator=gen)),
           -torch.rand(h, generator=gen) - 0.5,
           0.3 * torch.randn(b, l, g, n, generator=gen),
           0.3 * torch.randn(b, l, g, n, generator=gen),
           torch.ones(h) + 0.1 * torch.randn(h, generator=gen)]
    wy = torch.randn(b, l, h, p, generator=gen)
    ws = torch.randn(b, h, p, n, generator=gen)

    def grads(device):
        leaves = [t.to(device).requires_grad_(True) for t in cpu]
        y, s = ssd(*leaves, chunk=64)
        ((y * wy.to(device)).sum() + (s * ws.to(device)).sum()).backward()
        return [t.grad.cpu() for t in leaves]

    reset_launch_counts()
    got = grads(dev)
    counts = launch_counts()
    assert counts["ssd_scan_f32"] == 1 and counts["ssd_scan_bwd_f32"] == 1
    again = grads(dev)
    want = grads("cpu")
    for a, c, w in zip(got, again, want):
        assert torch.isfinite(a).all()
        assert torch.equal(a, c)
        err = (a - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), err


def _ssd_bwd_case(bc, h, g, q, p, n, splits=None):
    """A backward case; its id carries the split count it runs (the plan's,
    or ``splits`` forced) and whether one launch of clusters does the sums
    (``fused``) or a second launch."""
    from repro_torch.kernels.ssd_scan.kernel import bwd_plan

    plan = bwd_plan(bc, h, g, q, p, n, splits=splits)
    how = "fused" if plan["fused"] else "two"
    return pytest.param(
        bc, h, g, q, p, n, splits,
        id=f"BC{bc}-H{h}-G{g}-Q{q}-P{p}-N{n}-splits{plan['splits']}-{how}")


#: (BC, H, G, Q, P, N[, splits forced]): a chunk of 13 and a ragged one of
#: 129 (N off 4: 4-byte copies), one head a group, 24 heads in one group
#: (mamba2-130m's chunk, the plan's and 8 splits of 3 heads), groups the
#: split count does not divide, and in one launch of clusters: more sums
#: tasks than a cluster's blocks (N 256) and fewer (8 splits of one tile)
SSD_BWD_CASES = [_ssd_bwd_case(*c) for c in [
    (2, 4, 2, 13, 16, 8), (2, 8, 2, 129, 32, 22), (2, 6, 6, 64, 32, 16),
    (2, 24, 1, 256, 64, 128), (2, 24, 1, 256, 64, 128, 8),
    (2, 5, 1, 96, 32, 24, 2), (1, 24, 1, 256, 64, 128, 5),
    (2, 16, 2, 256, 128, 16, 3), (2, 8, 2, 129, 32, 22, 3),
    (2, 2, 2, 64, 16, 256), (1, 8, 1, 32, 16, 8, 8)]]


@pytest.mark.parametrize("bc,h,g,q,p,n,splits", SSD_BWD_CASES)
def test_ssd_scan_backward_kernel(dev, monkeypatch, bc, h, g, q, p, n,
                                  splits):
    """``ssd_scan`` on CUDA inputs that require grad: one forward and one
    backward launch; every gradient within 1e-4 of its largest magnitude
    (at least 1) of the plain version's autograd on the card (fp32 sums in
    another order, ``chip_smoke.TOL``); a second backward equal bit for
    bit; the plan's shared memory the library's."""
    import ctypes

    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.ssd_scan import kernel as kmod
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    if splits is not None:
        real = kmod.bwd_plan
        monkeypatch.setattr(kmod, "bwd_plan", lambda *a, **kw: real(
            *a, **{**kw, "splits": splits}))
    plan = kmod.bwd_plan(bc, h, g, q, p, n)
    fn = load_library("ssd_scan_bwd").ssd_scan_bwd_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    assert fn(p, n, plan["hs"]) == plan["smem"]
    gen = torch.Generator().manual_seed(q + n)
    dt = torch.nn.functional.softplus(torch.randn(bc, h, 1, q, generator=gen))
    a = -0.05 * torch.exp(0.2 * torch.randn(h, generator=gen))
    cs = torch.cumsum(dt * a[None, :, None, None], dim=-1)
    args = [t.to(dev) for t in (
        torch.randn(bc, h, q, p, generator=gen),
        0.3 * torch.randn(bc, g, q, n, generator=gen),
        0.3 * torch.randn(bc, g, q, n, generator=gen), cs, dt)]
    dy = torch.randn(bc, h, q, p, generator=gen).to(dev)
    ds = torch.randn(bc, h, n, p, generator=gen).to(dev)
    grads = []
    for fn_ in (ssd_scan, ssd_scan_ref, ssd_scan):
        leaves = [t.clone().requires_grad_(True) for t in args]
        reset_launch_counts()
        y, s = fn_(*leaves)
        torch.autograd.backward((y, s), (dy, ds))
        torch.cuda.synchronize()
        counts = launch_counts()
        if fn_ is ssd_scan:
            assert counts["ssd_scan_f32"] == 1
            assert counts["ssd_scan_bwd_f32"] == 1
        else:
            assert not any(counts.values())
        grads.append([t.grad for t in leaves])
    for got, want in zip(grads[0], grads[1]):
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * max(want.abs().max().item(), 1.0), err
    for a_, c in zip(grads[0], grads[2]):
        assert torch.equal(a_, c)


def test_stream_mllm_gradients_card_equals_cpu(dev):
    """The small stream MLLM's loss and gradients on a booth batch, on
    the card (the flash kernels), on the card with the plain attention
    (the witness) and on the CPU, same weights: the loss within 1e-4
    relative; each gradient leaf within 1e-4 of its largest |g| of the
    CPU's, or no farther than twice the witness (fp32 sums in other
    orders move gradients further than logits; ``chip_smoke.py`` phase
    18 (c) holds the big MLLM the same way)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    # fp32 throughout: cuDNN runs fp32 convolutions in TF32 by default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        _stream_mllm_card_vs_cpu(dev)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _stream_mllm_card_vs_cpu(dev):
    from repro_torch.configs.samsara_stream import STREAM_MLLM_SMALL_CONFIG
    from repro_torch.data import TollBoothStream
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    from repro_torch.models import attention
    from repro_torch.streaming.mllm import StreamMLLM
    from repro_torch.streaming.pretrain import (CROP, encode_tollbooth_labels,
                                                preprocess_np)

    frames, labels = TollBoothStream(seed=4).booth_batch(4)
    batch = {"frames": preprocess_np(frames, CROP, 2),
             **encode_tollbooth_labels(labels)}
    cpu = StreamMLLM(STREAM_MLLM_SMALL_CONFIG, patch=16, device="cpu").init(
        torch.Generator().manual_seed(1))
    card = StreamMLLM(STREAM_MLLM_SMALL_CONFIG, patch=16, device=dev)
    card.load_state_dict(cpu.state_dict())
    results = []
    for model, plain in ((cpu, False), (card, False), (card, True)):
        for p in model.parameters():
            p.requires_grad_(True)
            p.grad = None
        kernel = attention.flash_attention
        if plain:
            attention.flash_attention = flash_attention_plain
        try:
            loss = model.loss({k: torch.from_numpy(v)
                               for k, v in batch.items()})
            loss.backward()
        finally:
            attention.flash_attention = kernel
        results.append((loss.item(), {n: p.grad.cpu() for n, p in
                                      model.named_parameters()
                                      if p.grad is not None}))
    (loss_c, g_c), (loss_k, g_k), (_, g_p) = results
    assert abs(loss_k - loss_c) <= 1e-4 * abs(loss_c)
    assert g_c.keys() == g_k.keys() == g_p.keys()
    for n, g in g_c.items():
        scale = g.abs().max().item()
        err = (g_k[n] - g).abs().max().item()
        witness = (g_p[n] - g).abs().max().item()
        assert err <= max(1e-4 * scale, 2 * witness), (n, err, witness)


# ---------------------------------------------------------------------------
# bf16: flash_attention_bf16 and decode_attention_bf16 against their plain
# versions (fp32 inside, the output rounded to bf16 once) at the reference
# sweep's bf16 tolerances, 2e-2 and 3e-2
# ---------------------------------------------------------------------------

BF16_FLASH = [(b, s, g * hk, hk, d, kw)
              for d in (16, 32, 64, 96, 128, 256)
              for b, s, g, hk in ((2, 33, 1, 2), (1, 257, 16, 2),
                                  (1, 70, 64, 1), (2, 100, 2, 4))
              for kw in (dict(causal=True), dict(causal=False),
                         dict(causal=True, cap=20.0),
                         dict(causal=True, window=7))
              if not (g == 64 and d == 256 and kw.get("window"))]


def _bf16(gen, *shape):
    return torch.randn(shape, generator=gen).to(torch.bfloat16)


@pytest.mark.parametrize("b,s,h,hk,d,kw", BF16_FLASH)
def test_flash_attention_bf16_kernel(dev, b, s, h, hk, d, kw):
    gen = torch.Generator().manual_seed(21)
    q, k, v = _bf16(gen, b, s, h, d), _bf16(gen, b, s, hk, d), \
        _bf16(gen, b, s, hk, d)
    reset_launch_counts()
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev), **kw).cpu()
    assert got.dtype == torch.bfloat16
    assert launch_counts() == _counts(flash_attention_bf16=1)
    torch.testing.assert_close(got.float(),
                               flash_attention(q, k, v, **kw).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,sq,sk,h,hk,d,kw", [
    (4, 16, 1024, 16, 16, 64, {}), (2, 45, 130, 8, 4, 32, {}),
    (2, 33, 257, 4, 2, 128, dict(cap=20.0)), (2, 200, 77, 8, 8, 64, {})])
def test_flash_attention_bf16_cross_kernel(dev, b, sq, sk, h, hk, d, kw):
    gen = torch.Generator().manual_seed(22)
    q, k, v = _bf16(gen, b, sq, h, d), _bf16(gen, b, sk, hk, d), \
        _bf16(gen, b, sk, hk, d)
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=False,
                          **kw).cpu()
    torch.testing.assert_close(
        got.float(), flash_attention(q, k, v, causal=False, **kw).float(),
        atol=2e-2, rtol=2e-2)


#: the edges of the bf16 kernel's tiles (64-row warpgroups, 128-key tiles,
#: 64 at D 256): lengths about them at groups 4 and 8, and windows one key
#: either side of a tile at S 1000
BF16_FLASH_EDGES = [(1, s, g * 2, 2, d, dict(causal=True))
                    for d in (16, 32, 64, 96, 128, 256) for g in (4, 8)
                    for s in (63, 64, 65, 127, 128, 129)] + [
    (1, 1000, 2 * g, 2, d, dict(causal=True, window=w))
    for d in (64, 96, 128, 256) for g in (1, 4)
    for w in ((63, 65) if d == 256 else (127, 129))] + [
    (1, s, 2 * g, 2, d, kw)
    for d in (16, 32, 64, 96, 128, 256) for g in (3, 6) for s in (65, 257)
    for kw in (dict(causal=True), dict(causal=True, window=7))]


@pytest.mark.parametrize("b,s,h,hk,d,kw", BF16_FLASH_EDGES)
def test_flash_attention_bf16_tile_edges(dev, b, s, h, hk, d, kw):
    """One launch of flash_attention_bf16 a call, within 2e-2 of the plain
    version, and a second launch equal to the first bit for bit."""
    gen = torch.Generator().manual_seed(27)
    q, k, v = _bf16(gen, b, s, h, d), _bf16(gen, b, s, hk, d), \
        _bf16(gen, b, s, hk, d)
    qd, kd, vd = q.to(dev), k.to(dev), v.to(dev)
    reset_launch_counts()
    got = flash_attention(qd, kd, vd, **kw)
    assert launch_counts() == _counts(flash_attention_bf16=1)
    assert torch.equal(got, flash_attention(qd, kd, vd, **kw))
    torch.testing.assert_close(got.cpu().float(),
                               flash_attention(q, k, v, **kw).float(),
                               atol=2e-2, rtol=2e-2)


def test_flash_attention_bf16_refuses_unaligned(dev):
    """TMA reads from 16-byte aligned bases: a bf16 q, k or v that starts
    2 bytes in raises, with no launch, no copy and no other kernel."""
    gen = torch.Generator().manual_seed(28)
    q, k, v = (_bf16(gen, 1, 9, 4, 32).to(dev) for _ in range(3))
    for i in range(3):
        args = [q, k, v]
        raw = torch.empty(args[i].numel() + 1, dtype=torch.bfloat16,
                          device=dev)
        args[i] = raw[1:].view(args[i].shape)
        args[i].copy_((q, k, v)[i])
        reset_launch_counts()
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_cuda(*args)
        assert not any(launch_counts().values())


def test_flash_attention_bf16_refuses_grad_and_lse(dev):
    """bf16 inputs that require grad take the bf16 training pair (one
    launch of ``flash_attention_lse_bf16`` and, at the backward, one of
    ``flash_attention_bwd_bf16``; none of the serving forward); q, k and v
    of two dtypes are refused before any launch, and the bf16 backward
    refuses an lse that is not fp32."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bwd_cuda

    gen = torch.Generator().manual_seed(23)
    q, k, v = (_bf16(gen, 1, 9, 4, 32).to(dev) for _ in range(3))
    q.requires_grad_(True)
    reset_launch_counts()
    with pytest.raises(ValueError, match="one of"):
        flash_attention(q, k.float(), v)
    assert not any(launch_counts().values())
    out = flash_attention(q, k, v)
    assert launch_counts() == _counts(flash_attention_lse_bf16=1)
    out.backward(torch.ones_like(out))
    assert launch_counts() == _counts(flash_attention_lse_bf16=1,
                                      flash_attention_bwd_bf16=1)
    assert q.grad.dtype == torch.bfloat16
    with torch.no_grad():
        o, lse = flash_attention_cuda(q, k, v, lse=True)
        with pytest.raises(ValueError, match="fp32 lse"):
            flash_attention_bwd_cuda(q, k, v, o, lse.bfloat16(), o)


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(x, 1e-30))) - 7)


#: the bf16 backward's cases (B, Sq, Sk, H, Hk, D, options): every head
#: dim, groups 1-64, causal and not, cap, window, ragged lengths about the
#: 64-row tiles (32 streamed rows at D 256), Sq != Sk, and the split plans
BWD_BF16_CASES = [
    pytest.param(*c, id="-".join(str(x) for x in c[:6]) + "-" +
                 "-".join(f"{a}{b}" for a, b in c[6].items()))
    for c in [
        (8, 64, 64, 32, 2, 128, dict(causal=True)),
        (1, 300, 300, 8, 4, 256, dict(causal=True, cap=50.0, window=100)),
        (2, 129, 129, 32, 32, 96, dict(causal=True)),
        (2, 65, 65, 16, 16, 128, dict(causal=True)),
        (2, 128, 512, 16, 16, 64, dict(causal=False)),
        (2, 45, 130, 8, 4, 32, dict(causal=False)),
        (1, 33, 33, 64, 1, 16, dict(causal=True)),
        (1, 130, 130, 64, 1, 64, dict(causal=True)),
        (2, 45, 45, 4, 2, 96, dict(causal=True, cap=20.0)),
        (2, 63, 63, 4, 2, 256, dict(causal=True, window=7)),
        (1, 1, 1, 2, 1, 32, dict(causal=True)),
        (32, 64, 64, 14, 2, 128, dict(causal=True)),
        (2, 200, 77, 8, 8, 64, dict(causal=False))]]


@pytest.mark.parametrize("b,sq,sk,h,hk,d,kw", BWD_BF16_CASES)
def test_flash_attention_bwd_bf16_kernel(dev, b, sq, sk, h, hk, d, kw):
    """bf16 inputs that require grad: one launch of the lse forward and
    one of the backward.  The output equals the serving kernel's bit for
    bit and lse is within 2e-5 max(1, |lse|) of the plain one; dq, dk, dv
    (bf16) within 3e-2 (absolute and relative, the reference sweep's bf16
    tolerance) of the plain version's autograd on the same bf16 inputs
    and, against float64 on those inputs, within twice that autograd's
    distance plus one bf16 ulp of the gradient's largest magnitude (plus
    1e-6 of the case's largest gradient); a second backward equal bit for
    bit."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_lse_plain, flash_attention_plain)

    gen = torch.Generator().manual_seed(sq + sk + d)
    q, k, v = _bf16(gen, b, sq, h, d), _bf16(gen, b, sk, hk, d), \
        _bf16(gen, b, sk, hk, d)
    dout = _bf16(gen, b, sq, h, d)
    qd, kd, vd, gd = (t.to(dev) for t in (q, k, v, dout))
    runs = []
    for fn, dt in ((flash_attention, None), (flash_attention_plain, None),
                   (flash_attention_plain, torch.float64),
                   (flash_attention, None)):
        leaves = [(t if dt is None else t.to(dt)).clone().requires_grad_(True)
                  for t in (qd, kd, vd)]
        reset_launch_counts()
        out = fn(*leaves, **kw)
        out.backward(gd.to(out.dtype))
        torch.cuda.synchronize()
        if fn is flash_attention:
            assert launch_counts() == _counts(flash_attention_lse_bf16=1,
                                              flash_attention_bwd_bf16=1)
        runs.append([out.detach()] + [t.grad for t in leaves])
    kern, plain, f64, again = runs
    with torch.no_grad():
        assert torch.equal(kern[0], flash_attention_cuda(qd, kd, vd, **kw))
        _, lse = flash_attention_cuda(qd, kd, vd, lse=True, **kw)
        lse_p = flash_attention_lse_plain(qd, kd, vd, **kw)[1]
    assert ((lse - lse_p).abs() / lse_p.abs().clamp(min=1.0)).max() <= 2e-5
    # a floor of 1e-6 of the case's largest gradient (chip_smoke.BWD_FLOOR):
    # at S 1 the exact dq and dk are 0 (dP - delta cancels)
    floor = 1e-6 * max(f64[n].abs().max().item() for n in (1, 2, 3))
    for n in (1, 2, 3):
        g, gp, g64 = kern[n].double(), plain[n].double(), f64[n]
        assert kern[n].dtype == torch.bfloat16
        torch.testing.assert_close(g, gp, atol=3e-2, rtol=3e-2)
        top = g64.abs().max().item()
        bar = 2 * (gp - g64).abs().max().item() + _bf16_ulp(top) + floor
        assert (g - g64).abs().max().item() <= bar, n
        assert torch.equal(kern[n], again[n])


@pytest.mark.parametrize("b,s,h,hk,d,lens,kw", [
    (4, 8192, 8, 4, 256, [7, 23, 30, 4206], dict(cap=50.0, window=4096)),
    (4, 8192, 8, 4, 256, [7, 23, 30, 4206], dict(cap=50.0)),
    (4, 8192, 32, 2, 128, [7, 23, 30, 4206], {}),
    (4, 8192, 32, 2, 128, [6, 14, 23, 35], {}),
    (4, 8192, 32, 32, 96, [7, 23, 30, 4206], {}),
    (4, 1024, 16, 16, 64, [1024] * 4, {}),
    (2, 64, 4, 2, 32, [1, 1], {}),
    (2, 64, 4, 4, 32, [17, 3], dict(cap=20.0)),
    (3, 300, 8, 2, 64, [1, 9, 300], dict(window=8)),
    (2, 1000, 8, 8, 16, [999, 161], dict(window=517)),
    (2, 100, 6, 2, 64, [100, 37], {}),
    (1, 300, 32, 2, 256, [300], dict(cap=50.0)),
    (40, 700, 32, 32, 64, [1 + (37 * i) % 700 for i in range(40)], {}),
    # moonshot-v1-16b-a3b's decode shape (16 kv heads of 128, G 1)
    (4, 8192, 16, 16, 128, [7, 23, 30, 4206], {}),
    (4, 8192, 16, 16, 128, [6, 14, 23, 35], {}),
    # one key either side of a stage (64 keys): one split, 1-2 stages
    (4, 256, 32, 2, 128, [63, 64, 65, 129], {}),
    (4, 256, 8, 8, 96, [63, 64, 65, 127], {}),
    # G 3, G 16 at D 256 beside short slots, G 1 at D 96
    (4, 4096, 6, 2, 128, [7, 23, 30, 4000], {}),
    (4, 2048, 32, 2, 256, [7, 23, 30, 2000], dict(cap=50.0)),
    (2, 2048, 4, 4, 96, [1, 2047], {}),
    # a window shorter than one split, at a long slot
    (4, 8192, 32, 2, 128, [7, 23, 30, 4206], dict(window=40)),
    (4, 8192, 8, 4, 256, [7, 23, 30, 4206], dict(cap=50.0, window=100))])
def test_decode_attention_bf16_kernel(dev, b, s, h, hk, d, lens, kw):
    """As the fp32 kernel's test, on bf16: NaN keys past kv_len never read,
    one launch of decode_attention_bf16."""
    gen = torch.Generator().manual_seed(24)
    q = _bf16(gen, b, 1, h, d)
    k, v = _bf16(gen, b, s, hk, d), _bf16(gen, b, s, hk, d)
    kv_len = torch.tensor(lens, dtype=torch.int32)[:, None]
    want = decode_attention(q, k, v, kv_len, **kw)
    for i, n in enumerate(lens):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    reset_launch_counts()
    got = decode_attention_cuda(q.to(dev), k.to(dev), v.to(dev),
                                kv_len.to(dev), **kw).cpu()
    assert got.dtype == torch.bfloat16
    assert launch_counts() == _counts(decode_attention_bf16=1)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                               rtol=3e-2)


def _bf16_long_plan(dev, b, s, h, hk, d, lens, kw):
    """The bf16 kernel's plan of the last sequence, as the wrapper makes it
    on this card: (cluster size, (clusters, keys a split, splits))."""
    nb = dk.bf16_blocks(b, hk, s, kw.get("window"),
                        *dk._occupancy_bf16(dev, d, h // hk))
    c, ncl = dk.bf16_grid(b, nb)
    return c, dk.bf16_plan(lens, ncl, c)[-1]


#: the served long ticks' shapes (B4 S8192): chatglm3-6b, gemma2-2b's
#: local layer, phi3-mini, moonshot-v1-16b-a3b
BF16_TICKS = {"chatglm3": (32, 2, 128, {}),
              "gemma2": (8, 4, 256, dict(cap=50.0, window=4096)),
              "phi3": (32, 32, 96, {}), "moonshot": (16, 16, 128, {})}


@pytest.mark.parametrize("model", sorted(BF16_TICKS))
@pytest.mark.parametrize("edge", ["split", "stage"])
def test_decode_attention_bf16_split_edges(dev, model, edge):
    """The long slot's length one key either side of a split boundary
    (its length 1 past and 1 short of a multiple of its split), or of a
    stage boundary inside its last split (that split's length 1 past and
    1 short of a multiple of a stage's keys), as this card's plan cuts
    it: within 3e-2 of the plain version, one launch, two launches equal
    bit for bit.  At chatglm3's shape the last cluster is partly empty."""
    h, hk, d, kw = BF16_TICKS[model]
    found = []
    for n_long in range(3500, 4700):
        lens = [7, 23, 30, n_long]
        c, (n, chunk, used) = _bf16_long_plan(dev, 4, 8192, h, hk, d, lens,
                                              kw)
        live = min(n_long, kw.get("window") or n_long)
        rest = live - (used - 1) * chunk      # the last split's keys
        if edge == "split":
            hit, key = rest in (1, chunk - 1), rest
        else:
            st = dk.BF16_STAGE
            key = rest % st
            hit = key in (1, st - 1) and (chunk == st or 1 < rest < chunk - 1)
        # chatglm3's: lengths whose last cluster is partly empty
        hit = hit and (model != "chatglm3" or used % c != 0)
        if hit and key not in [f[1] for f in found]:
            found.append((n_long, key))
        if len(found) == 2:
            break
    assert len(found) == 2, (model, edge, found)
    gen = torch.Generator().manual_seed(29)
    for n_long, _ in found:
        lens = [7, 23, 30, n_long]
        q = _bf16(gen, 4, 1, h, d)
        k, v = _bf16(gen, 4, 8192, hk, d), _bf16(gen, 4, 8192, hk, d)
        kv_len = torch.tensor(lens, dtype=torch.int32)[:, None]
        want = decode_attention(q, k, v, kv_len, **kw)
        for i, n_ in enumerate(lens):
            k[i, n_:] = float("nan")
            v[i, n_:] = float("nan")
        args = (q.to(dev), k.to(dev), v.to(dev), kv_len.to(dev))
        reset_launch_counts()
        got = decode_attention_cuda(*args, **kw)
        assert launch_counts() == _counts(decode_attention_bf16=1)
        assert torch.equal(got, decode_attention_cuda(*args, **kw))
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=3e-2, rtol=3e-2)
