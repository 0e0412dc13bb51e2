"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (the check runs inside the test, never at import).  This file imports
no JAX, so it also runs on a GPU host without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.frame_diff.kernel import frame_diff_cuda  # noqa: E402
from repro_torch.kernels.frame_diff.ref import frame_diff_ref  # noqa: E402
from repro_torch.kernels.fused_preprocess.kernel import fused_preprocess_cuda  # noqa: E402
from repro_torch.kernels.fused_preprocess.ref import fused_preprocess_ref  # noqa: E402
from repro_torch.kernels.fused_prefix.kernel import (fused_prefix_cuda,  # noqa: E402
                                                     out_frame_shape)
from repro_torch.kernels.fused_prefix.ref import fused_prefix_ref  # noqa: E402
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
    ((3, 3, 30, 50), (3, 5))])
def test_frame_diff_kernel(dev, shape, regions):
    g = torch.Generator().manual_seed(0)
    a, b = _frames(g, shape), _frames(g, shape)
    got = frame_diff_cuda(a.to(dev), b.to(dev), regions=regions).cpu()
    torch.testing.assert_close(got, frame_diff_ref(a, b, regions=regions),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("crop,factor,grey", [
    ((64, 0, 64, 256), 2, False), ((33, 17, 30, 98), 2, True),
    ((5, 7, 96, 60), 3, False)])
def test_fused_preprocess_kernel(dev, crop, factor, grey):
    x = _frames(torch.Generator().manual_seed(1), (4, 3, 128, 256))
    got = fused_preprocess_cuda(x.to(dev), crop=crop, factor=factor,
                                grey=grey).cpu()
    want = fused_preprocess_ref(x, crop=crop, factor=factor, grey=grey)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


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


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_fused_prefix_kernel(dev, case, dtype):
    spec = PREFIX_CASES[case]
    b = 16 if case == "path" else 4
    g = torch.Generator().manual_seed(3)
    f = _frames(g, (b, 3, 128, 256)).to(dtype)
    p = _frames(g, (b, 3, 128, 256)).to(dtype)
    gy, gx, _, proj = signature_layout(out_frame_shape(spec,
                                                       (3, 128, 256)))
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
    (2, 300, 32, 32, 96, [1, 299], {})])
def test_decode_attention_kernel(dev, b, s, h, hk, d, lens, kw):
    """The kernel against its plain version; keys at or past kv_len are
    NaN in the cache and must never be read."""
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
    counts = launch_counts()
    assert counts["decode_attention_partials_f32"] == 1
    assert counts["decode_attention_combine_f32"] == 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bc,h,g,q,p,n", [
    (2, 24, 1, 256, 64, 128), (1, 24, 1, 13, 64, 128),   # mamba2-130m
    (4, 8, 4, 64, 16, 8), (2, 4, 2, 32, 16, 8)])          # reference sweep
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
    counts = launch_counts()
    assert counts["ssd_cb_f32"] == 1 and counts["ssd_scan_f32"] == 1
    for a_, b_ in zip(got, want):
        torch.testing.assert_close(a_.cpu(), b_, atol=1e-4, rtol=1e-4)


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
    counts = {name: 0 for name in launch_counts()}
    counts.update(int8_transpose_kn=1, int8_mma_f32=1)
    return counts


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
                                  "glm4-9b", "phi3-mini-3.8b"])
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
