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
