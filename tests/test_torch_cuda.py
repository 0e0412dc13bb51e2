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
