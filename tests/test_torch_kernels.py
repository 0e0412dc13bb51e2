"""The port's kernels (plain PyTorch versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode and its jnp oracles.

Inputs are made with numpy from a seed and handed to both packages.  fp32
tolerance 2e-5: the two packages sum in different orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_kernel  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.frame_diff.ops import frame_diff as jax_frame_diff  # noqa: E402
from repro.kernels.frame_diff.ref import frame_diff_ref as jax_frame_diff_ref  # noqa: E402
from repro.kernels.fused_preprocess.ops import fused_preprocess as jax_prep  # noqa: E402
from repro.kernels.fused_preprocess.ref import fused_preprocess_ref as jax_prep_ref  # noqa: E402
from repro.models.attention import full_attention  # noqa: E402

from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.kernels._build import require_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.frame_diff.kernel import frame_diff_cuda  # noqa: E402
from repro_torch.kernels.frame_diff.ops import frame_diff  # noqa: E402
from repro_torch.kernels.fused_preprocess.kernel import fused_preprocess_cuda  # noqa: E402
from repro_torch.kernels.fused_preprocess.ops import fused_preprocess  # noqa: E402
from repro_torch.kernels.fused_prefix.kernel import fused_prefix_cuda  # noqa: E402
from repro_torch.kernels.fused_prefix.ops import fused_prefix  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_cuda  # noqa: E402
from repro_torch.kernels.int8_matmul.ops import matmul_int8_dynamic  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd  # noqa: E402

TOL = 2e-5
# one compiled program per shape is cheaper than op-by-op eager dispatch
jax_flash_ref = jax.jit(jax_flash_ref,
                        static_argnames=("causal", "cap", "window"))
full_attention = jax.jit(full_attention, static_argnames=("causal", "cap"))


def randn(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def frames(seed, shape=(2, 3, 128, 256)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _mode(mode, s):
    if mode == "softcap":
        return dict(causal=True, cap=20.0)
    if mode == "window":
        return dict(causal=True, window=s // 4)
    if mode == "bidir":
        return dict(causal=False)
    return dict(causal=True)


@pytest.mark.parametrize("b,hk,g,s,d", [
    (1, 1, 1, 64, 32),
    (2, 2, 2, 128, 32),
    (1, 2, 4, 256, 64),
])
@pytest.mark.parametrize("mode", ["causal", "softcap", "window", "bidir"])
def test_flash_attention_sweep(b, hk, g, s, d, mode):
    q, k, v = (randn(0, (b, hk, g, s, d)), randn(1, (b, hk, s, d)),
               randn(2, (b, hk, s, d)))
    kw = _mode(mode, s)
    port = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw).numpy()
    pallas = flash_attention_kernel(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), bq=32, bk=32,
                                    interpret=True, **kw)
    close(port, pallas)
    close(port, jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw))


@pytest.mark.parametrize("b,s,h,hk", [
    (2, 140, 8, 4),     # big MLLM, full frame
    (2, 76, 8, 4),      # big MLLM, road crop
    (3, 28, 8, 4),      # big MLLM, road crop / 2
    (2, 140, 4, 4),     # small MLLM (G = 1)
    (1, 1, 2, 1),
    (1, 257, 4, 2),
])
@pytest.mark.parametrize("mode", ["causal", "window"])
def test_flash_attention_ragged_model_layout(b, s, h, hk, mode):
    """Any S, model layout (B, S, H, D), GQA over consecutive heads: the
    port's op against the reference's oracle (the Pallas kernel needs S to
    divide by its tile) and, causal, against ``full_attention``."""
    d = 32
    q, k, v = randn(3, (b, s, h, d)), randn(4, (b, s, hk, d)), \
        randn(5, (b, s, hk, d))
    kw = _mode(mode, s)
    if mode == "window":
        kw["window"] = max(1, s // 4)
    port = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **kw).numpy()
    g = h // hk
    ref = jax_flash_ref(
        jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b, hk, g, s, d),
        jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), **kw)
    close(port, np.asarray(ref).reshape(b, h, s, d).transpose(0, 2, 1, 3))
    if mode == "causal":
        close(port, full_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True))


@pytest.mark.parametrize("h,hk,d", [(32, 2, 128), (8, 8, 96)])
def test_flash_attention_dense_zoo_heads(h, hk, d):
    """chatglm3 / glm4's grouping (32 query heads over 2 kv heads, head
    dim 128) and phi3-mini's head dim 96, at a ragged S: the port's op
    against the reference's oracle."""
    b, s = 1, 37
    q, k, v = randn(15, (b, s, h, d)), randn(16, (b, s, hk, d)), \
        randn(17, (b, s, hk, d))
    port = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v)).numpy()
    ref = jax_flash_ref(
        jnp.asarray(q).transpose(0, 2, 1, 3).reshape(b, hk, h // hk, s, d),
        jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), causal=True)
    close(port, np.asarray(ref).reshape(b, h, s, d).transpose(0, 2, 1, 3))


def test_flash_attention_model_layout_vs_pallas():
    b, s, h, hk, d = 2, 128, 8, 2, 32
    q, k, v = randn(0, (b, s, h, d)), randn(1, (b, s, hk, d)), \
        randn(2, (b, s, hk, d))
    port = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True).numpy()
    close(port, jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, interpret=True))


# ---------------------------------------------------------------------------
# fused preprocess / frame diff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("crop,factor,grey", [
    ((0, 0, 128, 256), 1, False),
    ((0, 0, 128, 256), 2, False),
    ((32, 128, 64, 128), 2, True),
    ((96, 0, 32, 256), 4, False),
    ((64, 0, 64, 256), 2, False),       # the reduced Q8 plan's crop
    ((96, 0, 32, 256), 2, False),       # the optimized Q8 plan's crop
])
def test_fused_preprocess_sweep(crop, factor, grey):
    f = frames(2)
    port = fused_preprocess(torch.from_numpy(f), crop=crop, factor=factor,
                            grey=grey).numpy()
    pallas = jax_prep(jnp.asarray(f), crop=crop, factor=factor, grey=grey,
                      interpret=True)
    assert port.shape == pallas.shape
    close(port, pallas)
    close(port, jax_prep_ref(jnp.asarray(f), crop=crop, factor=factor,
                             grey=grey))


@pytest.mark.parametrize("crop,factor,grey", [
    ((33, 17, 30, 98), 2, True),
    ((1, 3, 63, 125), 1, False),
    ((5, 7, 96, 60), 3, False),
])
def test_fused_preprocess_odd_crops(crop, factor, grey):
    """Crops the Pallas kernel's tiling refuses; the port takes every crop
    the oracle takes."""
    f = frames(3)
    port = fused_preprocess(torch.from_numpy(f), crop=crop, factor=factor,
                            grey=grey).numpy()
    close(port, jax_prep_ref(jnp.asarray(f), crop=crop, factor=factor,
                             grey=grey))


@pytest.mark.parametrize("regions", [(1, 1), (4, 4), (4, 8)])
def test_frame_diff_sweep(regions):
    f, p = frames(2), frames(3)
    port = frame_diff(torch.from_numpy(f), torch.from_numpy(p),
                      regions=regions).numpy()
    close(port, jax_frame_diff(jnp.asarray(f), jnp.asarray(p),
                               regions=regions, interpret=True))
    close(port, jax_frame_diff_ref(jnp.asarray(f), jnp.asarray(p),
                                   regions=regions))
    z = frame_diff(torch.from_numpy(f), torch.from_numpy(f),
                   regions=regions).numpy()
    np.testing.assert_allclose(z, np.zeros_like(z), atol=1e-7)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_launching():
    before = launch_counts()
    f = torch.from_numpy(frames(4))
    frame_diff(f, f, regions=(4, 8))
    fused_preprocess(f, crop=(64, 0, 64, 256), factor=2)
    q = torch.from_numpy(randn(6, (1, 28, 8, 32)))
    k = torch.from_numpy(randn(7, (1, 28, 4, 32)))
    flash_attention(q, k, k)
    flash_attention(q.clone().requires_grad_(True), k, k).sum().backward()
    fused_prefix(f, f, spec=(("diff", (4, 8)), ("crop", (0, 0, 64, 64))))
    decode_attention(q[:, :1], k, k, torch.tensor([[28]], dtype=torch.int32))
    x = torch.from_numpy(randn(10, (1, 16, 2, 8)))
    ssd(x, torch.ones(1, 16, 2), -torch.ones(2), x[:, :, :1], x[:, :, :1],
        torch.ones(2), chunk=16)
    ssd(x.clone().requires_grad_(True), torch.ones(1, 16, 2), -torch.ones(2),
        x[:, :, :1], x[:, :, :1], torch.ones(2), chunk=16)[0].sum().backward()
    matmul_int8_dynamic(q[0, :, 0], torch.ones(32, 8, dtype=torch.int8),
                        torch.ones(1, 8))
    qb, kb = q.to(torch.bfloat16), k.to(torch.bfloat16)
    flash_attention(qb, kb, kb)
    flash_attention(qb.clone().requires_grad_(True), kb,
                    kb).float().sum().backward()
    decode_attention(qb[:, :1], kb, kb, torch.tensor([[28]],
                                                     dtype=torch.int32))
    assert launch_counts() == before
    assert set(before) == {"frame_diff_u8", "fused_preprocess_u8",
                           "flash_attention_f32", "flash_attention_lse_f32",
                           "flash_attention_bwd_f32", "fused_prefix_launch",
                           "decode_attention_f32", "ssd_scan_f32",
                           "ssd_scan_bwd_f32", "int8_transpose_kn",
                           "int8_mma_f32", "flash_attention_bf16",
                           "decode_attention_bf16", "flash_attention_lse_bf16",
                           "flash_attention_bwd_bf16"}


@pytest.mark.parametrize("call", ["frame_diff", "fused_preprocess", "flash",
                                  "fused_prefix", "decode_attention",
                                  "ssd_scan", "int8_matmul",
                                  "int8_matmul_mma"])
def test_kernel_path_refuses_cpu_tensors(call):
    """The CUDA entry points raise on anything but CUDA tensors: there is no
    fallback from the kernel to the plain version."""
    f = torch.from_numpy(frames(5))
    q = torch.from_numpy(randn(8, (1, 28, 8, 32)))
    k = torch.from_numpy(randn(9, (1, 28, 4, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        if call == "frame_diff":
            frame_diff_cuda(f, f, regions=(4, 8))
        elif call == "fused_preprocess":
            fused_preprocess_cuda(f, crop=(64, 0, 64, 256), factor=2)
        elif call == "fused_prefix":
            fused_prefix_cuda(f, f, spec=(("diff", (4, 8)),))
        elif call == "decode_attention":
            decode_attention_cuda(q[:, :1], k, k,
                                  torch.tensor([[28]], dtype=torch.int32))
        elif call.startswith("int8"):
            m = 4 if call == "int8_matmul" else 64   # a decode tick, a prefill
            int8_matmul_cuda(torch.ones(m, 32, dtype=torch.int8),
                             torch.ones(32, 8, dtype=torch.int8),
                             torch.ones(m, 1), torch.ones(1, 8))
        elif call == "ssd_scan":
            x = torch.from_numpy(randn(10, (1, 2, 16, 8)))
            c = x[:, :1, :, :1].contiguous()
            ssd_scan_cuda(x, x[:, :1], x[:, :1], c.transpose(2, 3),
                          c.transpose(2, 3))
        else:
            flash_attention_cuda(q, k, k)


@pytest.mark.parametrize("name", ["frame_diff", "fused_preprocess",
                                  "flash_attention", "fused_prefix",
                                  "decode_attention", "ssd_scan",
                                  "int8_matmul"])
def test_require_cuda_refuses_inputs_that_require_grad(name):
    """A kernel has no backward: with grad mode on, an input that requires
    grad is refused before anything else is checked, naming the kernel.
    Under no_grad the grad check passes and the device check speaks (these
    tensors lie on the CPU)."""
    x = torch.ones(4, 4, requires_grad=True)
    y = torch.ones(4, 4)
    with pytest.raises(ValueError, match=f"{name}: an input requires grad"):
        require_cuda(name, y, x)
    with torch.no_grad():
        with pytest.raises(ValueError, match="one CUDA device"):
            require_cuda(name, y, x)
    with pytest.raises(ValueError, match="one CUDA device"):
        require_cuda(name, y, x.detach())
