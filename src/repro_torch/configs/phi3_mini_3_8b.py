"""phi3-mini-3.8b — dense decoder, MHA (kv=32), SwiGLU.

[arXiv:2404.14219; unverified]
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.common.config import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    d_ff=8192,
    vocab_size=32064,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=96),
    block_pattern=("attn+dense",),
    grad_accum=2,
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        block_pattern=("attn+dense",),
        remat=False,
    )
