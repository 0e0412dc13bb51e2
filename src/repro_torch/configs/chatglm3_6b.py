"""chatglm3-6b — dense decoder, 2D/partial RoPE, extreme GQA (kv=2).

[arXiv:2406.12793; hf]
28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
ChatGLM's 2D rotary is realized as partial rotary (rotary_pct=0.5).
"""
from repro_torch.common.config import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    d_ff=13696,
    vocab_size=65024,
    attention=AttentionConfig(n_heads=32, n_kv_heads=2, head_dim=128,
                              rotary_pct=0.5),
    block_pattern=("attn+dense",),
    grad_accum=2,
    notes="32 query heads over 2 kv heads: a group of 16 in the kernels.",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        d_ff=192,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                                  rotary_pct=0.5),
        block_pattern=("attn+dense",),
        remat=False,
    )
