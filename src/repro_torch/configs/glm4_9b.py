"""glm4-9b — dense decoder, partial RoPE, GQA kv=2.

[hf:THUDM/glm-4-9b; hf]
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
from repro_torch.common.config import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    d_ff=13696,
    vocab_size=151552,
    attention=AttentionConfig(n_heads=32, n_kv_heads=2, head_dim=128,
                              rotary_pct=0.5),
    block_pattern=("attn+dense",),
    grad_accum=2,
    notes="32 query heads over 2 kv heads: a group of 16 in the kernels.",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="glm4-smoke",
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
