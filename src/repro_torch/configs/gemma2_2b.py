"""gemma2-2b: local/global alternating attention, logit softcaps.

[arXiv:2408.00118; hf]
26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216 vocab=256000.
Period = (local sliding-window 4096, global); attn softcap 50, final logit
softcap 30; sandwich (pre+post) RMSNorm; GeGLU; embeddings scaled sqrt(d).
"""
from repro_torch.common.config import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    d_ff=9216,
    vocab_size=256000,
    attention=AttentionConfig(n_heads=8, n_kv_heads=4, head_dim=256,
                              softcap=50.0, window=4096),
    block_pattern=("attn_local+dense", "attn_global+dense"),
    post_block_norm=True,
    embed_scale=True,
    final_softcap=30.0,
    grad_accum=2,
    notes="13 periods of (local, global).",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-smoke",
        family="dense",
        n_layers=4,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                                  softcap=50.0, window=16),
        block_pattern=("attn_local+dense", "attn_global+dense"),
        post_block_norm=True,
        embed_scale=True,
        final_softcap=30.0,
        remat=False,
    )
