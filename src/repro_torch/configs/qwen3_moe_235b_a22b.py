"""qwen3-moe-235b-a22b — Qwen3-MoE (QK-norm, GQA, fine-grained experts).

[hf:Qwen/Qwen3-235B-A22B family; hf]
94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936, MoE 128e top-8,
an unembedding apart from the token table.
"""
from repro_torch.common.config import ArchConfig, AttentionConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    d_ff=1536,
    vocab_size=151936,
    attention=AttentionConfig(
        n_heads=64, n_kv_heads=4, head_dim=128, rope_theta=1_000_000.0,
        qk_norm=True),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    block_pattern=("attn+moe",),
    tie_embeddings=False,
    grad_accum=8,
    notes="128 experts top-8; qk-norm; kv heads replicated 4->16 for TP=16.",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        d_ff=64,
        vocab_size=512,
        attention=AttentionConfig(n_heads=8, n_kv_heads=2, head_dim=16,
                                  qk_norm=True),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
        block_pattern=("attn+moe",),
        tie_embeddings=False,
        remat=False,
    )
