"""moonshot-v1-16b-a3b — Moonlight-16B-A3B (DeepSeek-V3-style MoE).

[hf:moonshotai/Moonlight-16B-A3B; hf]
48L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=163840, MoE 64e top-6
(+2 shared experts, DeepSeek-V2-lite style).  All layers MoE (Moonlight's
single dense first layer is folded into the uniform pattern, as the
reference does).
"""
from repro_torch.common.config import ArchConfig, AttentionConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    d_ff=1408,
    vocab_size=163840,
    attention=AttentionConfig(
        n_heads=16, n_kv_heads=16, head_dim=128, rope_theta=50000.0),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  n_shared_experts=2),
    block_pattern=("attn+moe",),
    grad_accum=4,
    notes="64e top-6 MoE; MHA; shared experts add a dense 2x1408 path.",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="moonshot-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        d_ff=96,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96,
                      n_shared_experts=1),
        block_pattern=("attn+moe",),
        remat=False,
    )
