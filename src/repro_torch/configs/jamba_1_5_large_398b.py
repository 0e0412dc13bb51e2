"""jamba-1.5-large-398b — hybrid Mamba+Attention 1:7 interleave with MoE.

[arXiv:2403.19887; hf]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period of 8 layers: one attention layer per 7 mamba layers; MoE replaces the
dense MLP on every other layer.  The paper's Mamba-1 mixer is the Mamba-2
SSD formulation, as in the reference.  One period's fp32 weights
(``LM.spec`` counts them) are more than one 80 GB card holds, and the depth
is a whole number of periods, so the port runs it on one card at
``smoke()`` width.
"""
from repro_torch.common.config import (ArchConfig, AttentionConfig, MoEConfig,
                                       SSMConfig)

_PATTERN = (
    "mamba+dense",
    "mamba+moe",
    "mamba+dense",
    "attn+moe",
    "mamba+dense",
    "mamba+moe",
    "mamba+dense",
    "mamba+moe",
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab_size=65536,
    attention=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                  capacity_factor=1.25),
    ssm=SSMConfig(d_state=16, d_conv=4, head_dim=128, expand=2, n_groups=8,
                  chunk=256),
    block_pattern=_PATTERN,
    sub_quadratic=True,
    grad_accum=8,
    notes="1:7 attn:mamba, MoE every other layer; 9 periods of 8.",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="jamba-smoke",
        family="hybrid",
        n_layers=8,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
        ssm=SSMConfig(d_state=16, d_conv=4, head_dim=16, expand=2,
                      n_groups=2, chunk=32),
        block_pattern=_PATTERN,
        sub_quadratic=True,
        remat=False,
    )
