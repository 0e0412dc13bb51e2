"""Paper-native streaming configs: the MLLM operator backbones Saṃsāra
actually *executes* in the CPU case study (Toll Booth / Volleyball).

STREAM_MLLM is a small VLM-style decoder (the stand-in for Qwen2.5-VL in the
paper's naive plan); STREAM_MLLM_SMALL is its distilled/pruned counterpart
that the physical-optimization phase may select.  Both use the patch-embed
frontend fed by the streaming preprocessing operators.
"""
from repro_torch.common.config import ArchConfig, AttentionConfig

STREAM_MLLM_CONFIG = ArchConfig(
    name="samsara-stream-mllm",
    family="vlm",
    n_layers=4,
    d_model=256,
    d_ff=768,
    vocab_size=512,
    attention=AttentionConfig(n_heads=8, n_kv_heads=4, head_dim=32),
    block_pattern=("attn+dense",),
    frontend="patch",
    remat=False,
    notes="paper-native CPU-scale MLLM operator backbone",
)

STREAM_MLLM_SMALL_CONFIG = ArchConfig(
    name="samsara-stream-mllm-small",
    family="vlm",
    n_layers=2,
    d_model=128,
    d_ff=384,
    vocab_size=512,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=32),
    block_pattern=("attn+dense",),
    frontend="patch",
    remat=False,
    notes="distilled/pruned target for physical optimization",
)


def smoke() -> ArchConfig:
    return STREAM_MLLM_SMALL_CONFIG
