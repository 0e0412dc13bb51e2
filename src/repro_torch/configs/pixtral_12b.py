"""pixtral-12b — VLM: pixtral-ViT frontend (stub) + mistral-nemo backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
The ViT frontend is a STUB: the caller hands the LM precomputed patch
embeddings (B, n_patches, d_model) and their positions in the token
sequence (``LM.forward(tokens, patch_embeds=..., patch_pos=...)``).
This is the most literal "MLLM operator" backbone for the Saṃsāra case study.
"""
from repro_torch.common.config import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131072,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0),
    block_pattern=("attn+dense",),
    tie_embeddings=False,
    frontend="patch",
    grad_accum=4,
    notes="kv heads replicated 8->16 for TP=16; patch-embed stub frontend.",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="pixtral-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        block_pattern=("attn+dense",),
        tie_embeddings=False,
        frontend="patch",
        remat=False,
    )
