"""seamless-m4t-medium — encoder-decoder speech/text model (audio stub).

[arXiv:2308.11596; hf]
12L (enc) + 12L (dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The audio frontend (fbank + conformer feature extractor) is a STUB: the
caller hands the LM precomputed frame embeddings (B, T_src, d_model)
(``LM.forward(tokens, frames=...)``, ``LM.prefill(..., frames=...)``).
LayerNorm and a non-gated FFN; its activation is SiLU, as the reference's
code picks (GeLU only for the gemma names), whatever the paper's FFN.
"""
from repro_torch.common.config import ArchConfig, AttentionConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    n_encoder_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=256206,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=64),
    block_pattern=("attn+dense",),
    encoder_decoder=True,
    norm="layernorm",
    mlp_gated=False,
    frontend="audio",
    grad_accum=2,
    notes="enc-dec; vocab padded 256206->256256 for TP divisibility.",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="seamless-smoke",
        family="audio",
        n_layers=2,
        n_encoder_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=512,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        block_pattern=("attn+dense",),
        encoder_decoder=True,
        norm="layernorm",
        mlp_gated=False,
        frontend="audio",
        remat=False,
    )
