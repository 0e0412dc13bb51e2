"""mamba2-130m: pure SSM (SSD, state-space duality), attention-free.

[arXiv:2405.21060]
24L d_model=768 (attn-free) vocab=50280, ssm_state=128, head_dim=64,
expand=2 => d_inner=1536, 24 SSD heads; the vocab is padded to 50432.
"""
from repro_torch.common.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, head_dim=64, expand=2, n_groups=1,
                  chunk=256),
    block_pattern=("mamba+none",),
    sub_quadratic=True,
    notes="vocab padded 50280->50432.",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        d_ff=0,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, head_dim=16, expand=2,
                      n_groups=1, chunk=32),
        block_pattern=("mamba+none",),
        sub_quadratic=True,
        remat=False,
    )
