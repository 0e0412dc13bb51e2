"""Architecture registry of the configurations the port runs:
``get_config(name)`` and ``smoke_config(name)``.

Counterpart of ``repro/configs/__init__.py`` over the archs the port serves
and trains (gemma2-2b, mamba2-130m, the dense zoo: chatglm3-6b, glm4-9b,
phi3-mini-3.8b, the MoE family: moonshot-v1-16b-a3b,
qwen3-moe-235b-a22b, jamba-1.5-large-398b, the encoder-decoder
seamless-m4t-medium and the patch-frontend pixtral-12b) and the two stream
MLLM backbones.  An unknown name raises a ``KeyError``.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.common.config import ArchConfig
from repro_torch.configs import (chatglm3_6b, gemma2_2b, glm4_9b,
                                 jamba_1_5_large_398b, mamba2_130m,
                                 moonshot_v1_16b_a3b, phi3_mini_3_8b,
                                 pixtral_12b, qwen3_moe_235b_a22b,
                                 samsara_stream, seamless_m4t_medium)

REGISTRY: Dict[str, ArchConfig] = {
    c.name: c for c in (
        gemma2_2b.CONFIG,
        mamba2_130m.CONFIG,
        chatglm3_6b.CONFIG,
        glm4_9b.CONFIG,
        phi3_mini_3_8b.CONFIG,
        moonshot_v1_16b_a3b.CONFIG,
        qwen3_moe_235b_a22b.CONFIG,
        jamba_1_5_large_398b.CONFIG,
        seamless_m4t_medium.CONFIG,
        pixtral_12b.CONFIG,
        samsara_stream.STREAM_MLLM_CONFIG,
        samsara_stream.STREAM_MLLM_SMALL_CONFIG,
    )
}

#: the assigned architectures, in the reference's order (the dry run's)
ASSIGNED = [
    "moonshot-v1-16b-a3b",
    "qwen3-moe-235b-a22b",
    "jamba-1.5-large-398b",
    "seamless-m4t-medium",
    "chatglm3-6b",
    "gemma2-2b",
    "glm4-9b",
    "phi3-mini-3.8b",
    "pixtral-12b",
    "mamba2-130m",
]

_SMOKE: Dict[str, Callable[[], ArchConfig]] = {
    "gemma2-2b": gemma2_2b.smoke,
    "mamba2-130m": mamba2_130m.smoke,
    "chatglm3-6b": chatglm3_6b.smoke,
    "glm4-9b": glm4_9b.smoke,
    "phi3-mini-3.8b": phi3_mini_3_8b.smoke,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.smoke,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.smoke,
    "jamba-1.5-large-398b": jamba_1_5_large_398b.smoke,
    "seamless-m4t-medium": seamless_m4t_medium.smoke,
    "pixtral-12b": pixtral_12b.smoke,
    "samsara-stream-mllm": samsara_stream.smoke,
    "samsara-stream-mllm-small": samsara_stream.smoke,
}


def _lookup(name: str) -> None:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")


def get_config(name: str) -> ArchConfig:
    _lookup(name)
    return REGISTRY[name]


def smoke_config(name: str) -> ArchConfig:
    """A reduced same-family config for CPU tests."""
    _lookup(name)
    return _SMOKE[name]()
