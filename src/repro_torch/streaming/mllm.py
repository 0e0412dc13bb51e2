"""StreamMLLM: the multimodal LLM operator the streaming plans invoke.

Counterpart of ``repro/streaming/mllm.py``.  A conv stem + patch embedding,
the ``("attn+dense",)`` decoder backbone and per-task readout heads: frames
(B, C, h, w) -> one logits tensor per task.  The parameters keep the
reference's shapes and init scheme, and their dotted names are the
reference's parameter-tree paths (the unused token-embedding table of the
reference's LM backbone is left out).  Conv kernels are stored OIHW here
(HWIO in the reference); ``repro_torch.bridge`` converts.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.common.config import ArchConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.data.tollbooth import BRANDS, COLORS, PLATE_CHARS
from repro_torch.data.volleyball import ACTIONS
from repro_torch.models.blocks import apply_stack, stack_spec
from repro_torch.models.layers import apply_norm
from repro_torch.models.param import ParamSpec, ParamTree, init_params

PLATE_LEN = 6
MLLM_TASKS = {
    "present": 2,
    "color": len(COLORS),
    "brand": len(BRANDS),
    "plate": PLATE_LEN * len(PLATE_CHARS),
    "action": len(ACTIONS),
    "n_jumping": 7,           # 0..6 jumping players
    "team": 2,                # attacking team (volleyball Q11)
}

SCALAR_TASKS = ("present", "color", "brand", "action", "n_jumping", "team")


def _same_pad(n: int, k: int = 3, s: int = 2):
    """JAX "SAME" padding (low, high) of one spatial dim for a k-wide
    stride-s conv: (0, 1) for the stem's 3x3 stride-2 convs on even sizes,
    not PyTorch's symmetric 1; (1, 1) for TinyDet's 3x3 stride 1."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class StreamMLLM(ParamTree):
    """Conv stem + patchify + decoder backbone + heads as one module.

    Readout: one learned task token per scalar task + one per plate char
    position (a 6-char plate reads from 6 dedicated tokens)."""

    STEM_CH = 48  # conv-stem output channels (stride 4 total)

    def __init__(self, cfg: ArchConfig, patch: int = 8,
                 device: DeviceLike = None, in_ch: int = 3,
                 max_patches: int = 512):
        assert cfg.frontend == "patch"
        dev = resolve_device(device)
        super().__init__(self.spec(cfg, patch, in_ch, max_patches), dev)
        self.cfg = cfg
        self.patch = patch
        self.device = dev
        self.n_tasks = len(SCALAR_TASKS) + PLATE_LEN

    @staticmethod
    def spec(cfg: ArchConfig, patch: int, in_ch: int = 3,
             max_patches: int = 512) -> Dict[str, Any]:
        d = cfg.d_model
        p = patch // 4  # patch size on the stride-4 conv feature map
        c = StreamMLLM.STEM_CH
        heads = {name: ParamSpec((d, MLLM_TASKS[name]))
                 for name in SCALAR_TASKS}
        heads["plate"] = ParamSpec((d, len(PLATE_CHARS)))
        return {
            "backbone": {"stack": stack_spec(cfg),
                         "final_norm": {"scale": ParamSpec((d,), "ones")}},
            "conv1": ParamSpec((c, in_ch, 3, 3), fan_in=in_ch),
            "conv1_b": ParamSpec((c,), "zeros"),
            "conv2": ParamSpec((c, c, 3, 3), fan_in=c),
            "conv2_b": ParamSpec((c,), "zeros"),
            "patch_proj": ParamSpec((c * p * p, d)),
            "patch_pos_emb": ParamSpec((max_patches, d), "small"),
            "task_tokens": ParamSpec((len(SCALAR_TASKS) + PLATE_LEN, d),
                                     "small"),
            "heads": heads,
        }

    def init(self, generator: torch.Generator) -> "StreamMLLM":
        """Seeded init (reference scheme) from a CPU ``torch.Generator``."""
        init_params(self, generator)
        return self

    # ------------------------------------------------------------------
    def _stem(self, frames: torch.Tensor) -> torch.Tensor:
        """Conv stem: (B, C, h, w) -> (B, c, h/4, w/4)."""
        x = frames
        for wk, bk in (("conv1", "conv1_b"), ("conv2", "conv2_b")):
            (t, b), (l, r) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.conv2d(F.pad(x, (l, r, t, b)), getattr(self, wk), stride=2)
            x = F.relu(x + getattr(self, bk)[None, :, None, None])
        return x

    def _patchify(self, feats: torch.Tensor) -> torch.Tensor:
        """feature map (B, C, h, w) -> (B, P, C·p·p) with p = patch//4."""
        b, c, h, w = feats.shape
        p = self.patch // 4
        assert h % p == 0 and w % p == 0, (h, w, p)
        x = feats.reshape(b, c, h // p, p, w // p, p)
        return x.permute(0, 2, 4, 1, 3, 5).reshape(
            b, (h // p) * (w // p), c * p * p)

    def forward(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """frames (B, C, h, w) float (preprocessed) -> task logits dict."""
        b = frames.shape[0]
        patches = self._patchify(self._stem(frames.to(torch.float32)))
        n_p = patches.shape[1]
        x_p = patches @ self.patch_proj + self.patch_pos_emb[:n_p][None]
        x_t = self.task_tokens[None].expand(b, -1, -1)
        x = torch.cat([x_p, x_t], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        bb = self.backbone.tree()
        x = apply_stack(self.cfg, bb["stack"], x, positions)
        x = apply_norm(bb["final_norm"]["scale"], x)
        task_h = x[:, n_p:, :]                       # (B, n_tasks, d)
        heads = self.heads.tree()
        out = {name: task_h[:, i] @ heads[name]
               for i, name in enumerate(SCALAR_TASKS)}
        out["plate"] = task_h[:, len(SCALAR_TASKS):] @ heads["plate"]
        return out                                   # plate (B, 6, 36)


def variant_models(ctx) -> Dict[str, StreamMLLM]:
    """Physical-variant name -> model from an OpContext ("adaptive" is not a
    physical variant: the op resolves it to big/pruned per batch)."""
    return {"big": ctx.mllm, "small": ctx.mllm_small,
            "pruned": ctx.mllm_pruned}


def make_extract_fn(mllm: StreamMLLM
                    ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Batched union extract: frames -> argmax prediction per task.

    Normalization is decided **per frame** (raw uint8-range vs already
    normalized), never from the batch max, so a coalesced row comes out
    as its solo row would.  Zero padding rows classify as "normalized" and
    are sliced off by the caller."""

    @torch.inference_mode()
    def run(frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = frames.to(torch.float32)
        raw = x.reshape(x.shape[0], -1).amax(dim=1) > 8.0
        x = torch.where(raw[:, None, None, None],
                        (x / 255.0 - 0.5) / 0.25, x)
        return {k: torch.argmax(v, dim=-1) for k, v in mllm(x).items()}

    return run
