"""Resumable data pipelines.

Counterpart of ``repro/training/data.py``.  ``TokenStream``: a
deterministic synthetic LM token stream; batch ``i`` is a pure function of
``(seed, i)`` (numpy, the reference's generator and draws, so its batches
equal the reference's), so the pipeline state is one integer and a
checkpoint of it replays exactly.  The distribution is an order-2 Markov
chain over the vocab with noise, so small models show a falling loss.
Batches are torch tensors on the stream's device.

``DistillBatcher`` wraps a teacher to emit (tokens, teacher logits)
batches; ``distill_loss_fn`` is the student's loss on them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models.layers import cross_entropy


class TokenStream:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0,
                 extra_fn: Optional[Callable[[np.random.RandomState, int],
                                             Dict[str, np.ndarray]]] = None,
                 device: DeviceLike = None):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.index = 0
        self.extra_fn = extra_fn
        self.device = resolve_device(device)
        # fixed random Markov transition structure (shared across batches)
        rs = np.random.RandomState(seed)
        self._succ = rs.randint(0, vocab_size, size=(vocab_size, 4))

    # -- resumable state ---------------------------------------------------
    def state(self) -> Dict[str, Any]:
        return {"index": np.asarray(self.index), "seed": np.asarray(self.seed)}

    def set_state(self, st: Dict[str, Any]) -> None:
        self.index = int(st["index"])
        self.seed = int(st["seed"])

    # -- batch generation ----------------------------------------------------
    def _gen(self, i: int) -> Dict[str, torch.Tensor]:
        rs = np.random.RandomState((self.seed * 1_000_003 + i) % 2**31)
        toks = np.zeros((self.batch, self.seq + 1), np.int64)
        toks[:, 0] = rs.randint(0, self.vocab, self.batch)
        choice = rs.randint(0, 4, size=(self.batch, self.seq))
        noise = rs.rand(self.batch, self.seq) < 0.1
        rand_tok = rs.randint(0, self.vocab, size=(self.batch, self.seq))
        for t in range(self.seq):
            nxt = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        arrays = {"tokens": toks[:, :-1].astype(np.int32),
                  "labels": toks[:, 1:].astype(np.int32)}
        if self.extra_fn is not None:
            arrays.update(self.extra_fn(rs, self.batch))
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def next_batch(self) -> Dict[str, torch.Tensor]:
        b = self._gen(self.index)
        self.index += 1
        return b


class DistillBatcher:
    """Generates (student batch + teacher logits) for distillation; the
    teacher runs without a graph."""

    def __init__(self, stream: TokenStream,
                 teacher_fn: Callable[[Dict], torch.Tensor]):
        self.stream = stream
        self.teacher_fn = teacher_fn

    def state(self):
        return self.stream.state()

    def set_state(self, st):
        self.stream.set_state(st)

    def next_batch(self) -> Dict[str, torch.Tensor]:
        batch = self.stream.next_batch()
        with torch.no_grad():
            batch["teacher_logits"] = self.teacher_fn(batch)
        return batch


def distill_loss_fn(lm, temperature: float = 2.0, alpha: float = 0.5):
    """KL(teacher || student) + alpha·CE hard-label loss of ``lm`` (an
    ``LM``) on a ``DistillBatcher`` batch: ``loss(batch) -> scalar``."""

    def loss(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits = lm(batch["tokens"])
        t = temperature
        t_logits = batch["teacher_logits"].to(torch.float32)
        p_t = torch.softmax(t_logits / t, dim=-1)
        logp_s = torch.log_softmax(logits / t, dim=-1)
        kl = -torch.mean(torch.sum(p_t * logp_s, dim=-1)) * t * t
        ce, zl = cross_entropy(logits, torch.clamp(batch["labels"], min=0))
        return (1 - alpha) * kl + alpha * ce + zl

    return loss
