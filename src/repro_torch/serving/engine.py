"""Continuous-batching serving engine.

Counterpart of ``repro/serving/engine.py``: decoder-only archs, served
from tokens (an encoder-decoder raises, as the reference asserts; the
patch frontend's LM serves its prompts' tokens).  Slot-based scheduler:
``max_slots`` concurrent sequences share one batched cache.  Prefill runs
per request (the prompt right-padded to a power-of-two bucket for attention
archs; exact length when the arch has Mamba layers, whose recurrent state
would otherwise take in the padding), its cache is copied into the
request's slot, and one batched decode advances every slot each tick.
Finished slots are freed and refilled from the queue.

Right-padded prefill is exact for attention blocks: causal rows never see
the padding, the padding's K/V written beyond the prompt are masked by the
slot's length until decode overwrites them, and the first token is sampled
at the prompt's last position (``last_pos``).  Slots without a request
decode too (token 0, length not advanced), as in the reference; their cache
is garbage until ``_insert_slot`` overwrites the whole slot.

The reference jits its two programs; the port runs eagerly.  The cache and
the slot lengths stay on the model's device between ticks; only the
sampled tokens are copied to the host.  ``dtype`` is the compute dtype of
every prefill and decode and the cache's, as the reference's (by default
the LM's, fp32; a bf16 engine serves an LM cast with ``LM.cast_(torch.bfloat16)``
or built in bf16, or, slowly, an fp32 one whose weights are cast at every
use).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import LM
from repro_torch.serving.sampler import sample_logits


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class ServingEngine:
    def __init__(self, lm: LM, *, max_slots: int = 4, s_max: int = 512,
                 dtype: Optional[torch.dtype] = None, eos_id: int = 1):
        if lm.cfg.encoder_decoder:
            raise ValueError(f"{lm.cfg.name}: the engine serves decoder-only "
                             "archs (an encoder-decoder's requests carry "
                             "frames; drive LM.prefill(frames=...) and "
                             "LM.decode)")
        self.cfg = lm.cfg
        self.lm = lm
        self.device = lm.device
        self.max_slots = max_slots
        self.s_max = s_max
        self.dtype = lm._dtype(dtype)
        self.eos_id = eos_id
        self.exact_prefill = self.cfg.has_mamba

        self.cache = lm.init_cache(max_slots, s_max, dtype=self.dtype)
        self.lens = torch.zeros((max_slots,), dtype=torch.int32,
                                device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.queue: collections.deque = collections.deque()
        self.stats = {"prefill_tokens": 0, "decode_steps": 0, "finished": 0}

    # ------------------------------------------------------------------
    # the two programs
    # ------------------------------------------------------------------
    def _prefill(self, tokens: torch.Tensor, last_pos: torch.Tensor):
        cache1 = self.lm.init_cache(1, self.s_max, dtype=self.dtype)
        logits, cache1 = self.lm.prefill(tokens, cache1, last_pos=last_pos,
                                         dtype=self.dtype)
        return logits[:, 0], cache1                      # (1, V), cache

    def _decode_step(self, tokens: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
        logits, self.cache = self.lm.decode(tokens, self.cache, self.lens,
                                            dtype=self.dtype)
        next_tok = sample_logits(logits[:, 0])
        self.lens = torch.where(active, self.lens + 1, self.lens)
        return next_tok

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in [i for i, r in enumerate(self.slot_req) if r is None]:
            if not self.queue:
                break
            req = self.queue.popleft()
            plen = len(req.prompt)
            if plen + req.max_new_tokens > self.s_max:
                raise ValueError(f"request {req.uid}: prompt {plen} + "
                                 f"{req.max_new_tokens} new tokens exceed "
                                 f"s_max {self.s_max}")
            padded = plen if self.exact_prefill else min(_bucket(plen),
                                                         self.s_max)
            tokens = np.zeros((1, padded), np.int64)
            tokens[0, :plen] = req.prompt
            logits, cache1 = self._prefill(
                torch.from_numpy(tokens).to(self.device),
                torch.tensor([plen - 1], device=self.device))
            req.output.append(int(sample_logits(logits)[0]))
            self._insert_slot(slot, cache1, plen)
            self.slot_req[slot] = req
            self.stats["prefill_tokens"] += plen

    def _insert_slot(self, slot: int, cache1: Dict[str, Any],
                     plen: int) -> None:
        # cache leaves are (n_periods, B, ...)
        for key, leaves in cache1["layers"].items():
            for leaf, one in leaves.items():
                self.cache["layers"][key][leaf][:, slot].copy_(one[:, 0])
        self.lens[slot] = plen

    def step(self) -> List[Request]:
        """One scheduler tick: admit, batched decode, collect finishes."""
        self._admit()
        active = np.array([r is not None for r in self.slot_req])
        if not active.any():
            return []
        tokens = np.zeros((self.max_slots, 1), np.int64)
        for i, r in enumerate(self.slot_req):
            if r is not None:
                tokens[i, 0] = r.output[-1]
        next_tok = self._decode_step(
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(active).to(self.device))
        self.stats["decode_steps"] += 1
        next_np = next_tok.cpu().numpy()
        finished = []
        for i, r in enumerate(self.slot_req):
            if r is None:
                continue
            tok = int(next_np[i])
            r.output.append(tok)
            if tok == self.eos_id or len(r.output) >= r.max_new_tokens:
                r.done = True
                finished.append(r)
                self.slot_req[i] = None
                self.stats["finished"] += 1
        return finished

    def run(self, requests: List[Request], max_ticks: int = 10_000
            ) -> List[Request]:
        for r in requests:
            self.submit(r)
        done: List[Request] = []
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            done.extend(self.step())
            ticks += 1
        return done
