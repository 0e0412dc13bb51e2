"""Train step factory + fault-tolerant training loop.

Counterpart of ``repro/training/trainer.py``.  ``make_train_step`` builds
one step: gradient accumulation over micro-batches (the mean of their
gradients, as the reference's scan), global-norm clipping, AdamW
(optionally int8 moments).  ``Trainer`` owns the loop: resumable data,
periodic atomic checkpoints of parameters, optimizer state and data state,
SIGTERM checkpointing, and the straggler log.

PyTorch idiom: the loss is ``loss_fn(batch) -> scalar`` over a model's own
parameters, passed as ``{dotted name: nn.Parameter}``; gradients come from
``loss.backward()`` into ``.grad`` (the only place a stacked layer
weight's gradient lands: ``models/blocks.py::_PeriodSlice`` adds it there
from inside autograd, so ``torch.autograd.grad`` would see none); the
step updates the parameters in place.  There is no jit and no buffer
donation.  ``REPRO_CAST_BF16_STEP=1`` is the reference's bf16 step: the
loss runs under ``models.param.cast_step``, so every fp32 leaf of two or
more dims enters the model as a bf16 copy made inside autograd (a stacked
leaf's period slice after its ``_PeriodSlice``), the loss at the caller's
dtype; the gradient comes back rounded to bf16 and accumulates into the
fp32 ``.grad``, and AdamW updates the fp32 masters.  The LM
(``models/model.py``, ``models/blocks.py``) takes the cast; a loss over
other modules sees none of it.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.param import cast_step
from repro_torch.training.checkpoint import CheckpointManager, nest
from repro_torch.training.optimizer import (
    OptimizerConfig,
    adamw_init,
    adamw_update,
)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    grad_accum: int = 1
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0  # warn when a step takes 3x the median


def _split(batch: Any, n: int, i: int) -> Any:
    """Micro-batch ``i`` of ``n`` of a (nested) batch, along axis 0."""
    if isinstance(batch, dict):
        return {k: _split(v, n, i) for k, v in batch.items()}
    size = batch.shape[0] // n
    return batch[i * size:(i + 1) * size]


def make_train_step(loss_fn: Callable[[Dict[str, Any]], torch.Tensor],
                    params: Mapping[str, torch.Tensor],
                    opt_cfg: OptimizerConfig, grad_accum: int = 1):
    """``train_step(opt_state, batch) -> (opt_state, metrics)``: the
    parameters' gradients of ``loss_fn`` (accumulated over ``grad_accum``
    micro-batches, then divided by it), then one AdamW update of
    ``params`` in place.  ``metrics``: loss, grad_norm, lr (tensors).
    Under ``REPRO_CAST_BF16_STEP=1`` ``loss_fn`` runs under
    ``cast_step(torch.bfloat16)`` (the module docstring)."""
    if os.environ.get("REPRO_CAST_BF16_STEP") == "1":
        plain_loss = loss_fn

        def loss_fn(batch):
            with cast_step(torch.bfloat16):
                return plain_loss(batch)

    def train_step(opt_state: Dict[str, Any], batch: Dict[str, Any]):
        for p in params.values():
            p.grad = None
        if grad_accum == 1:
            loss = loss_fn(batch)
            loss.backward()
            loss = loss.detach()
        else:
            lsum = 0.0
            for i in range(grad_accum):
                l = loss_fn(_split(batch, grad_accum, i))
                l.backward()
                lsum = lsum + l.detach()
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad /= grad_accum
            loss = lsum / grad_accum
        grads = {n: p.grad for n, p in params.items()}
        opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        for p in params.values():
            p.grad = None
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


def _at(tree: Dict[str, Any], name: str) -> Any:
    node = tree
    for part in name.split("."):
        node = node[part]
    return node


class Trainer:
    def __init__(self, loss_fn, params: Mapping[str, torch.Tensor],
                 opt_cfg: OptimizerConfig, train_cfg: TrainConfig,
                 data_iter, ckpt: Optional[CheckpointManager] = None,
                 param_shardings: Any = None):
        """``param_shardings``: the parameters' ``NamedSharding``s, nested
        by dotted name (``common/sharding.py::param_sharding_tree``),
        re-applied to the parameters a restore loads."""
        self.loss_fn = loss_fn
        self.param_shardings = param_shardings
        self.params = dict(params)
        for p in self.params.values():
            p.requires_grad_(True)
        self.opt_cfg = opt_cfg
        self.cfg = train_cfg
        self.data = data_iter
        self.ckpt = ckpt
        self.opt_state = adamw_init(self.params, opt_cfg)
        self.step = 0
        self.history: list = []
        self._train_step = make_train_step(loss_fn, self.params, opt_cfg,
                                           train_cfg.grad_accum)
        self._preempted = False
        self._step_times: list = []

    # -- preemption handling ------------------------------------------------
    def install_signal_handlers(self) -> None:
        def handler(signum, frame):  # pragma: no cover - signal path
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    # -- checkpoint / restore -----------------------------------------------
    def save(self) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(self.step, {
            "params": nest(self.params),
            "opt_state": {"moments": nest(self.opt_state["moments"]),
                          "step": self.opt_state["step"]},
            "data_state": self.data.state(),
        })

    def restore(self, step: Optional[int] = None) -> bool:
        """Parameters (copied in place), optimizer state and data state of
        the checkpoint at ``step`` (default the latest); False if none."""
        if self.ckpt is None:
            return False
        step = step if step is not None else self.ckpt.latest_step()
        if step is None:
            return False
        tree = self.ckpt.restore(step, shardings={
            "params": self.param_shardings} if self.param_shardings
            else None)
        with torch.no_grad():
            for name, p in self.params.items():
                p.copy_(_at(tree["params"], name))
        moments = tree["opt_state"]["moments"]
        self.opt_state = {
            "moments": {name: {k: v.to(p.device) for k, v in
                               _at(moments, name).items()}
                        for name, p in self.params.items()},
            "step": tree["opt_state"]["step"].to(torch.int32)}
        self.data.set_state({k: v.cpu().numpy()
                             for k, v in tree["data_state"].items()})
        self.step = step
        return True

    # -- loop -----------------------------------------------------------------
    def train(self, steps: Optional[int] = None) -> Dict[str, Any]:
        steps = steps if steps is not None else self.cfg.steps
        end = self.step + steps
        while self.step < end and not self._preempted:
            batch = self.data.next_batch()
            t0 = time.perf_counter()
            self.opt_state, metrics = self._train_step(self.opt_state, batch)
            loss = float(metrics["loss"])       # waits for the step
            dt = time.perf_counter() - t0
            self._step_times.append(dt)
            med = float(np.median(self._step_times[-50:]))
            if len(self._step_times) > 5 and \
                    dt > self.cfg.straggler_factor * med:
                print(f"[straggler] step {self.step} took {dt:.3f}s "
                      f"(median {med:.3f}s)")
            self.step += 1
            self.history.append(loss)
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                print(f"step {self.step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            if self.ckpt is not None and self.step % self.cfg.ckpt_every == 0:
                self.save()
        if self._preempted:  # pragma: no cover - signal path
            print(f"[preempt] checkpointing at step {self.step} and exiting")
            self.save()
        return {"final_loss": self.history[-1] if self.history else None,
                "history": self.history, "step": self.step,
                "step_times": self._step_times[-steps:] if steps else []}
