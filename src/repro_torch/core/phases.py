"""The common optimization-phase interface.

Counterpart of ``repro/core/phases.py``.  ``PhaseContext`` carries what a
phase may need for one query (the query, its stream factory, a ``run_fn``
executing candidate plans, validation budgets and the shared
``CostCatalog``); ``OptimizationPhase`` is the protocol the semantic,
logical and physical optimizers implement, so ``SuperOptimizer`` drives
any phase sequence uniformly and times each phase in one place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Protocol, Tuple

import numpy as np

from repro_torch.streaming.plan import Plan

#: frames sampled for logical-phase measurement / chain calibration
SAMPLE_FRAMES = 64
#: held-out seed for the sample stream (distinct from validation seeds
#: 202/303)
SAMPLE_SEED = 404


@dataclasses.dataclass
class PhaseContext:
    """Per-query inputs shared by every optimization phase."""

    query: Any
    stream_factory: Callable[[int], Any]
    run_fn: Callable[[Plan, Any, int], Any]   # (plan, stream, n) -> RunResult
    val_frames: int = 512
    catalog: Any = None                        # CostCatalog (optional)
    _sample: Optional[np.ndarray] = None

    def sample_frames(self, n: int = SAMPLE_FRAMES) -> np.ndarray:
        """A cached sample batch from the query's stream (phases measuring
        op costs share one draw instead of re-sampling)."""
        if self._sample is None or self._sample.shape[0] < n:
            stream = self.stream_factory(SAMPLE_SEED)
            self._sample, _ = stream.batch(max(n, SAMPLE_FRAMES))
        return self._sample[:n]


class OptimizationPhase(Protocol):
    """One rewrite phase: semantically valid plan in, better plan out."""

    name: str

    def run(self, plan: Plan, pctx: PhaseContext
            ) -> Tuple[Plan, Dict[str, Any]]:
        """Rewrite ``plan`` for ``pctx.query``; returns the new plan and a
        report dict whose ``"phase"`` key names the phase."""
        ...
