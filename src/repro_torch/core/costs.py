"""Calibrated operator cost catalog: the measured cost model the physical
phase, the fleet optimizer and the sharing-tree planner price plans with.

Counterpart of ``repro/core/costs.py``.  Every timing the optimization
phases take (``logical._time_op`` micro-benchmarks, semantic/physical
validation runs) flows into one ``CostCatalog``; ``calibrate_chain`` walks
a plan on a sample batch, timing each operator on its *actual* input and
measuring its survivor fraction, and stamps ``op.cost_us`` /
``op.overhead_us`` / ``op.pass_rate`` in place.

Entries are keyed ``"<OpClass>"`` for relational/semantic ops and
``"mllm[<variant>]"`` for extracts (plus per-resolution
``"mllm[<variant>]@<H>x<W>"`` diagnostic rows).  Direct per-op
measurements outrank run-derived estimates, except ``reconcile``'s
serving-time measurements.  Measured semantic-gate hit rates ride along
per feed (``record_gate_hit_rate``).  The catalog round-trips through
JSON (``save``/``load``).

Timing is the host clock around ``op.process``.  On the card that measures
device work only because every operator of the port ends in a
device-to-host copy of its result (``.cpu()``), which waits for the
device: an operator that returned device tensors without that copy would
be timed at its launch cost.  Keep every operator so.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.streaming.operators import MLLMExtractOp, Op, OpContext

#: EMA weight for merging a new sample into an existing entry of the same
#: provenance — recent measurements dominate (streams drift)
EMA = 0.5


def op_cost_key(op: Op) -> str:
    """Catalog key for one operator: extracts key by physical variant,
    every other op by class.  (Per-resolution extract measurements are
    additionally recorded under ``mllm_key(variant, shape)`` — diagnostic
    rows for the benchmark report; cost resolution itself reads the
    stamped op first, so the per-plan resolution difference is already
    captured where it matters.)"""
    if isinstance(op, MLLMExtractOp):
        return f"mllm[{op.model}]"
    return type(op).__name__


def mllm_key(variant: str, shape: Optional[tuple] = None) -> str:
    if shape is None:
        return f"mllm[{variant}]"
    return f"mllm[{variant}]@{shape[-2]}x{shape[-1]}"


@dataclasses.dataclass
class CostEntry:
    us: float                 # marginal per-input-frame cost, µs
    pass_rate: float = 1.0    # survivor fraction on the calibration sample
    overhead_us: float = 0.0  # fixed per-invocation cost, µs
    n: int = 1                # samples merged into this entry
    direct: bool = False      # micro-benchmarked (vs run-derived estimate)

    def merge(self, us: float, pass_rate: float, direct: bool,
              overhead_us: float = 0.0) -> None:
        if self.direct and not direct:
            return                      # run estimates never clobber direct
        if direct and not self.direct:  # first direct sample wins outright
            self.us, self.pass_rate = us, pass_rate
            self.overhead_us = overhead_us
            self.direct, self.n = True, 1
            return
        self.us = (1 - EMA) * self.us + EMA * us
        self.pass_rate = (1 - EMA) * self.pass_rate + EMA * pass_rate
        self.overhead_us = (1 - EMA) * self.overhead_us + EMA * overhead_us
        self.n += 1


class CostCatalog:
    """Persistent measured per-op cost table (µs per input frame)."""

    VERSION = 1

    def __init__(self):
        self.entries: Dict[str, CostEntry] = {}
        #: measured semantic-gate hit rate per feed (fraction of extract
        #: frames answered from the keyframe cache)
        self.gate_hit_rates: Dict[str, float] = {}

    # -- recording ---------------------------------------------------------
    def record(self, key: str, us: float, pass_rate: float = 1.0,
               direct: bool = False, overhead_us: float = 0.0) -> None:
        assert us >= 0, f"negative cost for {key}"
        if key in self.entries:
            self.entries[key].merge(us, pass_rate, direct, overhead_us)
        else:
            self.entries[key] = CostEntry(us=us, pass_rate=pass_rate,
                                          overhead_us=overhead_us,
                                          direct=direct)

    def record_op(self, op: Op, us: float, pass_rate: float = 1.0,
                  direct: bool = True, overhead_us: float = 0.0) -> None:
        """Record a measurement for one op (and, for extracts, the
        shape-free per-variant aggregate that backs unstamped plans)."""
        self.record(op_cost_key(op), us, pass_rate, direct, overhead_us)

    def record_run(self, plan_ops: List[Op], wall_s: float,
                   mllm_frames: int) -> None:
        """Fold a whole-pipeline validation run into the catalog: the
        extract dominates the wall, so wall/mllm_frames upper-bounds the
        chosen variant's per-frame cost.  Run-derived, never direct."""
        if mllm_frames <= 0:
            return
        us = wall_s / mllm_frames * 1e6
        for op in plan_ops:
            if isinstance(op, MLLMExtractOp):
                self.record(mllm_key(op.model), us, direct=False)

    def record_gate_hit_rate(self, feed: str, rate: float) -> None:
        """Fold one measured semantic-cache hit rate for a feed (from a
        gated run's counters) into the catalog, EMA-merged like every
        other measurement, so recent traffic dominates."""
        assert 0.0 <= rate <= 1.0, rate
        if feed in self.gate_hit_rates:
            self.gate_hit_rates[feed] = \
                (1 - EMA) * self.gate_hit_rates[feed] + EMA * rate
        else:
            self.gate_hit_rates[feed] = rate

    def reconcile(self, measured: Dict[str, Dict[str, float]],
                  tolerance: float = 0.5) -> List[str]:
        """Fold *serving-time* measurements back into the catalog:
        predictions that drift from reality are EMA-pulled toward what
        the last run measured, so the next planning pass self-corrects.

        ``measured`` maps catalog key → ``{"us": marginal µs/frame,
        "overhead_us"?: per-invocation µs, "pass_rate"?: survivor
        fraction, "frames"?: sample weight}``.  Unlike ``record``, this
        bypasses the direct-outranks-run protection: a measurement taken
        under serving conditions is better ground truth for planning than
        an offline micro-benchmark.  Keys without a prior entry are
        created outright.

        Returns the keys whose prior marginal cost was off by more than
        ``tolerance`` (relative, both directions): the drift flags the
        flight report surfaces."""
        flagged: List[str] = []
        for key, m in measured.items():
            us = float(m["us"])
            if us < 0 or not np.isfinite(us):
                continue
            e = self.entries.get(key)
            if e is None:
                self.entries[key] = CostEntry(
                    us=us, pass_rate=float(m.get("pass_rate", 1.0)),
                    overhead_us=float(m.get("overhead_us", 0.0)),
                    direct=False)
                continue
            if e.us > us * (1 + tolerance) or us > e.us * (1 + tolerance):
                flagged.append(key)
            e.us = (1 - EMA) * e.us + EMA * us
            if "pass_rate" in m:
                e.pass_rate = (1 - EMA) * e.pass_rate \
                    + EMA * float(m["pass_rate"])
            if "overhead_us" in m:
                e.overhead_us = (1 - EMA) * e.overhead_us \
                    + EMA * float(m["overhead_us"])
            e.n += 1
        return flagged

    def mean_gate_hit_rate(self) -> float:
        """Workload-level hit rate the planner discounts extract costs
        by; 0 until a gated run has been measured."""
        if not self.gate_hit_rates:
            return 0.0
        return sum(self.gate_hit_rates.values()) / len(self.gate_hit_rates)

    # -- lookup / stamping -------------------------------------------------
    def lookup(self, key: str) -> Optional[float]:
        e = self.entries.get(key)
        return e.us if e is not None else None

    #: the catalog key of an op (the sharing-tree planner reads an
    #: unstamped op's pass rate under it)
    key_of = staticmethod(op_cost_key)

    def lookup_op(self, op: Op) -> Optional[float]:
        return self.lookup(op_cost_key(op))

    def lookup_op_overhead(self, op: Op) -> Optional[float]:
        e = self.entries.get(op_cost_key(op))
        return e.overhead_us if e is not None else None

    def stamp(self, ops: List[Op]) -> List[str]:
        """Fill ``op.cost_us``/``op.pass_rate``/``op.overhead_us`` from
        catalog entries for every op that has no stamped measurement yet;
        returns the names of ops the catalog could not cover."""
        missing: List[str] = []
        for op in ops:
            if op.cost_us >= 0:
                continue
            e = self.entries.get(op_cost_key(op))
            if e is None:
                missing.append(op.name)
                continue
            op.cost_us = e.us
            op.pass_rate = e.pass_rate
            op.overhead_us = e.overhead_us
        return missing

    # -- direct calibration ------------------------------------------------
    def calibrate_chain(self, ops: List[Op], frames: np.ndarray,
                        ctx: OpContext, reps: int = 2) -> None:
        """Walk a plan on a sample batch, timing each op on its actual
        input and measuring its survivor fraction; stamps each op in place
        and records the measurement for catalog fallback.

        Each op is timed at two batch sizes and the pair is fit to
        ``T(n) = overhead + marginal·n``: the fixed per-invocation term
        (copies, launches, padding) is what sharing
        amortizes, and folding it into a per-frame average — the old
        estimate — systematically undervalues shared execution on sparse
        streams where few frames reach the expensive ops.

        Ops are timed on *clones* (timing reps mutate stateful ops like
        Skip), but the real chain advances with the original instances so
        downstream ops see realistic inputs."""
        batch = {"frames": frames, "idx": np.arange(frames.shape[0])}
        for op in ops:
            n_in = int(batch["idx"].shape[0])
            if n_in == 0:
                break
            probe = copy.deepcopy(op)
            probe.open(ctx)
            probe.reset()             # validation runs may have left state
            t_full = _time_probe(probe, batch, reps)
            n_small = n_in // 4
            if n_small >= 1 and n_small < n_in:
                small = _copy_batch(batch)
                small["frames"] = batch["frames"][:n_small]
                small["idx"] = batch["idx"][:n_small]
                if "attrs" in batch:
                    small["attrs"] = {k: np.asarray(v)[:n_small]
                                      for k, v in batch["attrs"].items()}
                t_small = _time_probe(probe, small, reps)
                marginal = max(t_full - t_small, 0.0) / (n_in - n_small)
                overhead = max(t_small - marginal * n_small, 0.0)
            else:
                marginal, overhead = t_full / n_in, 0.0
            us = marginal * 1e6
            over_us = overhead * 1e6
            op.open(ctx)
            op.reset()                # a stale skip carry would empty the
            out = op.process(_copy_batch(batch))       # whole sample chain
            out.pop("window_results", None)
            n_out = int(out["idx"].shape[0])
            op.reset()
            op.cost_us = us
            op.overhead_us = over_us
            op.pass_rate = n_out / n_in
            self.record_op(op, us, op.pass_rate, direct=True,
                           overhead_us=over_us)
            if isinstance(op, MLLMExtractOp):
                self.record(mllm_key(op.model, batch["frames"].shape),
                            us, op.pass_rate, direct=True,
                            overhead_us=over_us)
            batch = out

    # -- persistence / reporting -------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.VERSION,
            "entries": {k: dataclasses.asdict(e)
                        for k, e in sorted(self.entries.items())},
            "gate_hit_rates": dict(sorted(self.gate_hit_rates.items())),
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "CostCatalog":
        assert data.get("version") == cls.VERSION, \
            f"cost catalog version {data.get('version')} != {cls.VERSION}"
        cat = cls()
        for k, e in data.get("entries", {}).items():
            cat.entries[k] = CostEntry(**e)
        cat.gate_hit_rates = dict(data.get("gate_hit_rates", {}))
        return cat

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CostCatalog":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def rows(self) -> List[Dict[str, Any]]:
        """Structured rows, one per entry, sorted by key."""
        return [{"op": k, "us": e.us, "pass_rate": e.pass_rate,
                 "overhead_us": e.overhead_us, "n": e.n, "direct": e.direct}
                for k, e in sorted(self.entries.items())]

    def __len__(self) -> int:
        return len(self.entries)


def _copy_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(batch)
    if "attrs" in out:
        out["attrs"] = dict(out["attrs"])
    return out


def _time_probe(probe: Op, batch: Dict[str, Any], reps: int) -> float:
    """Seconds per invocation of ``probe`` on ``batch`` (after an untimed
    warmup invocation that pays one-time set-up such as kernel builds)."""
    probe.process(_copy_batch(batch))
    probe.reset()
    t0 = time.perf_counter()
    for _ in range(reps):
        probe.process(_copy_batch(batch))
        probe.reset()
    return (time.perf_counter() - t0) / reps
