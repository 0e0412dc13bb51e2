"""Cost-based sharing-tree planner over multi-query (and multi-stream)
plan sets.

Counterpart of ``repro/scheduler/sharing_tree.py`` (model-free: it prices
descriptors and never touches a device).

``repro_torch.core.multiquery.factor_plans`` factors the single longest
common prefix across *all* submitted plans: right when every query runs
the same preprocessing on the same stream, useless when one plan carries a
``Skip`` the others lack, or when the workload mixes streams (the global
common prefix is then empty).  This planner builds a sharing *tree*:

    stream                        (root: one branch per source stream)
    ├─ <signature prefix A> ──  group {Q5', Q6'}   shared (Δcost > 0)
    └─ <signature prefix B> ──  group {Q2, Q8}     shared (union extract)

Plans are grouped by ``core.multiquery.share_key`` (the ``Op.signature()``
chain of every op before the first MLLM extract plus the extract's
physical merge key), so each group factors through a *merged union-task*
extract.  A per-frame cost estimate then chooses, per group, between
shared and independent execution: groups whose estimated saving does not
clear ``min_saving_us`` are split back into independent singletons.

The estimate prefers *measured* costs: an op stamped by the calibration
pass (``repro_torch.core.costs.CostCatalog``) carries its measured
``cost_us`` and ``pass_rate``; an unstamped op falls back to the catalog's
per-class (or per-MLLM-variant) aggregate, then to the static defaults
below.  Chain cost is selectivity-aware: a filter's measured pass rate
discounts every downstream op.

``extract_bucket`` / ``coalescing_saving_us`` model the server-level
cross-feed term: groups (on any feed) whose extracts land in the same
(variant, frame-shape) bucket coalesce at the ``SharedExtractServer`` into
fewer, fuller forwards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.multiquery import (SharedExecution, factor_plans,
                                         share_key)
from repro_torch.streaming.operators import (
    CropOp,
    DownscaleOp,
    FusedPreprocessOp,
    MLLMExtractOp,
    Op,
    SourceOp,
)
from repro_torch.streaming.plan import Plan

#: static per-frame cost defaults (µs) when an op carries no calibrated
#: ``cost_us`` and no catalog entry covers it — relative magnitudes matter,
#: not absolutes: extracts are orders of magnitude above the cheap
#: semantic/relational ops
MODEL_COST_US: Dict[str, float] = {
    "big": 1200.0,
    "small": 220.0,
    "pruned": 600.0,
    "adaptive": 900.0,
}

OP_COST_US: Dict[str, float] = {
    "SourceOp": 0.0,
    "SinkOp": 1.0,
    "SkipOp": 30.0,
    "CropOp": 5.0,
    "DownscaleOp": 20.0,
    "GreyscaleOp": 15.0,
    "FusedPreprocessOp": 40.0,
    "CheapColorFilterOp": 60.0,
    "DetectOp": 400.0,
    # one device pass for a whole fusable prefix — cheaper than the sum
    # of its members' dispatches but above any single cheap stage; the
    # physical phase always calibrates before fusing, so this static
    # fallback only prices plans fused outside the optimizer
    "FusedPrefixOp": 90.0,
    "FilterOp": 5.0,
    "WindowAggOp": 10.0,
}


def op_cost_us(op: Op, catalog=None) -> float:
    """Estimated per-input-frame cost (µs).

    Resolution order: the op's own stamped measurement (``cost_us >= 0`` —
    zero is a real measurement for a free op, only *negative* means
    uncalibrated), then the calibration catalog's per-class / per-variant
    aggregate, then the static default for the op class."""
    if op.cost_us >= 0:
        return op.cost_us
    if catalog is not None:
        us = catalog.lookup_op(op)
        if us is not None:
            return us
    if isinstance(op, MLLMExtractOp):
        return MODEL_COST_US.get(op.model, MODEL_COST_US["big"])
    return OP_COST_US.get(type(op).__name__, 10.0)


def op_overhead_us(op: Op, catalog=None) -> float:
    """Calibrated fixed per-invocation cost (0.0 when never measured)."""
    if op.cost_us >= 0:                 # stamped together with cost_us
        return op.overhead_us
    if catalog is not None:
        over = catalog.lookup_op_overhead(op)
        if over is not None:
            return over
    return 0.0


def op_pass_rate(op: Op, catalog=None) -> float:
    """Calibrated survivor fraction, clamped to [0, 1]: the op's stamped
    measurement, else the catalog's per-class aggregate, else 1.0."""
    rate = op.pass_rate
    if op.cost_us < 0 and catalog is not None:
        e = catalog.entries.get(catalog.key_of(op))
        if e is not None:
            rate = e.pass_rate
    return min(max(rate, 0.0), 1.0)


def chain_reach(ops: List[Op], catalog=None) -> float:
    """Fraction of chain-entry frames surviving the whole chain (the
    product of calibrated pass rates)."""
    reach = 1.0
    for op in ops:
        reach *= op_pass_rate(op, catalog)
    return reach


def chain_cost_us(ops: List[Op], catalog=None, micro_batch: int = 16,
                  reach: float = 1.0, gate_hit_rate: float = 0.0) -> float:
    """Per-source-frame cost of a chain, selectivity- and overhead-aware.

    Each op's *marginal* cost is weighted by the fraction of source frames
    that actually reach it (the product of upstream calibrated pass
    rates; ``reach`` seeds the product — pass the prefix's survivor
    fraction when costing a tail that runs behind a shared prefix), and
    its *fixed* per-invocation cost is amortized over the micro-batch:
    with ``m = reach · micro_batch`` expected surviving frames per batch,
    the op is invoked ``min(1, m)`` times per batch — an op starved by
    upstream filters still pays its dispatch whenever any frame arrives,
    which is precisely the term a shared prefix (paid once) amortizes
    over its member queries (paid k times solo).

    ``gate_hit_rate`` is the semantic tier's measured temporal-redundancy
    hit rate (``CostCatalog.gate_hit_rates``): that fraction of frames
    reaching an MLLM extract is answered from the keyframe cache instead
    of paying the model's marginal cost, so the extract's per-frame term
    scales by ``1 − hit_rate``.  The extract's *fixed* dispatch overhead
    is still paid (a batch with any novel row still launches a forward),
    which keeps the coalescing and sharing terms honest under gating."""
    total = 0.0
    discount = 1.0 - min(max(gate_hit_rate, 0.0), 1.0)
    for op in ops:
        us = op_cost_us(op, catalog)
        if discount < 1.0 and isinstance(op, MLLMExtractOp):
            us *= discount
        total += reach * us
        over = op_overhead_us(op, catalog)
        if over > 0.0:
            m = reach * micro_batch
            total += over * min(1.0, m) / micro_batch
        reach *= op_pass_rate(op, catalog)
    return total


#: static fallback for an extract's fixed per-invocation dispatch cost
#: when neither the op nor the catalog carries a calibrated overhead —
#: used only by the fleet-level coalescing term below
EXTRACT_DISPATCH_US = 150.0


def extract_bucket(prefix: List[Op],
                   frame_shape: Tuple[int, int, int] = (3, 128, 256)
                   ) -> Optional[Tuple[str, Tuple[int, int, int]]]:
    """The ``SharedExtractServer`` coalescing bucket this chain's first
    extract lands in — ``(model variant, (C, H, W) at the extract)`` — or
    None when the chain has no extract.

    Tracks the shape transforms the pre-extract ops apply to the feed's
    frames (Crop / Downscale / FusedPreprocess; Greyscale keeps three
    channels).  Sharing groups — possibly on *different* feeds — whose
    buckets are equal coalesce into the same padded forwards at the
    server, so aligning buckets across feeds is worth money.

    ``model="adaptive"`` resolves to big/pruned per batch from the op's
    runtime density EMA, so its bucket cannot be known statically: such
    chains return None (no coalescing credit — the conservative score,
    never rewarding a share the server might not realize)."""
    c, h, w = frame_shape
    ops = []
    for op in prefix:
        # a fused prefix transforms frames exactly like its members:
        # expand it so the bucket shape math stays in one place
        stage_ops = getattr(op, "stage_ops", None)
        if stage_ops is not None:
            ops.extend(stage_ops)
        else:
            ops.append(op)
    for op in ops:
        if isinstance(op, MLLMExtractOp):
            if op.model == "adaptive":
                return None
            return (op.model, (c, h, w))
        if isinstance(op, CropOp):
            h, w = op.region[2], op.region[3]
        elif isinstance(op, DownscaleOp):
            h, w = h // op.factor, w // op.factor
        elif isinstance(op, FusedPreprocessOp):
            h, w = op.crop[2] // op.factor, op.crop[3] // op.factor
    return None


def coalescing_saving_us(forests, catalog=None, micro_batch: int = 16,
                         frame_shape: Tuple[int, int, int] = (3, 128, 256)
                         ) -> float:
    """Fleet-level server term: estimated per-source-frame saving from
    cross-feed bucket alignment.

    Sharing groups whose extracts land in the same (variant, frame-shape)
    bucket coalesce at the ``SharedExtractServer`` into fewer, fuller
    forwards: of k aligned groups, k−1 stop paying the extract's fixed
    per-invocation dispatch cost (the cheapest k−1 — the most expensive
    member's dispatch is the one actually paid).  The per-group term
    mirrors ``chain_cost_us``'s overhead amortization
    (``over · min(1, reach·micro_batch) / micro_batch``), so subtracting
    this saving from the summed per-feed forest costs keeps the fleet
    objective commensurable.  ``forests`` is any iterable of
    ``SharingForest``s (typically one per feed)."""
    buckets: Dict[Tuple, List[float]] = {}
    for forest in forests:
        for g in forest.groups():
            prefix = g.execution.prefix
            key = extract_bucket(prefix, frame_shape)
            if key is None:
                continue
            mi = next(i for i, op in enumerate(prefix)
                      if isinstance(op, MLLMExtractOp))
            over = op_overhead_us(prefix[mi], catalog)
            if over <= 0.0:
                over = EXTRACT_DISPATCH_US
            m = chain_reach(prefix[:mi], catalog) * micro_batch
            buckets.setdefault(key, []).append(
                over * min(1.0, m) / micro_batch)
    saving = 0.0
    for terms in buckets.values():
        if len(terms) > 1:
            saving += sum(terms) - max(terms)
    return saving


def uncalibrated(ops: List[Op]) -> List[str]:
    """Names of ops in the chain that would fall back to a static default
    (no stamped measurement) — the acceptance check that planned costs are
    measured end to end."""
    return [op.name for op in ops if op.cost_us < 0]


@dataclasses.dataclass
class SharingGroup:
    """One leaf of the sharing tree: a factored multi-query execution plus
    the cost estimate that justified (or rejected) sharing it."""

    execution: SharedExecution
    #: estimated per-frame cost of the shared execution (prefix once +
    #: every tail) vs running each member plan independently
    shared_cost_us: float
    indep_cost_us: float

    @property
    def n_queries(self) -> int:
        return len(self.execution.queries)

    @property
    def saving_us(self) -> float:
        return self.indep_cost_us - self.shared_cost_us

    @property
    def is_shared(self) -> bool:
        return self.n_queries > 1

    @property
    def failure_domain(self) -> List[str]:
        """The queries that lose answers together when this group's
        shared prefix faults: sharing trades isolation for model load,
        so every member query is one failure domain.  (Across groups the
        blast radius stays per-feed — the circuit breaker quarantines
        one feed, never the fleet.)"""
        return list(self.execution.queries)


@dataclasses.dataclass
class SharingForest:
    """The planner's output: per-stream lists of sharing groups (the tree:
    stream root -> signature-prefix branch -> group leaf)."""

    streams: Dict[str, List[SharingGroup]]
    notes: List[str] = dataclasses.field(default_factory=list)

    def groups(self) -> List[SharingGroup]:
        return [g for gs in self.streams.values() for g in gs]

    @property
    def n_queries(self) -> int:
        return sum(g.n_queries for g in self.groups())

    def describe(self) -> str:
        lines: List[str] = []
        for stream, groups in self.streams.items():
            lines.append(stream)
            for i, g in enumerate(groups):
                elbow = "└─" if i == len(groups) - 1 else "├─"
                head = " -> ".join(op.name for op in g.execution.prefix)
                qs = ",".join(g.execution.queries)
                tag = (f"shared Δ{g.saving_us:.0f}µs/frame"
                       if g.is_shared else "independent")
                dom = (f" domain={len(g.failure_domain)}q"
                       if g.is_shared else "")
                lines.append(f"  {elbow} {head}  {{{qs}}}  [{tag}]{dom}")
        return "\n".join(lines)


class SharingTreePlanner:
    """Group N plans (possibly over several streams) into a sharing forest.

    ``min_saving_us`` is the sharing threshold: a candidate group is kept
    shared only if its estimated per-frame saving strictly exceeds it —
    raise it to bias toward independent execution (e.g. when per-query
    isolation matters more than model load).  ``catalog`` (a
    ``repro_torch.core.costs.CostCatalog``) supplies calibrated fallback costs
    for ops the optimizer has not stamped individually.

    ``gate_hit_rate`` prices the semantic gating tier into every share
    decision: with a fraction of extract frames answered from the
    keyframe cache, the model-load saving that justifies sharing shrinks
    by the same fraction on both sides of the comparison — a share that
    only paid off because of the full extract cost is correctly refused
    once gating absorbs most of that cost.  Defaults to the catalog's
    measured mean when a catalog is supplied (0 with no measurements)."""

    def __init__(self, min_saving_us: float = 0.0, catalog=None,
                 micro_batch: int = 16,
                 gate_hit_rate: Optional[float] = None):
        self.min_saving_us = min_saving_us
        self.catalog = catalog
        self.micro_batch = micro_batch
        self._gate_hit_rate = gate_hit_rate

    @property
    def gate_hit_rate(self) -> float:
        """Explicit override, else the catalog's measured mean (resolved
        lazily — gated runs record their rates after the planner is
        built)."""
        if self._gate_hit_rate is not None:
            return self._gate_hit_rate
        if self.catalog is not None and \
                hasattr(self.catalog, "mean_gate_hit_rate"):
            return self.catalog.mean_gate_hit_rate()
        return 0.0

    # ------------------------------------------------------------------
    def _group(self, plans: List[Plan]) -> SharingGroup:
        exe = factor_plans(plans)
        # the merged union extract inherits the column's calibration (same
        # variant, same input: the union forward costs what any one did)
        for i, op in enumerate(exe.prefix):
            if isinstance(op, MLLMExtractOp) and op.cost_us < 0:
                donors = [p.ops[i] for p in plans if i < len(p.ops)
                          and isinstance(p.ops[i], MLLMExtractOp)
                          and p.ops[i].cost_us >= 0]
                if donors:
                    op.cost_us = max(d.cost_us for d in donors)
                    op.pass_rate = max(d.pass_rate for d in donors)
                    op.overhead_us = max(d.overhead_us for d in donors)
        # tails execute behind the prefix: cost them at the prefix's
        # survivor fraction, exactly as the independent side discounts the
        # same ops through its own leading chain — an asymmetry here would
        # misprice every share the min_saving_us gate decides on
        p_reach = chain_reach(exe.prefix, self.catalog)
        h = self.gate_hit_rate
        shared = chain_cost_us(exe.prefix, self.catalog, self.micro_batch,
                               gate_hit_rate=h) \
            + sum(chain_cost_us(tail, self.catalog, self.micro_batch,
                                reach=p_reach, gate_hit_rate=h)
                  for tail in exe.tails)
        indep = sum(chain_cost_us(p.ops, self.catalog, self.micro_batch,
                                  gate_hit_rate=h)
                    for p in plans)
        return SharingGroup(execution=exe, shared_cost_us=shared,
                            indep_cost_us=indep)

    def plan(self, plans: List[Plan]) -> SharingForest:
        assert plans, "need at least one plan"
        for p in plans:
            assert isinstance(p.ops[0], SourceOp), \
                f"plan {p.query!r} does not start at a Source"

        by_stream: Dict[str, List[Plan]] = {}
        for p in plans:
            by_stream.setdefault(p.ops[0].stream_name, []).append(p)

        notes: List[str] = []
        if len(by_stream) > 1:
            notes.append(
                f"{len(by_stream)} source streams -> global common prefix "
                "is empty; sharing within per-stream subsets only")

        streams: Dict[str, List[SharingGroup]] = {}
        for stream, splans in by_stream.items():
            candidates: Dict[Tuple, List[Plan]] = {}
            for p in splans:
                candidates.setdefault(share_key(p), []).append(p)
            groups: List[SharingGroup] = []
            for key, members in candidates.items():
                if len(members) == 1:
                    groups.append(self._group(members))
                    continue
                g = self._group(members)
                if g.saving_us > self.min_saving_us:
                    groups.append(g)
                    notes.append(
                        f"{stream}: share {{{','.join(g.execution.queries)}}}"
                        f" (Δ{g.saving_us:.0f}µs/frame)")
                else:
                    notes.append(
                        f"{stream}: sharing {{{','.join(p.query or '?' for p in members)}}}"
                        f" saves only {g.saving_us:.0f}µs/frame "
                        f"<= {self.min_saving_us:.0f} -> independent")
                    groups.extend(self._group([m]) for m in members)
            # deterministic order: largest sharing opportunity first
            groups.sort(key=lambda g: (-g.n_queries, g.execution.queries))
            streams[stream] = groups
        forest = SharingForest(streams=streams, notes=notes)
        forest.notes.append(
            f"{forest.n_queries} queries -> "
            f"{len(forest.groups())} execution groups over "
            f"{len(streams)} stream(s)")
        return forest
