"""Fleet optimizer: joint, sharing-aware super-optimization of a query set.

Counterpart of ``repro/core/fleet.py``.

``SuperOptimizer`` specializes one query to one stream; running it per
query destroys exactly the structure the sharing tier depends on: two
queries that would share a prefix and a union extract come back with
slightly different Crop boxes, different backoff results, a cheap filter
one of them pushed down, or different physical model choices — and
``SharingTreePlanner`` (which groups by ``Op.signature()`` chains and the
extract's merge key) can no longer share anything.  The fleet optimizer
closes that gap: it optimizes the *set* of queries, trading per-query
rewrites against the sharing they would break.

The fleet cost objective
------------------------
For an assignment of one concrete plan per query, the fleet cost is the
estimated per-source-frame cost of executing the whole workload through
the sharing forest the planner would build for it:

    fleet_cost(plans) = Σ_feeds Σ_groups [ cost(shared prefix, once)
                                           + Σ_tails cost(tail) ]
                        − coalescing_saving(forests)

with per-op costs *measured* (the ``CostCatalog`` stamped ``cost_us``) and
selectivity-aware (a filter's measured ``pass_rate`` discounts everything
downstream — the logical optimizer's pushdown gate applied fleet-wide).
The subtracted term is the *server-level* cross-feed interaction
(``scheduler.sharing_tree.coalescing_saving_us``): groups on different
feeds whose extracts land in the same (variant, frame-shape) bucket
coalesce at the ``SharedExtractServer`` into one dispatch instead of k,
so the objective rewards canonical prefixes that keep feeds
bucket-aligned.  A rewrite is accepted only if it lowers this joint
objective: a rewrite that saves 5% on one query but breaks a prefix four
other queries share (or knocks a feed out of a cross-feed bucket) raises
the objective and is rejected.

Procedure
---------
1. **Solo pass** — each query runs the ordinary phase pipeline through the
   common ``OptimizationPhase`` interface, sharing one ``CostCatalog`` so
   every timing (logical micro-benchmarks, semantic/physical validation
   runs, final chain calibration) lands in one measured cost model.
2. **Canonicalization** — per feed, the solo plans' pre-extract chains are
   joined into a canonical prefix with *safe-join* parameters (union crop,
   min skip amount, min downscale factor, …: the least aggressive setting
   any member needed), ops not common to every member dropped (they are
   data-reduction ops; dropping only returns toward naive semantics), and
   the physical model chosen **jointly**: the cheapest variant inside
   every member's accuracy-viable set.  Canonical chains are built from
   one op instance and copied, so semantically-equivalent prefixes keep
   bitwise-identical ``Op.signature()`` chains — the unit the planner
   factors on.  Each member's canonical plan is re-validated against its
   naive accuracy; members that fail the tolerance keep their solo plan.
3. **Assignment** — greedy coordinate descent over {canonical, solo} per
   query, minimizing the fleet cost objective; every accept/reject is
   logged with its cost delta.

The result carries per-query plans whose execution through
``MultiQueryRuntime`` / ``MultiStreamRuntime`` is bitwise identical to
running each chosen plan alone — sharing changes how many forwards run,
never what a query observes.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.costs import CostCatalog, mllm_key
from repro_torch.core.phases import PhaseContext
from repro_torch.core.superopt import OptimizationReport, SuperOptimizer
from repro_torch.streaming.operators import (
    CheapColorFilterOp,
    CropOp,
    DetectOp,
    DownscaleOp,
    FusedPreprocessOp,
    GreyscaleOp,
    MLLMExtractOp,
    Op,
    OpContext,
    SkipOp,
    SourceOp,
)
from repro_torch.streaming.plan import Plan


@dataclasses.dataclass
class FleetQuery:
    """One member of the fleet: a catalog query standing on a feed."""

    query: Any                                # queries.catalog.Query
    stream_factory: Callable[[int], Any]      # seed -> stream
    feed: str = ""                            # defaults to query.dataset

    def __post_init__(self):
        if not self.feed:
            self.feed = self.query.dataset


@dataclasses.dataclass
class FleetResult:
    """Joint optimization output: one stamped plan per query, grouped by
    feed, plus the forests / reports / decision log that justify it."""

    plans: Dict[str, Plan]                    # qid -> chosen plan
    plans_by_feed: Dict[str, List[Plan]]
    #: per-feed SharingForest over the chosen plans
    forests: Dict[str, Any]
    reports: Dict[str, OptimizationReport]    # per-query solo reports
    decisions: List[str]                      # fleet-level accept/reject log
    fleet_cost_us: Dict[str, float]           # naive / solo / fleet totals
    catalog: CostCatalog
    #: the baselines the fleet assignment chose over, calibrated with the
    #: same catalog (benchmarks compare all three without re-optimizing)
    solo_plans: Dict[str, Plan] = dataclasses.field(default_factory=dict)
    naive_plans: Dict[str, Plan] = dataclasses.field(default_factory=dict)
    feed_keys: Dict[str, List[str]] = dataclasses.field(default_factory=dict)

    def audit(self, tolerance: float = 0.5):
        """A ``repro_torch.obs.audit.PlanAudit`` over this result's forests and
        optimization reports — join with a served run's metrics for the
        predicted-vs-measured decision table, or call
        ``verify_predictions()`` to check the stored costs still derive
        from the catalog."""
        from repro_torch.obs.audit import PlanAudit
        return PlanAudit.from_fleet(self, tolerance=tolerance)

    def describe(self) -> str:
        lines = ["=== fleet optimization ==="]
        lines += [f"  {d}" for d in self.decisions]
        lines.append(
            "fleet cost (µs/frame): " + "  ".join(
                f"{k}={v:.0f}" for k, v in self.fleet_cost_us.items()))
        for feed, forest in self.forests.items():
            lines.append(f"[{feed}]")
            lines.append(forest.describe())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# safe-join: the least aggressive parameterization any member needed
# ---------------------------------------------------------------------------

def _union_bbox(regions: List[Tuple[int, int, int, int]]
                ) -> Tuple[int, int, int, int]:
    y0 = min(r[0] for r in regions)
    x0 = min(r[1] for r in regions)
    y1 = max(r[0] + r[2] for r in regions)
    x1 = max(r[1] + r[3] for r in regions)
    return (y0, x0, y1 - y0, x1 - x0)


def _join_skip(ops: List[SkipOp]) -> Optional[SkipOp]:
    if len({o.condition for o in ops}) != 1 or \
            len({o.regions for o in ops}) != 1:
        return None
    rois = [o.roi for o in ops]
    roi = None if any(r is None for r in rois) else _union_bbox(rois)
    return SkipOp(amount=min(o.amount for o in ops),
                  condition=ops[0].condition,
                  threshold=min(o.threshold for o in ops),
                  roi=roi, regions=ops[0].regions)


def _join_cheap_color(ops: List[CheapColorFilterOp]
                      ) -> Optional[CheapColorFilterOp]:
    if len({o.color for o in ops}) != 1:
        return None                     # different predicates never join
    rois = [o.roi for o in ops]
    roi = None if any(r is None for r in rois) else _union_bbox(rois)
    return CheapColorFilterOp(color=ops[0].color,
                              min_frac=min(o.min_frac for o in ops),
                              roi=roi)


def _join_fused(ops: List[FusedPreprocessOp]) -> FusedPreprocessOp:
    return FusedPreprocessOp(crop=_union_bbox([o.crop for o in ops]),
                             factor=min(o.factor for o in ops),
                             grey=all(o.grey for o in ops))


def _join_source(ops: List[SourceOp]) -> Optional[SourceOp]:
    if len({o.stream_name for o in ops}) != 1:
        return None                     # never rebind a query's source
    return SourceOp(stream_name=ops[0].stream_name)


_SAFE_JOIN: Dict[type, Callable[[List[Op]], Optional[Op]]] = {
    SourceOp: _join_source,
    SkipOp: _join_skip,
    CropOp: lambda ops: CropOp(region=_union_bbox([o.region for o in ops])),
    DownscaleOp: lambda ops: DownscaleOp(factor=min(o.factor for o in ops)),
    GreyscaleOp: lambda ops: GreyscaleOp(),
    FusedPreprocessOp: _join_fused,
    CheapColorFilterOp: _join_cheap_color,
    DetectOp: lambda ops: DetectOp(threshold=min(o.threshold for o in ops)),
}


def safe_join(ops: List[Op]) -> Optional[Op]:
    """One op valid for every member, or None when the class cannot join
    (then it is *dropped* from the canonical prefix — every joinable class
    here is a data-reduction op, so dropping is semantics-safe)."""
    cls = type(ops[0])
    if any(type(o) is not cls for o in ops):
        return None
    fn = _SAFE_JOIN.get(cls)
    if fn is not None:
        return fn(ops)
    # unknown class: join only when structurally identical already
    if len({o.signature() for o in ops}) == 1:
        return copy.deepcopy(ops[0])
    return None


def joined_prefix(chains: List[List[Op]]) -> List[Op]:
    """Join N pre-extract chains into one canonical chain: classes present
    in every chain (in the first chain's order, verified consistent) with
    safe-join parameters; everything else dropped."""
    class_sets = [[type(o) for o in ch] for ch in chains]
    common = [cls for cls in class_sets[0]
              if all(cls in cs for cs in class_sets)]
    # order consistency: the common subsequence must be ordered the same in
    # every chain, or the later op's semantics could change (e.g. a crop
    # before vs after a downscale) — drop everything past a violation
    joined: List[Op] = []
    last_pos = [-1] * len(chains)
    for cls in common:
        pos = [cs.index(cls) for cs in class_sets]
        if any(p <= lp for p, lp in zip(pos, last_pos)):
            break
        op = safe_join([ch[p] for ch, p in zip(chains, pos)])
        if op is None:
            continue
        joined.append(op)
        last_pos = pos
    return joined


# ---------------------------------------------------------------------------
# fleet optimizer
# ---------------------------------------------------------------------------

class FleetOptimizer:
    """Jointly optimize a workload of queries over one or more feeds.

    ``planner`` scores candidate assignments (it carries the calibrated
    catalog); ``tolerance`` bounds the accuracy a canonicalized plan may
    lose vs the query's naive accuracy (the same contract the semantic
    phase enforces for its own rewrites)."""

    def __init__(self, ctx: OpContext, tolerance: float = 0.10,
                 min_rel_accuracy: float = 0.90, micro_batch: int = 16,
                 val_frames: int = 256,
                 catalog: Optional[CostCatalog] = None,
                 planner=None,
                 max_rounds: int = 3, rel_margin: float = 0.02,
                 gate_hit_rate: Optional[float] = None):
        # deferred: repro_torch.scheduler <-> repro_torch.core import cycle
        from repro_torch.scheduler.sharing_tree import SharingTreePlanner

        self.ctx = ctx
        self.tolerance = tolerance
        self.val_frames = val_frames
        #: a flip away from the current assignment must beat it by this
        #: relative margin — calibrated costs carry measurement noise, and
        #: breaking a share for a hair-thin estimated win is a bad trade
        self.rel_margin = rel_margin
        self.catalog = catalog if catalog is not None else CostCatalog()
        self.solo = SuperOptimizer(ctx, tolerance=tolerance,
                                   min_rel_accuracy=min_rel_accuracy,
                                   micro_batch=micro_batch,
                                   val_frames=val_frames,
                                   catalog=self.catalog)
        # gated plans pay the model only for the novel fraction of their
        # frames: the planner discounts extract costs by the measured
        # semantic-cache hit rate (catalog.gate_hit_rates, or an explicit
        # override), so assignments are priced for the serving tier as it
        # actually runs — sharing that only paid off at full model load
        # is correctly dropped once gating absorbs most of it
        self.planner = planner if planner is not None \
            else SharingTreePlanner(catalog=self.catalog,
                                    micro_batch=micro_batch,
                                    gate_hit_rate=gate_hit_rate)
        self.max_rounds = max_rounds

    # ------------------------------------------------------------------
    def optimize(self, workload: List[FleetQuery],
                 phases: Tuple[str, ...] = ("semantic", "logical",
                                            "physical")) -> FleetResult:
        assert workload, "empty fleet"
        keys = self._keys(workload)
        by_feed: Dict[str, List[str]] = {}
        fq_of: Dict[str, FleetQuery] = {}
        for key, fq in zip(keys, workload):
            by_feed.setdefault(fq.feed, []).append(key)
            fq_of[key] = fq

        decisions: List[str] = []

        # (1) solo pass — per-query phase pipeline, one shared catalog
        solo_plans: Dict[str, Plan] = {}
        reports: Dict[str, OptimizationReport] = {}
        naive_plans: Dict[str, Plan] = {}
        for key in keys:
            fq = fq_of[key]
            plan, report = self.solo.optimize(fq.query, fq.stream_factory,
                                              phases=phases)
            plan.query = key
            solo_plans[key], reports[key] = plan, report
            naive = fq.query.naive_plan()
            naive.query = key
            self._calibrate(naive, fq)
            naive_plans[key] = naive

        # (2) canonicalization per feed
        canonical: Dict[str, Plan] = {}
        for feed, fkeys in by_feed.items():
            canonical.update(self._canonicalize(
                feed, fkeys, fq_of, solo_plans, reports, decisions))

        # (3) assignment by fleet cost: greedy coordinate descent.  A flip
        # re-plans exactly one feed's forest, but the objective is *not*
        # per-feed additive: the server-level coalescing term rewards
        # bucket alignment across feeds, so every candidate is scored over
        # the full forest set (the cross-feed term itself is cheap).
        choice: Dict[str, str] = {
            key: ("fleet" if key in canonical else "solo") for key in keys}

        def feed_plans(feed: str, ch: Dict[str, str]) -> List[Plan]:
            return [canonical[k] if ch[k] == "fleet" else solo_plans[k]
                    for k in by_feed[feed]]

        forests = {feed: self.planner.plan(feed_plans(feed, choice))
                   for feed in by_feed}
        base_cost = self._forests_cost(forests)
        for rnd in range(self.max_rounds):
            changed = False
            for key in keys:
                if key not in canonical:
                    continue
                feed = fq_of[key].feed
                flipped = dict(choice)
                flipped[key] = "solo" if choice[key] == "fleet" else "fleet"
                alt_forests = dict(forests)
                alt_forests[feed] = self.planner.plan(
                    feed_plans(feed, flipped))
                alt_cost = self._forests_cost(alt_forests)
                if alt_cost < base_cost * (1.0 - self.rel_margin):
                    decisions.append(
                        f"{key}: {flipped[key]} plan accepted "
                        f"(fleet cost {base_cost:.0f} -> {alt_cost:.0f}"
                        "µs/frame)")
                    choice, base_cost, changed = flipped, alt_cost, True
                    forests = alt_forests
                elif rnd == 0 and choice[key] == "fleet":
                    partners = [k for k in by_feed[feed] if k != key]
                    decisions.append(
                        f"{key}: per-query rewrite rejected — fleet cost "
                        f"{base_cost:.0f} -> {alt_cost:.0f}µs/frame "
                        f"(breaks sharing with "
                        f"{{{','.join(partners) or '-'}}})")
            if not changed:
                break

        save = self._coalescing_saving(forests)
        if save > 0:
            decisions.append(
                f"cross-feed bucket alignment: {save:.0f}µs/frame server "
                "coalescing saving across the chosen forests")

        plans = {key: (canonical[key] if choice[key] == "fleet"
                       else solo_plans[key]) for key in keys}
        plans_by_feed = {feed: [plans[k] for k in fkeys]
                         for feed, fkeys in by_feed.items()}
        costs = {
            "naive": self._fleet_cost(
                {f: [naive_plans[k] for k in ks]
                 for f, ks in by_feed.items()}),
            "solo": self._fleet_cost(
                {f: [solo_plans[k] for k in ks]
                 for f, ks in by_feed.items()}),
            "fleet": base_cost,
        }
        return FleetResult(plans=plans, plans_by_feed=plans_by_feed,
                           forests=forests, reports=reports,
                           decisions=decisions, fleet_cost_us=costs,
                           catalog=self.catalog, solo_plans=solo_plans,
                           naive_plans=naive_plans, feed_keys=dict(by_feed))

    # ------------------------------------------------------------------
    @staticmethod
    def _keys(workload: List[FleetQuery]) -> List[str]:
        seen: Dict[str, int] = {}
        keys = []
        for fq in workload:
            qid = fq.query.qid
            if qid in seen:
                keys.append(f"{fq.feed}:{qid}")
            else:
                keys.append(qid)
            seen[qid] = seen.get(qid, 0) + 1
        assert len(set(keys)) == len(keys), f"duplicate fleet keys {keys}"
        return keys

    def _calibrate(self, plan: Plan, fq: FleetQuery) -> None:
        pctx = PhaseContext(query=fq.query, stream_factory=fq.stream_factory,
                            run_fn=self.solo._run,
                            val_frames=self.val_frames,
                            catalog=self.catalog)
        self.catalog.calibrate_chain(plan.ops, pctx.sample_frames(),
                                     self.ctx)
        self.catalog.stamp(plan.ops)

    def _model_cost(self, variant: str) -> float:
        from repro_torch.scheduler.sharing_tree import MODEL_COST_US

        us = self.catalog.lookup(mllm_key(variant))
        return us if us is not None \
            else MODEL_COST_US.get(variant, MODEL_COST_US["big"])

    def _viable_models(self, key: str, plan: Plan,
                       reports: Dict[str, OptimizationReport]) -> List[str]:
        for ph in reports[key].phases:
            sel = ph.get("model_selection")
            if sel is not None:
                return list(sel.get("viable", [sel["chosen"]]))
        mi = plan.index_of(MLLMExtractOp)
        return [plan.ops[mi].model] if mi is not None else []

    # ------------------------------------------------------------------
    def _canonicalize(self, feed: str, fkeys: List[str],
                      fq_of: Dict[str, FleetQuery],
                      solo_plans: Dict[str, Plan],
                      reports: Dict[str, OptimizationReport],
                      decisions: List[str]) -> Dict[str, Plan]:
        """Build the canonical (shareable) candidate per member of one
        feed; members whose canonical plan fails validation keep solo."""
        members = [k for k in fkeys
                   if solo_plans[k].index_of(MLLMExtractOp) is not None]
        if len(members) < 2:
            return {}
        # a feed is one physical stream; a workload that labels two
        # different sources with the same feed string cannot canonicalize
        # (the join would silently rebind a query's source)
        if len({solo_plans[k].ops[0].stream_name for k in members}) != 1:
            decisions.append(
                f"{feed}: canonicalization skipped — members read "
                "different source streams")
            return {}
        mis = {k: solo_plans[k].index_of(MLLMExtractOp) for k in members}

        def expand(ops):
            # class-intersection joining reasons about the unfused op
            # descriptors; a physically fused prefix re-expands here so
            # fusion never blocks cross-query sharing (the runtimes
            # re-fuse per group where calibration still favors it)
            out = []
            for op in ops:
                stage_ops = getattr(op, "unfuse", None)
                out.extend(op.unfuse() if stage_ops is not None else [op])
            return out

        chains = [expand(solo_plans[k].ops[:mis[k]]) for k in members]
        joined = joined_prefix(chains)

        # joint physical model: cheapest variant viable for every member
        viable_all = None
        for k in members:
            v = set(self._viable_models(k, solo_plans[k], reports))
            viable_all = v if viable_all is None else viable_all & v
        variant = min(viable_all, key=self._model_cost) if viable_all \
            else "big"
        dt = min(solo_plans[k].ops[mis[k]].density_threshold
                 for k in members)
        decisions.append(
            f"{feed}: canonical prefix "
            f"[{' -> '.join(op.name for op in joined)}] + mllm[{variant}] "
            f"for {{{','.join(members)}}}")

        out: Dict[str, Plan] = {}
        for k in members:
            fq = fq_of[k]
            solo_ex = solo_plans[k].ops[mis[k]]
            ops = [copy.deepcopy(op) for op in joined]
            ops.append(MLLMExtractOp(tasks=solo_ex.tasks, model=variant,
                                     density_threshold=dt))
            ops.extend(copy.deepcopy(op)
                       for op in solo_plans[k].ops[mis[k] + 1:])
            cand = Plan(ops, query=k,
                        notes=list(solo_plans[k].notes)
                        + ["fleet: canonicalized prefix"])
            # re-validate: canonical must stay within tolerance of naive
            naive_acc = self._naive_accuracy(k, fq, reports)
            res = self.solo._run(cand, fq.stream_factory(202),
                                 self.val_frames)
            acc = fq.query.evaluate(res)
            self.catalog.record_run(cand.ops, res.wall_s, res.mllm_frames)
            if acc < naive_acc - self.tolerance:
                decisions.append(
                    f"{k}: canonical plan rejected by validation "
                    f"(acc {acc:.3f} < naive {naive_acc:.3f} - "
                    f"{self.tolerance:.2f}) — keeps solo plan")
                continue
            self._calibrate(cand, fq)
            out[k] = cand
        return out

    def _naive_accuracy(self, key: str, fq: FleetQuery,
                        reports: Dict[str, OptimizationReport]) -> float:
        for ph in reports[key].phases:
            if "naive_accuracy" in ph:
                return ph["naive_accuracy"]
        res = self.solo._run(fq.query.naive_plan(), fq.stream_factory(202),
                             self.val_frames)
        return fq.query.evaluate(res)

    # ------------------------------------------------------------------
    def _coalescing_saving(self, forests: Dict[str, Any]) -> float:
        from repro_torch.scheduler.sharing_tree import coalescing_saving_us

        return coalescing_saving_us(
            forests.values(), self.catalog,
            micro_batch=getattr(self.planner, "micro_batch", 16),
            frame_shape=self.ctx.frame_shape)

    def _forests_cost(self, forests: Dict[str, Any]) -> float:
        """The joint objective over a forest per feed: summed per-feed
        shared costs minus the server-level cross-feed coalescing saving
        (groups on different feeds landing in the same (variant, shape)
        bucket pay one extract dispatch, not k)."""
        per_feed = sum(g.shared_cost_us
                       for f in forests.values() for g in f.groups())
        return per_feed - self._coalescing_saving(forests)

    def _fleet_cost(self, plans_by_feed: Dict[str, List[Plan]]) -> float:
        """The joint objective for an assignment: per-source-frame cost of
        the sharing forests the planner would build for it, including the
        cross-feed server term.  The planner never mutates submitted plans
        (factor_plans clones), so assignments are scored without copying
        model-bearing ops."""
        return self._forests_cost({feed: self.planner.plan(plans)
                                   for feed, plans in plans_by_feed.items()})
