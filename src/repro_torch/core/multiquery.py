"""Multi-query planner pass: factor N plans over one stream into a shared
prefix + per-query tails.

Counterpart of ``repro/core/multiquery.py``.

The paper's throughput lever is MLLM model load; serving many concurrent
queries over the same stream multiplies that load N× unless the executor
shares work.  This pass takes N Plans whose sources name the same stream,
walks their operator chains in lockstep, and factors out the longest common
prefix:

  * structurally identical ops (Skip / Crop / FusedPreprocess / cheap
    filters — compared by ``Op.signature()``, i.e. class + init params,
    never runtime state) are kept once;
  * a column of ``MLLMExtractOp``s with the same physical model merges into
    a *single* op extracting the union of the requested tasks — one batched
    forward per surviving frame instead of one per query (StreamMLLM
    computes every head in one pass, so the union costs the same forward
    and each query reads exactly the attributes it asked for);
  * factoring stops at the first structural divergence, and never absorbs a
    Sink — the relational tail (Filter / WindowAgg / Sink) stays per-query.

The result is executed by
``repro_torch.streaming.multiquery.MultiQueryRuntime``, which fans each
annotated shared batch out to the per-query tails.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.streaming.mllm import MLLM_TASKS
from repro_torch.streaming.operators import (MLLMExtractOp, Op, SinkOp,
                                             SourceOp)
from repro_torch.streaming.plan import Plan


@dataclasses.dataclass
class SharedExecution:
    """A factored multi-query execution: one prefix chain, N tail chains."""

    prefix: List[Op]                 # Source ... (maybe merged MLLM ...)
    tails: List[List[Op]]            # per-query suffix, each ends in a Sink
    queries: List[str]               # query ids, parallel to ``tails``
    notes: List[str] = dataclasses.field(default_factory=list)

    def describe(self) -> str:
        head = " -> ".join(op.name for op in self.prefix)
        lines = [f"shared: {head}"]
        for qid, tail in zip(self.queries, self.tails):
            lines.append(f"  {qid}: ... -> " +
                         " -> ".join(op.name for op in tail))
        return "\n".join(lines)


def mllm_merge_key(op: MLLMExtractOp) -> Tuple:
    """Physical identity of an extract op *modulo its task set*: two
    extracts with the same merge key run the same backbone variant and can
    therefore collapse into one union-task forward."""
    return (op.model, op.density_threshold)


def merge_mllm_column(ops: List[Op]) -> Optional[MLLMExtractOp]:
    """Merge one MLLMExtractOp per plan into a union-task op, or None if the
    column is not uniformly the same physical MLLM configuration."""
    if not all(isinstance(o, MLLMExtractOp) for o in ops):
        return None
    keys = {mllm_merge_key(o) for o in ops}
    if len(keys) != 1:
        return None
    union = tuple(t for t in MLLM_TASKS
                  if any(t in o.tasks for o in ops))
    model, threshold = keys.pop()
    return MLLMExtractOp(tasks=union, model=model,
                         density_threshold=threshold)


def share_key(plan: Plan) -> Tuple:
    """Grouping key for the sharing-tree planner: the signature chain of
    every op before the first MLLM extract, plus that extract's merge key.

    Plans with equal share keys factor into one group whose prefix reaches
    *through* a merged union-task extract (the expensive op); plans with
    different keys would stop factoring at the first structural divergence
    anyway, so grouping by this key is exactly "share where it pays".
    Plans without an MLLM get ``(pre-sink signature chain, None)``, so
    pure relational plans only share if structurally identical up to the
    sink."""
    pre: List[Tuple] = []
    for op in plan.ops:
        if isinstance(op, MLLMExtractOp):
            return (tuple(pre), mllm_merge_key(op))
        if isinstance(op, SinkOp):
            break
        pre.append(op.signature())
    return (tuple(pre), None)


def factor_plans(plans: List[Plan]) -> SharedExecution:
    """Factor N single-stream plans into a SharedExecution."""
    assert plans, "need at least one plan"
    sources = {p.ops[0].stream_name for p in plans
               if isinstance(p.ops[0], SourceOp)}
    assert len(sources) == 1, \
        f"multi-query sharing needs one common stream, got {sources}"

    clones = [p.clone() for p in plans]     # never alias caller op state
    notes: List[str] = []
    max_depth = min(len(p.ops) for p in clones) - 1   # keep every Sink
    # the structurally-identical leading segment comes from the Plan API
    # (equality is transitive, so the N-way prefix is the pairwise minimum)
    depth = min([clones[0].common_prefix(p) for p in clones[1:]],
                default=max_depth)
    prefix, _ = clones[0].split_at(depth)
    # past the identical segment: columns may still merge (union-task MLLM),
    # and a merge can re-open identical sharing behind it
    while depth < max_depth:
        column = [p.ops[depth] for p in clones]
        if any(isinstance(o, SinkOp) for o in column):
            break
        if len({o.signature() for o in column}) == 1:
            prefix.append(column[0])
            depth += 1
            continue
        merged = merge_mllm_column(column)
        if merged is None:
            break
        prefix.append(merged)
        notes.append(
            f"merged {len(column)} MLLM extracts -> union tasks "
            f"{','.join(merged.tasks)} ({merged.model})")
        depth += 1
    assert depth >= 1, "plans share no source — nothing to factor"

    tails = [p.split_at(depth)[1] for p in clones]
    # per-query results are keyed by id — duplicate submissions of the same
    # query must not collapse onto one key, so disambiguate repeats
    queries: List[str] = []
    used: set = set()
    for i, p in enumerate(plans):
        qid = p.query or f"q{i}"
        if qid in used:
            k = 1
            while f"{qid}#{k}" in used:
                k += 1
            qid = f"{qid}#{k}"
        used.add(qid)
        queries.append(qid)
    notes.append(f"shared prefix depth {depth} across {len(plans)} queries")
    return SharedExecution(prefix=prefix, tails=tails, queries=queries,
                           notes=notes)
