"""Plan IR: an ordered operator chain + metadata the optimizer rewrites."""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.streaming.operators import Op, SinkOp, SourceOp


@dataclasses.dataclass
class Plan:
    ops: List[Op]
    query: str = ""
    notes: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        assert isinstance(self.ops[0], SourceOp), "plan starts with Source"
        assert isinstance(self.ops[-1], SinkOp), "plan ends with Sink"

    # -- rewriting helpers ---------------------------------------------------
    def clone(self) -> "Plan":
        return Plan([copy.deepcopy(o) for o in self.ops], self.query,
                    list(self.notes))

    def index_of(self, cls) -> Optional[int]:
        for i, op in enumerate(self.ops):
            if isinstance(op, cls):
                return i
        return None

    def insert_before(self, cls, op: Op, note: str = "") -> "Plan":
        i = self.index_of(cls)
        assert i is not None, f"no {cls.__name__} in plan"
        self.ops.insert(i, op)
        if note:
            self.notes.append(note)
        return self

    def insert_after_source(self, op: Op, note: str = "") -> "Plan":
        self.ops.insert(1, op)
        if note:
            self.notes.append(note)
        return self

    def remove(self, op: Op) -> "Plan":
        self.ops.remove(op)
        return self

    # -- shared-execution helpers --------------------------------------------
    def split_at(self, i: int) -> Tuple[List[Op], List[Op]]:
        """Split the chain into (prefix ops[:i], suffix ops[i:])."""
        assert 0 <= i <= len(self.ops)
        return list(self.ops[:i]), list(self.ops[i:])

    def common_prefix(self, other: "Plan") -> int:
        """Length of the longest structurally-identical leading op chain
        shared with ``other`` (never absorbs a Sink — the tail stays
        per-query even for identical plans)."""
        n = 0
        for a, b in zip(self.ops, other.ops):
            if isinstance(a, SinkOp) or isinstance(b, SinkOp):
                break
            if a.signature() != b.signature():
                break
            n += 1
        return n

    def describe(self) -> str:
        return " -> ".join(op.name for op in self.ops)
