"""GPipe-style pipeline parallelism over a mesh axis (the "pod" axis).

Counterpart of ``repro/distribution/pipeline.py``.  Each rank of the
mesh's pipeline axis holds one stage's parameters and runs in its own
process under the process group (the reference's ``shard_map`` body is
here simply the code every rank runs).  Micro-batches stream through a
loop of M + S - 1 ticks (S stages, M micro-batches): at each tick a rank
runs its stage on its current micro-batch, then sends the activation to
the next rank and receives the previous rank's (``batch_isend_irecv``,
the reference's ``ppermute`` ring); the last rank keeps the finished
micro-batches, which it then broadcasts, so every rank returns the
whole output.  ``bubble_fraction`` is the classic GPipe bubble
(S - 1) / (M + S - 1).  On one card the world is one process: one stage
and nothing to send.

Model-agnostic: ``stage_fn(stage_params, x)`` is any function of a
stage's parameters and a micro-batch (the tests drive it with an MLP
stack; the LM's periods slot in by stacking them a stage).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    axis: str = "pod"
    microbatches: int = 4

    def bubble_fraction(self, n_stages: int) -> float:
        return (n_stages - 1) / (self.microbatches + n_stages - 1)


def _local(tree: Any, rank: int) -> Any:
    """A stage's slice of a tree whose leaves lead with the stage axis:
    the rank's own row, or the only one of a local (1, ...) slice."""
    if isinstance(tree, torch.Tensor):
        return tree[0] if tree.shape[0] == 1 else tree[rank]
    if isinstance(tree, dict):
        return {k: _local(v, rank) for k, v in tree.items()}
    return type(tree)(_local(v, rank) for v in tree)


def gpipe(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], mesh,
          cfg: PipelineConfig = PipelineConfig()):
    """``pipelined(stage_params, x) -> y`` on every rank of ``mesh``'s
    ``cfg.axis`` (a ``DeviceMesh``).

    stage_params: a tree whose leaves lead with the stage axis, either
    every stage (S, ...) or this rank's own (1, ...); rank i runs stage i.
    x: (batch, ...), the same on every rank (split into
    ``cfg.microbatches`` micro-batches here).  Each stage's output has its
    input's shape."""
    axis = cfg.axis
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    rank = mesh.get_local_rank(axis)
    m = cfg.microbatches
    assert m >= n_stages, "microbatches must cover the pipeline depth"
    nxt = dist.get_global_rank(group, (rank + 1) % n_stages)
    prv = dist.get_global_rank(group, (rank - 1) % n_stages)
    last = dist.get_global_rank(group, n_stages - 1)

    def pipelined(stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        sp = _local(stage_params, rank)
        b = x.shape[0]
        xs = x.reshape(m, b // m, *x.shape[1:])
        buf = torch.zeros_like(xs[0])
        out = torch.zeros_like(xs)
        for t in range(m + n_stages - 1):
            idx = t - rank  # the micro-batch this rank holds at tick t
            active = 0 <= idx < m
            y = stage_fn(sp, xs[idx] if rank == 0 else buf) if active \
                else buf
            if active and rank == n_stages - 1:
                out[idx] = y
            if n_stages == 1:
                buf = y
                continue
            recv = torch.empty_like(buf)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                    dist.P2POp(dist.irecv, recv, prv, group)]):
                req.wait()
            buf = recv
        if n_stages > 1:
            dist.broadcast(out, src=last, group=group)
        return out.reshape(b, *out.shape[2:])

    return pipelined
