"""Logical-axis sharding: one rules table maps logical tensor axes to mesh
axes.

Counterpart of ``repro/common/sharding.py``.  The production mesh is
``("data", "model")`` single-pod or ``("pod", "data", "model")``
multi-pod (``launch/mesh.py``).  Model code names only *logical* axes;
the rules translate them, dropping mesh axes the mesh lacks, so one model
runs on a world of one, a single-pod mesh and a multi-pod mesh unchanged.
Per-cell overrides (``long_500k`` shards the KV sequence over "data" and
replicates the batch) are applied with ``rules_scope``.

PyTorch idiom: a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over a process group (``launch/mesh.py::make_test_mesh``) or an
``AbstractMesh``, axis names and sizes without devices (the production
meshes: one host cannot hold their 256 or 512 ranks).  A partition spec
is a tuple, one entry a tensor dim: None (replicated), a mesh axis name,
or a tuple of them (sharded over both, major first), the entries of the
reference's ``PartitionSpec``.  ``placements`` turns one into DTensor
placements on a ``DeviceMesh``.

Not ported: ``shard_map_compat``.  It wraps ``jax.shard_map``, which runs
a function per mesh rank inside one program; in PyTorch the per-rank code
runs in each rank's own process under the process group
(``distribution/pipeline.py``'s ranks send and receive activations
themselves), so there is nothing to wrap.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import torch

AxisVal = Union[None, str, Tuple[str, ...]]
#: a partition spec: one entry a tensor dim
Spec = Tuple[AxisVal, ...]

# logical axis -> mesh axes (tuple entries: sharded over both, major first)
DEFAULT_RULES: Dict[str, AxisVal] = {
    "batch": ("pod", "data"),      # global batch -> DP over pod+data
    "seq": None,                   # activations: sequence replicated
    "kv_seq": None,                # KV cache sequence (sharded for long_500k)
    "embed": None,                 # activation d_model
    "fsdp": ("data",),             # weight rows: ZeRO-3 over the data axis
    "vocab": ("model",),
    "heads": ("model",),           # attention q heads (TP)
    "kv_heads": ("model",),
    "head_dim": None,
    "mlp": ("model",),             # FFN hidden (TP)
    "experts": ("model",),         # MoE expert parallelism
    "expert_fsdp": ("data",),      # expert weight d-rows (ZeRO-3; kept even
                                   # when dense "fsdp" is overridden)
    "expert_ff": None,
    "ssm_heads": ("model",),       # mamba heads (TP)
    "ssm_state": None,
    "conv": None,
    "layers": None,                # the stacked periods' leading dim
    "frames": None,
    "pixels": None,
}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, without devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


Mesh = Any  # a DeviceMesh or an AbstractMesh

_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def current_rules() -> Dict[str, AxisVal]:
    rules = dict(DEFAULT_RULES)
    for override in _stack():
        rules.update(override)
    return rules


@contextlib.contextmanager
def rules_scope(**overrides: AxisVal) -> Iterator[None]:
    """Temporarily override logical -> mesh rules (e.g. for decode cells)."""
    _stack().append(overrides)
    try:
        yield
    finally:
        _stack().pop()


# The mesh that logical_to_mesh and friends read when given none; None
# means no sharding at all (one process, nothing to place).
_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def current_mesh() -> Optional[Mesh]:
    return _MESH


@contextlib.contextmanager
def mesh_scope(mesh: Optional[Mesh]) -> Iterator[None]:
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield
    finally:
        _MESH = prev


def mesh_shape(mesh: Mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _filter_axes(val: AxisVal, names: Sequence[str]) -> AxisVal:
    if val is None:
        return None
    if isinstance(val, str):
        return val if val in names else None
    kept = tuple(a for a in val if a in names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical_to_mesh(axes: Sequence[Optional[str]],
                    mesh: Optional[Mesh] = None) -> Spec:
    """A tuple of logical axis names -> the partition spec's entries."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    names = tuple(mesh_shape(mesh))
    rules = current_rules()
    used: set = set()
    out = []
    for ax in axes:
        val = rules.get(ax) if ax is not None else None
        val = _filter_axes(val, names)
        # a mesh axis may appear at most once in a spec
        if isinstance(val, tuple):
            val = tuple(a for a in val if a not in used) or None
            if isinstance(val, tuple) and len(val) == 1:
                val = val[0]
        if isinstance(val, str) and val in used:
            val = None
        if isinstance(val, tuple):
            used.update(val)
        elif isinstance(val, str):
            used.add(val)
        out.append(val)
    return tuple(out)


def placements(spec: Spec, mesh: Mesh) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` on a ``DeviceMesh``, one a mesh
    dim: ``Shard(d)`` where tensor dim d is sharded over that mesh axis,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of: Dict[str, int] = {}
    for d, val in enumerate(spec):
        for a in ((val,) if isinstance(val, str) else (val or ())):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def shard_constraint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes: ``x``
    itself without a mesh or on a world of one; the port's models call
    none, so a larger mesh raises."""
    mesh = current_mesh()
    if mesh is None or chips(mesh) == 1:
        return x
    raise NotImplementedError(
        f"shard_constraint on a mesh of {chips(mesh)} ranks: the port's "
        "models run on one card and place nothing")


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec, as the reference's ``NamedSharding``."""

    mesh: Mesh
    spec: Spec


def place(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``t`` laid out as ``sharding`` says: ``t`` itself on a mesh of one
    rank; a DTensor on a larger ``DeviceMesh`` of the running world.  A
    mesh of more ranks than the world (or an ``AbstractMesh`` of more than
    one) raises, naming both."""
    import torch.distributed as dist

    n = chips(sharding.mesh)
    world = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    if n == 1:
        return t
    if n > world or isinstance(sharding.mesh, AbstractMesh):
        raise ValueError(f"a mesh {mesh_shape(sharding.mesh)} of {n} ranks "
                         f"cannot be placed on a world of {world}")
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh,
                             placements(sharding.spec, sharding.mesh))


def named_sharding(axes: Sequence[Optional[str]],
                   mesh: Optional[Mesh] = None) -> NamedSharding:
    mesh = mesh or current_mesh()
    assert mesh is not None
    return NamedSharding(mesh, logical_to_mesh(axes, mesh))


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and \
        all(a is None or isinstance(a, str) for a in x)


def param_sharding_tree(axes_tree: Any, mesh: Optional[Mesh] = None) -> Any:
    """A tree of logical-axes tuples -> ``NamedSharding``s."""
    mesh = mesh or current_mesh()
    if _is_axes(axes_tree):
        return named_sharding(axes_tree, mesh)
    return {k: param_sharding_tree(v, mesh) for k, v in axes_tree.items()}


def dp_axis_names(mesh: Optional[Mesh] = None) -> Tuple[str, ...]:
    """Every mesh axis that carries data parallelism (all but 'model')."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in mesh_shape(mesh) if a != "model")


def axis_size(name: str, mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    return mesh_shape(mesh).get(name, 1)


def tp_size(mesh: Optional[Mesh] = None) -> int:
    return axis_size("model", mesh)


def dp_size(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in dp_axis_names(mesh))


def chips(mesh: Mesh) -> int:
    """The ranks of a mesh."""
    return math.prod(mesh_shape(mesh).values())
