"""Small shared helpers (counterpart of ``repro/common/utils.py``)."""
from __future__ import annotations

from typing import Any, Mapping


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_to_multiple(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return ceil_div(x, m) * m


def tree_size_bytes(tree: Any) -> int:
    """Total bytes of the array leaves (tensors or numpy arrays) of a tree
    of nested dicts, lists and tuples; other leaves count nothing."""
    if isinstance(tree, Mapping):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_size_bytes(v) for v in tree)
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        n = 1
        for s in tree.shape:
            n *= int(s)
        return n * tree.dtype.itemsize
    return 0
