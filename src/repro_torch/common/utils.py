"""Small shared integer helpers (counterpart of ``repro/common/utils.py``)."""
from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_to_multiple(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return ceil_div(x, m) * m
