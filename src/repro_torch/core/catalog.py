"""The data-reduction operator catalog the semantic optimizer selects from.

Counterpart of ``repro/core/catalog.py`` (a copy: the port imports nothing
of ``repro``).

Mirrors the paper's Figure 3: the optimizer doesn't synthesize arbitrary
code — it instantiates operators from a curated catalog, each annotated with
its *semantic precondition* (when the rewrite preserves query correctness)
and its parameter-derivation rule.
"""
from __future__ import annotations

CATALOG = {
    "skip": {
        "params": "(amount, condition, threshold, roi)",
        "precondition": "objects persist >= k frames; empty frames carry no "
                        "query-relevant information",
        "derivation": "amount <= min observed object dwell // safety so a "
                      "re-check always lands inside any pass",
    },
    "crop": {
        "params": "(region)",
        "precondition": "query-relevant objects confined to a spatial region",
        "derivation": "bounding box of frame-diff activity, quantized to "
                      "32px tiles",
    },
    "downscale": {
        "params": "(factor)",
        "precondition": "query features survive the resolution loss "
                        "(color: yes; glyph-level text: validate!)",
        "derivation": "factor 2 unless the query needs glyph detail",
    },
    "greyscale": {
        "params": "()",
        "precondition": "NO query predicate or extraction depends on color",
        "derivation": "reject whenever the query mentions color",
    },
}
