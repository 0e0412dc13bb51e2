"""Forward timing audit: device time against observed time.

Counterpart of the model-free part of ``repro/obs/audit.py``.  The
reference's ``PlanAudit`` joins the sharing-tree planner's decisions with
serving measurements; it prices ``SharingForest``s, which come with the
serving tier (``scheduler/sharing_tree.py``), so it is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional


def forward_gap(metrics) -> Optional[Dict[str, float]]:
    """Device-vs-observed forward gap: how much of the recorded
    ``forward_ms`` (launch → *observed* completion, poll-quantized) is
    actually poll latency rather than device time, per the sampled
    ``forward_device_ms`` probes.  None until both surfaces have data."""
    obs_h = metrics.histogram("forward_ms")
    dev_h = metrics.histogram("forward_device_ms")
    if not obs_h.count or not dev_h.count:
        return None
    observed = obs_h.mean()
    device = dev_h.mean()
    return {
        "observed_ms": observed,
        "device_ms": device,
        "gap_ms": observed - device,
        "gap_frac": (observed - device) / observed if observed else 0.0,
        "probes": dev_h.count,
        "forwards": obs_h.count,
    }
