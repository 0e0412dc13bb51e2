"""Cross-stream shared-MLLM serving tier.

Counterpart of ``repro/scheduler/``: serving *many queries over many
feeds* with one shared MLLM, in three pieces.

* ``SharingTreePlanner`` (``sharing_tree``): plans are grouped by the
  ``Op.signature()`` chain of their pre-extract prefix plus their
  extract's merge key, so *subsets* of queries share even when the global
  common prefix is empty, and a cost estimate decides per group between
  shared and independent execution.  ``extract_bucket`` /
  ``coalescing_saving_us`` price the server-level cross-feed term.
* ``SharedExtractServer`` (``extract_server``): one union-task extract
  per physical backbone variant serving every feed; requests from
  different streams coalesce into padded, shape-bucketed forwards,
  launched on the server's own CUDA stream and retired by event
  (``dispatch`` / ``poll`` / ``wait``; ``drain`` is the barrier), under a
  ``max_inflight`` cap.  An optional semantic gate answers near-duplicate
  rows from its keyframe cache inside ``submit``; transient forward
  faults retry with bounded backoff and a watchdog bounds every wait.
* ``MultiStreamRuntime`` (``multistream``): drives heterogeneous feeds
  round-robin with per-stream backpressure, suspending each feed's
  pipeline at its extract ops and routing them through the shared server,
  with every query's outputs equal to independent execution; per-feed
  circuit breakers quarantine, probe, replay and recover sick feeds.
"""
from repro_torch.scheduler.sharing_tree import (
    SharingForest,
    SharingGroup,
    SharingTreePlanner,
    coalescing_saving_us,
    extract_bucket,
)
from repro_torch.scheduler.extract_server import (
    ExtractRequest,
    GatedExtractRequest,
    SharedExtractServer,
)
from repro_torch.scheduler.multistream import (
    Feed,
    FeedResult,
    MultiStreamResult,
    MultiStreamRuntime,
)

__all__ = [
    "ExtractRequest", "Feed", "FeedResult", "GatedExtractRequest",
    "MultiStreamResult", "MultiStreamRuntime", "SharedExtractServer",
    "SharingForest", "SharingGroup", "SharingTreePlanner",
    "coalescing_saving_us", "extract_bucket",
]
