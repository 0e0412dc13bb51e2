"""Semantic gating tier: temporal-redundancy extract cache in front of the
MLLM.  Counterpart of ``repro/semantic/``.

* ``TemporalSignature`` (``signature``): batched per-frame signatures
  (patch means plus a random-projection embedding) on the operators'
  device.
* ``SemanticExtractCache`` (``cache``): keyframe extract outputs that
  answer near-duplicates, with a revalidation budget that sends every Nth
  hit through the model and compares.
* ``AdmissionController`` (``admission``): tunes each feed's similarity
  threshold online from the measured revalidation mismatch rate.
* ``SemanticGate`` (``gate``): the facade ``MLLMExtractOp`` consults.

Gating is off by default (``OpContext.gate is None``), and a gate with
``threshold=0`` is inert: every frame takes the ungated path, bitwise.
"""
from repro_torch.semantic.admission import AdmissionController
from repro_torch.semantic.cache import Admission, SemanticExtractCache
from repro_torch.semantic.gate import GateConfig, SemanticGate
from repro_torch.semantic.signature import TemporalSignature

__all__ = ["Admission", "AdmissionController", "GateConfig",
           "SemanticExtractCache", "SemanticGate", "TemporalSignature"]
