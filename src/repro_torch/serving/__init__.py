"""Continuous-batching LM serving (counterpart of ``repro/serving``)."""
