"""Continuous-batching LM serving (counterpart of ``repro/serving``)."""
from repro_torch.serving.quantize import quantize_params_int8  # noqa: F401
