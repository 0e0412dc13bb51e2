"""Saṃsāra on PyTorch + CUDA (Hopper): the port of the ``repro`` package.

Module paths mirror the JAX package (``repro_torch.streaming.operators`` is
the counterpart of ``repro.streaming.operators``).  The package imports
``torch`` and numpy only.  Entry points (``OpContext``, ``StreamMLLM``,
``StreamRuntime``) run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; asking for CUDA on a host without it raises.
"""
