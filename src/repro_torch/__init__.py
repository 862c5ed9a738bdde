"""PyTorch/CUDA port of the structure-aware graph engine (``repro``).

The port runs on an NVIDIA Hopper card; every block update goes through a
hand-written CUDA kernel (``csrc/block_sweep.cu``). It imports torch and
numpy only: neither JAX nor the ``repro`` package.

Entry points: :class:`repro_torch.core.engine.StructureAwareEngine`,
:class:`repro_torch.core.baseline.BaselineEngine`,
:class:`repro_torch.stream.StreamingEngine`,
:class:`repro_torch.serve.QueryService`, and ``python -m`` of
``repro_torch.quickstart``, ``repro_torch.streaming_graph`` and
``repro_torch.graph_service``.
"""
