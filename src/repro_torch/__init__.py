"""PyTorch/CUDA port of the structure-aware graph engine (``repro``).

The port runs on an NVIDIA Hopper card; every block update goes through a
hand-written CUDA kernel (``csrc/block_sweep.cu``,
``csrc/segment_combine.cu``), and so does the LM prefill's attention with
``use_kernel`` (``csrc/flash_attention.cu``). It imports torch and numpy
only: neither JAX nor the ``repro`` package.

Entry points: :class:`repro_torch.core.engine.StructureAwareEngine`,
:class:`repro_torch.core.baseline.BaselineEngine`,
:class:`repro_torch.stream.StreamingEngine`,
:class:`repro_torch.serve.QueryService`,
:class:`repro_torch.core.distributed.DistributedEngine`, the dense LM
decoders of :mod:`repro_torch.models.model`, and ``python -m`` of
``repro_torch.quickstart``, ``repro_torch.graph_suite``,
``repro_torch.streaming_graph``, ``repro_torch.graph_service``,
``repro_torch.distributed_graph``, ``repro_torch.launch.serve`` and
``repro_torch.obs`` (render or validate an exported trace).
"""
