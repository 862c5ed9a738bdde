"""Launchers: ``python -m repro_torch.launch.serve`` (LM serving),
``python -m repro_torch.launch.train`` (LM training, on a mesh with
``--nproc``), ``.dryrun``, ``.roofline`` and ``.perf`` (the fake-device
dry run and its H100 projections); ``.mesh`` and ``.sharding`` hold the
meshes and the sharding rules."""
