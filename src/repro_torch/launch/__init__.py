"""Launchers: ``python -m repro_torch.launch.serve`` (LM serving) and
``python -m repro_torch.launch.train`` (LM training)."""
