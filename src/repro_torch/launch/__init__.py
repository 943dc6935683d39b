"""Launchers: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train`` (the rest of the reference's
``launch/``, the dry-run, HLO and TPU-roofline tools, is not ported)."""
