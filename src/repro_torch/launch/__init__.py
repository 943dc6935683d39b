"""Launchers and the dry run: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, and the dry-run tooling
(``dryrun``, ``specs``, ``roofline``, ``step_analysis``, ``report``,
``perf``, ``mesh``): every arch x shape cell traced on the ``meta``
device, with per-device memory and H100 roofline terms."""
