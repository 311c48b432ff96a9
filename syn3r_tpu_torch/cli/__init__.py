"""Command-line entry points of the port: ``python -m
syn3r_tpu_torch.cli.train``, ``.render``, ``.metrics``,
``.summarize`` and ``.generate_pcd``."""
