"""Command-line interface of the port (``python -m gaplac_tpu_torch.cli.main``)."""
