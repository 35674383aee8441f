"""The port's command line: ``python -m dctpu_torch.cli.main``."""
