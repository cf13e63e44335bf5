"""Command-line entry points (``python -m building_gan_torch.cli.main``)."""
