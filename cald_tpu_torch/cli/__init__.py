"""Command line of the port (``python -m cald_tpu_torch.cli.main``)."""
