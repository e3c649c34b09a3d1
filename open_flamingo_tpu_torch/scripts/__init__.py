"""Command-line entry points of the port (`python -m open_flamingo_tpu_torch.scripts.<name>`)."""
