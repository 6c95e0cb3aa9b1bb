"""The port's experiments: `python -m yams_tpu_torch.scripts.<name>`."""
