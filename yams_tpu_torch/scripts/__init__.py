"""The port's experiments, trainers and evaluations: `python -m yams_tpu_torch.scripts.<name>`."""
