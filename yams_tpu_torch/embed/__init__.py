"""Port of yams_tpu.embed."""
