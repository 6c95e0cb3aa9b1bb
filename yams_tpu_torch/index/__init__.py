"""Port of yams_tpu.index."""
