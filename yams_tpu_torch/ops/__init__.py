"""Port of yams_tpu.ops."""
