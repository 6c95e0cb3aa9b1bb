"""Port of yams_tpu.search."""
