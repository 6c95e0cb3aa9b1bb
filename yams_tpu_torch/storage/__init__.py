"""Port of yams_tpu.storage."""
