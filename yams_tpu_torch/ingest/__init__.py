"""Port of yams_tpu.ingest."""
