"""Port of yams_tpu.core: config dataclasses, errors and value types."""
