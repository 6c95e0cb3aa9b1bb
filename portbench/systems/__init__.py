"""Cells of each kind of system, one module a kind (a configuration's `system` key)."""
