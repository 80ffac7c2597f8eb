"""Utilities of the port (so far: the analytic model-FLOP count)."""
