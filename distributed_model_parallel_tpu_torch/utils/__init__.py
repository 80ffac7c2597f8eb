"""Utilities of the port: the analytic model-FLOP count, and the serving
engine's planes — span and request tracing, the telemetry stream and
metrics registry, resource metering, SLO alerts, the device-health
sentinel and the live status exporter."""
