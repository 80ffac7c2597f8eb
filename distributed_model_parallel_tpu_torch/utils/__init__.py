"""Utilities of the port: the card's peak rates and the analytic
model-FLOP count, and the serving planes — span and request tracing, the telemetry stream and metrics
registry, resource metering, SLO alerts, the device-health sentinel, the
live status exporter, the fault-plan parser and serve-side injector
(:mod:`.faults`) and the crash flight recorder (:mod:`.flightrec`)."""

from distributed_model_parallel_tpu_torch.utils import (  # noqa: F401
    faults,
    flightrec,
)
