"""Observability: the agent's metrics registry, spans, flight recorder,
usage stamps, utilization accounting and device memory telemetry."""
