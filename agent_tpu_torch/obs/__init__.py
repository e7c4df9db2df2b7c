"""Observability: the agent's metrics registry, spans, flight recorder,
usage stamps, utilization accounting and device memory telemetry; and the
controller's half — the fleet merge and exposition of metrics, the
time-series ring and its durable store, anomaly detection, incident
bundles, SLO burn rates, the request log, the usage ledger, the trace
store, the health verdict, the host profiler and the scrape helpers."""
