"""Observability: the agent's metrics registry."""
