"""Capability detection and worker sizing: the lease's ``worker_profile``."""
