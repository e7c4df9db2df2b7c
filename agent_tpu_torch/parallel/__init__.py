"""Parallelism over the runtime's mesh: ring attention over ``sp``."""
