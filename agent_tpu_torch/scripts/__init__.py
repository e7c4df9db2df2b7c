"""Operator entry points, counterparts of the reference's ``scripts/``:
each runs as ``python -m agent_tpu_torch.scripts.<name>``."""
