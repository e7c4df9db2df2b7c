"""The native (C++) CSV row scanner, built with g++ at first use and loaded
with ctypes; best-effort, so callers fall back to the numpy scanner."""

from agent_tpu_torch.data.native.build import native_available, scan_row_offsets_native

__all__ = ["native_available", "scan_row_offsets_native"]
