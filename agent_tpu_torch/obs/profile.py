"""Device memory telemetry — the part of ``agent_tpu.obs.profile`` the agent
uses, read from CUDA's caching allocator instead of jax's
``memory_stats()``: :func:`device_memory_stats` (used, peak and limit of
every card the runtime owns) and :func:`hbm_totals` (their sums and the
per-card list). ``runtime.describe()`` and the agent's
``device_hbm_bytes{device,kind}`` gauges both read through here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

KINDS = ("used", "limit", "peak")


def device_memory_stats(devices: Sequence[Any]) -> List[Dict[str, Any]]:
    """``[{device, platform, used, peak, limit}, ...]``, one entry per
    distinct CUDA card in ``devices`` (``device`` is its CUDA index). A card
    listed several times, as by an sp ring on one card, counts once. ``used``
    and ``peak`` are the allocator's ``allocated_bytes.all.current`` and
    ``.peak``, ``limit`` the card's total memory (``mem_get_info``). CPU
    devices, and a card whose stats cannot be read, contribute nothing, so
    the empty list is the "no device memory here" answer, never an error."""
    import torch

    out: List[Dict[str, Any]] = []
    seen = set()
    for dev in devices:
        try:
            dev = torch.device(dev)
        except (TypeError, RuntimeError):
            continue
        if dev.type != "cuda":
            continue
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        if index in seen:
            continue
        seen.add(index)
        try:
            stats = torch.cuda.memory_stats(index)
            limit = torch.cuda.mem_get_info(index)[1]
        except Exception:  # noqa: BLE001 — telemetry must never raise
            continue
        entry: Dict[str, Any] = {"device": str(index), "platform": "cuda",
                                 "limit": int(limit)}
        for raw, kind in (("allocated_bytes.all.current", "used"),
                          ("allocated_bytes.all.peak", "peak")):
            v = stats.get(raw)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                entry[kind] = int(v)
        out.append(entry)
    return out


def hbm_totals(devices: Sequence[Any]) -> Optional[Dict[str, Any]]:
    """Summed used/limit/peak over the cards that reported, with the
    per-card list; None when none did (a CPU runtime)."""
    per_device = device_memory_stats(devices)
    if not per_device:
        return None
    out: Dict[str, Any] = {"per_device": per_device}
    for kind in KINDS:
        vals = [e[kind] for e in per_device if kind in e]
        if vals:
            out[kind] = int(sum(vals))
    return out
