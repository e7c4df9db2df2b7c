"""Worker profile assembly — the port's counterpart of
``agent_tpu.sizing.profile``: the ``cpu`` block (cores reserved for the OS,
worker counts, the in-flight target) and the ``gpu`` block (``nvidia-smi``'s
inventory). There is no ``tpu`` block: the port claims no TPU. The shard-size
hint that the reference puts in its ``tpu`` block rides the ``gpu`` block
instead (``suggested_batch``, ``suggested_shard_rows``, by the reference's
memory formula with the smallest listed card's ``memory.total`` as the
per-chip memory and the listed cards as the chips); the port's controller
reads it from either block, the reference's from ``tpu`` only. With
``TPU_DISABLED=1`` the ``gpu`` block says ``disabled: true``, offers no
workers and carries no hint, as the reference's ``tpu`` block does.

Every probe degrades to a conservative answer when its dependency is
missing (psutil, nvidia-smi), so the agent boots anywhere.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Any, Dict, List, Optional

from agent_tpu_torch.config import DeviceConfig, SizingConfig, env_bool

# Hard limits advertised to the controller with every lease (the reference's
# wire contract numbers).
MAX_PAYLOAD_BYTES = 262_144
MAX_TOKENS = 2_048


def _logical_cores() -> int:
    try:
        import psutil  # type: ignore

        n = psutil.cpu_count(logical=True)
        if n:
            return int(n)
    except Exception:  # noqa: BLE001 — psutil optional
        pass
    return os.cpu_count() or 1


def _total_ram_bytes() -> Optional[int]:
    try:
        import psutil  # type: ignore

        return int(psutil.virtual_memory().total)
    except Exception:  # noqa: BLE001 — psutil optional
        pass
    try:
        return int(os.sysconf("SC_PHYS_PAGES")) * int(os.sysconf("SC_PAGE_SIZE"))
    except (ValueError, OSError, AttributeError):
        return None


def detect_cpu(cfg: Optional[SizingConfig] = None) -> Dict[str, Any]:
    """CPU sizing: reserve cores for the OS, derive worker counts and the
    in-flight target."""
    cfg = cfg or SizingConfig()
    cores = _logical_cores()
    # Reserve ~25% of cores for the OS, clamped to [floor, cap], never all cores.
    reserved = min(cfg.cpu_reserved_cores_cap, max(cfg.cpu_reserved_cores_floor, cores // 4))
    reserved = min(reserved, max(cores - 1, 0))
    usable = max(1, cores - reserved)
    target_inflight = max(cfg.cpu_min_workers, int(usable * max(cfg.cpu_pipeline_factor, 0.0)))
    soft_cap = cores * max(cfg.cpu_soft_cap_multiplier, 1)
    ram = _total_ram_bytes()
    if ram and cfg.cpu_per_worker_bytes > 0:
        soft_cap = min(soft_cap, max(1, ram // cfg.cpu_per_worker_bytes))
    out: Dict[str, Any] = {
        "logical_cores": cores,
        "reserved_cores": reserved,
        "usable_cores": usable,
        "target_inflight": min(target_inflight, soft_cap),
        "max_cpu_workers": int(soft_cap),
    }
    if ram is not None:
        out["ram_bytes"] = ram
    return out


def _nvidia_devices_allowed() -> bool:
    """``NVIDIA_VISIBLE_DEVICES=none`` (or ``void``) disables GPU scheduling."""
    v = os.environ.get("NVIDIA_VISIBLE_DEVICES")
    if v is None:
        return True
    return v.strip().lower() not in ("none", "void", "")


def detect_gpu() -> Dict[str, Any]:
    """GPU inventory via ``nvidia-smi``. An absent binary, disallowed
    visibility or a parse failure all mean "no GPU"."""
    none = {"gpu_present": False, "gpus": [], "max_gpu_workers": 0}
    if not _nvidia_devices_allowed() or shutil.which("nvidia-smi") is None:
        return none
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,memory.total", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=5,
        )
    except (OSError, subprocess.TimeoutExpired):
        return none
    if proc.returncode != 0:
        return none
    gpus: List[Dict[str, Any]] = []
    for line in proc.stdout.splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) < 2 or not parts[0]:
            continue
        gpu: Dict[str, Any] = {"name": parts[0]}
        try:
            gpu["memory_mb"] = int(float(parts[1]))
        except (TypeError, ValueError):
            pass
        gpus.append(gpu)
    if not gpus:
        return none
    return {"gpu_present": True, "gpus": gpus, "max_gpu_workers": len(gpus)}


def batch_hints(n_chips: int, mem_bytes_per_chip: int) -> Dict[str, int]:
    """The reference's topology-derived batching hints (its
    ``_tpu_batch_hints``): rows per device step, a 64 MiB share of each
    chip's memory per row, 8 to 1,024 rows a chip; rows per leased task, 16
    such steps, so that the lease protocol's overhead amortizes."""
    chips = max(1, int(n_chips))
    per_chip = max(8, min(1024, int(mem_bytes_per_chip) // (64 * 2**20)))
    batch = per_chip * chips
    return {"suggested_batch": batch, "suggested_shard_rows": batch * 16}


def build_worker_profile(sizing: Optional[SizingConfig] = None,
                         device: Optional[DeviceConfig] = None) -> Dict[str, Any]:
    """The worker profile shipped with every lease request.

    ``TPU_ONLY`` caps the CPU block at one worker and one task in flight, as
    the reference does, so the controller routes no host work here. The
    reference also empties its ``gpu`` block; the port keeps it, since the
    card is its accelerator and the shard hint rides that block."""
    cpu = detect_cpu(sizing)
    if (device is not None and device.tpu_only) or env_bool("TPU_ONLY", False):
        cpu = dict(cpu, max_cpu_workers=1, target_inflight=1)
    if device is not None and device.tpu_disabled:
        gpu = {"gpu_present": False, "gpus": [], "max_gpu_workers": 0, "disabled": True}
    else:
        gpu = detect_gpu()
        mem = [g["memory_mb"] for g in gpu["gpus"] if "memory_mb" in g]
        if gpu["gpu_present"] and mem:
            gpu.update(batch_hints(len(gpu["gpus"]), min(mem) * 2**20))
    return {
        "schema": "worker_profile/v2",
        "tier": "gpu" if gpu["gpu_present"] else "cpu",
        "cpu": cpu,
        "gpu": gpu,
        "max_total_workers": cpu["max_cpu_workers"] + gpu["max_gpu_workers"],
        "limits": {"max_payload_bytes": MAX_PAYLOAD_BYTES, "max_tokens": MAX_TOKENS},
    }
