"""Typed configuration of the port's agent — the part of ``agent_tpu.config``
that the agent loop reads, with the same environment variable names and
defaults, read once in ``Config.from_env()`` and never at import.

``AgentConfig`` holds the control-plane knobs (the controller and its
``CONTROLLER_URLS`` failover list, timeouts, idle sleep and backoff,
``TASKS``, ``MAX_TASKS``, labels, the pipeline, the binary wire, retry and
the result spool); ``SizingConfig`` the host-sizing knobs of
``sizing.profile``; ``ServeConfig`` the serving knobs (``SERVE_*``,
``KV_*``, ``PREFIX_CACHE_*``), of which the agent's serving ops read the
decode engine's and the prefix cache's and carry the controller's
front-door fields as plain data; ``DeviceConfig`` the device knobs
(``TPU_QUANT``, ``TPU_DISABLED``, ``PALLAS_ATTN``, ``CHIP_SLICE``,
``MESH_SHAPE``, ``PROFILE_DIR``, ``PROFILE_TASKS``). ``FLIGHT_RECORDER_DIR``,
``PROFILE_CAPTURE_DIR``, ``TRACE_ENABLED`` and ``PEAK_TFLOPS`` are read
where the reference reads them: in ``obs.recorder``, the agent's capture,
``obs.trace`` and ``obs.health``. Not here: the partition map
(``CONTROLLER_PARTITION_MAP``) and the multi-host knobs, which wait for
the control plane and several processes.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

DEFAULT_CONTROLLER_URL = "http://10.11.12.54:8080"  # the reference's default
TRUTHY_TOKENS = ("1", "true", "yes", "on", "y")


def env_str(name: str, default: str) -> str:
    v = os.environ.get(name)
    return v if v is not None and v != "" else default


def env_int(name: str, default: int) -> int:
    """Forgiving int parse: a bad value falls back to the default."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(float(v))
    except (TypeError, ValueError):
        return default


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() in TRUTHY_TOKENS


def parse_labels(raw: str) -> Dict[str, Any]:
    """``"k=v,k2=v2,flag"`` -> ``{"k": "v", "k2": "v2", "flag": True}``."""
    labels: Dict[str, Any] = {}
    for tok in (raw or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" in tok:
            k, _, v = tok.partition("=")
            k, v = k.strip(), v.strip()
            if k:
                labels[k] = v
        else:
            labels[tok] = True
    return labels


def parse_tasks(raw: str) -> Tuple[str, ...]:
    """TASKS env -> ordered de-duplicated op names; the ``*``/``all``/``none``
    sentinels stay verbatim for the registry gate to resolve."""
    seen = []
    for tok in (raw or "").split(","):
        tok = tok.strip()
        if tok and tok not in seen:
            seen.append(tok)
    return tuple(seen)


@dataclass(frozen=True)
class AgentConfig:
    """Control-plane configuration."""

    controller_url: str = DEFAULT_CONTROLLER_URL
    # CONTROLLER_URLS: the failover candidates, primary first; a transport
    # error rotates the agent to the next one.
    controller_urls: Tuple[str, ...] = ()
    agent_name: str = field(default_factory=socket.gethostname)
    http_timeout_sec: float = 10.0
    idle_sleep_sec: float = 0.25
    max_tasks: int = 1
    lease_timeout_ms: int = 3000
    error_log_every_sec: float = 10.0
    error_backoff_sec: float = 1.0
    tasks: Tuple[str, ...] = ("echo", "map_classify_tpu")
    labels: Dict[str, Any] = field(default_factory=dict)
    # Staged-task queue depth between the staging pool and the device loop;
    # 0 = the serial loop.
    pipeline_depth: int = 2                   # PIPELINE_DEPTH
    stage_workers: int = 0                    # STAGE_WORKERS (0 = auto)
    stage_autotune: bool = True               # STAGE_AUTOTUNE
    feed_double_buffer: bool = True           # FEED_DOUBLE_BUFFER
    wire_binary: bool = True                  # WIRE_BINARY (offer "b1")
    retry_base_sec: float = 0.5               # RETRY_BASE_SEC
    retry_max_sec: float = 30.0               # RETRY_MAX_SEC
    retry_deadline_sec: float = 0.0           # RETRY_DEADLINE_SEC (0 = none)
    result_spool_path: str = ""               # RESULT_SPOOL_PATH ("" = memory)
    result_spool_max: int = 512               # RESULT_SPOOL_MAX

    @staticmethod
    def from_env() -> "AgentConfig":
        urls = tuple(u.strip().rstrip("/") for u in env_str("CONTROLLER_URLS", "").split(",")
                     if u.strip())
        return AgentConfig(
            # CONTROLLER_URLS alone is enough (its head is the primary);
            # CONTROLLER_URL wins when both are set.
            controller_url=env_str("CONTROLLER_URL",
                                   urls[0] if urls else DEFAULT_CONTROLLER_URL).rstrip("/"),
            controller_urls=urls,
            agent_name=env_str("AGENT_NAME", socket.gethostname()),
            http_timeout_sec=env_float("HTTP_TIMEOUT_SEC", 10.0),
            idle_sleep_sec=env_float("IDLE_SLEEP_SEC", 0.25),
            max_tasks=max(1, env_int("MAX_TASKS", 1)),
            lease_timeout_ms=env_int("LEASE_TIMEOUT_MS", 3000),
            error_log_every_sec=env_float("ERROR_LOG_EVERY_SEC", 10.0),
            error_backoff_sec=env_float("ERROR_BACKOFF_SEC", 1.0),
            tasks=parse_tasks(env_str("TASKS", "echo,map_classify_tpu")),
            labels=parse_labels(os.environ.get("AGENT_LABELS", "")),
            pipeline_depth=max(0, env_int("PIPELINE_DEPTH", 2)),
            stage_workers=max(0, env_int("STAGE_WORKERS", 0)),
            stage_autotune=env_bool("STAGE_AUTOTUNE", True),
            feed_double_buffer=env_bool("FEED_DOUBLE_BUFFER", True),
            wire_binary=env_bool("WIRE_BINARY", True),
            retry_base_sec=env_float("RETRY_BASE_SEC", 0.5),
            retry_max_sec=env_float("RETRY_MAX_SEC", 30.0),
            retry_deadline_sec=env_float("RETRY_DEADLINE_SEC", 0.0),
            result_spool_path=env_str("RESULT_SPOOL_PATH", ""),
            result_spool_max=max(1, env_int("RESULT_SPOOL_MAX", 512)),
        )


@dataclass(frozen=True)
class SizingConfig:
    """Host-sizing knobs of ``sizing.profile.detect_cpu``."""

    cpu_reserved_cores_floor: int = 1
    cpu_reserved_cores_cap: int = 4
    cpu_pipeline_factor: float = 4.0
    cpu_min_workers: int = 1
    cpu_soft_cap_multiplier: int = 8
    cpu_per_worker_bytes: int = 32 * 1024 * 1024

    @staticmethod
    def from_env() -> "SizingConfig":
        return SizingConfig(
            cpu_reserved_cores_floor=env_int("CPU_RESERVED_CORES_FLOOR", 1),
            cpu_reserved_cores_cap=env_int("CPU_RESERVED_CORES_CAP", 4),
            cpu_pipeline_factor=env_float("CPU_PIPELINE_FACTOR", 4.0),
            cpu_min_workers=env_int("CPU_MIN_WORKERS", 1),
            cpu_soft_cap_multiplier=env_int("CPU_SOFT_CAP_MULTIPLIER", 8),
            cpu_per_worker_bytes=env_int("CPU_PER_WORKER_BYTES", 32 * 1024 * 1024),
        )


@dataclass(frozen=True)
class ServeConfig:
    """Online-serving knobs, the reference's ``ServeConfig`` with the same
    environment names, defaults and clamps. The agent side reads
    ``decode_slots`` (running-batch capacity in requests of the continuous
    decode engine), ``decode_micro_steps`` (decode iterations issued back
    to back between joins and exits), the KV layout (``"paged"``: per-layer
    pools of ``kv_block_size``-token blocks, ``kv_pool_blocks`` of them, 0 =
    as many as the dense layout holds; ``"dense"``: a full-length cache per
    row) and the prefix cache's bounds. The front door's fields (batching,
    admission, buckets, the request log) belong to the controller and are
    carried as plain data."""

    enabled: bool = True                   # SERVE_ENABLED
    max_wait_ms: float = 25.0              # SERVE_MAX_WAIT_MS
    max_batch: int = 16                    # SERVE_MAX_BATCH
    max_pending: int = 1024                # SERVE_MAX_PENDING
    priority: int = 8                      # SERVE_PRIORITY
    len_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024)  # SERVE_LEN_BUCKETS
    decode_slots: int = 8                  # SERVE_DECODE_SLOTS
    decode_micro_steps: int = 1            # SERVE_MICRO_STEPS
    wait_timeout_sec: float = 60.0         # SERVE_WAIT_TIMEOUT_SEC
    kv_layout: str = "paged"               # SERVE_KV_LAYOUT
    kv_block_size: int = 16                # KV_BLOCK_SIZE
    kv_pool_blocks: int = 0                # KV_POOL_BLOCKS
    prefix_cache_enabled: bool = True      # PREFIX_CACHE_ENABLED
    prefix_cache_entries: int = 512        # PREFIX_CACHE_ENTRIES
    prefix_cache_mb: float = 256.0         # PREFIX_CACHE_MB
    disaggregated: bool = False            # SERVE_DISAGG
    reqlog_sample: float = 1.0             # SERVE_REQLOG_SAMPLE
    reqlog_capacity: int = 2048            # SERVE_REQLOG_CAPACITY

    @staticmethod
    def from_env() -> "ServeConfig":
        buckets = []
        for tok in env_str("SERVE_LEN_BUCKETS", "").split(","):
            tok = tok.strip()
            if tok:
                try:
                    buckets.append(int(tok))
                except ValueError:
                    pass
        buckets = tuple(sorted(b for b in buckets if b > 0))
        return ServeConfig(
            enabled=env_bool("SERVE_ENABLED", True),
            max_wait_ms=max(0.0, env_float("SERVE_MAX_WAIT_MS", 25.0)),
            max_batch=max(1, env_int("SERVE_MAX_BATCH", 16)),
            max_pending=max(0, env_int("SERVE_MAX_PENDING", 1024)),
            priority=min(9, max(0, env_int("SERVE_PRIORITY", 8))),
            len_buckets=buckets or ServeConfig.len_buckets,
            decode_slots=max(1, env_int("SERVE_DECODE_SLOTS", 8)),
            decode_micro_steps=max(1, env_int("SERVE_MICRO_STEPS", 1)),
            wait_timeout_sec=max(0.1, env_float("SERVE_WAIT_TIMEOUT_SEC", 60.0)),
            kv_layout=("dense" if env_str("SERVE_KV_LAYOUT", "paged").strip().lower()
                       == "dense" else "paged"),
            kv_block_size=max(1, env_int("KV_BLOCK_SIZE", 16)),
            kv_pool_blocks=max(0, env_int("KV_POOL_BLOCKS", 0)),
            prefix_cache_enabled=env_bool("PREFIX_CACHE_ENABLED", True),
            prefix_cache_entries=max(0, env_int("PREFIX_CACHE_ENTRIES", 512)),
            prefix_cache_mb=max(0.0, env_float("PREFIX_CACHE_MB", 256.0)),
            disaggregated=env_bool("SERVE_DISAGG", False),
            reqlog_sample=min(1.0, max(0.0, env_float("SERVE_REQLOG_SAMPLE", 1.0))),
            reqlog_capacity=max(1, env_int("SERVE_REQLOG_CAPACITY", 2048)),
        )


def parse_mesh_shape(text: str) -> Dict[str, int]:
    """``"dp=2,tp=2"`` (comma-separated ``axis=size``) -> ``{"dp": 2, "tp":
    2}``, as the reference's ``DeviceConfig.from_env`` parses ``MESH_SHAPE``:
    a size that is not an int is skipped, and a bare name means size 1."""
    shape: Dict[str, int] = {}
    for tok in text.split(","):
        name, eq, size = (part.strip() for part in tok.partition("="))
        if not name:
            continue
        try:
            shape[name] = int(size) if eq else 1
        except ValueError:
            pass
    return shape


@dataclass(frozen=True)
class DeviceConfig:
    """The device knobs (the reference's ``DeviceConfig``, cut to what the
    port reads)."""

    # The fleet's default quantized mode (TPU_QUANT): "" when unset. The
    # ops resolve each task's mode themselves (payload, then TPU_QUANT, then
    # the model config; ops._model_common.resolve_quant); this read-once
    # copy is what the lease telemetry reports (runtime.describe).
    quant: str = ""
    # TPU_DISABLED=1: the operator asks for a CPU runtime (the accelerator
    # is never touched).
    tpu_disabled: bool = False
    # PALLAS_ATTN=0 asks for attention without the hand-written kernels;
    # the port has no such path on the card, so a CUDA runtime refuses it.
    pallas_attn: bool = True
    # CHIP_SLICE "start:count": the slice of the host's cards this agent
    # owns ("" = from the first card).
    chip_slice: str = ""
    # MESH_SHAPE "dp=2,tp=2" (axes dp, tp, sp, pp, ep): the runtime's mesh
    # over its devices ({} = every device on dp).
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    # PROFILE_DIR: a torch.profiler trace of each of the first
    # PROFILE_TASKS tasks' execute is written there ("" disables).
    profile_dir: str = ""
    profile_tasks: int = 1
    # Several processes, one lease loop (runtime.distributed): the
    # coordinator's "host:port" (COORDINATOR_ADDRESS; None = one process),
    # NUM_PROCESSES and PROCESS_ID.
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    @staticmethod
    def from_env() -> "DeviceConfig":
        # PROCESS_ID parses forgivingly, as every int env does, but unset or
        # unparseable stays None, not 0.
        process_id = env_int("PROCESS_ID", -1) if os.environ.get("PROCESS_ID") else -1
        return DeviceConfig(quant=env_str("TPU_QUANT", "").strip().lower(),
                            tpu_disabled=env_bool("TPU_DISABLED", False),
                            pallas_attn=env_bool("PALLAS_ATTN", True),
                            chip_slice=env_str("CHIP_SLICE", "").strip(),
                            mesh_shape=parse_mesh_shape(env_str("MESH_SHAPE", "")),
                            profile_dir=env_str("PROFILE_DIR", ""),
                            profile_tasks=env_int("PROFILE_TASKS", 1),
                            coordinator_address=os.environ.get("COORDINATOR_ADDRESS") or None,
                            num_processes=env_int("NUM_PROCESSES", 0) or None,
                            process_id=process_id if process_id >= 0 else None)


@dataclass(frozen=True)
class Config:
    """The agent's whole configuration."""

    agent: AgentConfig = field(default_factory=AgentConfig)
    sizing: SizingConfig = field(default_factory=SizingConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)

    @staticmethod
    def from_env() -> "Config":
        return Config(agent=AgentConfig.from_env(), sizing=SizingConfig.from_env(),
                      serve=ServeConfig.from_env(), device=DeviceConfig.from_env())
