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
``obs.trace`` and ``obs.health``. The control plane's knobs follow, each
built by its own ``from_env()``: ``JournalConfig`` (``JOURNAL_*``,
``SNAPSHOT_*``), ``SchedConfig`` (``SCHED_*``), ``SloConfig``
(``SLO_*``), ``ObsConfig`` (``USAGE_*``, ``TSDB_*``, ``ANOMALY_*``,
``INCIDENT_*``, ``PROFILE_*``) and ``FlowConfig`` (``FLOW_*``,
``CACHE_*``). The partitioned control plane and the operations tooling
read ``PartitionConfig`` (``PARTITIONS``, ``PARTITION_URLS``, ``ROUTER_*``),
``LoadgenConfig`` (``LOADGEN_*``) and ``AutoscaleConfig``
(``AUTOSCALE_*``); the agent's partition map is ``AgentConfig``'s
``controller_partition_map`` (``CONTROLLER_PARTITION_MAP``).
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
    # CONTROLLER_PARTITION_MAP: an explicit partition map
    # ("p0=http://a|http://a-standby,p1=http://b") makes the agent run the
    # router's placement, steal and result routing in-process
    # (controller/partition.PartitionSession); empty = no map.
    controller_partition_map: str = ""
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
            controller_partition_map=env_str("CONTROLLER_PARTITION_MAP", "").strip(),
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
    # TPU_ONLY=1: the worker profile caps its CPU block at one worker, so the
    # controller routes no host work to this device agent
    # (sizing.profile.build_worker_profile).
    tpu_only: bool = False
    # COMPUTE_DTYPE: the reference's runtime-wide dtype, which only its
    # describe() reports. Each model's own config sets what its forward runs
    # in (bf16, the MoE encoder f32), so the port's runtime reports none and
    # refuses any value but the default rather than ignore it.
    compute_dtype: str = "bfloat16"
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
                            tpu_only=env_bool("TPU_ONLY", False),
                            compute_dtype=env_str("COMPUTE_DTYPE", "bfloat16"),
                            pallas_attn=env_bool("PALLAS_ATTN", True),
                            chip_slice=env_str("CHIP_SLICE", "").strip(),
                            mesh_shape=parse_mesh_shape(env_str("MESH_SHAPE", "")),
                            profile_dir=env_str("PROFILE_DIR", ""),
                            profile_tasks=env_int("PROFILE_TASKS", 1),
                            coordinator_address=os.environ.get("COORDINATOR_ADDRESS") or None,
                            num_processes=env_int("NUM_PROCESSES", 0) or None,
                            process_id=process_id if process_id >= 0 else None)


@dataclass(frozen=True)
class JournalConfig:
    """Controller journal durability knobs.

    Everything defaults to the historical behavior: one append-only JSONL
    file at ``CONTROLLER_JOURNAL``, flushed but never fsynced, never
    rotated. Setting any segmentation/snapshot knob switches the journal
    to bounded ``<path>.seg-NNNNNNNN`` segments with periodic atomic
    ``<path>.snapshot`` images, after which replay cost is O(live state +
    uncovered tail) instead of O(history) and covered segments are
    garbage-collected."""

    # Rotate the active segment past this size / event count (0 = never —
    # the legacy single-file journal).
    segment_max_bytes: int = 0            # JOURNAL_SEGMENT_MAX_BYTES
    segment_max_events: int = 0           # JOURNAL_SEGMENT_MAX_EVENTS
    # Take a compacting snapshot every N journal appends (0 = never).
    # Implies segmentation (default 4 MiB segments when no bound is set).
    snapshot_every_events: int = 0        # SNAPSHOT_EVERY_EVENTS
    # Terminal-job retention in snapshots: 0 = keep every terminal job
    # forever (full restart fidelity, unbounded snapshot growth); N =
    # snapshots keep only the N most recent *droppable* terminal jobs
    # (jobs a non-terminal job depends on are never dropped). A restart
    # then forgets older completed jobs: late duplicate results for them
    # reject as `unknown job` instead of `already complete` — the same
    # at-most-once outcome — and this is what makes restart cost O(live
    # state) instead of O(every job ever submitted).
    snapshot_retain_terminal: int = 0     # SNAPSHOT_RETAIN_TERMINAL
    # fdatasync journal appends: off by default — the journal protects
    # against process death (flushed OS buffers survive SIGKILL), not
    # kernel/power loss; turning this on buys the latter at per-append
    # syscall cost. fsync_every=N batches the sync (group commit).
    fsync: bool = False                   # JOURNAL_FSYNC
    fsync_every: int = 1                  # JOURNAL_FSYNC_EVERY

    @staticmethod
    def from_env() -> "JournalConfig":
        return JournalConfig(
            segment_max_bytes=max(
                0, env_int("JOURNAL_SEGMENT_MAX_BYTES", 0)
            ),
            segment_max_events=max(
                0, env_int("JOURNAL_SEGMENT_MAX_EVENTS", 0)
            ),
            snapshot_every_events=max(
                0, env_int("SNAPSHOT_EVERY_EVENTS", 0)
            ),
            snapshot_retain_terminal=max(
                0, env_int("SNAPSHOT_RETAIN_TERMINAL", 0)
            ),
            fsync=env_bool("JOURNAL_FSYNC", False),
            fsync_every=max(1, env_int("JOURNAL_FSYNC_EVERY", 1)),
        )


@dataclass(frozen=True)
class SchedConfig:
    """Controller scheduler knobs.

    ``policy="fifo"`` (the default) is bit-compatible with the
    pre-scheduler controller: priority/tenant fields are accepted and
    recorded but dispatch order is pure arrival order and admission is
    unbounded unless a budget is set. ``policy="fair"`` enables priority
    tiers + weighted tenant fair-share + load-aware placement
    (``agent_tpu/sched/fair.py``).
    """

    policy: str = "fifo"                 # SCHED_POLICY: fifo | fair
    # Default priority for submits that don't carry one (0–9, 9 = urgent).
    default_priority: int = 4            # SCHED_DEFAULT_PRIORITY
    # Admission control: pending-queue budgets; 0 = unbounded. Submits past
    # a bound get HTTP 429 + retry_after_ms (transient per utils/retry.py).
    max_pending: int = 0                 # SCHED_MAX_PENDING (global)
    max_pending_per_tenant: int = 0      # SCHED_MAX_PENDING_PER_TENANT
    retry_after_ms: int = 1000           # SCHED_RETRY_AFTER_MS (429 hint)
    # Fair-share weights, "tenantA=3,tenantB=1" (absent tenants weigh 1).
    tenant_weights: Dict[str, float] = field(default_factory=dict)
    # Placement: how many leases a preferred-elsewhere job may be deferred
    # before any capable agent takes it (0 = placement is advisory only).
    placement_patience: int = 3          # SCHED_PLACEMENT_PATIENCE
    # Staged-queue depth beyond which an agent counts as busy: bulk shards
    # defer and grants shrink by the excess.
    busy_queue_depth: int = 2            # SCHED_BUSY_QUEUE_DEPTH
    # Deadline escalation: once this fraction of deadline_sec has elapsed a
    # still-pending job is bumped one priority tier (once).
    escalate_frac: float = 0.75          # SCHED_ESCALATE_FRAC

    @staticmethod
    def from_env() -> "SchedConfig":
        weights: Dict[str, float] = {}
        for k, v in parse_labels(
            os.environ.get("SCHED_TENANT_WEIGHTS", "")
        ).items():
            try:
                weights[k] = float(v)
            except (TypeError, ValueError):
                pass
        return SchedConfig(
            policy=env_str("SCHED_POLICY", "fifo").strip().lower(),
            default_priority=min(
                9, max(0, env_int("SCHED_DEFAULT_PRIORITY", 4))
            ),
            max_pending=max(0, env_int("SCHED_MAX_PENDING", 0)),
            max_pending_per_tenant=max(
                0, env_int("SCHED_MAX_PENDING_PER_TENANT", 0)
            ),
            retry_after_ms=max(0, env_int("SCHED_RETRY_AFTER_MS", 1000)),
            tenant_weights=weights,
            placement_patience=max(0, env_int("SCHED_PLACEMENT_PATIENCE", 3)),
            busy_queue_depth=max(0, env_int("SCHED_BUSY_QUEUE_DEPTH", 2)),
            escalate_frac=min(
                1.0, max(0.0, env_float("SCHED_ESCALATE_FRAC", 0.75))
            ),
        )


@dataclass(frozen=True)
class SloConfig:
    """Fleet health / SLO engine knobs.

    ``enabled=False`` (``SLO_ENABLED=0``) no-ops the whole judgment path:
    no tracker is built, ``observe`` never runs, and ``GET /v1/health``
    reports ``slo.enabled: false`` while still serving the fleet/queue
    signals. ``spec`` is the declarative objective list
    (``SLO_SPEC='[{"tier":8,"p99_ms":250,"availability":0.999}]'``; empty
    = the built-in interactive-tier default, see ``obs/slo.py``).
    """

    enabled: bool = True                  # SLO_ENABLED
    spec: str = ""                        # SLO_SPEC (JSON; "" = default)
    # Google-SRE multi-window burn-rate alerting: the short window catches
    # fast burns, the long window stops one bad minute from paging.
    window_short_sec: float = 300.0       # SLO_WINDOW_SHORT_SEC
    window_long_sec: float = 3600.0       # SLO_WINDOW_LONG_SEC
    burn_warn: float = 3.0                # SLO_BURN_WARN (enter `warn`)
    burn_page: float = 10.0               # SLO_BURN_PAGE (enter `page`)
    # Hysteresis: a level exits only once the short-window burn falls below
    # enter_threshold * this fraction — oscillation around the line holds.
    burn_exit_frac: float = 0.5           # SLO_BURN_EXIT_FRAC
    # Agents silent longer than this count stale in the /v1/health verdict.
    agent_stale_sec: float = 60.0         # HEALTH_AGENT_STALE_SEC

    @staticmethod
    def from_env() -> "SloConfig":
        short = max(0.1, env_float("SLO_WINDOW_SHORT_SEC", 300.0))
        return SloConfig(
            enabled=env_bool("SLO_ENABLED", True),
            spec=env_str("SLO_SPEC", ""),
            window_short_sec=short,
            window_long_sec=max(
                short, env_float("SLO_WINDOW_LONG_SEC", 3600.0)
            ),
            burn_warn=max(0.0, env_float("SLO_BURN_WARN", 3.0)),
            burn_page=max(0.0, env_float("SLO_BURN_PAGE", 10.0)),
            burn_exit_frac=min(
                1.0, max(0.0, env_float("SLO_BURN_EXIT_FRAC", 0.5))
            ),
            agent_stale_sec=max(
                1.0, env_float("HEALTH_AGENT_STALE_SEC", 60.0)
            ),
        )


@dataclass(frozen=True)
class ObsConfig:
    """Resource accounting, trend retention & continuous profiling knobs
   .

    Everything defaults ON with bounded memory: the ledger is a small
    aggregate map + a capped per-job table, the time-series ring holds
    ``window/interval`` flattened samples, and the host profiler starts
    LAZILY on the first ``GET /v1/profile/host`` (a controller that is never
    asked for a flamegraph never spawns the sampler thread)."""

    # Usage accounting (GET /v1/usage): per-{tenant,tier,op} + per-job
    # billing of accepted result applications.
    usage_enabled: bool = True             # USAGE_ENABLED
    usage_top_k: int = 10                  # USAGE_TOP_K (top jobs in report)
    usage_max_jobs: int = 4096             # USAGE_MAX_JOBS (per-job table cap)
    # $/chip-hour for the report's est_cost lines; 0 = no cost estimate.
    usage_cost_per_chip_hour: float = 0.0  # USAGE_COST_PER_CHIP_HOUR
    # Controller time-series ring (GET /v1/timeseries): periodic registry
    # snapshots spanning TSDB_WINDOW at TSDB_INTERVAL cadence.
    tsdb_enabled: bool = True              # TSDB_ENABLED
    tsdb_window_sec: float = 900.0         # TSDB_WINDOW
    tsdb_interval_sec: float = 10.0        # TSDB_INTERVAL
    # Durable on-disk store: "" keeps the ring in-memory only;
    # a directory persists every sample with tiered downsampling.
    tsdb_dir: str = ""                     # TSDB_DIR
    tsdb_segment_bytes: int = 1 << 20      # TSDB_SEGMENT_BYTES
    tsdb_retention_raw_sec: float = 3600.0      # TSDB_RETENTION_RAW_SEC
    tsdb_retention_1m_sec: float = 86400.0      # TSDB_RETENTION_1M_SEC
    tsdb_retention_10m_sec: float = 604800.0    # TSDB_RETENTION_10M_SEC
    tsdb_max_bytes: int = 256 << 20        # TSDB_MAX_BYTES (0 = uncapped)
    # Rolling-baseline anomaly detection over the sample stream.
    anomaly_enabled: bool = True           # ANOMALY_ENABLED
    anomaly_window: int = 60               # ANOMALY_WINDOW (baseline n)
    anomaly_warmup: int = 12               # ANOMALY_WARMUP (gate)
    anomaly_z: float = 8.0                 # ANOMALY_Z (MAD z threshold)
    anomaly_confirm: int = 2               # ANOMALY_CONFIRM (consecutive)
    anomaly_clear: int = 5                 # ANOMALY_CLEAR (episode close)
    # Incident forensics bundles (GET /v1/incidents).
    incident_enabled: bool = True          # INCIDENT_ENABLED
    incident_dir: str = ""                 # INCIDENT_DIR ("" = memory only)
    incident_capacity: int = 32            # INCIDENT_CAPACITY
    incident_min_interval_sec: float = 60.0  # INCIDENT_MIN_INTERVAL_SEC
    incident_worst_k: int = 3              # INCIDENT_WORST_K (traces kept)
    # Host sampling profiler (GET /v1/profile/host): collapsed-stack
    # flamegraph of the controller process, lazily started.
    profile_host_enabled: bool = True      # PROFILE_HOST_ENABLED
    profile_host_hz: float = 19.0          # PROFILE_HOST_HZ
    # Where agents write on-demand torch.profiler capture artifacts
    # ("" = a per-capture tempdir).
    profile_capture_dir: str = ""          # PROFILE_CAPTURE_DIR

    @staticmethod
    def from_env() -> "ObsConfig":
        interval = max(0.05, env_float("TSDB_INTERVAL", 10.0))
        return ObsConfig(
            usage_enabled=env_bool("USAGE_ENABLED", True),
            usage_top_k=max(1, env_int("USAGE_TOP_K", 10)),
            usage_max_jobs=max(16, env_int("USAGE_MAX_JOBS", 4096)),
            usage_cost_per_chip_hour=max(
                0.0, env_float("USAGE_COST_PER_CHIP_HOUR", 0.0)
            ),
            tsdb_enabled=env_bool("TSDB_ENABLED", True),
            tsdb_window_sec=max(
                interval, env_float("TSDB_WINDOW", 900.0)
            ),
            tsdb_interval_sec=interval,
            tsdb_dir=env_str("TSDB_DIR", "").strip(),
            tsdb_segment_bytes=max(
                4096, env_int("TSDB_SEGMENT_BYTES", 1 << 20)
            ),
            tsdb_retention_raw_sec=max(
                0.0, env_float("TSDB_RETENTION_RAW_SEC", 3600.0)
            ),
            tsdb_retention_1m_sec=max(
                0.0, env_float("TSDB_RETENTION_1M_SEC", 86400.0)
            ),
            tsdb_retention_10m_sec=max(
                0.0, env_float("TSDB_RETENTION_10M_SEC", 604800.0)
            ),
            tsdb_max_bytes=max(0, env_int("TSDB_MAX_BYTES", 256 << 20)),
            anomaly_enabled=env_bool("ANOMALY_ENABLED", True),
            anomaly_window=max(4, env_int("ANOMALY_WINDOW", 60)),
            anomaly_warmup=max(2, env_int("ANOMALY_WARMUP", 12)),
            anomaly_z=max(1.0, env_float("ANOMALY_Z", 8.0)),
            anomaly_confirm=max(1, env_int("ANOMALY_CONFIRM", 2)),
            anomaly_clear=max(1, env_int("ANOMALY_CLEAR", 5)),
            incident_enabled=env_bool("INCIDENT_ENABLED", True),
            incident_dir=env_str("INCIDENT_DIR", "").strip(),
            incident_capacity=max(1, env_int("INCIDENT_CAPACITY", 32)),
            incident_min_interval_sec=max(
                0.0, env_float("INCIDENT_MIN_INTERVAL_SEC", 60.0)
            ),
            incident_worst_k=max(0, env_int("INCIDENT_WORST_K", 3)),
            profile_host_enabled=env_bool("PROFILE_HOST_ENABLED", True),
            profile_host_hz=max(0.1, env_float("PROFILE_HOST_HZ", 19.0)),
            profile_capture_dir=env_str("PROFILE_CAPTURE_DIR", "").strip(),
        )

@dataclass(frozen=True)
class FlowConfig:
    """Workflow DAG engine + result cache knobs.

    The DAG limits bound what one ``POST /v1/workflows`` may expand into
    (stages x fan-out, before admission control sees the jobs); the cache
    knobs size the content-addressed result cache and pin the model
    version that fences its key space (bump => invalidate)."""

    enabled: bool = True                  # FLOW_ENABLED
    max_stages: int = 32                  # FLOW_MAX_STAGES
    max_width: int = 64                   # FLOW_MAX_WIDTH
    cache_enabled: bool = True            # CACHE_ENABLED
    cache_capacity: int = 4096            # CACHE_CAPACITY (entries; 0 = off)
    cache_model_version: str = "v1"       # CACHE_MODEL_VERSION
    # Billed est-cost per cache hit in the usage ledger — the "cache price"
    # a deduped result charges instead of chip-seconds.
    cache_price_per_hit: float = 0.0      # CACHE_PRICE_PER_HIT

    @staticmethod
    def from_env() -> "FlowConfig":
        return FlowConfig(
            enabled=env_bool("FLOW_ENABLED", True),
            max_stages=max(1, env_int("FLOW_MAX_STAGES", 32)),
            max_width=max(1, env_int("FLOW_MAX_WIDTH", 64)),
            cache_enabled=env_bool("CACHE_ENABLED", True),
            cache_capacity=max(0, env_int("CACHE_CAPACITY", 4096)),
            cache_model_version=env_str("CACHE_MODEL_VERSION", "v1"),
            cache_price_per_hit=max(
                0.0, env_float("CACHE_PRICE_PER_HIT", 0.0)
            ),
        )


@dataclass(frozen=True)
class LoadgenConfig:
    """Open-loop traffic generator knobs (the LOADGEN_* env
    surface, consumed by ``agent_tpu_torch/loadgen.py``).

    Arrivals follow a seeded non-homogeneous Poisson process:
    ``rate(t) = base_rate · (1 + diurnal_amplitude·sin(2πt/period)) ·
    burst_factor(t)`` — the diurnal term models the day/night swing of a
    planet-scale user base, the burst window the 10× thundering herd the
    autoscaler must absorb. The same seed always produces the same
    arrival schedule (open loop: arrivals never wait on completions)."""

    seed: int = 0                          # LOADGEN_SEED
    base_rate: float = 2.0                 # LOADGEN_RATE (jobs/sec)
    duration_sec: float = 30.0             # LOADGEN_DURATION_SEC
    # One burst window: rate multiplies by burst_factor inside
    # [burst_at_sec, burst_at_sec + burst_len_sec). factor 1 / len 0 = off.
    burst_factor: float = 10.0             # LOADGEN_BURST_FACTOR
    burst_at_sec: float = 0.0              # LOADGEN_BURST_AT_SEC
    burst_len_sec: float = 0.0             # LOADGEN_BURST_LEN_SEC
    # Sinusoidal diurnal modulation (0 = flat; 1 = full swing to zero).
    diurnal_amplitude: float = 0.0         # LOADGEN_DIURNAL_AMPLITUDE
    diurnal_period_sec: float = 86400.0    # LOADGEN_DIURNAL_PERIOD_SEC

    @staticmethod
    def from_env() -> "LoadgenConfig":
        return LoadgenConfig(
            seed=env_int("LOADGEN_SEED", 0),
            base_rate=max(0.0, env_float("LOADGEN_RATE", 2.0)),
            duration_sec=max(0.0, env_float("LOADGEN_DURATION_SEC", 30.0)),
            burst_factor=max(0.0, env_float("LOADGEN_BURST_FACTOR", 10.0)),
            burst_at_sec=max(0.0, env_float("LOADGEN_BURST_AT_SEC", 0.0)),
            burst_len_sec=max(0.0, env_float("LOADGEN_BURST_LEN_SEC", 0.0)),
            diurnal_amplitude=min(
                1.0, max(0.0, env_float("LOADGEN_DIURNAL_AMPLITUDE", 0.0))
            ),
            diurnal_period_sec=max(
                1e-3, env_float("LOADGEN_DIURNAL_PERIOD_SEC", 86400.0)
            ),
        )


@dataclass(frozen=True)
class AutoscaleConfig:
    """Elastic-fleet control loop knobs (the AUTOSCALE_* env
    surface, consumed by ``agent_tpu_torch/autoscale.py``).

    The loop scales up on queue pressure / SLO burn / starvation and down
    only after ``down_idle_evals`` consecutive idle judgments, with
    separate up/down cooldowns so a noisy signal cannot flap the fleet."""

    min_agents: int = 1                    # AUTOSCALE_MIN
    max_agents: int = 4                    # AUTOSCALE_MAX
    interval_sec: float = 2.0              # AUTOSCALE_INTERVAL_SEC
    # Scale up when queued jobs per live agent exceed this...
    up_queue_per_agent: float = 4.0        # AUTOSCALE_UP_QUEUE_PER_AGENT
    # ...or the oldest queued job has waited longer than this.
    up_starvation_sec: float = 10.0        # AUTOSCALE_UP_STARVATION_SEC
    # Members added per scale-up decision (capacity replacement after a
    # reclaim is separate and always allowed up to `max_agents`).
    step_up: int = 2                       # AUTOSCALE_STEP_UP
    step_down: int = 1                     # AUTOSCALE_STEP_DOWN
    # Scale down only after this many consecutive idle evaluations
    # (queue empty AND every live agent's duty cycle below down_max_duty).
    down_idle_evals: int = 3               # AUTOSCALE_DOWN_IDLE_EVALS
    down_max_duty: float = 0.10            # AUTOSCALE_DOWN_MAX_DUTY
    # Hysteresis: no scale-up within up_cooldown of the last scale-up; no
    # scale-down within down_cooldown of the last scale event either way.
    up_cooldown_sec: float = 5.0           # AUTOSCALE_UP_COOLDOWN_SEC
    down_cooldown_sec: float = 10.0        # AUTOSCALE_DOWN_COOLDOWN_SEC

    @staticmethod
    def from_env() -> "AutoscaleConfig":
        min_agents = max(0, env_int("AUTOSCALE_MIN", 1))
        return AutoscaleConfig(
            min_agents=min_agents,
            max_agents=max(min_agents, env_int("AUTOSCALE_MAX", 4)),
            interval_sec=max(0.05, env_float("AUTOSCALE_INTERVAL_SEC", 2.0)),
            up_queue_per_agent=max(
                0.1, env_float("AUTOSCALE_UP_QUEUE_PER_AGENT", 4.0)
            ),
            up_starvation_sec=max(
                0.1, env_float("AUTOSCALE_UP_STARVATION_SEC", 10.0)
            ),
            step_up=max(1, env_int("AUTOSCALE_STEP_UP", 2)),
            step_down=max(1, env_int("AUTOSCALE_STEP_DOWN", 1)),
            down_idle_evals=max(1, env_int("AUTOSCALE_DOWN_IDLE_EVALS", 3)),
            down_max_duty=min(
                1.0, max(0.0, env_float("AUTOSCALE_DOWN_MAX_DUTY", 0.10))
            ),
            up_cooldown_sec=max(
                0.0, env_float("AUTOSCALE_UP_COOLDOWN_SEC", 5.0)
            ),
            down_cooldown_sec=max(
                0.0, env_float("AUTOSCALE_DOWN_COOLDOWN_SEC", 10.0)
            ),
        )


@dataclass(frozen=True)
class PartitionConfig:
    """Partitioned control plane knobs (PARTITIONS/ROUTER_*).

    The router process (``python -m agent_tpu_torch.controller.router``) fronts
    either an EXISTING fleet of partition controllers (``partition_urls``
    names them, ``|``-separated alternates per partition for the hot
    standby's slot) or, when only ``partitions`` is set, N in-process
    partitions it boots itself — the single-host convenience mode.
    The steal decision's own knobs (STEAL_ENABLED / STEAL_MIN_ADVANTAGE)
    live with the policy in ``sched/steal.py``.
    """

    partitions: int = 0                   # PARTITIONS (0 = unpartitioned)
    partition_urls: str = ""              # PARTITION_URLS ("p0=url|alt,p1=url")
    router_host: str = "0.0.0.0"          # ROUTER_HOST
    router_port: int = 8800               # ROUTER_PORT
    # Steal-probe depth sample TTL: how stale the per-partition leasable
    # depths the router steals against may be.
    depth_cache_sec: float = 0.25         # ROUTER_DEPTH_CACHE_SEC
    # Per-proxied-request upstream timeout.
    timeout_sec: float = 30.0             # ROUTER_TIMEOUT_SEC

    @staticmethod
    def from_env() -> "PartitionConfig":
        return PartitionConfig(
            partitions=max(0, env_int("PARTITIONS", 0)),
            partition_urls=env_str("PARTITION_URLS", "").strip(),
            router_host=env_str("ROUTER_HOST", "0.0.0.0"),
            router_port=env_int("ROUTER_PORT", 8800),
            depth_cache_sec=max(
                0.0, env_float("ROUTER_DEPTH_CACHE_SEC", 0.25)
            ),
            timeout_sec=max(0.1, env_float("ROUTER_TIMEOUT_SEC", 30.0)),
        )

@dataclass(frozen=True)
class OpsConfig:
    """Per-op knobs that an op reads. The reference's class also carries
    ``summarize_model`` and the SAP/Oracle credentials, which nothing reads:
    the summarize ops resolve ``BART_MODEL`` themselves and the trigger ops
    read their credentials from the environment, in both packages."""

    # SUMMARIZE_FORCE_CPU=1 asks map_summarize for a CPU runtime; off, the
    # op runs on the card or fails (never a retry on the CPU).
    summarize_force_cpu: bool = False

    @staticmethod
    def from_env() -> "OpsConfig":
        return OpsConfig(summarize_force_cpu=env_bool("SUMMARIZE_FORCE_CPU", False))


@dataclass(frozen=True)
class Config:
    """The agent's whole configuration."""

    agent: AgentConfig = field(default_factory=AgentConfig)
    sizing: SizingConfig = field(default_factory=SizingConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    ops: OpsConfig = field(default_factory=OpsConfig)

    @staticmethod
    def from_env() -> "Config":
        return Config(agent=AgentConfig.from_env(), sizing=SizingConfig.from_env(),
                      serve=ServeConfig.from_env(), device=DeviceConfig.from_env(),
                      ops=OpsConfig.from_env())
