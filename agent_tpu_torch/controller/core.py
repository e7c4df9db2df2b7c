"""Controller scheduling core — the port's counterpart of
``agent_tpu.controller.core``, host code that imports no torch (protocol
per SURVEY.md §2.9, inferred from the reference client at
``app.py:162-213``). It differs from the reference in one place: a CSV
job's shard-size hint is read from the worker profile's ``tpu`` block or
its ``gpu`` block (:func:`sizing_block`), where the port's agents put it.

Design decisions:

- **Pull-based**: agents long-poll; the controller never initiates contact.
  A lease hands out up to ``max_tasks`` tasks whose op is in the agent's
  advertised capabilities.
- **Lease expiry**: each lease carries a TTL; a sweeper re-queues tasks whose
  lease expired, bumping ``job_epoch`` so the original agent's late result is
  fenced off (the reference protocol's whole point, ref ``app.py:201,209``).
- **Epoch fencing**: a result is accepted only if its ``job_epoch`` matches the
  job's current epoch; stale results are counted, not applied.
- **Shard splitting**: ``submit_csv_job`` turns ``(source_uri, total_rows,
  shard_size)`` into one task per shard addressed ``(start_row, shard_size)``
  — the reference's data-distribution primitive (ref ``ops/csv_shard.py:9-26``)
  — and an optional ``reduce_op`` job gated on the shards completing.
- **Delegated scheduling**: every lease decision goes through a
  pluggable ``sched.Scheduler``. The default ``fifo`` policy replays the
  historical inline queue scan bit-for-bit; ``SCHED_POLICY=fair`` adds
  priority tiers (0–9), weighted deficit-round-robin across tenants,
  load/capability-aware placement (device-bound ops prefer device agents, bulk
  shards prefer idle agents, deep-queue agents get shrunken grants),
  bounded admission (HTTP 429 + ``retry_after_ms`` past the pending
  budget), and deadline handling (``deadline_sec`` expiry lands terminal
  ``dead`` with a ``DeadlineExceeded`` reason; near-deadline pending jobs
  escalate one priority tier). The controller keeps owning correctness
  (state machine, fencing, labels, dependencies, journal); the policy owns
  only order and placement.
- **Fault injection** (SURVEY.md §5.3): ``inject(...)`` arms one-shot faults —
  ``drop_lease`` (issue no tasks once), ``duplicate_task`` (hand the same task
  to two leases), ``stale_epoch`` (bump a job's epoch right after leasing so
  the result arrives stale).

State is in-memory and lock-guarded; the HTTP layer in ``server.py`` is a
thin adapter over this class, so tests can drive it directly in-process.
Two durability/liveness extras beyond the reference protocol:

- **Background sweeper** (``sweep_interval_sec``): TTL expiry runs on a timer,
  not only inside ``lease()`` — with no polling agents, expired leases still
  re-queue and ``/v1/status`` stays truthful.
- **Append-only journal** (``journal_path``): submissions, accepted results,
  and expiry requeues are journaled as JSONL; a restarted controller replays
  the file and resumes a half-drained job — completed shards stay completed,
  in-flight ones re-queue at their current epoch (journaled fences replay;
  a result an agent spooled across the restart is accepted rather than
  re-executed, and the terminal-state guard keeps application at-most-once
  even if the job was re-leased meanwhile). Result *bodies* are durable only for jobs
  some other job depends on (reduce partials); journaling every drain shard's
  output would duplicate the whole dataset, so operators should fetch map
  results as shards complete (GET ``/v1/jobs/<id>``) or add a reduce stage.
  Snapshots bound the replay cost: with the ``JOURNAL_*``/``SNAPSHOT_*``
  knobs set, the journal rotates into segments with periodic compacting
  snapshots (``controller/journal.py``) so restart is O(live state), and a
  hot standby (the reference's ``controller/standby.py``, not ported yet)
  can tail it and promote with epoch fencing when this process dies.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from agent_tpu_torch.config import (
    FlowConfig,
    JournalConfig,
    ObsConfig,
    TRUTHY_TOKENS,
    SchedConfig,
    ServeConfig,
    SloConfig,
)
from agent_tpu_torch.controller.journal import SegmentedJournal
from agent_tpu_torch.flow.dag import (
    critical_path_lengths,
    expand_workflow,
    graph_doc,
    parse_workflow,
    spec_from_graph_doc,
)
from agent_tpu_torch.flow.result_cache import ResultCache
from agent_tpu_torch.ops import OP_TO_MODULE, is_cacheable
from agent_tpu_torch.controller.serving import (
    DONE as SERVE_DONE,
    SERVE_OPS,
    ServeBatch,
    ServeFrontDoor,
)
from agent_tpu_torch.data import wire
from agent_tpu_torch.obs.anomaly import AnomalyDetector
from agent_tpu_torch.obs.health import build_health
from agent_tpu_torch.obs.incident import IncidentBundler
from agent_tpu_torch.obs.profile import CaptureCoordinator, HostProfiler
from agent_tpu_torch.obs.timeseries import TimeSeriesRing
from agent_tpu_torch.obs.tsdb import TsdbStore, query_history
from agent_tpu_torch.obs.usage import UsageLedger
from agent_tpu_torch.obs.metrics import (
    MetricsRegistry,
    histogram_quantile,
    merge_snapshots,
    render_snapshots,
)
from agent_tpu_torch.obs.recorder import FlightRecorder, default_dump_path
from agent_tpu_torch.obs.reqlog import RequestLog, dominant_component
from agent_tpu_torch.obs.slo import SloTracker, parse_slo_spec
from agent_tpu_torch.obs.trace import TraceStore
from agent_tpu_torch.obs import trace as obs_trace
from agent_tpu_torch.sched import (
    DEFAULT_PRIORITY,
    DEFAULT_TENANT,
    PRIORITY_MAX,
    PRIORITY_MIN,
    AdmissionError,
    LeaseContext,
    make_scheduler,
)
from agent_tpu_torch.utils.logging import log
from agent_tpu_torch.utils.retry import PERMANENT, classify_error

# The worker-profile blocks a shard-size hint may ride. The reference reads
# ``tpu`` only; the port's agents, which claim no TPU, send theirs in the
# ``gpu`` block, and a reference agent's ``tpu`` block still works here.
SIZING_BLOCKS = ("tpu", "gpu")


def sizing_block(profile: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The first of ``profile``'s ``tpu``/``gpu`` blocks that carries a
    ``suggested_shard_rows`` hint, or None."""
    for name in SIZING_BLOCKS:
        block = (profile or {}).get(name)
        if isinstance(block, dict) and block.get("suggested_shard_rows"):
            return block
    return None


PENDING = "pending"
LEASED = "leased"
SUCCEEDED = "succeeded"
FAILED = "failed"      # permanent error — retrying cannot fix it
DEAD = "dead"          # transient failures exhausted the retry budget

# States no result post can move a job out of (`dead` joins the
# terminal set; duplicate completions against any of them are counted, not
# applied).
TERMINAL_STATES = (SUCCEEDED, FAILED, DEAD)

# Reference behavior: every failed job got exactly one retry (two attempts
# total). Kept as the default budget; per-job `max_attempts` overrides.
DEFAULT_MAX_ATTEMPTS = 2

# Reference default shard size (ref ops/csv_shard.py:62) — the fallback when
# no worker profile has suggested anything better.
DEFAULT_SHARD_ROWS = 100


def _truthy(value: Any) -> bool:
    """Truthiness for advertised label values, consistent with the env
    grammar (``config.env_bool``): AGENT_LABELS="tpu=false" advertises the
    *string* "false", which must not satisfy a True requirement."""
    if isinstance(value, str):
        return value.strip().lower() in TRUTHY_TOKENS
    return bool(value)


@dataclass
class Job:
    job_id: str
    op: str
    payload: Dict[str, Any]
    epoch: int = 0
    state: str = PENDING
    result: Any = None
    error: Any = None
    lease_id: Optional[str] = None
    lease_deadline: float = 0.0
    agent: Optional[str] = None
    attempts: int = 0
    # Per-job retry budget; None falls back to the controller default.
    max_attempts: Optional[int] = None
    # Requeue delay: a retried job is not leasable before this controller-
    # clock instant, so a crashing op can't hot-loop through the queue.
    not_before: float = 0.0
    # Controller-clock submit time (queue-wait attribution: submit→lease).
    submitted_at: float = 0.0
    # Jobs that must complete before this one becomes leasable (reduce
    # stages). ``after_order`` preserves submission order for partials
    # materialization (shard-10 must not precede shard-2); ``after`` is the
    # same ids as a set for O(1) dependency checks.
    after: Set[str] = field(default_factory=set)
    after_order: Tuple[str, ...] = ()
    # Label constraints: every key must appear in the leasing agent's labels,
    # and non-True values must match (the consumer side of the AGENT_LABELS
    # channel the protocol has always carried, reference app.py:49-63,168).
    required_labels: Dict[str, Any] = field(default_factory=dict)
    # Scheduling. priority 0–9 (9 = most urgent); tenant is the
    # fair-share bucket; deadline_sec counts from submit (re-anchored to
    # replay time after a restart — the journal carries no wall clock).
    priority: int = DEFAULT_PRIORITY
    tenant: str = DEFAULT_TENANT
    deadline_sec: Optional[float] = None
    # One-shot near-deadline escalation marker (sweeper bumps one tier).
    escalated: bool = False
    # Times the fair policy skipped this job waiting for a better-placed
    # agent; capped by SCHED_PLACEMENT_PATIENCE so preference never starves.
    placement_defers: int = 0
    # Distributed tracing: the job-lifetime root span opened at
    # submit, the currently-open lease span agent-side spans parent to, and
    # the controller-clock instant the job last became queued (what the
    # sched.decide span measures its wait from).
    root_span_id: Optional[str] = None
    lease_span_id: Optional[str] = None
    enqueued_clock: float = 0.0
    # Workflow DAG membership: stage jobs carry their graph id
    # and stage name so status/placement/tracing see the whole DAG as one
    # unit. ``critical_path`` is the longest remaining stage count to a
    # sink — the scheduler's critical-path-first tiebreak (0 = plain job,
    # which keeps non-DAG drain order bit-identical).
    workflow_id: Optional[str] = None
    stage: Optional[str] = None
    critical_path: int = 0

    @property
    def trace_root(self) -> str:
        """The trace this job's spans land in: its workflow's single tree
        when it is a DAG stage, else its own job-id trace (one trace
        tree per DAG)."""
        return self.workflow_id or self.job_id

    def to_task(self) -> Dict[str, Any]:
        task = {
            "id": self.job_id,
            "op": self.op,
            "payload": self.payload,
            "job_epoch": self.epoch,
            # Trace propagation: the agent stamps {job_id, attempt,
            # lease_id} into ctx.tags and result bodies, so one job's life
            # greps across journal, agent logs, and both flight recorders.
            "attempt": self.attempts,
        }
        if self.tenant != DEFAULT_TENANT:
            # Tenant plumb-through: agents stamp it into their
            # trace tags so per-tenant attribution greps across agent logs
            # and flight recorders too. Appended only when non-default —
            # single-tenant drains keep the exact legacy task bytes.
            task["tenant"] = self.tenant
        if self.lease_span_id is not None:
            # Causal parenting: agent-side stage/execute/post
            # spans hang off the lease span. Absent when tracing is off,
            # keeping the wire byte-identical to the pre-trace protocol.
            task["trace"] = {
                "trace_id": self.trace_root,
                "span_id": self.lease_span_id,
            }
        return task


class Controller:
    def __init__(
        self,
        lease_ttl_sec: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        journal_path: Optional[str] = None,
        sweep_interval_sec: Optional[float] = None,
        registry: Optional[MetricsRegistry] = None,
        recorder: Optional[FlightRecorder] = None,
        max_attempts: int = DEFAULT_MAX_ATTEMPTS,
        requeue_delay_sec: float = 0.0,
        sched: Optional[SchedConfig] = None,
        trace_store: Optional[TraceStore] = None,
        wire_binary: bool = True,
        slo: Optional[SloConfig] = None,
        obs: Optional[ObsConfig] = None,
        journal: Optional[JournalConfig] = None,
        serve: Optional[ServeConfig] = None,
        partition: Optional[str] = None,
        flow: Optional[FlowConfig] = None,
        tsdb_defer_open: bool = False,
    ) -> None:
        self.lease_ttl_sec = lease_ttl_sec
        # Partitioned control plane: this controller's partition
        # name, stamped into generated job/lease/request ids and the status
        # surfaces so any id or status doc names its owning partition. None
        # (the default) keeps every id byte-compatible with the
        # single-controller shape.
        self.partition = str(partition) if partition else None
        self._id_tag = f"{self.partition}-" if self.partition else ""
        # Binary shard wire: False = never negotiate (a JSON-only
        # controller for compatibility tests and WIRE_BINARY=0 operators);
        # agents that don't advertise are unaffected either way.
        self.wire_binary = bool(wire_binary)
        self.max_attempts = max(1, int(max_attempts))
        self.requeue_delay_sec = max(0.0, float(requeue_delay_sec))
        self.sched_config = sched if sched is not None else SchedConfig()
        # Workflow DAG engine + result cache. The cache is one
        # shared instance serving both planes: batch jobs (submit/lease
        # consult, report-time fill) and /v1/infer requests (front-door
        # consult before bucketing).
        self.flow_config = flow if flow is not None else FlowConfig()
        self.result_cache: Optional[ResultCache] = None
        if self.flow_config.cache_enabled \
                and self.flow_config.cache_capacity > 0:
            self.result_cache = ResultCache(
                capacity=self.flow_config.cache_capacity,
                model_version=self.flow_config.cache_model_version,
            )
        self._clock = clock
        self._lock = threading.Lock()
        self._jobs: Dict[str, Job] = {}
        self._faults: List[str] = []  # one-shot armed faults
        self._fault_plan = None      # seeded probabilistic plan (chaos.py)
        self.stale_results = 0
        self.last_metrics: Dict[str, Any] = {}
        self.last_profile: Dict[str, Any] = {}
        # Observability: an OWN registry/recorder per controller —
        # agents frequently share the process (tests, bench) and must not
        # conflate their series with the scheduler's.
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.recorder = recorder if recorder is not None else FlightRecorder()
        # Distributed tracing: the assembly point for the swarm's
        # span trees — controller-side spans land here directly; agent-side
        # spans arrive piggybacked on results/leases and are ingested, deduped
        # by span_id. Bounded like the flight recorder.
        self.traces = trace_store if trace_store is not None else TraceStore()
        # Per-agent telemetry keyed by agent id (replaces the overwritten
        # last_metrics as the fleet source of truth; last_metrics is kept as
        # the legacy /v1/status field). Each entry: {last_seen_wall, metrics
        # (sans obs), obs (the agent's registry snapshot)}.
        self.agent_metrics: Dict[str, Dict[str, Any]] = {}
        self._started_wall = time.time()
        m = self.metrics
        self._m_lease = m.counter(
            "controller_lease_requests_total",
            "Lease requests by outcome", ("outcome",))
        self._m_tasks_leased = m.counter(
            "controller_tasks_leased_total", "Tasks handed out", ("op",))
        self._m_results = m.counter(
            "controller_results_total",
            "Result posts by op and outcome (succeeded/failed/released/"
            "stale_epoch/duplicate/unknown_job)", ("op", "outcome"))
        self._m_retries = m.counter(
            "controller_retries_total",
            "Transiently-failed jobs re-queued within their retry budget",
            ("op",))
        self._m_dead = m.counter(
            "controller_jobs_dead_total",
            "Jobs that exhausted their retry budget (terminal `dead`)",
            ("op",))
        self._m_faults = m.counter(
            "controller_faults_injected_total",
            "Chaos faults injected controller-side (one-shot or plan)",
            ("fault",))
        self._m_journal_skipped = m.counter(
            "controller_journal_replay_skipped_total",
            "Unparseable mid-file journal lines skipped during replay")
        self._m_expirations = m.counter(
            "controller_lease_expirations_total",
            "Leases TTL-expired and re-queued", ("op",))
        self._m_journal_writes = m.counter(
            "controller_journal_writes_total", "Journal appends", ("ev",))
        self._m_queue_wait = m.histogram(
            "controller_queue_wait_seconds",
            "submit -> first lease latency", ("op",))
        # `state` separates jobs leasable right now from
        # jobs held back by a requeue delay (`not_before`) — the old
        # unlabeled gauge counted held jobs as leasable.
        self._m_queue_depth = m.gauge(
            "controller_queue_depth",
            "Queued (pending) jobs by leasability", ("state",))
        self._m_journal_torn = m.counter(
            "controller_journal_torn_tail_total",
            "Journal replays that found a torn (unparseable) final line")
        # Journal durability surface: segmentation/compaction
        # bookkeeping + the replay-cost number the micro-bench tracks.
        self._m_snapshots = m.counter(
            "controller_journal_snapshots_total",
            "Compacting journal snapshots committed (atomic tmp+rename)")
        self._m_snapshot_invalid = m.counter(
            "controller_journal_snapshot_invalid_total",
            "Snapshots ignored as invalid/half-written at replay (replay "
            "fell back to full segments)")
        self._m_segments = m.gauge(
            "controller_journal_segments",
            "Journal segment files currently on disk")
        self._m_journal_disk_bytes = m.gauge(
            "controller_journal_bytes",
            "Journal bytes on disk (segments; snapshot excluded)")
        self._m_snapshot_age = m.gauge(
            "controller_journal_snapshot_age_seconds",
            "Age of the newest compacting snapshot")
        self._m_replay_sec = m.gauge(
            "controller_journal_replay_seconds",
            "Wall-clock duration of this incarnation's journal replay")
        self._m_promotions = m.counter(
            "controller_promotions_total",
            "Hot-standby promotions completed by this process")
        # Scheduler observability: decision counters, per-tenant
        # queue depth, and how long jobs waited before their first lease
        # (the starvation signal the fair policy exists to bound).
        self._m_sched_decisions = m.counter(
            "sched_decisions_total",
            "Scheduler decisions (leased/deferred_placement/escalated/"
            "deadline_dead/admission_rejected)", ("policy", "decision"))
        self._m_sched_depth = m.gauge(
            "sched_queue_depth", "Queued jobs per tenant", ("tenant",))
        self._m_starvation = m.histogram(
            "sched_starvation_age_seconds",
            "Job age (since submit) at first lease, per tenant", ("tenant",))
        self._m_admission = m.counter(
            "controller_admission_rejections_total",
            "Submits rejected by admission control (HTTP 429)", ("tenant",))
        self._m_deadline_dead = m.counter(
            "controller_jobs_deadline_expired_total",
            "Pending jobs that ran out of deadline_sec (terminal `dead`, "
            "reason DeadlineExceeded)", ("op",))
        # Data-plane wire accounting: envelopes encoded/decoded
        # and raw HTTP bytes per route+direction (fed by server.py from
        # Content-Length / response sizes — real wire bytes, not estimates;
        # bench derives bytes/row from the scrape delta).
        self._m_wire = m.counter(
            "controller_wire_total",
            "Binary-wire envelopes by direction (task=encoded task "
            "payloads, result=decoded results, result_error=undecodable)",
            ("direction", "format"))
        self._m_http_bytes = m.counter(
            "controller_http_bytes_total",
            "HTTP bytes on the data-plane routes", ("route", "direction"))
        # Fleet health / SLO engine: declarative objectives fed by
        # submit→apply latencies at result-apply time, judged by multi-window
        # burn rates, rolled into GET /v1/health. SLO_ENABLED=0 leaves
        # self.slo None and no-ops the whole path (observe/evaluate/alerts).
        self.slo_config = slo if slo is not None else SloConfig()
        self.slo: Optional[SloTracker] = None
        # Page-entry auto-dump bookkeeping: dump paths written this process
        # (tests and the CI smoke assert on them), one dump per objective
        # per page episode.
        self.slo_dump_paths: List[str] = []
        if self.slo_config.enabled:
            # A malformed SLO_SPEC fails controller boot — an objective
            # typo silently judging nothing is the rot this refuses.
            self.slo = SloTracker(
                parse_slo_spec(self.slo_config.spec),
                registry=self.metrics,
                clock=self._clock,
                window_short_sec=self.slo_config.window_short_sec,
                window_long_sec=self.slo_config.window_long_sec,
                burn_warn=self.slo_config.burn_warn,
                burn_page=self.slo_config.burn_page,
                burn_exit_frac=self.slo_config.burn_exit_frac,
                on_alert=self._on_slo_alert,
            )
        # Resource accounting & continuous profiling: the showback
        # ledger billed at result-apply time, the trend ring sampled from
        # sweep/lease, on-demand deep-capture bookkeeping riding the lease
        # alerts channel, and a lazily-started host sampling profiler.
        # USAGE_ENABLED=0 / TSDB_ENABLED=0 leave the members None and no-op
        # every touch point (no families registered, no journal keys).
        self.obs_config = obs if obs is not None else ObsConfig()
        self.usage: Optional[UsageLedger] = None
        if self.obs_config.usage_enabled:
            self.usage = UsageLedger(
                registry=self.metrics,
                top_k=self.obs_config.usage_top_k,
                max_jobs=self.obs_config.usage_max_jobs,
                cost_per_chip_hour=self.obs_config.usage_cost_per_chip_hour,
                cache_price_per_hit=self.flow_config.cache_price_per_hit,
            )
        self.tsdb: Optional[TimeSeriesRing] = None
        if self.obs_config.tsdb_enabled:
            self.tsdb = TimeSeriesRing(
                window_sec=self.obs_config.tsdb_window_sec,
                interval_sec=self.obs_config.tsdb_interval_sec,
                clock=self._clock,
            )
        # Durable telemetry vertical: on-disk store + anomaly
        # detector + incident bundler, all riding the ring's sample hook.
        # A hot standby defers the store open (``tsdb_defer_open``) — two
        # incarnations must never append to the same segment stream;
        # ``finalize_promotion`` opens it when the replica takes over.
        self.tsdb_store: Optional[TsdbStore] = None
        self._tsdb_defer_open = bool(tsdb_defer_open)
        self._tsdb_prev_sample: Optional[Dict[str, Any]] = None
        self.anomaly: Optional[AnomalyDetector] = None
        if self.obs_config.anomaly_enabled and self.tsdb is not None:
            self.anomaly = AnomalyDetector(
                window=self.obs_config.anomaly_window,
                warmup=self.obs_config.anomaly_warmup,
                z_thresh=self.obs_config.anomaly_z,
                confirm=self.obs_config.anomaly_confirm,
                clear=self.obs_config.anomaly_clear,
            )
        self.incidents: Optional[IncidentBundler] = None
        if self.obs_config.incident_enabled:
            self.incidents = IncidentBundler(
                directory=self.obs_config.incident_dir,
                capacity=self.obs_config.incident_capacity,
                min_interval_sec=self.obs_config.incident_min_interval_sec,
            )
        if self.tsdb is not None:
            if not self._tsdb_defer_open:
                self._open_tsdb_store()
            self.tsdb.on_sample = self._on_tsdb_sample
        # Online-serving front door: POST /v1/infer requests
        # coalesce into length-bucketed interactive-tier batch jobs.
        # SERVE_ENABLED=0 leaves the door None and 501s the route.
        self.serve_config = serve if serve is not None else ServeConfig()
        self.serve_door: Optional[ServeFrontDoor] = None
        self._m_serve_requests = m.counter(
            "serve_requests_total",
            "POST /v1/infer requests by op and outcome "
            "(accepted/completed/failed/rejected)", ("op", "outcome"))
        self._m_serve_batches = m.counter(
            "serve_batches_total",
            "Coalesced serving batches by flush reason (full = hit "
            "SERVE_MAX_BATCH, deadline = oldest waited SERVE_MAX_WAIT_MS)",
            ("op", "reason"))
        self._m_serve_ttft = m.histogram(
            "serve_ttft_seconds",
            "Serving time-to-first-token per op (arrival -> first decode "
            "token; classify: arrival -> answer)", ("op",))
        self._m_serve_latency = m.histogram(
            "serve_latency_seconds",
            "Serving request latency per op (arrival -> completion fan-out)",
            ("op",))
        self._m_serve_tokens = m.counter(
            "serve_tokens_total",
            "Tokens emitted for completed serving requests", ("op",))
        # controller_-prefixed: the agents' live `serve_batch_occupancy`
        # gauge is the canonical one (the engine lives there) and the two
        # must not collide in the merged /v1/metrics exposition.
        self._m_serve_occupancy = m.gauge(
            "controller_serve_batch_occupancy",
            "Continuous-batching running-batch occupancy (mean requests "
            "seated per decode step, as reported by the last serving batch)")
        # Prefix-cache and paged-KV telemetry: serve results
        # carry per-batch deltas; the controller accumulates them so the
        # fleet-wide hit rate is one exposition read (swarmtop's column).
        self._m_serve_prefix = m.counter(
            "serve_prefix_cache_events_total",
            "Prefix-cache events reported by serving batches "
            "(hits = prefill rows served from cache, misses = rows that "
            "ran the encoder, evictions = LRU discards)", ("event",))
        self._m_serve_kv_total = m.gauge(
            "serve_kv_blocks_total",
            "Paged KV pool size in blocks, as reported by the last "
            "serving batch's engine (0 = dense layout)")
        self._m_serve_kv_free = m.gauge(
            "serve_kv_blocks_free",
            "Free paged KV blocks after the last serving batch drained")
        # TTFT decomposition + per-token pace. One request's
        # component observations telescope: bucket_wait + queue_wait +
        # prefill + handoff + kv_wait + first_decode = its measured TTFT.
        self._m_serve_ttft_component = m.histogram(
            "serve_ttft_component_seconds",
            "Serving TTFT decomposition per component: bucket_wait "
            "(coalescing), queue_wait (job queue + lease), prefill "
            "(encoder forward), handoff (prefill->decode transport, ~0 "
            "colocated), kv_wait (engine admit -> seated), first_decode "
            "(seated -> first token)", ("component",))
        self._m_serve_tpot = m.histogram(
            "serve_tpot_seconds",
            "Serving time-per-output-token per op: per-request mean step "
            "pace after the first token (requests with >= 2 decode steps)",
            ("op",))
        # Wide-event request log: one record per terminal
        # request, tail-sampled, served at GET /v1/debug/requests.
        self.reqlog: Optional[RequestLog] = None
        if self.serve_config.enabled:
            self.reqlog = RequestLog(
                capacity=self.serve_config.reqlog_capacity,
                sample=self.serve_config.reqlog_sample,
            )
            self.serve_door = ServeFrontDoor(
                self.serve_config, clock=self._clock, traces=self.traces,
                partition=self.partition,
            )
        self.captures = CaptureCoordinator()
        # Built on first GET /v1/profile/host (a controller never asked for
        # a flamegraph never spawns the sampler thread — tests construct
        # hundreds of Controllers).
        self.host_profiler: Optional[HostProfiler] = None
        self._host_profiler_lock = threading.Lock()
        # The policy object every lease decision delegates to.
        self._sched = make_scheduler(
            self.sched_config, on_decision=self._on_sched_decision
        )
        # Queued job ids currently held back by a requeue delay — the small
        # set scanned to split the depth gauge into leasable vs held.
        self._delayed: Set[str] = set()
        # Job ids carrying a deadline (non-terminal) — the sweeper's
        # deadline/escalation scan iterates only these.
        self._deadlined: Set[str] = set()
        # Tenants that ever had a sched_queue_depth sample: drained tenants
        # report 0 instead of a stale last value.
        self._seen_tenants: Set[str] = set()
        # The most recent profile that actually carried a sizing hint —
        # kept separately because in a mixed fleet every leasing agent
        # overwrites last_profile, and a CPU agent's poll must not revert
        # shard sizing to the fallback.
        self._last_sized_profile: Dict[str, Any] = {}
        # Job ids some other job depends on (reduce stages): their result
        # bodies must survive a restart, so only these journal results.
        self._depended_on: Set[str] = set()
        # Workflow DAG state: per-graph bookkeeping for status/
        # tracing, job -> (workflow, stage) membership, and the REVERSE dep
        # edges the generalized DependencyFailed cascade walks (forward
        # edges live on Job.after; without the reverse map a failure would
        # have to scan every job to find its dependents).
        self._workflows: Dict[str, Dict[str, Any]] = {}
        self._job_workflow: Dict[str, Tuple[str, str]] = {}
        self._dependents: Dict[str, Set[str]] = {}
        self._m_workflows = m.counter(
            "flow_workflows_total",
            "Workflow DAG submissions by outcome "
            "(submitted/succeeded/dead/rejected)", ("outcome",))
        self._m_flow_stage_jobs = m.counter(
            "flow_stage_jobs_total",
            "Jobs expanded out of workflow DAG stages", ("op",))
        self._m_result_cache = m.counter(
            "result_cache_events_total",
            "Content-addressed result cache events by plane "
            "(hit_submit/hit_lease/hit_infer = result served without "
            "compute; miss = consulted, absent; put = computed result "
            "stored)", ("event",))
        # Journal replay damage, distinctly visible to operators: a torn FINAL line (expected crash artifact, tolerated)
        # vs unparseable MID-FILE lines (real corruption). Mirrored from the
        # replay-time counters into /v1/status so "did my journal replay
        # clean" reads off one status call, not a metrics scrape.
        self.journal_torn_tail = 0
        self.journal_replay_skipped = 0
        # Replay cost, the number compaction exists to bound:
        # wall seconds + events this incarnation replayed before serving.
        self.journal_replay_sec = 0.0
        self.journal_replayed_events = 0
        self.promotions = 0
        self.journal_config = journal if journal is not None \
            else JournalConfig()
        self._journal_impl: Optional[SegmentedJournal] = None
        if journal_path:
            impl = SegmentedJournal(
                journal_path,
                segment_max_bytes=self.journal_config.segment_max_bytes,
                segment_max_events=self.journal_config.segment_max_events,
                snapshot_every_events=(
                    self.journal_config.snapshot_every_events
                ),
                fsync=self.journal_config.fsync,
                fsync_every=self.journal_config.fsync_every,
            )
            self._replay_journal(impl)
            impl.open_for_append()
            self._journal_impl = impl
        self._sweeper: Optional[threading.Thread] = None
        self._sweep_stop = threading.Event()
        if sweep_interval_sec:
            self.start_sweeper(sweep_interval_sec)

    def _on_sched_decision(
        self, decision: str, job_id: Optional[str] = None
    ) -> None:
        """Policy decision hook: counts every decision; policy decisions
        that name a job (placement deferrals) additionally leave an instant
        ``sched.defer`` span on the job's trace, so a deferred-placement
        wait is visible in the timeline, not just the aggregate counter.
        Called under the controller lock (from inside ``lease``)."""
        self._m_sched_decisions.inc(
            policy=self.sched_config.policy, decision=decision
        )
        if job_id is None:
            return
        job = self._jobs.get(job_id)
        if job is None or job.root_span_id is None:
            return
        self.traces.add({
            "trace_id": job.trace_root,
            "span_id": obs_trace.new_span_id(),
            "parent_span_id": job.root_span_id,
            "name": "sched.defer",
            "start_wall": time.time(),
            "start_mono": self._clock(),
            "duration_ms": 0.0,
            "process": "controller",
            "attributes": {
                "decision": decision,
                "policy": self.sched_config.policy,
                "defers": job.placement_defers,
            },
        })

    # ---- fleet health / SLO engine ----

    def _on_slo_alert(
        self, result: Dict[str, Any], old: str, new: str
    ) -> None:
        """Burn-rate alert transition hook (fires outside the controller
        lock — evaluate runs before/after lock-held sections). Entering
        ``page`` auto-dumps the controller flight-recorder ring, tagged
        with the breaching objective's ``{tier, op}`` — the post-hoc
        evidence that previously only existed for SIGUSR1/fatal paths."""
        selector = {
            k: result.get(k) for k in ("tier", "tenant", "op")
            if result.get(k) is not None
        }
        self.recorder.record(
            "slo_alert", objective=result.get("objective"),
            old_state=old, new_state=new,
            burn_short=result.get("burn_rate_short"),
            burn_long=result.get("burn_rate_long"), **selector,
        )
        log(
            "slo alert transition", objective=result.get("objective"),
            old=old, new=new, burn_short=result.get("burn_rate_short"),
            burn_long=result.get("burn_rate_long"),
        )
        if new != "page":
            return
        tag_bits = "-".join(
            f"{k}{v}" for k, v in selector.items()
        ) or "all"
        path = default_dump_path(
            f"controller-slo-{result.get('objective')}-{tag_bits}"
        )
        try:
            n = self.recorder.dump(path)
            self.slo_dump_paths.append(path)
            log("slo page — flight recorder dumped", path=path, events=n)
        except OSError:
            pass  # a failing dump must not take down the control plane
        # Incident forensics: page entry snapshots one
        # correlated bundle (the dump above folds in via slo_dumps).
        self._capture_incident(
            "slo_page",
            str(result.get("objective")),
            {
                "objective": result.get("objective"),
                "burn_short": result.get("burn_rate_short"),
                "burn_long": result.get("burn_rate_long"),
                **selector,
            },
        )

    def _slo_observe_locked(self, job: Job, now: float) -> None:
        """Feed one terminal job into the SLO tracker: submit→apply latency
        on the controller clock, success = SUCCEEDED. The tracker has its
        own lock and does a handful of integer bumps — cheap enough to run
        under the controller lock at drain scale."""
        if self.slo is None:
            return
        self.slo.observe(
            max(0.0, now - job.submitted_at),
            ok=job.state == SUCCEEDED,
            tier=job.priority,
            tenant=job.tenant,
            op=job.op,
            now=now,
        )

    def starvation_age_sec(self) -> Optional[float]:
        """Age (since submit) of the oldest currently-queued job — the live
        starvation signal /v1/health reports (the existing
        ``sched_starvation_age_seconds`` histogram only records at first
        lease, so a job that never leases is invisible to it)."""
        with self._lock:
            now = self._clock()
            ages = [
                now - self._jobs[jid].submitted_at
                for jid in self._sched.queued_ids()
                if jid in self._jobs
            ]
        return max(ages) if ages else None

    def health_json(self) -> Dict[str, Any]:
        """The ``GET /v1/health`` body: SLO attainment/burn states, queue
        pressure (per-tier depth + starvation age), per-agent duty
        cycle/MFU/liveness, and one rolled-up verdict — the signal vector
        ROADMAP item 4's autoscaler consumes."""
        slo_results = self.slo.evaluate() if self.slo is not None else []
        with self._lock:
            counts: Dict[str, int] = {}
            for job in self._jobs.values():
                counts[job.state] = counts.get(job.state, 0) + 1
            queue_depth = self._sched.total()
            by_tier = self._sched.depth_by_priority()
            now = self._clock()
            ages = [
                now - self._jobs[jid].submitted_at
                for jid in self._sched.queued_ids()
                if jid in self._jobs
            ]
            agents = {
                a: {
                    "last_seen_wall": e.get("last_seen_wall", 0.0),
                    "obs": e.get("obs"),
                    "draining": bool(e.get("draining")),
                }
                for a, e in self.agent_metrics.items()
            }
        return build_health(
            slo_enabled=self.slo is not None,
            slo_objectives=slo_results,
            counts=counts,
            queue_depth=queue_depth,
            queue_by_tier=by_tier,
            starvation_age_sec=max(ages) if ages else None,
            agents=agents,
            agent_stale_sec=self.slo_config.agent_stale_sec,
            partition=self.partition,
            anomalies=(
                self.anomaly.active() if self.anomaly is not None else ()
            ),
        )

    @property
    def _queue(self) -> List[str]:
        """Queued job ids in dispatch order (legacy introspection surface —
        the list the scheduler replaced; tests and debugging peek at it)."""
        return self._sched.queued_ids()

    def _update_queue_stats_locked(self, now: Optional[float] = None) -> None:
        """Refresh the depth gauges: controller_queue_depth{state} splits
        leasable from requeue-delay-held jobs; sched_queue_depth{tenant} is
        the per-tenant fair-share view. Only jobs that ever received a
        requeue delay are scanned (the ``_delayed`` set), so the hot submit
        path stays O(1) in queue length."""
        if now is None:
            now = self._clock()
        total = self._sched.total()
        held = 0
        for jid in list(self._delayed):
            job = self._jobs.get(jid)
            if job is None or job.state != PENDING or job.not_before <= now:
                self._delayed.discard(jid)
            else:
                held += 1
        self._m_queue_depth.set(total - held, state="leasable")
        self._m_queue_depth.set(held, state="held")
        depths = self._sched.depth_by_tenant()
        self._seen_tenants.update(depths)
        for tenant in self._seen_tenants:
            self._m_sched_depth.set(depths.get(tenant, 0), tenant=tenant)

    # ---- durability (journal) ----

    def _journal(self, event: Dict[str, Any]) -> None:
        # Caller holds the lock; writes are ordered with the state changes
        # they record. fsync is opt-in (JOURNAL_FSYNC): by
        # default the journal protects against controller restarts, not
        # kernel crashes, and a 10M-row drain posts thousands of results.
        if self._journal_impl is not None:
            self._journal_impl.append(event)
            self._m_journal_writes.inc(ev=str(event.get("ev", "?")))

    def _apply_replay_event(self, ev: Dict[str, Any]) -> None:
        """Apply ONE journal event to job state — the unit shared by
        restart replay and the hot standby's live tail. Caller
        holds the lock (or is pre-serving __init__)."""
        if ev.get("ev") == "submit":
            after_order = tuple(ev.get("after") or ())
            raw_max = ev.get("max_attempts")
            raw_deadline = ev.get("deadline_sec")
            job = Job(
                job_id=ev["job_id"],
                op=ev["op"],
                payload=ev.get("payload") or {},
                after=set(after_order),
                after_order=after_order,
                required_labels=ev.get("required_labels") or {},
                max_attempts=int(raw_max) if raw_max else None,
                # Journal schema vN+1: scheduling fields ride
                # the submit record only when the submitter set them, so
                # old journals (and default submissions) replay — and
                # re-journal — byte-identically.
                priority=int(
                    ev.get("priority", self.sched_config.default_priority)
                ),
                tenant=str(ev.get("tenant", DEFAULT_TENANT)),
                deadline_sec=float(raw_deadline) if raw_deadline else None,
            )
            # Workflow membership replays from the ``workflow``
            # event that preceded the stage submits in the journal — the
            # submit record itself stays byte-identical to every prior
            # schema.
            info = self._job_workflow.get(job.job_id)
            if info is not None:
                job.workflow_id, job.stage = info
                wf = self._workflows.get(job.workflow_id)
                if wf is not None:
                    job.critical_path = int(
                        wf["critical_path"].get(job.stage, 0)
                    )
            for dep in after_order:
                self._dependents.setdefault(dep, set()).add(job.job_id)
            self._jobs[job.job_id] = job
            self._depended_on.update(after_order)
        elif ev.get("ev") == "workflow":
            # Graph bookkeeping rebuilds BEFORE the stage submits replay;
            # the root span is recreated at finalize (traces are in-memory
            # and did not survive).
            self._register_workflow_locked(
                str(ev.get("workflow_id")),
                ev.get("graph") or {},
                tenant=str(ev.get("tenant", DEFAULT_TENANT)),
                priority=int(
                    ev.get("priority", self.sched_config.default_priority)
                ),
                stage_jobs={
                    str(k): list(v)
                    for k, v in (ev.get("stage_jobs") or {}).items()
                },
                root_span_id=None,
                now=self._clock(),
            )
        elif ev.get("ev") == "result":
            job = self._jobs.get(ev.get("job_id"))
            if job is None:
                return
            job.state = ev.get("state", job.state)
            job.epoch = int(ev.get("epoch", job.epoch))
            job.attempts = int(ev.get("attempts", job.attempts))
            job.result = ev.get("result")
            job.error = ev.get("error")
            if ev.get("cache_hit"):
                info = self._job_workflow.get(job.job_id)
                wf = (
                    self._workflows.get(info[0]) if info is not None else None
                )
                if wf is not None:
                    wf["cache_hits"] += 1
            if self.usage is not None and isinstance(
                ev.get("usage"), dict
            ):
                # Replay-correct showback: billed usage rides
                # the result event, so a restarted controller's
                # /v1/usage reports the same totals the dead one did.
                self.usage.bill(
                    job.job_id, tenant=job.tenant, tier=job.priority,
                    op=job.op, attempt=ev.get("attempts", 0),
                    usage=ev["usage"],
                )
        elif ev.get("ev") == "requeue":
            # Lease-expiry epoch bump: must replay, or a result the
            # previous incarnation had fenced off could be accepted
            # after restart (its epoch would collide with ours).
            job = self._jobs.get(ev.get("job_id"))
            if job is not None:
                job.epoch = int(ev.get("epoch", job.epoch))

    def _load_snapshot_state(
        self, doc: Dict[str, Any], mirror: bool = True
    ) -> None:
        """Rehydrate job state from a compacting snapshot. Job
        records are stored in insertion order, so the post-load requeue
        step reproduces exactly the scheduler order a full-history replay
        would have built. Results ride only for depended-on jobs — the
        same bound the journal's result events keep."""
        for wrec in doc.get("workflows") or []:
            # Workflow records load FIRST so job membership re-attaches
            # while the job records stream in below.
            if not isinstance(wrec, dict) or "workflow_id" not in wrec:
                continue
            self._register_workflow_locked(
                str(wrec["workflow_id"]),
                wrec.get("graph") or {},
                tenant=str(wrec.get("tenant", DEFAULT_TENANT)),
                priority=int(
                    wrec.get(
                        "priority", self.sched_config.default_priority
                    )
                ),
                stage_jobs={
                    str(k): list(v)
                    for k, v in (wrec.get("stage_jobs") or {}).items()
                },
                root_span_id=None,
                now=self._clock(),
            )
            wf = self._workflows[str(wrec["workflow_id"])]
            wf["cache_hits"] = int(wrec.get("cache_hits", 0))
        for rec in doc.get("jobs") or []:
            after_order = tuple(rec.get("after") or ())
            raw_max = rec.get("max_attempts")
            raw_deadline = rec.get("deadline_sec")
            job = Job(
                job_id=rec["job_id"],
                op=rec.get("op", "?"),
                payload=rec.get("payload") or {},
                epoch=int(rec.get("epoch", 0)),
                state=str(rec.get("state", PENDING)),
                attempts=int(rec.get("attempts", 0)),
                result=rec.get("result"),
                error=rec.get("error"),
                after=set(after_order),
                after_order=after_order,
                required_labels=rec.get("required_labels") or {},
                max_attempts=int(raw_max) if raw_max else None,
                priority=int(
                    rec.get("priority", self.sched_config.default_priority)
                ),
                tenant=str(rec.get("tenant", DEFAULT_TENANT)),
                deadline_sec=float(raw_deadline) if raw_deadline else None,
            )
            info = self._job_workflow.get(job.job_id)
            if info is not None:
                job.workflow_id, job.stage = info
                wfrec = self._workflows.get(job.workflow_id)
                if wfrec is not None:
                    job.critical_path = int(
                        wfrec["critical_path"].get(job.stage, 0)
                    )
            for dep in after_order:
                self._dependents.setdefault(dep, set()).add(job.job_id)
            self._jobs[job.job_id] = job
            self._depended_on.update(after_order)
        if self.usage is not None and isinstance(doc.get("usage"), dict):
            self.usage.import_state(doc["usage"], mirror=mirror)

    def _finalize_replay_locked(self) -> None:
        """The replay→serving transition: jobs that were pending or in
        flight when the previous controller died re-queue at their CURRENT
        epoch — deliberately NOT bumped. Every deliberate fence
        (expiry/retry requeue) was journaled and already replayed; bumping
        here as well would fence the *good* results agents spooled while
        the controller was down, re-executing finished shards on every
        restart. An agent whose lease straddled the restart redelivers at
        the same epoch and is accepted; if the job was meanwhile re-leased
        and completed by someone else, the terminal-state guard rejects
        the second application (first wins) — never applied twice either
        way. Shared by restart replay and hot-standby promotion."""
        now = self._clock()
        # Workflow progress recomputes from the replayed job states
        #: counters fold whatever mix of snapshot + events got
        # us here, and still-running graphs get a fresh root span so
        # post-restart stage spans keep assembling into ONE tree.
        for wf in self._workflows.values():
            terminal = failed = 0
            for ids in wf["stage_jobs"].values():
                for jid in ids:
                    job = self._jobs.get(jid)
                    if job is None:
                        # Retention-dropped terminal stage job: it only
                        # left the snapshot because it was terminal.
                        terminal += 1
                        continue
                    if job.state in TERMINAL_STATES:
                        terminal += 1
                        if job.state != SUCCEEDED:
                            failed += 1
            wf["terminal_jobs"] = terminal
            wf["failed_jobs"] = failed
            if terminal >= wf["total_jobs"]:
                wf["state"] = "succeeded" if failed == 0 else "dead"
            else:
                wf["state"] = "running"
                wf["root_span_id"] = self.traces.open(
                    wf["workflow_id"], "workflow", start_clock=now,
                    attributes={
                        "replayed": True, "tenant": wf["tenant"],
                        "stages": len(wf["stage_order"]),
                    },
                )
        for job in self._jobs.values():
            if job.state not in TERMINAL_STATES:
                job.state = PENDING
                job.lease_id = None
                # Deadlines re-anchor to replay time (the journal carries no
                # wall clock); queue-wait attribution restarts here too.
                job.submitted_at = now
                job.enqueued_clock = now
                # Traces are in-memory and did not survive the restart: a
                # fresh root span lets post-restart spans still assemble.
                parent_span = None
                if job.workflow_id is not None:
                    wf = self._workflows.get(job.workflow_id)
                    parent_span = (wf or {}).get("root_span_id")
                job.root_span_id = self.traces.open(
                    job.trace_root, "submit", parent_span_id=parent_span,
                    start_clock=now,
                    attributes={"op": job.op, "replayed": True},
                )
                self._sched.add(job)
                if job.deadline_sec is not None:
                    self._deadlined.add(job.job_id)
            elif (
                self.result_cache is not None
                and job.state == SUCCEEDED
                and not job.after_order
                and isinstance(job.result, dict)
                and is_cacheable(job.op)
            ):
                # Warm the result cache from replayed dep-free results: a
                # restart must not forfeit the dedupe it already earned.
                # (Dep-gated jobs are skipped — their cache key covers the
                # lease-time materialized partials, not the submit
                # payload.)
                self.result_cache.put(job.op, job.payload, job.result)
        # Replay-ordering re-arm/cascade fix: a
        # dep-gated job is requeued above in whatever state its upstreams
        # REPLAYED to, which can differ from the order things happened
        # live — an upstream that went terminal between the downstream's
        # submit record and the journal tail. Success re-arms for free
        # (dep checks read live state at lease time), but a FAILED/DEAD
        # upstream used to strand the dependent in pending forever: the
        # only cascade ran inside ``_serve_reap`` and touched serve jobs
        # alone. Walk the general cascade for every replayed failure so
        # batch/DAG dependents die (and journal) the same way live ones
        # do.
        for job in list(self._jobs.values()):
            if job.state in (FAILED, DEAD):
                self._cascade_dep_failure_locked(job, now)
        self._update_queue_stats_locked(now)

    def _replay_journal(self, impl: SegmentedJournal) -> None:
        """Rebuild job state from a previous incarnation's journal:
        snapshot (when present and valid) + uncovered segments. Runs
        before the journal opens for append, without the lock (no other
        thread can hold a reference yet)."""
        t0 = time.perf_counter()
        snap, events, stats = impl.replay()
        if snap is not None:
            self._load_snapshot_state(snap)
        for ev in events:
            self._apply_replay_event(ev)
        stats.duration_sec = time.perf_counter() - t0
        if stats.torn_tail:
            self._m_journal_torn.inc(stats.torn_tail)
            self.journal_torn_tail += stats.torn_tail
        if stats.skipped:
            # Mid-stream corruption is NOT a torn write: something else
            # damaged the journal. Skipping silently would quietly
            # resurrect or lose jobs, so count + warn.
            self.journal_replay_skipped += stats.skipped
            self._m_journal_skipped.inc(stats.skipped)
            log(
                "journal replay skipped unparseable mid-file lines",
                path=impl.path, count=stats.skipped,
                lines=stats.skipped_lines,
            )
        if stats.snapshot_invalid:
            self._m_snapshot_invalid.inc(stats.snapshot_invalid)
        self.journal_replay_sec = stats.duration_sec
        self.journal_replayed_events = stats.events
        self._m_replay_sec.set(round(stats.duration_sec, 6))
        self._finalize_replay_locked()

    # ---- snapshot / compaction ----

    def _snapshot_state_locked(self) -> Dict[str, Any]:
        """Live state as one snapshot document: every job's replayable
        fields (in insertion order — the order replay rebuilds the
        scheduler from), result bodies only for depended-on jobs (the
        journal's own bound — a snapshot must not become a second copy of
        the drain output), and the usage ledger.

        Terminal-job retention (``SNAPSHOT_RETAIN_TERMINAL``): with a
        positive bound, only the newest N *droppable* terminal jobs ride
        the snapshot — jobs some non-terminal job still depends on are
        never dropped (a reduce must find its partials after a restart).
        Restart then forgets older completed jobs; their late duplicates
        reject as ``unknown job`` (still never re-applied), and restart
        cost becomes O(live state + N) regardless of history length."""
        retain = self.journal_config.snapshot_retain_terminal
        drop: Set[str] = set()
        if retain > 0:
            protected: Set[str] = set()
            for job in self._jobs.values():
                if job.state not in TERMINAL_STATES:
                    protected.update(job.after)
            droppable = [
                job.job_id for job in self._jobs.values()
                if job.state in TERMINAL_STATES
                and job.job_id not in protected
            ]
            if len(droppable) > retain:
                drop = set(droppable[: len(droppable) - retain])
        jobs: List[Dict[str, Any]] = []
        for job in self._jobs.values():
            if job.job_id in drop:
                continue
            rec: Dict[str, Any] = {
                "job_id": job.job_id,
                "op": job.op,
                "payload": job.payload,
                "state": job.state,
                "epoch": job.epoch,
                "attempts": job.attempts,
                "error": job.error,
                "after": list(job.after_order),
                "required_labels": job.required_labels,
                "max_attempts": job.max_attempts,
                "priority": job.priority,
                "tenant": job.tenant,
                "deadline_sec": job.deadline_sec,
            }
            if (
                job.job_id in self._depended_on
                or job.workflow_id is not None
            ):
                rec["result"] = job.result
            jobs.append(rec)
        state: Dict[str, Any] = {"jobs": jobs}
        if self._workflows:
            # Workflow graphs ride the snapshot the same way
            # the ``workflow`` journal event rides the segments: replay
            # re-attaches stage-job membership from them. Progress
            # counters recompute from job states at finalize; only the
            # cache-hit count (not derivable from state) is carried.
            state["workflows"] = [
                {
                    "workflow_id": wf["workflow_id"],
                    "tenant": wf["tenant"],
                    "priority": wf["priority"],
                    "graph": wf["graph"],
                    "stage_jobs": wf["stage_jobs"],
                    "cache_hits": wf["cache_hits"],
                }
                for wf in self._workflows.values()
            ]
        if drop:
            state["dropped_terminal"] = len(drop)
        if self.usage is not None:
            # The ledger is aggregate-bounded on its own (USAGE_MAX_JOBS)
            # and keeps billing history for retention-dropped jobs — the
            # (job, attempt) dedupe must survive even for forgotten jobs.
            state["usage"] = self.usage.export_state()
        return state

    def maybe_snapshot(self, force: bool = False) -> Optional[str]:
        """Take a compacting snapshot when the configured cadence is due
        (``SNAPSHOT_EVERY_EVENTS`` appends since the last one). Called
        from ``sweep()`` and the post-lease backstop; ``force=True`` is
        the operator/test handle. The active segment rotates and the state
        captures under the lock; the atomic write + covered-segment GC
        run outside it. Returns the snapshot path, or None when not due
        or snapshotting is off."""
        impl = self._journal_impl
        if impl is None or not impl.segmented:
            return None
        if not force and not impl.snapshot_every_events:
            return None
        with self._lock:
            if not force and not impl.snapshot_due():
                return None
            through = impl.rotate_for_snapshot()
            state = self._snapshot_state_locked()
        path = impl.commit_snapshot(through, state)
        self._m_snapshots.inc()
        self.recorder.record(
            "journal_snapshot", through_seq=through, jobs=len(state["jobs"]),
        )
        return path

    def journal_status(self) -> Dict[str, Any]:
        """The ``/v1/status`` ``journal`` durability block: replay damage + segment/snapshot/replay-cost numbers,
        one schema whether or not a journal is configured."""
        impl = self._journal_impl
        file_stats = impl.stats() if impl is not None else {}
        out = {
            "torn_tail": self.journal_torn_tail,
            "replay_skipped": self.journal_replay_skipped,
            "enabled": impl is not None,
            "segmented": bool(file_stats.get("segmented")),
            "segments": int(file_stats.get("segments", 0)),
            "bytes": int(file_stats.get("bytes", 0)),
            "snapshot_bytes": int(file_stats.get("snapshot_bytes", 0)),
            "snapshots_written": int(
                file_stats.get("snapshots_written", 0)
            ),
            "last_snapshot_age_sec": file_stats.get(
                "last_snapshot_age_sec"
            ),
            "last_replay_sec": round(self.journal_replay_sec, 6),
            "replayed_events": self.journal_replayed_events,
            "fsync": bool(file_stats.get("fsync")),
            "promotions": self.promotions,
        }
        if self.partition:
            out["partition"] = self.partition
        # Mirror the file-side numbers into gauges so the scrape surface
        # tracks them too (swarmtop, tsdb sparklines).
        if impl is not None:
            self._m_segments.set(out["segments"])
            self._m_journal_disk_bytes.set(out["bytes"])
            if out["last_snapshot_age_sec"] is not None:
                self._m_snapshot_age.set(out["last_snapshot_age_sec"])
        return out

    # ---- hot-standby surface (driven by controller/standby.py) --

    def apply_snapshot_doc(
        self, doc: Dict[str, Any], mirror: bool = True
    ) -> None:
        """Standby bootstrap/resync: load a snapshot into this replica
        under the lock. A RESYNC (the primary's compaction GC'd segments
        before the tail finished reading them) overwrites every job with
        the snapshot's authoritative fold — convergent, since the
        snapshot covers everything the lost segments held."""
        with self._lock:
            self._load_snapshot_state(doc, mirror=mirror)

    def apply_journal_event(self, ev: Dict[str, Any]) -> int:
        """Standby tail: apply one primary journal event to the warm
        replica. Returns 1 (applied) so callers can count lag drains."""
        with self._lock:
            self._apply_replay_event(ev)
        return 1

    def finalize_promotion(
        self,
        impl: SegmentedJournal,
        sweep_interval_sec: Optional[float] = None,
    ) -> None:
        """Promote this warm replica to the live controller: run the
        replay→serving transition (non-terminal jobs requeue at their
        current epoch — the same applied-once-or-cleanly-rejected fencing
        a restart gets), attach the journal for append (the standby opens
        it on a FRESH segment so a lingering primary file handle can never
        interleave with the new incarnation's appends), and start the
        sweeper."""
        with self._lock:
            self._finalize_replay_locked()
            self._journal_impl = impl
            self.promotions += 1
        self._m_promotions.inc()
        self.recorder.record("promotion", path=impl.path)
        log("standby promoted to primary", journal=impl.path)
        # Durable telemetry: the replica deferred the tsdb
        # store open (the dead primary owned the segment streams); the
        # promoted incarnation reopens them — open_for_append seals any
        # torn tail — so pre-kill history stays queryable after failover.
        self._open_tsdb_store()
        if sweep_interval_sec:
            self.start_sweeper(sweep_interval_sec)

    # ---- liveness (background TTL sweeper) ----

    def sweep(self) -> None:
        """Re-queue expired leases and enforce deadlines now (both also run
        inside every ``lease()``)."""
        with self._lock:
            self._expire_leases_locked()
            self._expire_deadlines_locked()
            # Held → leasable is a time-passive transition (not_before
            # elapsing): the sweep is what keeps the split gauge truthful
            # with no lease traffic.
            self._update_queue_stats_locked()
        if self.slo is not None:
            # Burn states must decay without traffic too (recovery after the
            # last slow request is itself a window rollover) — the sweeper
            # is the no-traffic evaluation cadence. Outside the lock: the
            # alert hook does file I/O on page entry.
            self.slo.evaluate()
        # Serving flush/reap: the sweeper keeps the front door
        # moving with no lease traffic — deadline flushes and completion
        # fan-outs don't wait for an agent poll.
        if self.serve_door is not None:
            self._serve_pump()
        # Trend ring: the sweeper is the steady sampling cadence;
        # the lease path backstops it under sweeper-less tests/drains.
        self._tsdb_sample()
        # Compaction cadence: snapshot when enough has been
        # journaled since the last one. Outside the state lock except for
        # the rotation + state capture inside maybe_snapshot itself. A
        # failing snapshot write must not kill the sweeper — segments
        # still replay, and the next cadence retries.
        try:
            self.maybe_snapshot()
        except OSError as exc:
            log("snapshot failed (segments still replay)",
                error=str(exc)[:200])

    def _tsdb_sample(self) -> None:
        """Rate-limited time-series sample (controller registry + fleet
        merge). Runs OUTSIDE the controller lock — fleet_snapshot takes it —
        and costs one clock read when no sample is due. The ring's
        ``on_sample`` hook fans each recorded sample out to the durable
        store and the anomaly detector."""
        if self.tsdb is not None:
            self.tsdb.maybe_sample(
                lambda: (self.metrics.snapshot(), self.fleet_snapshot())
            )

    # ---- durable telemetry / anomaly / incidents ----

    def _open_tsdb_store(self) -> None:
        """Open (or reopen after promotion) the on-disk store. Idempotent;
        a failed open degrades to ring-only telemetry, never a crash."""
        if (
            self.tsdb is None
            or not self.obs_config.tsdb_dir
            or self.tsdb_store is not None
        ):
            return
        try:
            self.tsdb_store = TsdbStore(
                self.obs_config.tsdb_dir,
                segment_max_bytes=self.obs_config.tsdb_segment_bytes,
                retention_raw_sec=self.obs_config.tsdb_retention_raw_sec,
                retention_1m_sec=self.obs_config.tsdb_retention_1m_sec,
                retention_10m_sec=self.obs_config.tsdb_retention_10m_sec,
                max_bytes=self.obs_config.tsdb_max_bytes,
            )
        except OSError as exc:
            log("tsdb store open failed (ring-only telemetry)",
                dir=self.obs_config.tsdb_dir, error=str(exc)[:200])

    def _on_tsdb_sample(
        self, wall: float, mono: float, data: Dict[str, Dict[str, float]]
    ) -> None:
        """Ring sample hook: persist to disk, score for anomalies, and
        bundle an incident when one confirms. Runs on the sampling thread
        (sweeper or lease path), outside the controller lock."""
        if self.tsdb_store is not None:
            self.tsdb_store.append_sample(wall, data)
        if self.anomaly is None:
            self._tsdb_prev_sample = {"wall": wall, "data": data}
            return
        sample = {"wall": wall, "data": data}
        events = self.anomaly.observe(self._tsdb_prev_sample, sample)
        self._tsdb_prev_sample = sample
        for ev in events:
            self.recorder.record("anomaly", **ev)
            log("anomaly confirmed", watch=ev.get("watch"),
                value=ev.get("value"), z=ev.get("z"))
            self._capture_incident(
                "anomaly", str(ev.get("watch")), dict(ev)
            )

    def _capture_incident(
        self, kind: str, key: str, reason: Dict[str, Any]
    ) -> None:
        """Snapshot one correlated forensics bundle: the telemetry window
        around the event, flight-recorder tail + today's SLO dumps, the
        reqlog slow tail, traces of the K worst requests, status and
        health. Bounded and content-addressed by the bundler; dedup and
        rate-limiting happen there too."""
        if self.incidents is None:
            return
        sections: Dict[str, Any] = {}
        if self.tsdb is not None:
            watched = [
                "controller_queue_depth", "serve_ttft_seconds_sum",
                "serve_ttft_seconds_count", "serve_kv_blocks_free",
                "device_duty_cycle", "result_post_failures_total",
                "controller_results_total",
            ]
            window: Dict[str, Any] = {}
            for name in watched:
                series = self.tsdb.series(name, window_sec=600.0)
                if series:
                    window[name] = series
            sections["timeseries"] = window
        sections["flight_recorder"] = self.recorder.events()[-200:]
        if self.slo_dump_paths:
            sections["slo_dumps"] = list(self.slo_dump_paths)[-8:]
        worst: List[Dict[str, Any]] = []
        if self.reqlog is not None:
            slow = self.reqlog.snapshot(slow=True, limit=64)
            sections["reqlog_slow"] = slow[:32]
            worst = sorted(
                (r for r in slow if isinstance(
                    r.get("ttft_ms"), (int, float))),
                key=lambda r: float(r["ttft_ms"]), reverse=True,
            )[: self.obs_config.incident_worst_k]
        if worst:
            traces = []
            for rec in worst:
                req_id = rec.get("req_id")
                if not req_id:
                    continue
                doc = self.traces.assemble(str(req_id))
                if doc is not None:
                    traces.append(doc)
            if traces:
                sections["worst_request_traces"] = traces
        sections["status"] = {
            "counts": self.counts(),
            "queue_depth": self.queue_depth(),
            "journal": self.journal_status(),
            "promotions": self.promotions,
            "partition": self.partition,
        }
        try:
            sections["health"] = self.health_json()
        except Exception:  # noqa: BLE001 — forensics best-effort
            pass
        bundle = self.incidents.capture(kind, key, reason, sections)
        if bundle is not None:
            self.recorder.record(
                "incident", id=bundle["id"], trigger=kind, key=key,
            )
            log("incident bundle captured", id=bundle["id"], kind=kind,
                key=key)

    def incidents_json(self, incident_id: Optional[str] = None) -> \
            Dict[str, Any]:
        """The ``GET /v1/incidents{,/id}`` body."""
        if self.incidents is None:
            if incident_id is not None:
                return {"enabled": False, "incident": None}
            return {"enabled": False, "incidents": [], "stats": {}}
        if incident_id is not None:
            return {
                "enabled": True,
                "incident": self.incidents.get(incident_id),
            }
        return {
            "enabled": True,
            "incidents": self.incidents.list(),
            "stats": self.incidents.stats(),
        }

    def timeseries_export_json(
        self, since: float, limit: int = 2000
    ) -> Dict[str, Any]:
        """The ``GET /v1/timeseries/export`` body — raw ring samples
        newer than ``since`` (the router collector's delta-scrape
        cursor)."""
        if self.tsdb is None:
            return {"enabled": False, "samples": [], "now": time.time()}
        return {
            "enabled": True,
            "samples": self.tsdb.samples_since(float(since), limit=limit),
            "interval_sec": self.tsdb.interval_sec,
            "partition": self.partition,
            "now": time.time(),
        }

    def start_sweeper(self, interval_sec: float = 5.0) -> None:
        """TTL enforcement without traffic: a daemon thread sweeping every
        ``interval_sec`` so dead agents' tasks re-queue even when no other
        agent is polling."""
        if self._sweeper is not None:
            return
        self._sweep_stop.clear()

        def loop() -> None:
            while not self._sweep_stop.wait(interval_sec):
                self.sweep()

        self._sweeper = threading.Thread(
            target=loop, name="lease-sweeper", daemon=True
        )
        self._sweeper.start()

    def close(self) -> None:
        """Stop the sweeper and close the journal (idempotent)."""
        if self.host_profiler is not None:
            self.host_profiler.stop()
        self._sweep_stop.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=5)
            self._sweeper = None
        if self.tsdb_store is not None:
            self.tsdb_store.close()
        with self._lock:
            if self._journal_impl is not None:
                self._journal_impl.close()
                self._journal_impl = None

    # ---- job submission ----

    def _admit_locked(self, tenant: str, n: int = 1) -> None:
        """Admission control: raise ``AdmissionError`` (wire: 429
        + retry_after_ms) when accepting ``n`` more jobs would breach the
        global or per-tenant pending budget. Budgets of 0 = unbounded, so
        the default configuration admits everything (fifo bit-compat)."""
        cfg = self.sched_config
        if cfg.max_pending and self._sched.total() + n > cfg.max_pending:
            self._m_admission.inc(tenant=tenant)
            self.recorder.record(
                "admission_rejected", tenant=tenant, scope="global",
                pending=self._sched.total(), budget=cfg.max_pending,
            )
            self._m_sched_decisions.inc(
                policy=cfg.policy, decision="admission_rejected")
            raise AdmissionError(
                f"pending budget exhausted ({self._sched.total()} queued, "
                f"global budget {cfg.max_pending})",
                retry_after_ms=cfg.retry_after_ms, tenant=tenant,
                scope="global",
            )
        if cfg.max_pending_per_tenant and (
            self._sched.depth_for(tenant) + n > cfg.max_pending_per_tenant
        ):
            self._m_admission.inc(tenant=tenant)
            self.recorder.record(
                "admission_rejected", tenant=tenant, scope="tenant",
                pending=self._sched.depth_for(tenant),
                budget=cfg.max_pending_per_tenant,
            )
            self._m_sched_decisions.inc(
                policy=cfg.policy, decision="admission_rejected")
            raise AdmissionError(
                f"tenant {tenant!r} pending budget exhausted "
                f"({self._sched.depth_for(tenant)} queued, budget "
                f"{cfg.max_pending_per_tenant})",
                retry_after_ms=cfg.retry_after_ms, tenant=tenant,
                scope="tenant",
            )

    def submit(
        self,
        op: str,
        payload: Optional[Dict[str, Any]] = None,
        job_id: Optional[str] = None,
        after: Optional[Sequence[str]] = None,
        required_labels: Optional[Dict[str, Any]] = None,
        max_attempts: Optional[int] = None,
        priority: Optional[int] = None,
        tenant: Optional[str] = None,
        deadline_sec: Optional[float] = None,
        workflow_id: Optional[str] = None,
        stage: Optional[str] = None,
        critical_path: int = 0,
    ) -> str:
        """Submit one job. The trailing workflow kwargs are internal —
        ``submit_workflow`` stamps DAG membership (graph id, stage name,
        remaining-critical-path length) onto the stage jobs it expands;
        they are deliberately NOT journaled on the submit record (the
        ``workflow`` journal event carries the graph once, and replay
        re-attaches membership from it), keeping plain submit bytes
        identical to every prior journal schema."""
        job_id = job_id or f"job-{self._id_tag}{uuid.uuid4().hex[:12]}"
        if priority is not None:
            if (
                isinstance(priority, bool)
                or not isinstance(priority, int)
                or not PRIORITY_MIN <= priority <= PRIORITY_MAX
            ):
                raise ValueError(
                    f"priority must be an int in "
                    f"[{PRIORITY_MIN}, {PRIORITY_MAX}], got {priority!r}"
                )
        if tenant is not None and (
            not isinstance(tenant, str) or not tenant
        ):
            raise ValueError(f"tenant must be a non-empty string, got {tenant!r}")
        if deadline_sec is not None:
            if (
                isinstance(deadline_sec, bool)
                or not isinstance(deadline_sec, (int, float))
                or deadline_sec <= 0
            ):
                raise ValueError(
                    f"deadline_sec must be a positive number, got "
                    f"{deadline_sec!r}"
                )
        if max_attempts is not None:
            if (
                isinstance(max_attempts, bool)
                or not isinstance(max_attempts, int)
                or max_attempts < 1
            ):
                raise ValueError(
                    f"max_attempts must be a positive int, got {max_attempts!r}"
                )
        required_labels = dict(required_labels or {})
        for k, v in required_labels.items():
            # Non-scalar requirements can never match the AGENT_LABELS
            # grammar (strings or True) — rejecting here turns would-be
            # silent starvation into an immediate submit error.
            if not isinstance(k, str) or not k:
                raise ValueError(f"required_labels keys must be strings, got {k!r}")
            scalar_ok = v is True or (
                isinstance(v, (str, int, float)) and not isinstance(v, bool)
            )
            if not scalar_ok:
                raise ValueError(
                    f"required_labels[{k!r}] must be True or a scalar, got {v!r}"
                )
        if isinstance(after, (set, frozenset)):
            # collect_partials materializes dependency results in after
            # order — an unordered collection would make shard order
            # nondeterministic. Force callers to pass a sequence.
            raise ValueError("after must be an ordered sequence, not a set")
        if isinstance(after, str):
            # tuple("job-1") would split into characters and the dependency
            # would silently vanish (unknown ids are skipped in dep checks).
            raise ValueError("after must be a sequence of job ids, not a str")
        after_order = tuple(after or ())
        job = Job(
            job_id=job_id,
            op=op,
            payload=payload or {},
            after=set(after_order),
            after_order=after_order,
            required_labels=required_labels,
            max_attempts=max_attempts,
            priority=(
                priority if priority is not None
                else self.sched_config.default_priority
            ),
            tenant=tenant if tenant is not None else DEFAULT_TENANT,
            deadline_sec=(
                float(deadline_sec) if deadline_sec is not None else None
            ),
            workflow_id=workflow_id,
            stage=stage,
            critical_path=max(0, int(critical_path)),
        )
        # Submit-time result-cache consult: a dep-free cacheable
        # WORKFLOW STAGE whose content key already has a stored result
        # never enters the queue — it lands terminal SUCCEEDED with the
        # cached bytes. Dep-gated stages consult at lease time instead
        # (their real input includes the partials that don't exist yet).
        # Plain ``POST /v1/jobs`` submits never consult: every non-DAG
        # submit executes, the contract the pre-DAG controller pinned
        # (test_sched's FIFO model, fault injection, standby promotion all
        # count on submitted == executed). The lookup runs outside the
        # controller lock (the cache has its own).
        cached_result: Optional[Dict[str, Any]] = None
        if (
            self.result_cache is not None
            and not after_order
            and workflow_id is not None
            and is_cacheable(op)
        ):
            cached_result = self.result_cache.get(op, job.payload)
            if cached_result is None:
                self._m_result_cache.inc(event="miss")
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"duplicate job id {job_id!r}")
            if cached_result is None:
                # A cache hit consumes no queue slot — admission control
                # guards the pending budget, and a hit never goes pending.
                self._admit_locked(job.tenant)
            now = self._clock()
            job.submitted_at = now
            job.enqueued_clock = now
            # Root of the job's span tree: open at submit, closed
            # when the job reaches a terminal state. trace_id = job_id —
            # except workflow stage jobs, whose spans parent to
            # the workflow's root so the whole DAG is ONE trace tree.
            span_attrs: Dict[str, Any] = {
                "op": op, "tenant": job.tenant, "priority": job.priority,
            }
            parent_span = None
            if workflow_id is not None:
                wf = self._workflows.get(workflow_id)
                parent_span = (wf or {}).get("root_span_id")
                span_attrs["stage"] = stage
            job.root_span_id = self.traces.open(
                job.trace_root, "submit", parent_span_id=parent_span,
                start_clock=now, attributes=span_attrs,
            )
            self._jobs[job_id] = job
            for dep in after_order:
                # Reverse dependency edges: what the generalized
                # DependencyFailed cascade walks.
                self._dependents.setdefault(dep, set()).add(job_id)
            if cached_result is None:
                self._sched.add(job)
                if job.deadline_sec is not None:
                    self._deadlined.add(job_id)
            self._update_queue_stats_locked(now)
            self.recorder.record("submit", job_id=job_id, op=op)
            self._depended_on.update(after_order)
            # Journal schema vN+1: the scheduling fields are appended only
            # when the caller set them, so default submissions keep writing
            # the exact bytes the pre-scheduler controller wrote (the fifo
            # byte-compat guarantee) and old journals replay unchanged.
            record = {
                "ev": "submit",
                "job_id": job_id,
                "op": op,
                "payload": job.payload,
                "after": list(after_order),
                "required_labels": required_labels,
                "max_attempts": max_attempts,
            }
            if priority is not None:
                record["priority"] = job.priority
            if tenant is not None:
                record["tenant"] = job.tenant
            if deadline_sec is not None:
                record["deadline_sec"] = job.deadline_sec
            self._journal(record)
            if cached_result is not None:
                # Terminal immediately: the submit record above plus the
                # cache-hit result record replay back to the same state.
                self._finalize_cache_hit_locked(
                    job, cached_result, now, plane="submit"
                )
        return job_id

    def suggested_shard_size(self) -> Optional[int]:
        """The ``suggested_shard_rows`` hint from the most recent lease
        that carried one (``sizing/profile.py`` derives it from chip count ×
        device memory), or None when no device agent has leased yet. CPU
        agents polling in a mixed fleet do not revert the hint."""
        with self._lock:
            profile = self._last_sized_profile
        rows = (sizing_block(profile) or {}).get("suggested_shard_rows")
        if isinstance(rows, (int, float)) and not isinstance(rows, bool) \
                and rows > 0:
            return int(rows)
        return None

    def submit_csv_job(
        self,
        source_uri: str,
        total_rows: int,
        shard_size: Optional[int] = None,
        map_op: str = "read_csv_shard",
        extra_payload: Optional[Dict[str, Any]] = None,
        reduce_op: Optional[str] = None,
        reduce_payload: Optional[Dict[str, Any]] = None,
        required_labels: Optional[Dict[str, Any]] = None,
        collect_partials: bool = False,
        max_attempts: Optional[int] = None,
        priority: Optional[int] = None,
        tenant: Optional[str] = None,
        deadline_sec: Optional[float] = None,
    ) -> Tuple[List[str], Optional[str]]:
        """Split a CSV dataset into shard tasks (+ optional gated reduce job).

        Shards address rows ``[start_row, start_row + shard_size)`` — idempotent
        re-execution is the resume unit (SURVEY.md §5.4).

        ``shard_size=None`` closes the sizing→controller loop (SURVEY.md §2.5):
        the split uses the submitting cluster's last-seen worker profile
        (``suggested_shard_rows``, derived from topology + device memory),
        falling back to the 100-row default when no device agent has leased
        yet. Pass an explicit size to override.

        With ``collect_partials`` the controller materializes the shard jobs'
        results into the reduce job's ``partials`` payload when it leases —
        the "partials combined controller-side" flow the reference implied
        (SURVEY.md §5.8) made explicit, e.g. ``map_op="risk_accumulate"``
        (per-shard stats) + ``reduce_op="risk_accumulate"`` (merge).
        """
        if shard_size is None:
            shard_size = self.suggested_shard_size() or DEFAULT_SHARD_ROWS
        if shard_size <= 0:
            raise ValueError("shard_size must be positive")
        if total_rows <= 0:
            # Zero shards + an immediately-leasable reduce-over-nothing is
            # never what the caller meant.
            raise ValueError("total_rows must be positive")
        # Whole-batch admission pre-check: reject before the first shard
        # submits rather than 429-ing mid-split and leaving a half-submitted
        # job behind. (Advisory — each submit re-checks under the lock.)
        n_jobs = -(-total_rows // shard_size) + (1 if reduce_op else 0)
        with self._lock:
            self._admit_locked(tenant if tenant is not None else DEFAULT_TENANT,
                               n_jobs)
        shard_ids: List[str] = []
        for i, start in enumerate(range(0, total_rows, shard_size)):
            payload = dict(extra_payload or {})
            payload.update(
                source_uri=source_uri,
                start_row=start,
                shard_size=min(shard_size, total_rows - start),
            )
            shard_ids.append(
                self.submit(
                    map_op,
                    payload,
                    job_id=f"shard-{i}-{self._id_tag}{uuid.uuid4().hex[:8]}",
                    required_labels=required_labels,
                    max_attempts=max_attempts,
                    priority=priority,
                    tenant=tenant,
                    deadline_sec=deadline_sec,
                )
            )
        reduce_id = None
        if reduce_op is not None:
            payload = dict(reduce_payload or {})
            if collect_partials:
                payload["__collect_partials__"] = True
            reduce_id = self.submit(
                reduce_op,
                payload,
                after=shard_ids,  # ordered: partials materialize shard-order
                required_labels=required_labels,
                max_attempts=max_attempts,
                priority=priority,
                tenant=tenant,
                deadline_sec=deadline_sec,
            )
        return shard_ids, reduce_id

    # ---- workflow DAG engine + result cache ----

    def submit_workflow(
        self,
        workflow: Dict[str, Any],
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
        deadline_sec: Optional[float] = None,
        workflow_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        """``POST /v1/workflows``: accept a fan-out/fan-in graph as ONE
        unit, validate it (acyclic, known ops, bounded width — ``DagError``
        maps to HTTP 400), expand stages into ordinary jobs with
        generalized dep edges, and journal the graph FIRST so replay and
        standby promotion rebuild membership before any stage submit
        replays. Returns ``{workflow_id, job_ids, stages}``."""
        if not self.flow_config.enabled:
            raise RuntimeError("workflows are disabled (FLOW_ENABLED=0)")
        spec = parse_workflow(
            workflow,
            known_ops=list(OP_TO_MODULE),
            max_stages=self.flow_config.max_stages,
            max_width=self.flow_config.max_width,
        )
        if priority is not None and (
            isinstance(priority, bool) or not isinstance(priority, int)
            or not PRIORITY_MIN <= priority <= PRIORITY_MAX
        ):
            raise ValueError(
                f"priority must be an int in [{PRIORITY_MIN}, "
                f"{PRIORITY_MAX}], got {priority!r}"
            )
        if tenant is not None and (
            not isinstance(tenant, str) or not tenant
        ):
            raise ValueError(
                f"tenant must be a non-empty string, got {tenant!r}"
            )
        if workflow_id is not None and (
            not isinstance(workflow_id, str) or not workflow_id
        ):
            raise ValueError("workflow_id must be a non-empty string")
        workflow_id = (
            workflow_id or f"wf-{self._id_tag}{uuid.uuid4().hex[:12]}"
        )
        default_priority = (
            priority if priority is not None
            else self.sched_config.default_priority
        )
        tenant_val = tenant if tenant is not None else DEFAULT_TENANT
        planned = expand_workflow(
            spec, workflow_id, default_priority=default_priority
        )
        graph = graph_doc(spec)
        stage_jobs: Dict[str, List[str]] = {}
        for pj in planned:
            stage_jobs.setdefault(pj.stage, []).append(pj.job_id)
        with self._lock:
            if workflow_id in self._workflows:
                raise ValueError(f"duplicate workflow id {workflow_id!r}")
            if any(pj.job_id in self._jobs for pj in planned):
                raise ValueError(
                    f"workflow {workflow_id!r} stage job ids collide with "
                    "existing jobs"
                )
            # Whole-graph admission pre-check (the CSV rule): reject before
            # the first stage submits rather than 429 mid-expansion.
            self._admit_locked(tenant_val, len(planned))
            now = self._clock()
            root_span = self.traces.open(
                workflow_id, "workflow", start_clock=now,
                attributes={
                    "stages": len(spec.stages), "jobs": len(planned),
                    "tenant": tenant_val, "priority": default_priority,
                },
            )
            self._register_workflow_locked(
                workflow_id, graph, tenant_val, default_priority,
                stage_jobs, root_span_id=root_span, now=now,
            )
            self._m_workflows.inc(outcome="submitted")
            self.recorder.record(
                "workflow_submit", workflow_id=workflow_id,
                stages=len(spec.stages), jobs=len(planned),
            )
            self._journal({
                "ev": "workflow",
                "workflow_id": workflow_id,
                "tenant": tenant_val,
                "priority": default_priority,
                "graph": graph,
                "stage_jobs": stage_jobs,
            })
        job_ids: List[str] = []
        for pj in planned:
            job_ids.append(self.submit(
                pj.op,
                pj.payload,
                job_id=pj.job_id,
                after=list(pj.after),
                required_labels=pj.required_labels,
                max_attempts=pj.max_attempts,
                priority=pj.priority,
                tenant=tenant,
                deadline_sec=deadline_sec,
                workflow_id=workflow_id,
                stage=pj.stage,
                critical_path=pj.critical_path,
            ))
            self._m_flow_stage_jobs.inc(op=pj.op)
        return {
            "workflow_id": workflow_id,
            "job_ids": job_ids,
            "stages": [s.name for s in spec.stages],
        }

    def _register_workflow_locked(
        self,
        workflow_id: str,
        graph: Dict[str, Any],
        tenant: str,
        priority: int,
        stage_jobs: Dict[str, List[str]],
        root_span_id: Optional[str],
        now: float,
    ) -> None:
        """Install the per-graph bookkeeping record + job membership map.
        Shared by live submit and journal replay (the ``workflow`` event)."""
        spec = spec_from_graph_doc(graph)
        cp = critical_path_lengths(spec)
        total = sum(len(ids) for ids in stage_jobs.values())
        self._workflows[workflow_id] = {
            "workflow_id": workflow_id,
            "tenant": tenant,
            "priority": priority,
            "graph": graph,
            "stage_jobs": {k: list(v) for k, v in stage_jobs.items()},
            "stage_order": [s.name for s in spec.stages],
            "critical_path": cp,
            "total_jobs": total,
            "terminal_jobs": 0,
            "failed_jobs": 0,
            "cache_hits": 0,
            "state": "running",
            "root_span_id": root_span_id,
            "submitted_clock": now,
            "submitted_wall": time.time(),
        }
        for stage, ids in stage_jobs.items():
            for jid in ids:
                self._job_workflow[jid] = (workflow_id, stage)

    def _workflow_note_terminal_locked(self, job: Job, now: float) -> None:
        """Progress accounting on any stage job reaching a terminal state.
        When the last stage job lands, the workflow itself goes terminal:
        root span finished (closing the single DAG trace tree), outcome
        counted, recorder event."""
        info = self._job_workflow.get(job.job_id)
        if info is None:
            return
        wf = self._workflows.get(info[0])
        if wf is None or wf["state"] != "running":
            return
        wf["terminal_jobs"] += 1
        if job.state != SUCCEEDED:
            wf["failed_jobs"] += 1
        if wf["terminal_jobs"] < wf["total_jobs"]:
            return
        wf["state"] = "succeeded" if wf["failed_jobs"] == 0 else "dead"
        wf["finished_clock"] = now
        self.traces.finish(
            wf["workflow_id"], wf.get("root_span_id"), now,
            attributes={
                "outcome": wf["state"], "failed_jobs": wf["failed_jobs"],
                "cache_hits": wf["cache_hits"],
            },
        )
        self._m_workflows.inc(outcome=wf["state"])
        self.recorder.record(
            "workflow_done", workflow_id=wf["workflow_id"],
            outcome=wf["state"], failed_jobs=wf["failed_jobs"],
            cache_hits=wf["cache_hits"],
        )

    def _cascade_dep_failure_locked(self, failed: Job, now: float) -> None:
        """Generalized DependencyFailed cascade: walk the
        REVERSE dep edges from a terminally-failed job and kill every
        still-pending dependent, transitively — a workflow's downstream
        stages must not sit queued forever behind a dead upstream. This
        supersedes the serve-only scan ``_serve_reap`` used to carry (that
        path now rides the same edges). Each death journals as a result
        record so replay keeps it dead.

        Scope: workflow members and serve-door jobs (the two populations
        with a waiter who must see the failure). Plain dep-gated jobs keep
        the legacy contract — a dead upstream leaves them pending, the
        behavior the pre-DAG controller pinned (test_sched's FIFO model
        replays interleavings against it byte-for-byte)."""
        if failed.state not in (FAILED, DEAD):
            return
        serve_ids = (
            set(self.serve_door.job_ids())
            if self.serve_door is not None else set()
        )
        stack = [failed.job_id]
        while stack:
            dead_id = stack.pop()
            for dep_id in sorted(self._dependents.get(dead_id, ())):
                job = self._jobs.get(dep_id)
                if job is None or job.state != PENDING:
                    continue
                if job.workflow_id is None and dep_id not in serve_ids:
                    continue
                self._sched.discard(dep_id)
                self._delayed.discard(dep_id)
                self._deadlined.discard(dep_id)
                job.error = {
                    "type": "DependencyFailed",
                    "message": f"dependency {dead_id} failed",
                    "trace": "",
                }
                job.state = DEAD
                self.traces.finish(
                    job.trace_root, job.root_span_id, now,
                    attributes={
                        "outcome": DEAD, "reason": "DependencyFailed",
                    },
                )
                self._slo_observe_locked(job, now)
                self._m_dead.inc(op=job.op)
                self.recorder.record(
                    "dead", job_id=dep_id, op=job.op,
                    reason="dependency", attempts=job.attempts,
                )
                self._journal({
                    "ev": "result",
                    "job_id": dep_id,
                    "state": DEAD,
                    "epoch": job.epoch,
                    "attempts": job.attempts,
                    "result": None,
                    "error": job.error,
                })
                self._workflow_note_terminal_locked(job, now)
                stack.append(dep_id)
        self._update_queue_stats_locked(now)

    def _finalize_cache_hit_locked(
        self, job: Job, result: Dict[str, Any], now: float, plane: str
    ) -> None:
        """Land a result-cache hit as a terminal SUCCEEDED application:
        journaled as a cache-hit result event (with the result BODY —
        downstream stages and replay must see the exact cached bytes),
        billed at cache price in the usage ledger, root span closed with
        the hit attribute, workflow progress noted. Caller holds the lock
        and has kept the job out of (or removed it from) the queue."""
        job.result = result
        job.error = None
        job.state = SUCCEEDED
        self._delayed.discard(job.job_id)
        self._deadlined.discard(job.job_id)
        self._m_result_cache.inc(event=f"hit_{plane}")
        self.recorder.record(
            "cache_hit", job_id=job.job_id, op=job.op, plane=plane,
        )
        if job.lease_span_id is not None:
            self.traces.finish(
                job.trace_root, job.lease_span_id, now,
                attributes={"outcome": SUCCEEDED, "cache_hit": True},
            )
            job.lease_span_id = None
        self.traces.finish(
            job.trace_root, job.root_span_id, now,
            attributes={"outcome": SUCCEEDED, "cache_hit": True},
        )
        self._slo_observe_locked(job, now)
        billed = None
        if self.usage is not None:
            billed = self.usage.bill(
                job.job_id, tenant=job.tenant, tier=job.priority,
                op=job.op, attempt=job.attempts,
                usage={"result_cache_hits": 1},
            )
        record: Dict[str, Any] = {
            "ev": "result",
            "job_id": job.job_id,
            "state": SUCCEEDED,
            "epoch": job.epoch,
            "attempts": job.attempts,
            "result": job.result,
            "error": None,
            "cache_hit": True,
        }
        if billed is not None:
            record["usage"] = billed
        self._journal(record)
        info = self._job_workflow.get(job.job_id)
        if info is not None:
            wf = self._workflows.get(info[0])
            if wf is not None:
                wf["cache_hits"] += 1
        self._workflow_note_terminal_locked(job, now)

    def workflow_json(self, workflow_id: str) -> Optional[Dict[str, Any]]:
        """``GET /v1/workflows/{id}``: graph + per-stage progress + the
        critical-path stage (deepest remaining work — what the scheduler
        is preferring right now) + terminal results of the sink stages."""
        with self._lock:
            wf = self._workflows.get(workflow_id)
            if wf is None:
                return None
            stages = []
            critical_stage = None
            critical_depth = -1
            for stage in wf["stage_order"]:
                ids = wf["stage_jobs"].get(stage, [])
                counts: Dict[str, int] = {}
                for jid in ids:
                    job = self._jobs.get(jid)
                    state = job.state if job is not None else "forgotten"
                    counts[state] = counts.get(state, 0) + 1
                remaining = sum(
                    n for s, n in counts.items()
                    if s not in TERMINAL_STATES
                )
                depth = int(wf["critical_path"].get(stage, 0))
                if remaining and depth > critical_depth:
                    critical_depth = depth
                    critical_stage = stage
                stages.append({
                    "name": stage,
                    "jobs": len(ids),
                    "counts": counts,
                    "critical_path": depth,
                })
            # Sink results: stages nothing depends on (fan-in outputs).
            downstream: Set[str] = set()
            for raw in wf["graph"].get("stages", []):
                downstream.update(raw.get("after") or ())
            results: Dict[str, Any] = {}
            for stage in wf["stage_order"]:
                if stage in downstream:
                    continue
                for jid in wf["stage_jobs"].get(stage, []):
                    job = self._jobs.get(jid)
                    if job is not None and job.state == SUCCEEDED:
                        results[jid] = job.result
            out = {
                "workflow_id": workflow_id,
                "tenant": wf["tenant"],
                "priority": wf["priority"],
                "state": wf["state"],
                "stages": stages,
                "total_jobs": wf["total_jobs"],
                "terminal_jobs": wf["terminal_jobs"],
                "failed_jobs": wf["failed_jobs"],
                "cache_hits": wf["cache_hits"],
                "critical_stage": critical_stage,
                "submitted_wall": round(wf["submitted_wall"], 3),
                "results": results,
            }
            if self.partition:
                out["partition"] = self.partition
            return out

    def workflows_json(self) -> Dict[str, Any]:
        """Summary list for swarmtop's Workflows panel + ``--json``."""
        with self._lock:
            items = []
            for wf in self._workflows.values():
                done = wf["terminal_jobs"]
                critical_stage = None
                critical_depth = -1
                for stage in wf["stage_order"]:
                    remaining = sum(
                        1 for jid in wf["stage_jobs"].get(stage, [])
                        if (j := self._jobs.get(jid)) is not None
                        and j.state not in TERMINAL_STATES
                    )
                    depth = int(wf["critical_path"].get(stage, 0))
                    if remaining and depth > critical_depth:
                        critical_depth = depth
                        critical_stage = stage
                items.append({
                    "workflow_id": wf["workflow_id"],
                    "tenant": wf["tenant"],
                    "state": wf["state"],
                    "stages": len(wf["stage_order"]),
                    "total_jobs": wf["total_jobs"],
                    "terminal_jobs": done,
                    "failed_jobs": wf["failed_jobs"],
                    "cache_hits": wf["cache_hits"],
                    "critical_stage": critical_stage,
                })
            cache = (
                self.result_cache.stats()
                if self.result_cache is not None else None
            )
        return {"workflows": items, "result_cache": cache}

    # ---- fault injection (SURVEY.md §5.3, extended) ----

    def inject(self, fault: Optional[str] = None, plan: Any = None) -> None:
        """Arm a one-shot fault by name, or install a seeded probabilistic
        ``chaos.FaultPlan`` (``inject(plan=...)``) consulted on every lease —
        sustained, reproducible failure instead of a single shot. Passing
        ``plan=None`` with no fault name clears an installed plan."""
        if fault is not None:
            if fault not in ("drop_lease", "duplicate_task", "stale_epoch"):
                raise ValueError(f"unknown fault {fault!r}")
            with self._lock:
                self._faults.append(fault)
            return
        with self._lock:
            self._fault_plan = plan

    def _take_fault(self, fault: str) -> bool:
        # caller holds the lock
        if fault in self._faults:
            self._faults.remove(fault)
            return True
        return False

    # ---- lease protocol ----

    def _expire_leases_locked(self) -> None:
        now = self._clock()
        for job in self._jobs.values():
            if job.state == LEASED and now >= job.lease_deadline:
                # Dead agent: re-queue with a bumped epoch so its late result
                # is discarded on arrival.
                job.epoch += 1
                job.state = PENDING
                job.lease_id = None
                self.traces.finish(
                    job.trace_root, job.lease_span_id, now,
                    attributes={"outcome": "expired"},
                )
                job.lease_span_id = None
                job.enqueued_clock = now
                self._sched.add(job)
                self._m_expirations.inc(op=job.op)
                self._update_queue_stats_locked(now)
                self.recorder.record(
                    "lease_expired", job_id=job.job_id, op=job.op,
                    epoch=job.epoch, agent=job.agent,
                )
                self._journal(
                    {"ev": "requeue", "job_id": job.job_id, "epoch": job.epoch}
                )

    def _expire_deadlines_locked(self) -> None:
        """Deadline/TTL enforcement: a PENDING job whose
        ``deadline_sec`` elapsed lands the existing terminal ``dead`` state
        with a distinct ``DeadlineExceeded`` reason; a still-pending job
        past ``SCHED_ESCALATE_FRAC`` of its deadline escalates one priority
        tier (once). Leased jobs are left alone — an in-flight attempt may
        still beat the deadline, and its result is accepted if it does."""
        if not self._deadlined:
            return
        now = self._clock()
        frac = self.sched_config.escalate_frac
        for jid in list(self._deadlined):
            job = self._jobs.get(jid)
            if job is None or job.state in TERMINAL_STATES \
                    or job.deadline_sec is None:
                self._deadlined.discard(jid)
                continue
            age = now - job.submitted_at
            if job.state != PENDING:
                continue  # leased: give the in-flight attempt its chance
            if age >= job.deadline_sec:
                self._sched.discard(jid)
                self._delayed.discard(jid)
                self._deadlined.discard(jid)
                job.error = {
                    "type": "DeadlineExceeded",
                    "message": (
                        f"deadline_sec {job.deadline_sec} elapsed after "
                        f"{job.attempts} attempt(s)"
                    ),
                    "trace": "",
                }
                job.state = DEAD
                self.traces.finish(
                    job.trace_root, job.root_span_id, now,
                    attributes={"outcome": DEAD, "reason": "DeadlineExceeded"},
                )
                # A deadline death is an availability breach the SLO engine
                # must see — it never passes through report().
                self._slo_observe_locked(job, now)
                self._m_dead.inc(op=job.op)
                self._m_deadline_dead.inc(op=job.op)
                self._m_sched_decisions.inc(
                    policy=self.sched_config.policy, decision="deadline_dead")
                self.recorder.record(
                    "dead", job_id=jid, op=job.op, reason="deadline",
                    deadline_sec=job.deadline_sec, attempts=job.attempts,
                )
                self._update_queue_stats_locked(now)
                # Journaled as a result record so replay keeps it dead.
                self._journal(
                    {
                        "ev": "result",
                        "job_id": jid,
                        "state": DEAD,
                        "epoch": job.epoch,
                        "attempts": job.attempts,
                        "result": None,
                        "error": job.error,
                    }
                )
                # A deadline death inside a DAG fails every downstream stage
                # — after journaling the death itself, so replay
                # sees cause before effect.
                self._workflow_note_terminal_locked(job, now)
                self._cascade_dep_failure_locked(job, now)
            elif not job.escalated and age >= job.deadline_sec * frac:
                job.escalated = True
                if job.priority < PRIORITY_MAX:
                    job.priority += 1
                    self._sched.reprioritize(job)
                self._m_sched_decisions.inc(
                    policy=self.sched_config.policy, decision="escalated")
                self.recorder.record(
                    "deadline_escalated", job_id=jid, op=job.op,
                    priority=job.priority,
                )

    def _deps_done_locked(self, job: Job) -> bool:
        return all(
            self._jobs[d].state == SUCCEEDED
            for d in job.after
            if d in self._jobs
        )

    @staticmethod
    def _labels_match(job: Job, labels: Dict[str, Any]) -> bool:
        """Every required label must be present; a required value of True
        accepts any truthy advertisement (bare-token labels parse to True).

        Value comparison is string-coerced: the AGENT_LABELS env grammar only
        produces strings (or True), so a JSON-typed requirement like
        ``{"mem_gb": 16}`` must still match an agent advertising ``"16"`` —
        a strict type-sensitive compare would starve the job silently.
        Numeric requirements compare numerically first, so ``{"mem_gb": 16.0}``
        also matches ``"16"`` (str-coercing 16.0 to "16.0" would reintroduce
        exactly the silent starvation the coercion exists to prevent).
        """
        for key, want in job.required_labels.items():
            have = labels.get(key)
            if want is True:
                if not _truthy(have):  # absent, falsy, or "false"/"0"/...
                    return False
            elif have is None:
                return False
            elif isinstance(want, (int, float)) and not isinstance(want, bool):
                if isinstance(have, bool):
                    # A bare flag label (True) carries no value — it must not
                    # satisfy a numeric requirement via float(True) == 1.0.
                    return False
                try:
                    if float(have) != float(want):
                        return False
                except (TypeError, ValueError):
                    return False
            elif str(have) != str(want):
                return False
        return True

    def lease(
        self,
        agent: str,
        capabilities: Optional[Dict[str, Any]] = None,
        max_tasks: int = 1,
        worker_profile: Optional[Dict[str, Any]] = None,
        metrics: Optional[Dict[str, Any]] = None,
        labels: Optional[Dict[str, Any]] = None,
        draining: bool = False,
        **_ignored: Any,
    ) -> Optional[Dict[str, Any]]:
        # Serving flush: deadline-expired infer buckets become
        # leasable jobs BEFORE this poll's take, so the asking agent can
        # carry them now instead of a poll cycle later. Outside the state
        # lock by construction (the front door has its own).
        if self.serve_door is not None:
            self._serve_pump()
        try:
            return self._lease_impl(
                agent, capabilities=capabilities, max_tasks=max_tasks,
                worker_profile=worker_profile, metrics=metrics,
                labels=labels, draining=draining, **_ignored,
            )
        finally:
            # Trend-ring backstop: AFTER the lease, so the sample
            # sees the telemetry this very poll ingested (the metrics-only
            # drain-end flush is what carries the final counters). Rate-
            # limited to TSDB_INTERVAL — one clock read per lease between
            # samples — and outside the controller lock by construction.
            self._tsdb_sample()
            # Compaction backstop for sweeper-less drains: a
            # cheap counter check unless a snapshot is actually due. A
            # failing write must not fail the lease that triggered it.
            try:
                self.maybe_snapshot()
            except OSError as exc:
                log("snapshot failed (segments still replay)",
                    error=str(exc)[:200])

    def _lease_impl(
        self,
        agent: str,
        capabilities: Optional[Dict[str, Any]] = None,
        max_tasks: int = 1,
        worker_profile: Optional[Dict[str, Any]] = None,
        metrics: Optional[Dict[str, Any]] = None,
        labels: Optional[Dict[str, Any]] = None,
        draining: bool = False,
        **_ignored: Any,
    ) -> Optional[Dict[str, Any]]:
        """One lease request → ``{lease_id, tasks}`` or None (HTTP 204).

        ``draining=True`` marks the agent as retiring in the
        per-agent view — ``/v1/status`` and ``/v1/health`` surface it, and
        the autoscaler stops counting the member as live capacity. The mark
        clears when the same agent name polls again without the flag (a
        fresh incarnation after a reclaim). Placement needs no change: a
        draining agent never asks for work, and the pull protocol is the
        fence.

        ``max_tasks < 1`` is a **metrics-only poll**: the agent's telemetry
        is recorded (per-agent snapshot, profile) but nothing leases — the
        flush channel drain loops use to push their final counters after the
        last task posts (old agents always send ≥ 1, so the wire contract
        is unchanged for them).

        Which jobs go out — and how many — is the scheduler's call
       : this method owns eligibility (state, not_before,
        capability ops, labels, dependencies) and the lease bookkeeping;
        ``self._sched.take`` owns order and placement, fed the enriched
        capability fields (``device_kind``, ``mesh_devices``,
        ``queue_depth``) agents now advertise.
        """
        caps = capabilities or {}
        ops = set(caps.get("ops") or [])
        labels = labels or {}
        # SLO alert piggyback: keep the judgment fresh
        # (rate-limited to ~1/s inside the tracker) and collect any paging
        # objectives BEFORE taking the controller lock — the page-entry hook
        # dumps the flight recorder (file I/O). Granted leases carry the
        # active page alerts so agents can auto-dump their own rings.
        page_alerts: List[Dict[str, Any]] = []
        if self.slo is not None:
            self.slo.maybe_evaluate()
            page_alerts = self.slo.active_alerts("page")
        # Binary-wire negotiation: both sides must opt in — the
        # agent by advertising, this controller by configuration. Old
        # agents never advertise, so they keep byte-identical JSON.
        adv = caps.get("wire_formats")
        wire_fmt = (
            wire.FORMAT
            if self.wire_binary and isinstance(adv, (list, tuple))
            and wire.FORMAT in adv
            else None
        )
        with self._lock:
            now_wall = time.time()
            if metrics:
                # Piggybacked agent spans: the lease `metrics`
                # channel doubles as the span ship — including the
                # metrics-only flush at drain end — keyed by agent id like
                # the obs snapshot, deduped by span_id at the store.
                piggyback = metrics.pop("spans", None) \
                    if isinstance(metrics, dict) else None
                if piggyback:
                    self.traces.ingest(piggyback)
                # Deep-capture completions ride the same channel:
                # popped so the stored per-agent snapshot stays clean.
                done_captures = metrics.pop("profile_captures", None) \
                    if isinstance(metrics, dict) else None
                for payload in done_captures or []:
                    self.captures.complete(payload)
                self.last_metrics = metrics
                if agent:
                    self.agent_metrics[agent] = {
                        "last_seen_wall": now_wall,
                        "metrics": {
                            k: v for k, v in metrics.items() if k != "obs"
                        },
                        "obs": metrics.get("obs"),
                    }
            elif agent and agent in self.agent_metrics:
                self.agent_metrics[agent]["last_seen_wall"] = now_wall
            if agent:
                # Drain handshake: sticky until a NON-draining poll from the
                # same name (a restarted incarnation) clears it.
                entry = self.agent_metrics.get(agent)
                if entry is not None:
                    entry["draining"] = bool(draining)
                elif draining:
                    self.agent_metrics[agent] = {
                        "last_seen_wall": now_wall,
                        "metrics": {},
                        "obs": None,
                        "draining": True,
                    }
                if draining:
                    self.recorder.record("agent_draining", agent=agent)
            if worker_profile:
                self.last_profile = worker_profile
                if sizing_block(worker_profile) is not None:
                    self._last_sized_profile = worker_profile
            self._expire_leases_locked()
            self._expire_deadlines_locked()
            if max_tasks < 1:
                self._m_lease.inc(outcome="metrics_only")
                return None
            plan = self._fault_plan
            if self._take_fault("drop_lease") or (
                plan is not None and plan.decide("drop_lease")
            ):
                self._m_lease.inc(outcome="fault_drop")
                self._m_faults.inc(fault="drop_lease")
                self.recorder.record("fault", fault="drop_lease", agent=agent)
                return None
            duplicate = self._take_fault("duplicate_task") or (
                plan is not None and plan.decide("duplicate_task")
            )
            stale = self._take_fault("stale_epoch") or (
                plan is not None and plan.decide("stale_epoch")
            )

            lease_id = f"lease-{self._id_tag}{uuid.uuid4().hex[:12]}"
            now = self._clock()
            deadline = now + self.lease_ttl_sec
            tasks: List[Dict[str, Any]] = []
            # Grant accounting: the historical loop bounded len(tasks) —
            # which included the duplicate_task copy — so an armed duplicate
            # consumes one distinct-job slot (unless only one slot exists).
            n = max(1, max_tasks)
            limit = max(1, n - 1) if duplicate else n

            def eligible(job: Job) -> bool:
                return (
                    job.state == PENDING
                    and job.not_before <= now
                    and (not ops or job.op in ops)
                    and self._labels_match(job, labels)
                    and self._deps_done_locked(job)
                )

            ctx = LeaseContext(
                agent=agent,
                now=now,
                limit=limit,
                requested=n,
                ops=frozenset(ops),
                labels=labels,
                device_kind=caps.get("device_kind"),
                mesh_devices=caps.get("mesh_devices"),
                queue_depth=caps.get("queue_depth"),
            )
            while True:
                cache_hits_round = 0
                for job in self._sched.take(ctx, eligible):
                    if (
                        self.result_cache is not None
                        and job.workflow_id is not None
                        and is_cacheable(job.op)
                    ):
                        # Lease-time result-cache consult: the
                        # first moment a dep-gated stage's REAL input exists
                        # — materialize its partials, then key on the full
                        # payload. A hit lands terminal here without ever
                        # reaching an agent (the job already left the queue
                        # via take()). Dep-free cacheable stages re-consult
                        # too: an identical job may have computed while this
                        # one sat queued. Workflow stages only — plain jobs
                        # keep the submitted == executed contract.
                        if job.payload.pop("__collect_partials__", None):
                            job.payload["partials"] = [
                                self._jobs[d].result
                                for d in job.after_order
                                if d in self._jobs
                            ]
                        cached = self.result_cache.get(job.op, job.payload)
                        if cached is not None:
                            self._finalize_cache_hit_locked(
                                job, cached, now, plane="lease"
                            )
                            cache_hits_round += 1
                            continue
                        self._m_result_cache.inc(event="miss")
                    job.state = LEASED
                    job.lease_id = lease_id
                    job.lease_deadline = deadline
                    job.agent = agent
                    job.attempts += 1
                    self._m_tasks_leased.inc(op=job.op)
                    self._m_sched_decisions.inc(
                        policy=self.sched_config.policy, decision="leased")
                    if job.attempts == 1:
                        # Queue-wait attribution: submit → FIRST lease only
                        # (a retry's wait measures failure handling, not
                        # scheduling pressure).
                        self._m_queue_wait.observe(
                            max(0.0, now - job.submitted_at),
                            exemplar={"trace_id": job.trace_root},
                            op=job.op,
                        )
                        self._m_starvation.observe(
                            max(0.0, now - job.submitted_at), tenant=job.tenant
                        )
                    if job.root_span_id is not None:
                        # The scheduling wait as a span: last-enqueued → this
                        # grant, annotated with the policy's deferral/held
                        # history so "why did this job sit" reads off the trace.
                        wait = max(0.0, now - job.enqueued_clock)
                        self.traces.add({
                            "trace_id": job.trace_root,
                            "span_id": obs_trace.new_span_id(),
                            "parent_span_id": job.root_span_id,
                            "name": "sched.decide",
                            "start_wall": time.time() - wait,
                            "start_mono": job.enqueued_clock,
                            "duration_ms": round(wait * 1e3, 3),
                            "process": "controller",
                            "attributes": {
                                "decision": "leased",
                                "policy": self.sched_config.policy,
                                "attempt": job.attempts,
                                "placement_defers": job.placement_defers,
                                "held": job.not_before > job.enqueued_clock,
                                "agent": agent,
                            },
                        })
                        # The lease window stays open until the result applies
                        # or the TTL expires; agent-side spans parent to it.
                        job.lease_span_id = self.traces.open(
                            job.trace_root, "lease",
                            parent_span_id=job.root_span_id, start_clock=now,
                            attributes={
                                "lease_id": lease_id, "agent": agent,
                                "epoch": job.epoch, "attempt": job.attempts,
                            },
                        )
                    self.recorder.record(
                        "lease", job_id=job.job_id, op=job.op,
                        lease_id=lease_id, agent=agent, epoch=job.epoch,
                        attempt=job.attempts,
                    )
                    if job.payload.pop("__collect_partials__", None):
                        # Reduce-time materialization: dependency results
                        # become the op's partials (kept out of the payload
                        # until every shard result actually exists), in
                        # submission order — shard order, for reduce ops
                        # that are order-sensitive.
                        job.payload["partials"] = [
                            self._jobs[d].result
                            for d in job.after_order
                            if d in self._jobs
                        ]
                    def out_task(j: Job = job) -> Dict[str, Any]:
                        task = j.to_task()
                        if wire_fmt and wire.encodable_task(j.op, j.payload):
                            # Bulk ``texts`` columns ship binary to a
                            # negotiated agent; the job's own payload (journal,
                            # replay, /v1/jobs) stays plain JSON.
                            task["payload"] = wire.encode_task_payload(j.payload)
                            self._m_wire.inc(direction="task", format=wire_fmt)
                        return task

                    tasks.append(out_task())
                    if duplicate:
                        # Same task handed out twice under one lease: the
                        # second completion must be idempotent/fenced.
                        tasks.append(out_task())
                        duplicate = False
                        self._m_faults.inc(fault="duplicate_task")
                        self.recorder.record(
                            "fault", fault="duplicate_task", job_id=job.job_id
                        )
                    if stale:
                        # Epoch bumps right after leasing → the agent's result
                        # arrives carrying the old epoch and is discarded.
                        job.epoch += 1
                        stale = False
                        self._m_faults.inc(fault="stale_epoch")
                        self.recorder.record(
                            "fault", fault="stale_epoch", job_id=job.job_id
                        )
                if tasks or not cache_hits_round:
                    break
                # Every job this scan took landed straight from the
                # result cache; their dependents may have just become
                # serviceable. Rescan instead of granting an idle
                # lease — bounded: each rescan only repeats if it
                # finalized at least one more job.
            self._update_queue_stats_locked(now)
            if not tasks:
                self._m_lease.inc(outcome="idle")
                return None
            self._m_lease.inc(outcome="granted")
            out = {"lease_id": lease_id, "tasks": tasks}
            # Pending deep-capture requests for THIS agent ride granted
            # leases only — a capture wraps an op execution, so
            # delivering alongside tasks is the natural (and only) slot.
            alerts = page_alerts + self.captures.pending_for(agent)
            if alerts:
                # Only when something is paging or a capture is pending:
                # the wire stays byte-identical to the pre-health protocol
                # otherwise, and old agents ignore the extra key either way.
                out["alerts"] = alerts
            if wire_fmt:
                # The negotiation answer: the agent may now binary-encode
                # its result columns. Stamped on every negotiated grant so
                # agents self-correct against a reconfigured controller.
                out["wire"] = wire_fmt
            return out

    def report(
        self,
        lease_id: str,
        job_id: str,
        job_epoch: Any,
        status: str,
        result: Any = None,
        error: Any = None,
        spans: Any = None,
        wire_bytes: int = 0,
        **_ignored: Any,
    ) -> Dict[str, Any]:
        out = self._report_impl(
            lease_id, job_id, job_epoch, status, result=result, error=error,
            spans=spans, wire_bytes=wire_bytes, **_ignored,
        )
        # Serving fan-out: an accepted application may have
        # landed a serve batch job terminal — complete its riders now, not
        # on the next sweep. Outside the state lock (the reap re-takes it
        # briefly per job; lock order controller → front door, never both).
        if (
            self.serve_door is not None
            and out.get("accepted") and not out.get("released")
        ):
            self._serve_reap()
        return out

    def _report_impl(
        self,
        lease_id: str,
        job_id: str,
        job_epoch: Any,
        status: str,
        result: Any = None,
        error: Any = None,
        spans: Any = None,
        wire_bytes: int = 0,
        **_ignored: Any,
    ) -> Dict[str, Any]:
        """One result post. Stale epochs are counted and discarded.

        ``spans`` is the agent's piggybacked span batch — ingested
        regardless of whether the result is accepted (a fenced result's
        execution still happened and belongs on the timeline).

        ``wire_bytes`` is the HTTP layer's measured request size:
        the exact per-task result-wire attribution the usage ledger bills —
        0 for in-process sessions, which simply have no wire."""
        if spans:
            self.traces.ingest(spans)
        if wire.is_binary_result(result):
            # Binary shard wire: decode OUTSIDE the lock (zlib +
            # numpy work) so the hot path holds it no longer than a JSON
            # result would. The stored result is exactly what a JSON-wire
            # agent would have posted — downstream consumers (journal
            # partials, /v1/jobs, reduce stages) never see the envelope.
            try:
                result = wire.decode_result(result)
                self._m_wire.inc(direction="result", format=wire.FORMAT)
            except ValueError as exc:
                # Undecodable envelope: keep the raw body (debuggable, not
                # silently dropped) and make the corruption visible.
                self._m_wire.inc(
                    direction="result_error", format=wire.FORMAT
                )
                log("binary result envelope undecodable", job_id=job_id,
                    error=str(exc)[:200])
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                self._m_results.inc(op="?", outcome="unknown_job")
                self.recorder.record(
                    "result_rejected", job_id=job_id, reason="unknown job",
                    lease_id=lease_id,
                )
                return {"accepted": False, "reason": "unknown job"}
            if job_epoch != job.epoch:
                # The epoch fence doing its job — a real counter now
                # (``controller_results_total{outcome="stale_epoch"}``), not
                # just the legacy attribute.
                self.stale_results += 1
                self._m_results.inc(op=job.op, outcome="stale_epoch")
                self.recorder.record(
                    "epoch_fence", job_id=job_id, op=job.op,
                    posted_epoch=job_epoch, current_epoch=job.epoch,
                    lease_id=lease_id, attempt=job.attempts,
                )
                return {"accepted": False, "reason": "stale epoch"}
            if job.state in TERMINAL_STATES:
                # Duplicate completion (duplicate_task fault, a result
                # redelivered after its response was lost): first wins —
                # terminal states never move, and nothing re-applies.
                self._m_results.inc(op=job.op, outcome="duplicate")
                self.recorder.record(
                    "result_rejected", job_id=job_id, op=job.op,
                    reason="already complete", lease_id=lease_id,
                )
                return {"accepted": False, "reason": "already complete"}
            if status == "released":
                # Drain handback: a retiring agent returns an
                # unstarted leased task. Requeue NOW (no TTL wait), bump the
                # epoch (any late duplicate of this lease is fenced), and
                # give the attempt back — a release is not a failure and
                # must not eat the retry budget. The epoch check above
                # already proved this lease still owns the job.
                if job.state != LEASED:
                    self._m_results.inc(op=job.op, outcome="duplicate")
                    self.recorder.record(
                        "result_rejected", job_id=job_id, op=job.op,
                        reason="release of unleased job", lease_id=lease_id,
                    )
                    return {"accepted": False, "reason": "not leased"}
                now = self._clock()
                job.epoch += 1
                job.state = PENDING
                job.lease_id = None
                job.attempts = max(0, job.attempts - 1)
                job.not_before = now
                job.enqueued_clock = now
                self.traces.finish(
                    job.trace_root, job.lease_span_id, now,
                    attributes={"outcome": "released"},
                )
                job.lease_span_id = None
                self._sched.add(job)
                self._m_results.inc(op=job.op, outcome="released")
                self.recorder.record(
                    "released", job_id=job_id, op=job.op, epoch=job.epoch,
                    lease_id=lease_id, agent=job.agent,
                )
                self._update_queue_stats_locked(now)
                # Journaled like an expiry requeue: replay must keep the
                # fence or a post-restart duplicate could apply.
                self._journal(
                    {"ev": "requeue", "job_id": job_id, "epoch": job.epoch}
                )
                return {"accepted": True, "released": True}
            # result/error before state: unlocked readers keying on a
            # terminal state must never see it paired with a stale result.
            t_apply = self._clock()
            job.result = result
            job.error = error
            job.state = SUCCEEDED if status == "succeeded" else FAILED
            job.lease_id = lease_id
            self._m_results.inc(
                op=job.op,
                outcome="succeeded" if job.state == SUCCEEDED else "failed",
            )
            self.recorder.record(
                "result", job_id=job_id, op=job.op, state=job.state,
                epoch=job.epoch, attempt=job.attempts, lease_id=lease_id,
                error_type=(error or {}).get("type")
                if isinstance(error, dict) else None,
            )
            if job.state == FAILED:
                # Classified retry policy: a permanent error
                # (UnknownOp, malformed payload — re-running cannot fix it)
                # sticks `failed` immediately without burning retries; a
                # transient one re-queues until the attempt budget is spent,
                # then the job lands terminal `dead`. Retried jobs carry a
                # requeue delay so a crashing op can't hot-loop the queue.
                budget = job.max_attempts or self.max_attempts
                if classify_error(error) == PERMANENT:
                    self.recorder.record(
                        "permanent_error", job_id=job_id, op=job.op,
                        error_type=(error or {}).get("type")
                        if isinstance(error, dict) else None,
                    )
                elif job.attempts < budget:
                    job.state = PENDING
                    job.epoch += 1
                    job.not_before = self._clock() + self.requeue_delay_sec
                    self._sched.add(job)
                    if self.requeue_delay_sec > 0:
                        # Feeds the held/leasable split of the depth gauge.
                        self._delayed.add(job.job_id)
                    self._m_retries.inc(op=job.op)
                    self._update_queue_stats_locked()
                    self.recorder.record(
                        "retry", job_id=job_id, op=job.op, epoch=job.epoch,
                        attempt=job.attempts, budget=budget,
                    )
                else:
                    job.state = DEAD
                    self._m_dead.inc(op=job.op)
                    self.recorder.record(
                        "dead", job_id=job_id, op=job.op,
                        attempts=job.attempts, budget=budget,
                    )
            now = self._clock()
            self.traces.finish(
                job.trace_root, job.lease_span_id, now,
                attributes={"outcome": job.state},
            )
            job.lease_span_id = None
            if job.root_span_id is not None:
                # The controller-side application itself (state transition +
                # retry classification + journal ordering), closing the
                # submit→…→apply chain.
                self.traces.add({
                    "trace_id": job.trace_root,
                    "span_id": obs_trace.new_span_id(),
                    "parent_span_id": job.root_span_id,
                    "name": "apply",
                    "start_wall": time.time() - max(0.0, now - t_apply),
                    "start_mono": t_apply,
                    "duration_ms": round(max(0.0, now - t_apply) * 1e3, 3),
                    "process": "controller",
                    "attributes": {
                        "outcome": job.state, "attempt": job.attempts,
                    },
                })
            if job.state in TERMINAL_STATES:
                self.traces.finish(
                    job.trace_root, job.root_span_id, now,
                    attributes={"outcome": job.state},
                )
                # SLO feed: one observation per job, at terminal
                # apply — the submit→apply span, the latency a submitter
                # actually experienced (retries included).
                self._slo_observe_locked(job, now)
            else:
                # Transient-failure requeue: the next sched.decide span
                # measures its wait from here.
                job.enqueued_clock = now
            # Showback billing: every ACCEPTED application bills
            # once — fenced/duplicate posts already returned above, and the
            # ledger's (job, attempt) dedupe makes double-billing
            # structurally impossible even across replay + live overlap.
            billed_usage = None
            if self.usage is not None:
                billed_usage = self.usage.bill(
                    job.job_id, tenant=job.tenant, tier=job.priority,
                    op=job.op, attempt=job.attempts,
                    usage=result.get("usage")
                    if isinstance(result, dict) else None,
                    wire_bytes=wire_bytes,
                )
            # Journal the post-decision state (not the raw report): replay
            # applies it verbatim, so a failed-then-requeued job replays as
            # pending at the bumped epoch and a completed shard stays done.
            # Result bodies are journaled only for depended-on jobs (a reduce
            # will need them as partials after a restart) — journaling every
            # drain shard's output would make the journal an unbounded second
            # copy of the dataset. Workflow members keep theirs
            # too: a DAG's sink result is the workflow's deliverable and must
            # replay bit-identically; stage width is bounded by
            # FLOW_MAX_WIDTH, so the journal stays bounded.
            record = {
                "ev": "result",
                "job_id": job.job_id,
                "state": job.state,
                "epoch": job.epoch,
                "attempts": job.attempts,
                "result": (
                    job.result
                    if (
                        job.job_id in self._depended_on
                        or job.workflow_id is not None
                    )
                    else None
                ),
                "error": job.error,
            }
            if billed_usage is not None:
                # Appended only when billed (journal schema vN+1 rule):
                # usage-less drains keep writing the exact legacy bytes.
                record["usage"] = billed_usage
            self._journal(record)
            if (
                job.state == SUCCEEDED
                and self.result_cache is not None
                and is_cacheable(job.op)
                and isinstance(job.result, dict)
            ):
                # Content-addressed memoization: the key covers
                # the payload AS EXECUTED — for a reduce that includes the
                # materialized partials, so an identical fan-in replays from
                # cache only when every upstream byte matched too.
                self.result_cache.put(job.op, job.payload, job.result)
                self._m_result_cache.inc(event="put")
            if job.state in TERMINAL_STATES:
                # Workflow bookkeeping + downstream cascade AFTER this job's
                # own journal record: replay must see the upstream terminal
                # before any DependencyFailed deaths it caused.
                self._workflow_note_terminal_locked(job, now)
                if job.state in (FAILED, DEAD):
                    self._cascade_dep_failure_locked(job, now)
            return {"accepted": True}

    # ---- online serving front door ----

    def _require_serve(self) -> ServeFrontDoor:
        if self.serve_door is None:
            raise RuntimeError("serving is disabled (SERVE_ENABLED=0)")
        return self.serve_door

    def submit_infer(
        self,
        op: str,
        text: Any,
        params: Optional[Dict[str, Any]] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
    ) -> str:
        """One ``POST /v1/infer`` request → req_id. The request joins a
        length-bucketed coalescing bucket; a bucket that fills flushes to
        the job queue immediately, a partial one flushes on the lease/sweep
        cadence once its oldest rider waited ``SERVE_MAX_WAIT_MS``. Raises
        ``ValueError`` (HTTP 400) / ``AdmissionError`` (HTTP 429)."""
        door = self._require_serve()
        if self.result_cache is not None and isinstance(text, str) and text:
            # Front-door memoization: consulted BEFORE bucketing
            # (and before admission — a hit costs no pending-budget slot).
            # Keys cover op+text+params, not tenant: dedupe is global, the
            # usage ledger attributes the hit to the asking tenant.
            cached = self.result_cache.get(
                f"infer:{op}", {"text": text, "params": dict(params or {})}
            )
            if cached is not None:
                req = door.complete_cached(
                    op, text, cached, params=params, tenant=tenant,
                    priority=priority,
                )
                self._m_result_cache.inc(event="hit_infer")
                self._m_serve_requests.inc(op=req.op, outcome="accepted")
                self.recorder.record(
                    "serve_request", req_id=req.req_id, op=req.op,
                    tenant=req.tenant, cache_hit=True,
                )
                self.recorder.record(
                    "cache_hit", req_id=req.req_id, op=req.op, plane="infer",
                )
                if self.usage is not None:
                    self.usage.bill(
                        req.req_id, tenant=req.tenant, tier=req.priority,
                        op=SERVE_OPS[req.op], attempt=1,
                        usage={"result_cache_hits": 1},
                    )
                self._note_serve_completions([req])
                return req.req_id
            self._m_result_cache.inc(event="miss")
        try:
            req, full = door.submit(
                op, text, params=params, tenant=tenant, priority=priority,
            )
        except AdmissionError:
            self._m_serve_requests.inc(op=str(op), outcome="rejected")
            self.recorder.record(
                "serve_rejected", op=str(op), tenant=tenant,
            )
            raise
        self._m_serve_requests.inc(op=req.op, outcome="accepted")
        self.recorder.record(
            "serve_request", req_id=req.req_id, op=req.op, tenant=req.tenant,
        )
        self._submit_serve_batches(full)
        return req.req_id

    def _submit_serve_batches(self, batches: List[ServeBatch]) -> None:
        """Flushed buckets → ordinary jobs on the existing queue (priority
        tier, tenant, journal, fencing all inherited). A job-queue admission
        refusal fails the riders visibly rather than re-queueing them —
        backpressure at the front door is the 429 the submitter already got;
        a full JOB queue behind it means the system is saturated."""
        door = self.serve_door
        if door is None:
            return
        for batch in batches:
            op = SERVE_OPS[batch.key.op]
            # Disaggregated pools: the decode path splits into a
            # serve_prefill job and a dep-gated serve_decode job, so the two
            # phases can land on SEPARATE fleets (capability routing + the
            # fair scheduler's steer). The prefill result's encoded rows
            # ride the ordinary results wire into the decode job's
            # ``partials`` — the controller's dep-gating queue IS the
            # KV-handoff transport, no new endpoints.
            disagg = (
                self.serve_config.disaggregated and op == "serve_summarize"
            )
            job_id = f"serve-{uuid.uuid4().hex[:12]}"
            pf_id: Optional[str] = None
            try:
                if disagg:
                    pf_id = f"serve-pf-{uuid.uuid4().hex[:12]}"
                    self.submit(
                        "serve_prefill",
                        batch.job_payload(),
                        job_id=pf_id,
                        priority=batch.key.priority,
                        tenant=batch.key.tenant,
                    )
                    # If THIS submit 429s the prefill job above is already
                    # queued and runs as an orphan — its result simply never
                    # fans out. Acceptable: admission refusal here means the
                    # system is saturated and the riders fail visibly below.
                    payload = batch.job_payload()
                    payload["__collect_partials__"] = True
                    self.submit(
                        "serve_decode",
                        payload,
                        job_id=job_id,
                        after=[pf_id],
                        priority=batch.key.priority,
                        tenant=batch.key.tenant,
                    )
                else:
                    self.submit(
                        op,
                        batch.job_payload(),
                        job_id=job_id,
                        priority=batch.key.priority,
                        tenant=batch.key.tenant,
                    )
            except AdmissionError as exc:
                completed = door.fail_batch(batch, {
                    "type": "AdmissionError",
                    "message": str(exc),
                })
                self._note_serve_completions(completed)
            else:
                door.mark_batched(batch, job_id, prefill_job_id=pf_id)
                self._m_serve_batches.inc(
                    op=batch.key.op, reason=batch.reason
                )
                self.recorder.record(
                    "serve_batch", job_id=job_id, op=batch.key.op,
                    n_requests=len(batch.requests), reason=batch.reason,
                )
                self._link_serve_batch(batch, job_id, pf_id)

    def _link_serve_batch(
        self,
        batch: ServeBatch,
        job_id: str,
        prefill_job_id: Optional[str],
    ) -> None:
        """Cross-trace stitching for one flushed batch: the
        batch job's root span gains one link per rider request, each rider's
        request trace links back to the job(s) it rides — so GET
        /v1/trace/{req_id} can inline the shared batch timeline and a job
        trace names every request it carried."""
        with self._lock:
            job_ids = [j for j in (job_id, prefill_job_id) if j]
            roots = {
                j: self._jobs[j].root_span_id
                for j in job_ids if j in self._jobs
            }
        for jid in job_ids:
            self.traces.add_links(jid, roots.get(jid), [
                obs_trace.span_link(
                    r.req_id, r.root_span_id, kind="serve_request"
                )
                for r in batch.requests
            ])
        kinds = {job_id: "serve_batch_job", prefill_job_id: "serve_prefill_job"}
        for r in batch.requests:
            self.traces.add_links(r.req_id, r.root_span_id, [
                obs_trace.span_link(jid, roots.get(jid), kind=kinds[jid])
                for jid in job_ids
            ])

    def _serve_pump(self) -> None:
        """Deadline-flush due buckets and reap terminal serve jobs — driven
        by the lease path, the sweeper, and the HTTP wait loops, so the
        front door makes progress under any one of them."""
        door = self.serve_door
        if door is None:
            return
        self._submit_serve_batches(door.pop_due())
        self._serve_reap()

    def _serve_reap(self) -> None:
        """Fan terminal serve jobs' results out to their riding requests.
        The catch-all completion path: covers result application, retry
        exhaustion, deadline death, and replayed jobs alike."""
        door = self.serve_door
        if door is None:
            return
        for job_id in door.job_ids():
            with self._lock:
                job = self._jobs.get(job_id)
                if job is None:
                    state: Optional[str] = DEAD
                    ok, result, error = False, None, {
                        "type": "UnknownJob",
                        "message": "serve batch job vanished",
                    }
                elif job.state not in TERMINAL_STATES:
                    # Disaggregated-chain cascade: dep gating
                    # only ever RELEASES on success, so a serve_decode job
                    # whose prefill dependency died would sit queued
                    # forever with its riders' HTTP waits open. Fail it
                    # now, the deadline-death way.
                    dead_dep = next(
                        (
                            d for d in job.after
                            if d in self._jobs
                            and self._jobs[d].state in (FAILED, DEAD)
                        ),
                        None,
                    ) if job.state == PENDING and job.after else None
                    if dead_dep is None:
                        continue
                    # Catch-all: the generalized cascade fires at
                    # the upstream's terminal apply, but a reap can still race
                    # ahead of it (replayed journals from before the cascade
                    # existed, or a dep that died under a code path without
                    # the hook). Drive the same cascade from the dead
                    # upstream so the kill is identical either way.
                    now = self._clock()
                    self._cascade_dep_failure_locked(
                        self._jobs[dead_dep], now
                    )
                    if job.state not in TERMINAL_STATES:
                        continue
                    ok = job.state == SUCCEEDED
                    result, error = job.result, job.error
                else:
                    ok = job.state == SUCCEEDED
                    result, error = job.result, job.error
            completed = door.complete_job(
                job_id, ok, result=result, error=error
            )
            if completed:
                if ok and isinstance(result, dict):
                    occ = result.get("occupancy")
                    if isinstance(occ, (int, float)):
                        self._m_serve_occupancy.set(float(occ))
                    # Prefix-cache / paged-KV telemetry: the
                    # result carries per-batch deltas (disagg decode jobs
                    # forward the prefill agent's counters).
                    pc = result.get("prefix_cache")
                    if isinstance(pc, dict):
                        for event in ("hits", "misses", "evictions"):
                            n = pc.get(event)
                            if isinstance(n, (int, float)) and n > 0:
                                self._m_serve_prefix.inc(int(n), event=event)
                    kv_total = result.get("kv_blocks_total")
                    if isinstance(kv_total, (int, float)) and kv_total > 0:
                        self._m_serve_kv_total.set(float(kv_total))
                        kv_free = result.get("kv_blocks_free")
                        if isinstance(kv_free, (int, float)):
                            self._m_serve_kv_free.set(float(kv_free))
                self._note_serve_completions(completed)

    # Wall-clock checkpoint chain of one request's road to its first token.
    # Consecutive checkpoints bound one component, so the components
    # TELESCOPE: their sum is first_token − arrival = the measured TTFT
    # (modulo per-component clamping of cross-host clock skew to >= 0).
    _TTFT_CHAIN = (
        ("bucket_wait", "arrived_wall", "batched_wall"),
        ("queue_wait", "batched_wall", "prefill_t0_wall"),
        ("prefill", "prefill_t0_wall", "prefill_t1_wall"),
        ("handoff", "prefill_t1_wall", "admitted_wall"),
        ("kv_wait", "admitted_wall", "joined_wall"),
        ("first_decode", "joined_wall", "first_token_wall"),
    )

    def _ttft_components(self, req: Any) -> Dict[str, float]:
        """Per-request TTFT decomposition in ms, from the lifecycle walls
        the engine/op stamped (``req.telemetry``) plus the front door's own
        arrival/flush walls. Components with a missing endpoint (failed
        before reaching it) are simply absent."""
        walls: Dict[str, Any] = dict(req.telemetry or {})
        walls["arrived_wall"] = req.arrived_wall
        walls["batched_wall"] = req.batched_wall
        out: Dict[str, float] = {}
        for name, k0, k1 in self._TTFT_CHAIN:
            w0, w1 = walls.get(k0), walls.get(k1)
            if isinstance(w0, (int, float)) and isinstance(w1, (int, float)):
                out[name] = round(max(0.0, (w1 - w0)) * 1e3, 3)
        return out

    def _synthesize_request_spans(
        self,
        req: Any,
        outcome: str,
        components: Dict[str, float],
        tel: Dict[str, Any],
    ) -> None:
        """Close out the request trace: one child span per TTFT
        component plus a ``decode`` span for the post-first-token stream,
        then finish the ``infer`` root — so GET /v1/trace/{req_id} assembles
        a complete, gap-free tree on its own (links stitch in the batch
        job's timeline separately)."""
        if req.root_span_id is None:
            return
        walls: Dict[str, Any] = dict(tel)
        walls["arrived_wall"] = req.arrived_wall
        walls["batched_wall"] = req.batched_wall
        for name, k0, _k1 in self._TTFT_CHAIN:
            ms = components.get(name)
            w0 = walls.get(k0)
            if ms is None or not isinstance(w0, (int, float)):
                continue
            attrs: Dict[str, Any] = {"component": name}
            if name == "kv_wait":
                # The seat delta; the pure KV-block stall inside it is the
                # engine's own measurement.
                attrs["kv_blocked_ms"] = tel.get("kv_wait_ms")
                attrs["occupancy_at_join"] = tel.get("occupancy_at_join")
            if name == "bucket_wait":
                attrs["flush_reason"] = req.flush_reason
                attrs["bucket"] = req.bucket
            self.traces.add({
                "trace_id": req.req_id,
                "span_id": obs_trace.new_span_id(),
                "parent_span_id": req.root_span_id,
                "name": f"ttft.{name}",
                "start_wall": float(w0),
                "start_mono": float(w0),
                "duration_ms": ms,
                "process": "controller",
                "attributes": attrs,
            })
        first = tel.get("first_token_wall")
        done = tel.get("done_wall")
        if isinstance(first, (int, float)) and isinstance(done, (int, float)):
            self.traces.add({
                "trace_id": req.req_id,
                "span_id": obs_trace.new_span_id(),
                "parent_span_id": req.root_span_id,
                "name": "decode",
                "start_wall": float(first),
                "start_mono": float(first),
                "duration_ms": round(max(0.0, done - first) * 1e3, 3),
                "process": "controller",
                "attributes": {
                    "steps": tel.get("steps"), "tokens": req.tokens,
                },
            })
        self.traces.finish(
            req.req_id, req.root_span_id, self._clock(),
            attributes={
                "outcome": outcome,
                "job_id": req.job_id,
                "prefill_job_id": req.prefill_job_id,
                "path": tel.get("path"),
            },
        )

    def _note_serve_completions(self, completed: List[Any]) -> None:
        """Terminal-request bookkeeping: metrics + SLO feed (latency into
        the default objectives, TTFT into the ``metric: "ttft"`` ones), the
        TTFT component decomposition (histograms + synthesized request-trace
        spans), and the wide-event request log."""
        now = self._clock()
        for req in completed:
            ok = req.state == SERVE_DONE
            outcome = "completed" if ok else "failed"
            if not ok and isinstance(req.error, dict) \
                    and req.error.get("type") == "DependencyFailed":
                # The disagg cascade: decode riders killed by a dead
                # prefill dependency are their own failure class.
                outcome = "dep_failed"
            self._m_serve_requests.inc(
                op=req.op, outcome="completed" if ok else "failed"
            )
            if req.latency_ms is not None:
                self._m_serve_latency.observe(
                    req.latency_ms / 1e3, op=req.op
                )
            if req.ttft_ms is not None:
                self._m_serve_ttft.observe(req.ttft_ms / 1e3, op=req.op)
            if req.tokens:
                self._m_serve_tokens.inc(req.tokens, op=req.op)
            if ok and req.job_id is not None \
                    and self.result_cache is not None \
                    and isinstance(req.result, dict):
                # Populate the front-door cache from computed riders only
                # (job_id None = this completion WAS a cache hit). The key
                # re-includes max_length: it shaped the answer.
                req_params = dict(req.params)
                if req.max_length is not None:
                    req_params["max_length"] = req.max_length
                self.result_cache.put(
                    f"infer:{req.op}",
                    {"text": req.text, "params": req_params},
                    req.result,
                )
                self._m_result_cache.inc(event="put")
            tel: Dict[str, Any] = (
                req.telemetry if isinstance(req.telemetry, dict) else {}
            )
            components = self._ttft_components(req)
            for name, ms in components.items():
                self._m_serve_ttft_component.observe(
                    ms / 1e3, component=name
                )
            tpot_ms: Optional[float] = None
            steps = tel.get("steps")
            first = tel.get("first_token_wall")
            done = tel.get("done_wall")
            if isinstance(steps, int) and steps >= 2 \
                    and isinstance(first, (int, float)) \
                    and isinstance(done, (int, float)):
                tpot_ms = round(
                    max(0.0, done - first) * 1e3 / (steps - 1), 3
                )
                self._m_serve_tpot.observe(tpot_ms / 1e3, op=req.op)
            self._synthesize_request_spans(req, outcome, components, tel)
            if self.reqlog is not None:
                self.reqlog.add({
                    "req_id": req.req_id,
                    "tenant": req.tenant,
                    "op": req.op,
                    "bucket": req.bucket,
                    "priority": req.priority,
                    "outcome": outcome,
                    "path": tel.get("path") or (
                        "disagg" if req.prefill_job_id else "colocated"
                    ),
                    "ttft_ms": req.ttft_ms,
                    "tpot_ms": tpot_ms,
                    "latency_ms": req.latency_ms,
                    "tokens": req.tokens,
                    "steps": steps,
                    "prefix_hit": bool(tel.get("cache_hit")),
                    "kv_wait_ms": components.get("kv_wait"),
                    "kv_blocked_ms": tel.get("kv_wait_ms"),
                    "occupancy": tel.get("occupancy_at_join"),
                    "flush_reason": req.flush_reason,
                    "components": components,
                    "dominant_component": dominant_component(components),
                    "trace_id": req.req_id,
                    "job_id": req.job_id,
                    "prefill_job_id": req.prefill_job_id,
                    "error": (
                        req.error.get("type")
                        if isinstance(req.error, dict) else None
                    ),
                })
            self.recorder.record(
                "serve_done", req_id=req.req_id, op=req.op,
                outcome=outcome,
                ttft_ms=req.ttft_ms, latency_ms=req.latency_ms,
            )
            if self.slo is not None and req.latency_ms is not None:
                self.slo.observe(
                    req.latency_ms / 1e3, ok=ok, tier=req.priority,
                    tenant=req.tenant, op=f"infer_{req.op}", now=now,
                )
                if req.ttft_ms is not None:
                    self.slo.observe(
                        req.ttft_ms / 1e3, ok=ok, tier=req.priority,
                        tenant=req.tenant, op=f"infer_{req.op}", now=now,
                        metric="ttft",
                    )

    def infer_snapshot(self, req_id: str) -> Optional[Dict[str, Any]]:
        door = self.serve_door
        return door.snapshot(req_id) if door is not None else None

    def wait_infer(
        self, req_id: str, timeout_sec: float
    ) -> Optional[Dict[str, Any]]:
        """Long-poll one request to a terminal state (or timeout). The wait
        loop itself pumps the front door, so pure-HTTP traffic (no sweeper,
        no polling agent yet) still deadline-flushes its buckets."""
        door = self._require_serve()
        slice_sec = max(0.005, self.serve_config.max_wait_ms / 2e3)
        deadline = time.monotonic() + max(0.0, timeout_sec)
        while True:
            self._serve_pump()
            remaining = deadline - time.monotonic()
            snap = door.wait(req_id, min(max(remaining, 0.0), slice_sec))
            if snap is None or snap["state"] in ("done", "failed") \
                    or remaining <= 0:
                return snap

    def wait_infer_change(
        self, req_id: str, last_state: str, timeout_sec: float
    ) -> Optional[Dict[str, Any]]:
        """Block until the request's state moves past ``last_state`` (or
        timeout) — the chunked-streaming event source. Pumps like
        :meth:`wait_infer`."""
        door = self._require_serve()
        slice_sec = max(0.005, self.serve_config.max_wait_ms / 2e3)
        deadline = time.monotonic() + max(0.0, timeout_sec)
        while True:
            self._serve_pump()
            remaining = deadline - time.monotonic()
            snap = door.wait_change(
                req_id, last_state, min(max(remaining, 0.0), slice_sec)
            )
            if snap is None or snap["state"] != last_state or remaining <= 0:
                return snap

    def serve_status(self) -> Dict[str, Any]:
        """The ``/v1/status`` serving block (one schema enabled or not)."""
        out: Dict[str, Any] = {"enabled": self.serve_door is not None}
        if self.serve_door is not None:
            out.update(self.serve_door.stats())
        if self.reqlog is not None:
            out["request_log"] = self.reqlog.stats()
        return out

    def requests_json(
        self,
        tenant: Optional[str] = None,
        outcome: Optional[str] = None,
        slow: bool = False,
        limit: int = 256,
    ) -> Dict[str, Any]:
        """The ``GET /v1/debug/requests`` body: newest-first wide-event
        request records (tail-sampled) plus the log's keep/drop counters."""
        if self.reqlog is None:
            return {"enabled": False, "requests": []}
        return {
            "enabled": True,
            "requests": self.reqlog.snapshot(
                tenant=tenant, outcome=outcome, slow=slow, limit=limit
            ),
            "stats": self.reqlog.stats(),
        }

    def note_http_bytes(self, route: str, direction: str, n: int) -> None:
        """Raw data-plane byte accounting, fed by the HTTP layer (request
        Content-Length in, response body bytes out) — what bench's
        ``drain_binary_wire`` leg derives wire bytes/row from."""
        if n > 0:
            self._m_http_bytes.inc(int(n), route=route, direction=direction)

    # ---- introspection (for tests, bench, and a future status endpoint) ----

    def job(self, job_id: str) -> Job:
        with self._lock:
            return self._jobs[job_id]

    def job_snapshot(self, job_id: str) -> Dict[str, Any]:
        """Consistent read of a job's public fields (all under one lock —
        a field-by-field read could observe state='succeeded' before the
        result assignment lands). The HTTP GET surface uses this."""
        with self._lock:
            job = self._jobs[job_id]
            return {
                "job_id": job.job_id,
                "op": job.op,
                "state": job.state,
                "job_epoch": job.epoch,
                "attempts": job.attempts,
                "agent": job.agent,
                "result": job.result,
                "error": job.error,
                "priority": job.priority,
                "tenant": job.tenant,
                "deadline_sec": job.deadline_sec,
            }

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for job in self._jobs.values():
                out[job.state] = out.get(job.state, 0) + 1
            return out

    def leased_to(self, agent: str) -> List[str]:
        """Job ids currently leased to ``agent`` — the scale-down
        stranded-lease probe: the moment a graceful retirement
        completes this must be empty, because the drain finished the
        in-flight task and released the rest instead of abandoning them to
        the TTL."""
        with self._lock:
            return [
                j.job_id for j in self._jobs.values()
                if j.state == LEASED and j.agent == agent
            ]

    def drained(self) -> bool:
        with self._lock:
            return all(
                j.state in TERMINAL_STATES for j in self._jobs.values()
            )

    def results(self) -> Dict[str, Any]:
        with self._lock:
            return {
                j.job_id: j.result
                for j in self._jobs.values()
                if j.state == SUCCEEDED
            }

    # ---- observability surface (GET /v1/metrics, /v1/status) ----

    def counts_by_op(self) -> Dict[str, Dict[str, int]]:
        """``{op: {state: n}}`` — the per-op breakdown /v1/status exposes."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for job in self._jobs.values():
                per = out.setdefault(job.op, {})
                per[job.state] = per.get(job.state, 0) + 1
            return out

    def queue_depth(self) -> int:
        with self._lock:
            return self._sched.total()

    def leasable_depth(self) -> int:
        """Pending jobs an agent could lease RIGHT NOW — the number the
        cross-partition steal probe reads off ``GET /v1/depth``
       . Computed from job state, NOT the scheduler heap: the
        heap deletes lazily, and a stale entry (a job completed via a
        redelivered result while also requeued) would advertise phantom
        depth — a steal victim with nothing to grant that can shadow a
        partition with REAL work behind the min-advantage filter,
        starving that job for as long as the phantom persists. O(jobs),
        which the router's depth cache amortizes."""
        with self._lock:
            now = self._clock()
            n = 0
            for job in self._jobs.values():
                if job.state != PENDING:
                    continue
                if job.not_before > now:
                    continue
                if job.after and not self._deps_done_locked(job):
                    continue
                n += 1
            return n

    def agents_summary(self) -> Dict[str, Any]:
        """Per-agent liveness: seconds since the last lease poll plus the
        light host/device telemetry it pushed (sans the obs snapshot — that
        feeds /v1/metrics, not status JSON)."""
        now = time.time()
        with self._lock:
            entries = {
                a: (
                    e.get("last_seen_wall", 0.0),
                    bool(e.get("draining")),
                    e.get("metrics") or {},
                )
                for a, e in self.agent_metrics.items()
            }
        return {
            a: {
                "last_seen_sec_ago": round(max(0.0, now - seen), 3),
                "draining": drain,
                "metrics": m,
            }
            for a, (seen, drain, m) in entries.items()
        }

    def fleet_snapshot(self) -> Dict[str, Any]:
        """Per-agent obs snapshots summed into fleet totals."""
        with self._lock:
            snaps = [
                e.get("obs") for e in self.agent_metrics.values()
                if isinstance(e.get("obs"), dict)
            ]
        return merge_snapshots(snaps)

    # Counter families that join the gauges in the per-agent view: load/
    # utilization series whose per-agent split is the whole point of a
    # fleet drain's attribution.
    _PER_AGENT_COUNTERS = (
        "device_busy_seconds_total",
        "device_idle_seconds_total",
    )

    def _per_agent_view(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """The families of one agent's snapshot that also render PER AGENT
        (stamped with an ``agent`` label): every gauge — summing two agents'
        ``queue_depth`` into one fleet series collapses exactly the signal a
        fleet operator needs — plus the device busy/idle counters."""
        return {
            name: fam for name, fam in snap.items()
            if isinstance(fam, dict) and (
                fam.get("type") == "gauge"
                or name in self._PER_AGENT_COUNTERS
            )
        }

    def metrics_text(self) -> str:
        """The full Prometheus exposition: controller series, fleet-merged
        agent series, and a synthetic per-agent liveness gauge. Agent metric
        names never collide with the ``controller_``-prefixed families, so
        one flat exposition stays valid.

        Fleet hygiene: when ≥ 2 agents have pushed
        snapshots, gauge families and the device busy/idle counters
        ADDITIONALLY render once per agent with an ``agent`` label next to
        the unlabeled fleet merge — without it the merged view collapses
        per-agent load into one number and a starving fleet member is
        invisible. Single-agent expositions keep the legacy (unlabeled)
        shape byte-for-byte; scrape consumers that sum fleet series must
        skip ``agent``-labeled samples (``obs.scrape.op_phase_seconds``
        already does)."""
        liveness = {
            "agent_last_seen_seconds": {
                "type": "gauge",
                "help": "Seconds since each agent's last lease poll",
                "labels": ["agent"],
                "series": [
                    {"labels": {"agent": a}, "value": s["last_seen_sec_ago"]}
                    for a, s in self.agents_summary().items()
                ],
            }
        }
        with self._lock:
            agent_snaps = [
                (a, e.get("obs")) for a, e in self.agent_metrics.items()
                if isinstance(e.get("obs"), dict)
            ]
        parts = [
            (self.metrics.snapshot(), {}),
            (merge_snapshots([s for _, s in agent_snaps]), {}),
        ]
        if len(agent_snaps) >= 2:
            for a, snap in agent_snaps:
                parts.append((self._per_agent_view(snap), {"agent": a}))
        parts.append((liveness, {}))
        return render_snapshots(parts)

    # Linked traces inlined per GET /v1/trace/{id} — enough for a serving
    # batch's full rider list (SERVE_MAX_BATCH is 16 by default).
    MAX_LINKED_TRACES = 32

    def trace_json(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Assembled span tree for one trace (``GET /v1/trace/{id}`` —
        ``trace_id`` is a job id or a serving ``req_id``):
        spans sorted by wall start, orphans flagged, completeness = one root
        + no orphans + every span closed. Traces whose spans carry cross-
        trace ``links`` (a request ↔ its coalesced batch job) get the linked
        traces assembled inline under ``linked_traces`` — the stitched view
        spanning the disagg prefill → decode handoff. None for unknown
        traces."""
        assembled = self.traces.assemble(trace_id)
        if assembled is None:
            return None
        linked: Dict[str, Dict[str, Any]] = {}
        for span in assembled["spans"]:
            for link in span.get("links") or ():
                tid = link.get("trace_id")
                if (
                    isinstance(tid, str) and tid and tid != trace_id
                    and tid not in linked
                    and len(linked) < self.MAX_LINKED_TRACES
                ):
                    sub = self.traces.assemble(tid)
                    if sub is not None:
                        linked[tid] = sub
        if linked:
            assembled["linked_traces"] = list(linked.values())
        return assembled

    def traces_json(self, limit: int = 20) -> List[Dict[str, Any]]:
        """Newest-first trace summaries (``GET /v1/traces?limit=N``)."""
        return self.traces.summaries(limit)

    # ---- resource accounting & profiling surface ----

    def usage_json(self, top_k: Optional[int] = None) -> Dict[str, Any]:
        """The ``GET /v1/usage`` body: billed totals per tenant/tier/op,
        top-K jobs by device seconds, and the LIVE per-tenant queue depth so
        consumed and still-pending demand read off one report."""
        if self.usage is None:
            return {"enabled": False}
        with self._lock:
            pending = self._sched.depth_by_tenant()
        return self.usage.report(top_k=top_k, pending_by_tenant=pending)

    def timeseries_json(
        self,
        name: str,
        label_filter: Optional[Dict[str, str]] = None,
        rate: bool = False,
        window_sec: Optional[float] = None,
        since: Optional[float] = None,
        step: Optional[float] = None,
    ) -> Dict[str, Any]:
        """The ``GET /v1/timeseries`` body. Unknown names and an empty ring
        return an empty ``series`` list, never an error. ``since``/``step``
        switch to the historical view: the durable store when
        one is open (it holds every ring sample and survives restarts),
        the ring's bounded window otherwise — seamless either way."""
        if self.tsdb is None:
            return {"enabled": False, "name": name, "series": []}
        if since is not None or step is not None:
            out = query_history(
                name, label_filter=label_filter, rate=rate,
                since=since, step=step,
                ring=self.tsdb, store=self.tsdb_store,
            )
        else:
            out = self.tsdb.query(
                name, label_filter, rate=rate, window_sec=window_sec
            )
        out["enabled"] = True
        return out

    def timeseries_names(self) -> List[str]:
        return self.tsdb.names() if self.tsdb is not None else []

    def request_capture(
        self,
        agent: str,
        op: Optional[str] = None,
        duration_ms: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Arm one on-demand ``jax.profiler`` deep capture (``POST
        /v1/profile/capture``); the request rides the target agent's next
        granted lease via the ``alerts`` channel."""
        return self.captures.request(agent, op=op, duration_ms=duration_ms)

    def captures_json(self) -> Dict[str, Any]:
        return {"captures": self.captures.snapshot()}

    def host_profile_text(self) -> Optional[str]:
        """Collapsed-stack flamegraph text of THIS process (``GET
        /v1/profile/host``), or None when disabled. The sampler thread
        starts lazily on the first request; the first response still
        carries ≥1 real sample (one synchronous walk if the thread hasn't
        beaten yet)."""
        if not self.obs_config.profile_host_enabled:
            return None
        with self._host_profiler_lock:
            if self.host_profiler is None:
                self.host_profiler = HostProfiler(
                    hz=self.obs_config.profile_host_hz
                ).start()
            prof = self.host_profiler
        if prof.n_samples == 0:
            prof.sample_once()
        return prof.collapsed()

    def host_profile_stats(self) -> Optional[Dict[str, Any]]:
        if self.host_profiler is None:
            return None
        return self.host_profiler.stats()

    def status_summary(self) -> Dict[str, Any]:
        """Structured rollup for /v1/status: per-op task counts + throughput
        since controller start, and p50/p95/p99 per task phase estimated
        from the fleet-merged ``task_phase_seconds`` histogram buckets."""
        uptime = max(1e-9, time.time() - self._started_wall)
        snap = self.metrics.snapshot()
        per_op: Dict[str, Dict[str, Any]] = {}
        for s in snap.get("controller_results_total", {}).get("series", []):
            labels = s.get("labels", {})
            op, outcome = labels.get("op"), labels.get("outcome")
            if op is None or outcome not in ("succeeded", "failed"):
                continue
            entry = per_op.setdefault(op, {"succeeded": 0, "failed": 0})
            entry[outcome] = int(s.get("value", 0))
        for op, entry in per_op.items():
            entry["tasks_per_sec"] = round(entry["succeeded"] / uptime, 3)
        phases: Dict[str, Dict[str, Any]] = {}
        fleet = self.fleet_snapshot().get("task_phase_seconds")
        if fleet:
            buckets = fleet.get("buckets", [])
            for s in fleet.get("series", []):
                labels = s.get("labels", {})
                op, phase = labels.get("op"), labels.get("phase")
                if op is None or phase is None or not s.get("count"):
                    continue
                qs = {
                    f"p{int(q * 100)}": histogram_quantile(
                        buckets, s.get("counts", []), q
                    )
                    for q in (0.5, 0.95, 0.99)
                }
                phases.setdefault(op, {})[phase] = {
                    "count": s["count"],
                    "sum_seconds": round(float(s.get("sum", 0.0)), 6),
                    **{
                        k: (round(v, 6) if v is not None else None)
                        for k, v in qs.items()
                    },
                }
        return {
            "uptime_sec": round(uptime, 3),
            "ops": per_op,
            "task_phase_seconds": phases,
        }
