"""Open-loop traffic generator — planet-scale arrivals in miniature; the
port's counterpart of ``agent_tpu.loadgen``, whose schedule it draws byte
for byte from the same seed.

Everything the swarm has drained so far was a *fixed* queue: submit N
shards, drain, stop. "Millions of users" is not that — it is an **open
loop** where arrivals follow their own clock (diurnal swing, bursty
thundering herds, spot-market churn underneath) and never wait for the
system to catch up. This module generates that traffic deterministically:

- :class:`ArrivalPattern` — a non-homogeneous Poisson intensity
  ``rate(t) = base · (1 + amplitude·sin(2πt/period)) · burst_factor(t)``.
  The diurnal sine models the day/night swing; burst windows model the 10×
  herd the autoscaler (``agent_tpu_torch/autoscale.py``) must absorb.
- :class:`TrafficClass` — one kind of work: op + payload template, tenant,
  priority tier, optional ``deadline_sec`` (the interactive class the SLO
  engine judges is just a class with tier 8 + a deadline).
- :class:`LoadGen` — draws the whole arrival **schedule** up front from one
  ``random.Random(seed)`` (thinning over the pattern's peak rate), then
  replays it against a submit callable in real time. Same seed → same
  arrivals, byte for byte; the soak's churn run and its calm reference
  submit the *identical* job set.

Submission is transport-agnostic: :func:`session_submitter` adapts any
``session.post``-shaped object — a ``requests.Session`` against a real
controller URL or a ``chaos.LoopbackSession`` — to the submit-callable
shape ``LoadGen.run`` expects. Open-loop semantics on backpressure: an
admission 429 **drops** the arrival (counted, never retried) — a real user
herd does not politely hold its requests either.
"""

from __future__ import annotations

import bisect
import functools
import math
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from agent_tpu_torch.config import LoadgenConfig


@functools.lru_cache(maxsize=64)
def _zipf_cdf(n: int, s: float) -> Tuple[float, ...]:
    weights = [1.0 / (i + 1) ** s for i in range(n)]
    total = sum(weights)
    acc = 0.0
    cdf = []
    for w in weights:
        acc += w
        cdf.append(acc / total)
    return tuple(cdf)


def zipf_rank(rng: random.Random, n: int, s: float) -> int:
    """Draw a 0-based rank from a truncated zipfian over ``n`` items:
    P(rank=k) ∝ 1/(k+1)^s. ``s=0`` is uniform; larger ``s`` concentrates
    mass on low ranks — the head-heavy repeat distribution real request
    streams show, and exactly what makes a content-addressed result cache
    earn its keep. Deterministic given the caller's seeded rng."""
    if n <= 1:
        return 0
    cdf = _zipf_cdf(int(n), float(s))
    return min(n - 1, bisect.bisect_left(cdf, rng.random()))


class Rejected(Exception):
    """Submit refused by admission control (HTTP 429) — the open loop
    counts the drop and moves on. Behind the partitioned control plane's
    router the 429 body names the rejecting partition;
    ``partition`` carries it so drops count per partition, not as one
    smeared fleet total."""

    def __init__(self, msg: str, partition: Optional[str] = None) -> None:
        super().__init__(msg)
        self.partition = partition


@dataclass(frozen=True)
class TrafficClass:
    """One class of offered work. ``payload`` is the static template;
    ``payload_fn(rng, seq)`` (when given) builds a per-arrival payload from
    the generator's seeded rng and the arrival sequence number, so payload
    variety stays deterministic too.

    ``route`` picks the submission surface: ``"jobs"`` (the
    batch queue, ``POST /v1/jobs`` — the historical shape) or ``"infer"``
    (the serving front door, ``POST /v1/infer``). An infer class's ``op``
    is the REQUEST op (``classify``/``summarize``) and its payload carries
    ``{"text": ..., "params": {...}}`` — one traffic driver for
    elastic_soak's job churn and the serving bench's interactive load.

    ``payload_zipf_s`` switches the class to a zipfian payload
    MIX: each arrival draws a variant rank from ``zipf_rank(rng,
    payload_pool, payload_zipf_s)`` and the payload is a deterministic
    function of that rank alone — so popular variants recur byte-identical
    (the repeats a result cache dedupes) while the tail stays cold. With a
    ``payload_fn`` the rank replaces ``seq`` and the rng is freshly seeded
    from the rank, making the built payload a pure function of the rank;
    without one the template gains a ``"variant": rank`` field."""

    name: str
    op: str
    weight: float = 1.0
    tenant: Optional[str] = None
    priority: Optional[int] = None
    deadline_sec: Optional[float] = None
    payload: Dict[str, Any] = field(default_factory=dict)
    payload_fn: Optional[Callable[[random.Random, int], Dict[str, Any]]] = None
    route: str = "jobs"   # "jobs" | "infer"
    payload_zipf_s: Optional[float] = None  # zipf exponent; None = off
    payload_pool: int = 64                  # distinct variants when zipfian

    def __post_init__(self) -> None:
        if self.route not in ("jobs", "infer"):
            raise ValueError(
                f"route must be 'jobs' or 'infer', got {self.route!r}"
            )
        if self.payload_zipf_s is not None and self.payload_zipf_s < 0:
            raise ValueError("payload_zipf_s must be >= 0")
        if self.payload_pool < 1:
            raise ValueError("payload_pool must be >= 1")

    def build_payload(self, rng: random.Random, seq: int) -> Dict[str, Any]:
        if self.payload_zipf_s is not None:
            rank = zipf_rank(rng, self.payload_pool, self.payload_zipf_s)
            if self.payload_fn is not None:
                # Fresh rank-seeded rng: the variant's payload is identical
                # every time the rank recurs, whatever the arrival history.
                return self.payload_fn(random.Random(rank), rank)
            out = dict(self.payload)
            out["variant"] = rank
            return out
        if self.payload_fn is not None:
            return self.payload_fn(rng, seq)
        return dict(self.payload)


@dataclass(frozen=True)
class Arrival:
    """One scheduled submission: offset seconds from run start, the class,
    the pre-built payload, and the run-wide sequence number."""

    t: float
    cls: TrafficClass
    payload: Dict[str, Any]
    seq: int


class ArrivalPattern:
    """Deterministic intensity function over run time."""

    def __init__(
        self,
        base_rate: float,
        diurnal_amplitude: float = 0.0,
        diurnal_period_sec: float = 86400.0,
        bursts: Sequence[Tuple[float, float, float]] = (),
    ) -> None:
        self.base_rate = max(0.0, float(base_rate))
        self.diurnal_amplitude = min(1.0, max(0.0, float(diurnal_amplitude)))
        self.diurnal_period_sec = max(1e-9, float(diurnal_period_sec))
        # (start_sec, end_sec, factor) windows; overlapping windows multiply.
        self.bursts = [
            (float(s), float(e), max(0.0, float(f))) for s, e, f in bursts
        ]

    @classmethod
    def from_config(cls, cfg: LoadgenConfig) -> "ArrivalPattern":
        bursts = []
        if cfg.burst_len_sec > 0 and cfg.burst_factor != 1.0:
            bursts.append((
                cfg.burst_at_sec,
                cfg.burst_at_sec + cfg.burst_len_sec,
                cfg.burst_factor,
            ))
        return cls(
            cfg.base_rate,
            diurnal_amplitude=cfg.diurnal_amplitude,
            diurnal_period_sec=cfg.diurnal_period_sec,
            bursts=bursts,
        )

    def burst_factor(self, t: float) -> float:
        f = 1.0
        for start, end, factor in self.bursts:
            if start <= t < end:
                f *= factor
        return f

    def rate(self, t: float) -> float:
        """Jobs/sec at offset ``t`` (never negative)."""
        diurnal = 1.0 + self.diurnal_amplitude * math.sin(
            2.0 * math.pi * t / self.diurnal_period_sec
        )
        return max(0.0, self.base_rate * diurnal * self.burst_factor(t))

    def peak_rate(self) -> float:
        """An upper bound on ``rate`` — the thinning envelope."""
        burst_max = max(
            [1.0] + [f for _s, _e, f in self.bursts if f > 1.0]
        )
        return self.base_rate * (1.0 + self.diurnal_amplitude) * burst_max


@dataclass
class LoadGenStats:
    """What one replayed schedule did: per-class submit counts, open-loop
    drops, and the (job_id, class, submit-wall-offset, seq) ledger the soak
    joins against controller-side completion times."""

    submitted: Dict[str, int] = field(default_factory=dict)
    rejected: Dict[str, int] = field(default_factory=dict)
    # Which partition said no: keyed by the partition name the
    # router stamped into the 429 body; unstamped rejects (a bare
    # controller) count under "".
    rejected_by_partition: Dict[str, int] = field(default_factory=dict)
    errors: Dict[str, int] = field(default_factory=dict)
    jobs: List[Dict[str, Any]] = field(default_factory=list)

    def total_submitted(self) -> int:
        return sum(self.submitted.values())

    def total_rejected(self) -> int:
        return sum(self.rejected.values())

    def job_ids(self, cls_name: Optional[str] = None) -> List[str]:
        return [
            j["job_id"] for j in self.jobs
            if cls_name is None or j["class"] == cls_name
        ]


class LoadGen:
    """Seeded open-loop generator over a class mix + arrival pattern."""

    def __init__(
        self,
        classes: Sequence[TrafficClass],
        pattern: ArrivalPattern,
        seed: int = 0,
    ) -> None:
        if not classes:
            raise ValueError("at least one TrafficClass is required")
        if any(c.weight < 0 for c in classes):
            raise ValueError("class weights must be >= 0")
        if not any(c.weight > 0 for c in classes):
            raise ValueError("at least one class weight must be > 0")
        self.classes = list(classes)
        self.pattern = pattern
        self.seed = int(seed)

    def schedule(self, duration_sec: float) -> List[Arrival]:
        """The full arrival list for ``duration_sec``, drawn from one seeded
        rng: thinning over the pattern's peak rate (a draw is accepted with
        probability ``rate(t)/peak``), then a weighted class pick and the
        class's payload build. Pure function of (seed, classes, pattern,
        duration) — the determinism the soak's calm-vs-churn comparison
        rests on."""
        rng = random.Random(self.seed)
        peak = self.pattern.peak_rate()
        arrivals: List[Arrival] = []
        if peak <= 0 or duration_sec <= 0:
            return arrivals
        weights = [c.weight for c in self.classes]
        t = 0.0
        seq = 0
        while True:
            t += rng.expovariate(peak)
            if t >= duration_sec:
                break
            if rng.random() >= self.pattern.rate(t) / peak:
                continue  # thinned: the instantaneous rate is below peak
            cls = rng.choices(self.classes, weights=weights, k=1)[0]
            arrivals.append(Arrival(t, cls, cls.build_payload(rng, seq), seq))
            seq += 1
        return arrivals

    def run(
        self,
        submit: Callable[[Arrival], str],
        duration_sec: float,
        *,
        now: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        stats: Optional[LoadGenStats] = None,
    ) -> LoadGenStats:
        """Replay the schedule in real time against ``submit(arrival) ->
        job_id``. Open loop: the clock, not the system, paces submissions —
        a slow controller gets the full burst anyway, late (the generator
        never skips an arrival, it just falls behind the ideal offsets).
        ``Rejected`` (admission 429) drops the arrival; any other submit
        exception is counted and dropped too (the generator must outlive a
        controller blip)."""
        stats = stats if stats is not None else LoadGenStats()
        t0 = now()
        for arrival in self.schedule(duration_sec):
            delay = arrival.t - (now() - t0)
            if delay > 0:
                sleep(delay)
            name = arrival.cls.name
            try:
                job_id = submit(arrival)
            except Rejected as exc:
                stats.rejected[name] = stats.rejected.get(name, 0) + 1
                part = exc.partition or ""
                stats.rejected_by_partition[part] = (
                    stats.rejected_by_partition.get(part, 0) + 1
                )
                continue
            except Exception:  # noqa: BLE001 — open loop outlives blips
                stats.errors[name] = stats.errors.get(name, 0) + 1
                continue
            stats.submitted[name] = stats.submitted.get(name, 0) + 1
            stats.jobs.append({
                "job_id": job_id,
                "class": name,
                "seq": arrival.seq,
                "scheduled_t": arrival.t,
                "submitted_t": now() - t0,
            })
        return stats


def session_submitter(
    session: Any, base_url: str = "http://loopback"
) -> Callable[[Arrival], str]:
    """Adapt any ``session.post``-shaped transport (``requests.Session``,
    ``chaos.LoopbackSession``) into the submit callable ``LoadGen.run``
    expects. ``route="jobs"`` classes POST to ``{base_url}/v1/jobs``
    (tenant/priority/deadline riding the body, job_id back);
    ``route="infer"`` classes POST to the serving front door
    ``{base_url}/v1/infer`` non-blocking (``wait: false``, req_id back) —
    open loop both ways. 429 → :class:`Rejected` (open-loop drop,
    carrying the rejecting partition when the body is router-stamped);
    any other non-200 raises. ``base_url`` may be a single controller OR
    the partition router — the paths are identical, which is
    the router's whole contract."""
    base = base_url.rstrip("/")
    jobs_url = f"{base}/v1/jobs"
    infer_url = f"{base}/v1/infer"

    def submit(arrival: Arrival) -> str:
        cls = arrival.cls
        if cls.route == "infer":
            body: Dict[str, Any] = {
                "op": cls.op,
                "text": arrival.payload.get("text"),
                "wait": False,
            }
            if isinstance(arrival.payload.get("params"), dict):
                body["params"] = arrival.payload["params"]
            id_key, url = "req_id", infer_url
        else:
            body = {"op": cls.op, "payload": arrival.payload}
            if cls.deadline_sec is not None:
                body["deadline_sec"] = cls.deadline_sec
            id_key, url = "job_id", jobs_url
        if cls.tenant is not None:
            body["tenant"] = cls.tenant
        if cls.priority is not None:
            body["priority"] = cls.priority
        resp = session.post(url, json=body, timeout=10.0)
        status = getattr(resp, "status_code", 0)
        if status == 429:
            try:
                rej = resp.json()
            except ValueError:
                rej = None
            partition = (
                rej.get("partition") if isinstance(rej, dict) else None
            )
            raise Rejected(
                f"admission rejected {cls.name!r}", partition=partition
            )
        if status != 200:
            raise RuntimeError(
                f"submit {cls.name!r} failed: HTTP {status}"
            )
        out_id = resp.json().get(id_key)
        if not isinstance(out_id, str) or not out_id:
            raise RuntimeError(f"submit {cls.name!r}: malformed response")
        return out_id

    return submit
