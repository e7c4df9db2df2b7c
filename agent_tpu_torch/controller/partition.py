"""Partitioned control plane: consistent-hash placement + routing core —
the port's counterpart of ``agent_tpu.controller.partition``, host code
that imports no torch. Placement is bit-identical to the reference's (the
same blake2b digest over the same UTF-8 bytes, the same tie order), so a
fleet that mixes both packages homes every key on the same partition.

One GIL-bound controller process is both a throughput ceiling and a blast
radius. This module shards the control plane into N independent
``Controller`` partitions — each with its own segmented journal, snapshot
cadence, and (optionally) hot standby, the journal machinery
instantiated N times on distinct journal paths — and provides the
*stateless* routing brain that hides the topology from clients and agents:

- ``HashRing``: rendezvous (highest-random-weight) hashing over
  ``hashlib.blake2b`` digests. Deterministic across processes and Python
  builds (never the builtin ``hash()``, which PYTHONHASHSEED perturbs),
  and minimal-remap by construction: adding or removing one of N members
  moves only the keys whose argmax changed, ~1/N of them.
- ``placement_key(tenant, job_id)``: jobs shard by ``{tenant, job_id}``.
  Serve traffic routes by tenant alone — serving bucket keys already
  include the tenant, so whole buckets land on one home partition and
  coalescing stays intact.
- ``RouterCore``: the transport-agnostic routing logic shared by the HTTP
  router process (``controller/router.py``) and by agents running with an
  explicit partition map (``PartitionSession`` below). Stateless by
  design: every decision is a pure function of the request plus a cached
  depth sample; any number of router replicas can front the same
  partitions.

Lease handoff and idempotency: a granted lease's ``lease_id`` comes back
tagged ``<partition>!<lease_id>`` so the result post (and any spool
redelivery of it — the spool stores the tagged id) routes to the partition
that granted the lease, home or stolen. Job state never moves between
partitions: "stealing" is an idle agent *polling* a deeper partition, so a
stolen job that races its home lease resolves first-wins inside the owning
partition via the existing epoch fence and terminal-state duplicate guard.
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

from agent_tpu_torch.config import env_str
from agent_tpu_torch.sched.base import DEFAULT_TENANT
from agent_tpu_torch.sched.steal import StealPolicy

# Separates the granting partition's name from its native lease id in the
# tagged ids the router hands out. Safe: partition names reject it at
# parse time and native lease ids are `lease-<hex>`.
LEASE_TAG_SEP = "!"

# (status, parsed-JSON-body) — transport failures raise OSError (covers
# urllib URLError, socket timeouts, requests' RequestException, and the
# chaos harness's ChaosTransportError).
PostFn = Callable[[str, str, Dict[str, Any], float], Tuple[int, Any]]
GetFn = Callable[[str, str, float], Tuple[int, Any]]


def stable_hash(text: str) -> int:
    """64-bit digest that is identical in every process. The builtin
    ``hash()`` is salted per-process (PYTHONHASHSEED) and would scatter a
    job's home partition across restarts."""
    return int.from_bytes(
        hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest(), "big"
    )


def placement_key(tenant: Optional[str], job_id: str) -> str:
    """Jobs shard by ``{tenant, job_id}``; 0x1f keeps ``("ab","c")`` and
    ``("a","bc")`` distinct."""
    return f"{tenant or DEFAULT_TENANT}\x1f{job_id}"


class HashRing:
    """Rendezvous-hash placement over a set of partition names.

    ``place(key)`` picks the member maximizing ``blake2b(member, key)`` —
    deterministic, uniform, and minimal-remap: membership changes move
    only keys whose winning member appeared/vanished (~1/N of them),
    which the ring-stability property test pins.
    """

    def __init__(self, members: Iterable[str]) -> None:
        self._members: List[str] = []
        for m in members:
            self.add(m)
        if not self._members:
            raise ValueError("HashRing needs at least one member")

    @property
    def members(self) -> Tuple[str, ...]:
        return tuple(self._members)

    def add(self, member: str) -> None:
        member = str(member)
        if LEASE_TAG_SEP in member or not member:
            raise ValueError(f"bad partition name {member!r}")
        if member not in self._members:
            self._members.append(member)
            self._members.sort()

    def remove(self, member: str) -> None:
        self._members.remove(member)
        if not self._members:
            raise ValueError("HashRing cannot become empty")

    def place(self, key: str) -> str:
        # Ties are astronomically unlikely at 64 bits but the (score,
        # name) tuple makes the argmax total-ordered regardless.
        return max(
            self._members,
            key=lambda m: (stable_hash(f"{m}\x1f{key}"), m),
        )


class PartitionMap:
    """Partition name -> ordered failover URL list.

    Spec grammar (``PARTITION_URLS``)::

        p0=http://host:8080|http://standby:8081,p1=http://host:8082

    Bare URLs are also accepted (``http://a,http://b``) and named
    ``p0..pN-1`` in order. The ``|``-separated alternates per partition
    are tried in order on transport failure — the slot a promoted hot
    standby serves on.
    """

    def __init__(self, partitions: Mapping[str, Sequence[str]]) -> None:
        if not partitions:
            raise ValueError("PartitionMap needs at least one partition")
        self._urls: Dict[str, List[str]] = {}
        for name, urls in partitions.items():
            name = str(name)
            if LEASE_TAG_SEP in name or not name:
                raise ValueError(f"bad partition name {name!r}")
            cleaned = [str(u).rstrip("/") for u in urls if str(u).strip()]
            if not cleaned:
                raise ValueError(f"partition {name!r} has no URLs")
            self._urls[name] = cleaned
        self.ring = HashRing(self._urls)

    @classmethod
    def parse(cls, spec: str) -> "PartitionMap":
        out: Dict[str, List[str]] = {}
        unnamed = 0
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            if "=" in entry and not entry.split("=", 1)[0].startswith("http"):
                name, urls = entry.split("=", 1)
                name = name.strip()
            else:
                name, urls = f"p{unnamed}", entry
                unnamed += 1
            out.setdefault(name, []).extend(
                u.strip() for u in urls.split("|") if u.strip()
            )
        return cls(out)

    @classmethod
    def from_env(cls) -> Optional["PartitionMap"]:
        spec = env_str("PARTITION_URLS", "").strip()
        return cls.parse(spec) if spec else None

    @property
    def names(self) -> Tuple[str, ...]:
        return self.ring.members

    def urls(self, name: str) -> List[str]:
        return list(self._urls[name])

    def __len__(self) -> int:
        return len(self._urls)


def job_id_for_partition(
    ring: HashRing,
    target: str,
    tenant: Optional[str] = None,
    prefix: str = "job",
    start: int = 0,
    limit: int = 100000,
) -> str:
    """A job id that the ring places on ``target`` — how tests and the
    smoke craft skewed load against one partition deterministically."""
    for i in range(start, start + limit):
        jid = f"{prefix}-{i}"
        if ring.place(placement_key(tenant, jid)) == target:
            return jid
    raise RuntimeError(f"no id landing on {target} within {limit} tries")


class PartitionDown(ConnectionError):
    """Every URL of the required partition failed at the transport."""

    def __init__(self, partition: str, last: Optional[BaseException]) -> None:
        super().__init__(f"partition {partition} unreachable: {last}")
        self.partition = partition


class RouterCore:
    """The stateless routing brain over a ``PartitionMap``.

    All state here is *soft*: per-partition URL rotation indices (which
    alternate answered last), a TTL-bounded depth sample for steal
    decisions, and monotonic counters for observability. Losing it all
    (router restart, second replica) changes nothing about correctness —
    placement is a pure hash and lease routing rides the tagged ids.
    """

    def __init__(
        self,
        pmap: PartitionMap,
        post_fn: PostFn,
        get_fn: Optional[GetFn] = None,
        steal: Optional[StealPolicy] = None,
        depth_cache_sec: float = 0.25,
        timeout_sec: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.pmap = pmap
        self.steal = steal if steal is not None else StealPolicy()
        self._post = post_fn
        self._get = get_fn
        self._timeout = timeout_sec
        self._clock = clock
        self._lock = threading.Lock()
        self._url_index: Dict[str, int] = {n: 0 for n in pmap.names}
        self._depths: Dict[str, Optional[int]] = {}
        self._depths_at = -1e9
        self._depth_cache_sec = max(0.0, depth_cache_sec)
        self.counters: Dict[str, int] = {
            "submits_total": 0,
            "rejects_429_total": 0,
            "lease_grants_home_total": 0,
            "lease_grants_stolen_total": 0,
            "results_routed_total": 0,
            "results_fanout_total": 0,
            "partition_failovers_total": 0,
        }

    # ---- placement ----

    def home_for_job(self, tenant: Optional[str], job_id: str) -> str:
        return self.pmap.ring.place(placement_key(tenant, job_id))

    def home_for_tenant(self, tenant: Optional[str]) -> str:
        # Serve buckets key on the tenant, so the whole tenant routes as a
        # unit and partition-local coalescing keeps working.
        return self.pmap.ring.place(f"tenant\x1f{tenant or DEFAULT_TENANT}")

    def home_for_agent(self, agent: str) -> str:
        return self.pmap.ring.place(f"agent\x1f{agent}")

    # ---- transport with per-partition URL failover ----

    def post_partition(
        self, name: str, path: str, body: Dict[str, Any]
    ) -> Tuple[int, Any]:
        urls = self.pmap.urls(name)
        with self._lock:
            start = self._url_index.get(name, 0)
        last: Optional[BaseException] = None
        for attempt in range(len(urls)):
            url = urls[(start + attempt) % len(urls)]
            try:
                status, parsed = self._post(url, path, body, self._timeout)
            except OSError as exc:
                last = exc
                with self._lock:
                    # Rotate only if nobody beat us to it (same benign
                    # race rule as the agent's controller failover).
                    if self._url_index.get(name, 0) == (
                        (start + attempt) % len(urls)
                    ):
                        self._url_index[name] = (
                            (start + attempt + 1) % len(urls)
                        )
                    self.counters["partition_failovers_total"] += 1
                continue
            return status, parsed
        raise PartitionDown(name, last)

    def get_partition(self, name: str, path: str) -> Tuple[int, Any]:
        if self._get is None:
            raise PartitionDown(name, None)
        urls = self.pmap.urls(name)
        with self._lock:
            start = self._url_index.get(name, 0)
        last: Optional[BaseException] = None
        for attempt in range(len(urls)):
            url = urls[(start + attempt) % len(urls)]
            try:
                return self._get(url, path, self._timeout)
            except OSError as exc:
                last = exc
                continue
        raise PartitionDown(name, last)

    # ---- write-path routing ----

    def route_submit(self, body: Dict[str, Any]) -> Tuple[int, Any]:
        """POST /v1/jobs. Single submits place by ``{tenant, job_id}`` —
        the router mints the id when the client didn't, so placement stays
        a pure function and a client retry with the same id lands on the
        same partition (preserving the duplicate-id exactly-once ack). CSV
        map-reduce submits place as one unit by ``{tenant, source_uri}``:
        shards and their reduce must share a partition for dep-gating."""
        tenant = body.get("tenant") or DEFAULT_TENANT
        if body.get("source_uri"):
            name = self.pmap.ring.place(
                placement_key(tenant, f"csv\x1f{body['source_uri']}")
            )
        else:
            job_id = body.get("job_id") or f"job-{uuid.uuid4().hex[:12]}"
            body = dict(body, job_id=job_id)
            name = self.home_for_job(tenant, job_id)
        status, parsed = self.post_partition(name, "/v1/jobs", body)
        with self._lock:
            self.counters["submits_total"] += 1
            if status == 429:
                self.counters["rejects_429_total"] += 1
        if isinstance(parsed, dict):
            # 429s aggregate trivially: only the home partition was asked,
            # so its verdict (and retry_after_ms) IS the answer; the stamp
            # lets loadgen count drops per partition.
            parsed.setdefault("partition", name)
        return status, parsed

    def route_workflow(self, body: Dict[str, Any]) -> Tuple[int, Any]:
        """POST /v1/workflows. A DAG places as ONE unit by
        ``{tenant, workflow_id}`` — the CSV ``source_uri`` rule generalized:
        every stage job of a graph must share a partition or cross-partition
        dep edges would never release. The router mints the workflow id when
        the client didn't so placement stays a pure function and a client
        retry with the same id lands on the same partition."""
        tenant = body.get("tenant") or DEFAULT_TENANT
        workflow_id = body.get("workflow_id") or f"wf-{uuid.uuid4().hex[:12]}"
        body = dict(body, workflow_id=workflow_id)
        name = self.pmap.ring.place(
            placement_key(tenant, f"wf\x1f{workflow_id}")
        )
        status, parsed = self.post_partition(name, "/v1/workflows", body)
        with self._lock:
            self.counters["submits_total"] += 1
            if status == 429:
                self.counters["rejects_429_total"] += 1
        if isinstance(parsed, dict):
            parsed.setdefault("partition", name)
        return status, parsed

    def route_infer(self, body: Dict[str, Any]) -> Tuple[int, Any]:
        tenant = body.get("tenant") or (
            (body.get("params") or {}).get("tenant")
            if isinstance(body.get("params"), dict) else None
        )
        name = self.home_for_tenant(tenant)
        status, parsed = self.post_partition(name, "/v1/infer", body)
        if isinstance(parsed, dict):
            parsed.setdefault("partition", name)
        return status, parsed

    def route_lease(self, body: Dict[str, Any]) -> Tuple[int, Any]:
        """POST /v1/leases: home partition first; an empty home plus a
        sufficiently deeper foreign queue steals one poll there. The
        granted ``lease_id`` comes back tagged with the granting
        partition so the result finds its way home."""
        agent = str(body.get("agent") or "")
        home = self.home_for_agent(agent)
        home_down: Optional[PartitionDown] = None
        try:
            status, parsed = self.post_partition(home, "/v1/leases", body)
        except PartitionDown as exc:
            # A dead home partition must NOT strand its agents — they fall
            # through to stealing from survivors (pick_victim treats an
            # unreachable home as depth 0, so any survivor with work
            # qualifies). This is the partition-kill survivability bar:
            # surviving partitions keep granting within one poll interval.
            home_down = exc
            status, parsed = 204, None
        requested = body.get("max_tasks")
        if self._granted(status, parsed):
            with self._lock:
                self.counters["lease_grants_home_total"] += 1
            return status, self._tag_lease(home, parsed)
        if requested == 0:
            # Metrics-push / spool-flush poll: a heartbeat, not a request
            # for work — never escalate it into a steal.
            if home_down is not None:
                raise home_down
            return status, parsed
        victim = self.steal.pick_victim(home, self.leasable_depths())
        if victim is None:
            if home_down is not None:
                raise home_down
            return status, parsed
        try:
            v_status, v_parsed = self.post_partition(
                victim, "/v1/leases", body
            )
        except PartitionDown:
            if home_down is not None:
                raise home_down
            return status, parsed
        if self._granted(v_status, v_parsed):
            with self._lock:
                self.counters["lease_grants_stolen_total"] += 1
            return v_status, self._tag_lease(victim, v_parsed)
        # Victim reachable but empty: an honest 204 — the agent polls
        # again shortly, which beats a 503-driven backoff even when the
        # home partition is dark.
        return status, parsed

    def route_result(self, body: Dict[str, Any]) -> Tuple[int, Any]:
        """POST /v1/results: tagged lease ids route straight to the
        partition that granted the lease (stolen or home — the spool keeps
        the tag, so redelivery follows the applying partition). Untagged
        ids (direct-to-partition agents, hand-written clients) fan out
        until some partition recognizes the job."""
        lease_id = str(body.get("lease_id") or "")
        if LEASE_TAG_SEP in lease_id:
            name, raw = lease_id.split(LEASE_TAG_SEP, 1)
            if name in self.pmap.names:
                status, parsed = self.post_partition(
                    name, "/v1/results", dict(body, lease_id=raw)
                )
                with self._lock:
                    self.counters["results_routed_total"] += 1
                return status, parsed
        with self._lock:
            self.counters["results_fanout_total"] += 1
        last: Tuple[int, Any] = (404, {"accepted": False,
                                       "reason": "unknown job"})
        down: Optional[PartitionDown] = None
        for name in self.pmap.names:
            try:
                status, parsed = self.post_partition(
                    name, "/v1/results", body
                )
            except PartitionDown as exc:
                down = exc
                continue
            if not isinstance(parsed, dict):
                last = (status, parsed)
                continue
            if parsed.get("accepted") or parsed.get("reason") not in (
                "unknown job", None
            ):
                return status, parsed
            last = (status, parsed)
        if down is not None and last[1].get("reason") == "unknown job":
            # The owner might be the unreachable partition — surface a
            # transport error so the agent spools and retries instead of
            # dropping the result on a false "unknown job".
            raise down
        return last

    # ---- steal support ----

    def leasable_depths(self) -> Dict[str, Optional[int]]:
        """Per-partition leasable queue depth, cached ``depth_cache_sec``
        — the steal decision's input. Unreachable partitions sample as
        None (never stolen from)."""
        now = self._clock()
        with self._lock:
            if now - self._depths_at < self._depth_cache_sec and self._depths:
                return dict(self._depths)
        depths: Dict[str, Optional[int]] = {}
        for name in self.pmap.names:
            try:
                status, parsed = self.get_partition(name, "/v1/depth")
            except (PartitionDown, OSError):
                depths[name] = None
                continue
            if status == 200 and isinstance(parsed, dict):
                depths[name] = int(
                    parsed.get("leasable", parsed.get("queue_depth", 0))
                )
            else:
                depths[name] = None
        with self._lock:
            self._depths = dict(depths)
            self._depths_at = now
        return depths

    # ---- helpers ----

    @staticmethod
    def _granted(status: int, parsed: Any) -> bool:
        return (
            status == 200
            and isinstance(parsed, dict)
            and bool(parsed.get("tasks"))
            and bool(parsed.get("lease_id"))
        )

    @staticmethod
    def _tag_lease(name: str, parsed: Dict[str, Any]) -> Dict[str, Any]:
        return dict(
            parsed, lease_id=f"{name}{LEASE_TAG_SEP}{parsed['lease_id']}"
        )

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "partitions": list(self.pmap.names),
                "steal": {
                    "enabled": self.steal.enabled,
                    "min_advantage": self.steal.min_advantage,
                },
                **dict(self.counters),
            }


class _ShimResponse:
    """requests.Response-shaped wrapper for ``PartitionSession``."""

    def __init__(self, status_code: int, body: Any) -> None:
        self.status_code = int(status_code)
        self._body = body

    def json(self) -> Any:
        return self._body

    @property
    def text(self) -> str:
        import json as _json

        try:
            return _json.dumps(self._body)
        except (TypeError, ValueError):
            return str(self._body)


class PartitionSession:
    """Agent-side partition map: an in-process router shim.

    When ``CONTROLLER_PARTITION_MAP`` is set, the agent wraps its HTTP
    session in one of these and keeps the rest of its loop untouched —
    ``lease_once``/``post_result``/``flush_spool`` post to the same paths
    they always did, and the shim runs the identical ``RouterCore`` logic
    the standalone router runs (home-first lease, steal, tagged lease ids,
    result routing by tag). Spooled results carry the tagged id, so
    redelivery follows the stolen job's applying partition with zero new
    spool machinery.
    """

    def __init__(
        self,
        inner: Any,
        pmap: PartitionMap,
        steal: Optional[StealPolicy] = None,
        timeout_sec: float = 10.0,
    ) -> None:
        self._inner = inner

        def post_fn(
            url: str, path: str, body: Dict[str, Any], timeout: float
        ) -> Tuple[int, Any]:
            resp = inner.post(url + path, json=body, timeout=timeout)
            try:
                parsed = resp.json()
            except ValueError:
                parsed = None
            return resp.status_code, parsed

        def get_fn(
            url: str, path: str, timeout: float
        ) -> Tuple[int, Any]:
            getter = getattr(inner, "get", None)
            if getter is None:
                raise ConnectionError("session has no GET")
            resp = getter(url + path, timeout=timeout)
            try:
                parsed = resp.json()
            except ValueError:
                parsed = None
            return resp.status_code, parsed

        self.core = RouterCore(
            pmap, post_fn, get_fn=get_fn, steal=steal,
            timeout_sec=timeout_sec,
        )

    def post(
        self,
        url: str,
        json: Optional[Dict[str, Any]] = None,
        timeout: Optional[float] = None,
    ) -> _ShimResponse:
        from urllib.parse import urlsplit

        body = json or {}
        path = urlsplit(url).path or "/"
        if path.endswith("/v1/leases"):
            status, parsed = self.core.route_lease(body)
        elif path.endswith("/v1/results"):
            status, parsed = self.core.route_result(body)
        elif path.endswith("/v1/jobs"):
            status, parsed = self.core.route_submit(body)
        elif path.endswith("/v1/workflows"):
            status, parsed = self.core.route_workflow(body)
        elif path.endswith("/v1/infer"):
            status, parsed = self.core.route_infer(body)
        else:
            # Anything else goes to the first partition (debug surfaces).
            status, parsed = self.core.post_partition(
                self.core.pmap.names[0], path, body
            )
        return _ShimResponse(status, parsed)


class LocalPartitionSet:
    """N in-process partitions behind real HTTP — the harness tests, the
    smoke, and the router's convenience single-process mode share.

    Each partition is a full ``Controller`` (own journal at
    ``<journal_base>.<name>``, own sweeper, own metrics registry) served
    by its own ``ControllerServer`` on an ephemeral port.
    """

    def __init__(
        self,
        n: int,
        journal_base: Optional[str] = None,
        controller_kwargs: Optional[Dict[str, Any]] = None,
        host: str = "127.0.0.1",
    ) -> None:
        from agent_tpu_torch.controller.core import Controller

        self.names = [f"p{i}" for i in range(max(1, int(n)))]
        self.controllers: Dict[str, Any] = {}
        self._host = host
        kwargs = dict(controller_kwargs or {})
        for name in self.names:
            per = dict(kwargs)
            if journal_base:
                per["journal_path"] = f"{journal_base}.{name}"
            self.controllers[name] = Controller(partition=name, **per)
        self.servers: Dict[str, Any] = {}
        self.pmap: Optional[PartitionMap] = None

    def start(self) -> "LocalPartitionSet":
        from agent_tpu_torch.controller.server import ControllerServer

        for name in self.names:
            self.servers[name] = ControllerServer(
                self.controllers[name], host=self._host, port=0
            ).start()
        self.pmap = PartitionMap(
            {name: [self.servers[name].url] for name in self.names}
        )
        return self

    def stop(self) -> None:
        for server in self.servers.values():
            try:
                server.stop()
            except Exception:  # noqa: BLE001 — teardown must not mask
                pass
        for controller in self.controllers.values():
            try:
                controller.close()
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self) -> "LocalPartitionSet":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()
