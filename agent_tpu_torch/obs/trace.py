"""Distributed tracing — counterpart of
``agent_tpu.obs.trace``: the span model, the bounded span ring the agent
records into, the ambient trace context, and the pure assembly and export
functions the tests and chip_smoke's stand-in controller use.

The agent turns the runner's own phase measurements (stage, queue,
execute, post, a spool redelivery) into closed spans parented to the
controller's lease span (``task["trace"]``), buffers them in a
:class:`SpanBuffer` and ships them on ``POST /v1/results`` and on the lease
``metrics`` channel, where the reference controller's ``TraceStore``
assembles one tree per job. The wire dicts are the reference's, key for
key, so that store ingests them unchanged.

The controller's half is :class:`TraceStore`, the bounded per-trace store
that assembles one tree per job (oldest trace evicted first, spans deduped
by id), and :func:`span_link`, a causal reference into another trace.

``TRACE_ENABLED=0`` turns every record path into a no-op. Not here:
``xla.compile`` spans and cache events, which come from an executor the
port does not have.
Stdlib only.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

from agent_tpu_torch.config import TRUTHY_TOKENS

DEFAULT_BUFFER_CAPACITY = 4096
DEFAULT_MAX_TRACES = 512
DEFAULT_MAX_SPANS_PER_TRACE = 1024

# ---- global enable switch (TRACE_ENABLED, default on) ----

_forced_enabled: Optional[bool] = None
_env_enabled: Optional[bool] = None  # memoized env read (hot path)


def set_enabled(value: Optional[bool]) -> None:
    """Override the TRACE_ENABLED env check (tests); ``None`` restores it
    (and re-reads the env on the next :func:`enabled` call)."""
    global _forced_enabled, _env_enabled
    _forced_enabled = value
    _env_enabled = None


def enabled() -> bool:
    if _forced_enabled is not None:
        return _forced_enabled
    global _env_enabled
    if _env_enabled is None:
        v = os.environ.get("TRACE_ENABLED")
        _env_enabled = True if v is None or v == "" else v.strip().lower() in TRUTHY_TOKENS
    return _env_enabled


def new_span_id() -> str:
    """64 random bits, hex: the OpenTelemetry span-id width."""
    return os.urandom(8).hex()


# ---- the span model ----

@dataclass
class Span:
    """One timed operation. ``start_mono``/``duration_ms`` are the exact
    measurement (monotonic clock); ``start_wall`` anchors it on the wall
    clock so spans of different processes sort into one timeline.
    ``duration_ms=None`` means the span is still open."""

    trace_id: str
    span_id: str
    name: str
    parent_span_id: Optional[str] = None
    start_wall: float = 0.0
    start_mono: float = 0.0
    duration_ms: Optional[float] = None
    process: str = ""
    attributes: Dict[str, Any] = field(default_factory=dict)

    def to_wire(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "start_wall": self.start_wall,
            "start_mono": self.start_mono,
            "duration_ms": self.duration_ms,
            "process": self.process,
            "attributes": dict(self.attributes),
        }


def make_span(name: str, trace_id: str, parent_span_id: Optional[str] = None, *,
              start_mono: Optional[float] = None, duration_s: Optional[float] = None,
              process: str = "", span_id: Optional[str] = None,
              attributes: Optional[Mapping[str, Any]] = None,
              links: Optional[Sequence[Mapping[str, Any]]] = None) -> Dict[str, Any]:
    """A closed span wire dict from a measured ``(start_mono, duration)``
    pair; the wall anchor is derived from the current clocks, so one
    measurement never runs two clocks. ``links`` is emitted only when
    non-empty."""
    now_mono = time.monotonic()
    start_mono = now_mono if start_mono is None else float(start_mono)
    span = {
        "trace_id": trace_id,
        "span_id": span_id or new_span_id(),
        "parent_span_id": parent_span_id,
        "name": name,
        "start_wall": time.time() - max(0.0, now_mono - start_mono),
        "start_mono": start_mono,
        "duration_ms": None if duration_s is None else round(float(duration_s) * 1e3, 3),
        "process": process,
        "attributes": dict(attributes or {}),
    }
    if links:
        span["links"] = [dict(link) for link in links]
    return span


def span_link(
    trace_id: str,
    span_id: Optional[str] = None,
    **attributes: Any,
) -> Dict[str, Any]:
    """One link entry for a span's ``links`` list: a causal reference into
    ANOTHER trace (the serving batch job ↔ rider request association).
    ``span_id``/``attributes`` are optional and omitted when empty."""
    link: Dict[str, Any] = {"trace_id": str(trace_id)}
    if span_id:
        link["span_id"] = str(span_id)
    if attributes:
        link["attributes"] = dict(attributes)
    return link


def _valid_span(span: Any) -> bool:
    if type(span) is not dict and not isinstance(span, Mapping):
        return False
    return (isinstance(span.get("trace_id"), str) and span["trace_id"] != ""
            and isinstance(span.get("span_id"), str) and span["span_id"] != ""
            and isinstance(span.get("name"), str) and span["name"] != "")


# ---- per-process span ring ----

class SpanBuffer:
    """Thread-safe bounded ring of span wire dicts. ``add`` is on hot paths:
    it never raises, never blocks beyond the lock, and stays O(1)."""

    def __init__(self, capacity: int = DEFAULT_BUFFER_CAPACITY) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._spans: "collections.deque" = collections.deque(maxlen=self.capacity)
        self._dropped = 0

    def add(self, span: Any) -> None:
        """Buffer one span; a plain dict is stored as given (the caller must
        not mutate it afterwards)."""
        if not enabled():
            return
        if isinstance(span, Span):
            span = span.to_wire()
        if not _valid_span(span):
            return
        if type(span) is not dict:
            span = dict(span)
        with self._lock:
            if len(self._spans) == self.capacity:
                self._dropped += 1
            self._spans.append(span)

    def drain(self) -> List[Dict[str, Any]]:
        """Pop everything pending (the piggyback ship); a caller that fails
        to deliver must :meth:`requeue` what it took."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def requeue(self, spans: Iterable[Mapping[str, Any]]) -> None:
        """Put undelivered spans back; the ring bound still applies."""
        with self._lock:
            for s in spans:
                if len(self._spans) == self.capacity:
                    self._dropped += 1
                self._spans.append(dict(s))

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


# ---- ambient trace context ----

@dataclass(frozen=True)
class TraceContext:
    """What a deep layer needs to attribute a span to the current task:
    where to record (``tracer``/``registry``) and what to parent to."""

    trace_id: str = ""
    parent_span_id: Optional[str] = None
    tracer: Optional[SpanBuffer] = None
    registry: Any = None
    process: str = ""


_current: "contextvars.ContextVar[Optional[TraceContext]]" = contextvars.ContextVar(
    "agent_tpu_torch_trace_ctx", default=None)


def current() -> Optional[TraceContext]:
    return _current.get()


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]):
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


# ---- the controller's bounded per-trace store ----

class TraceStore:
    """Bounded per-trace span store — the controller's assembly point.

    Traces evict oldest-first past ``max_traces`` (same O(capacity) deal as
    the flight recorder: a 10M-shard drain keeps the newest window, not the
    whole history). Spans dedup by ``span_id``, so a piggyback redelivered
    after a lost response re-ingests idempotently.
    """

    def __init__(
        self,
        max_traces: int = DEFAULT_MAX_TRACES,
        max_spans_per_trace: int = DEFAULT_MAX_SPANS_PER_TRACE,
    ) -> None:
        self.max_traces = max(1, int(max_traces))
        self.max_spans_per_trace = max(1, int(max_spans_per_trace))
        self._lock = threading.Lock()
        # trace_id -> {span_id: span dict}; OrderedDict for FIFO eviction.
        self._traces: "collections.OrderedDict[str, Dict[str, Dict[str, Any]]]" = (
            collections.OrderedDict()
        )
        self.dropped_traces = 0
        self.dropped_spans = 0

    def add(self, span: Any) -> bool:
        """Ingest one span wire dict; False = rejected (malformed/bounds).
        Ownership transfers like :meth:`SpanBuffer.add`: a plain dict is
        stored without copying (``finish`` mutates it in place)."""
        if not enabled():
            return False
        if isinstance(span, Span):
            span = span.to_wire()
        if not _valid_span(span):
            return False
        if type(span) is not dict:
            span = dict(span)
        with self._lock:
            spans = self._traces.get(span["trace_id"])
            if spans is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                    self.dropped_traces += 1
                spans = {}
                self._traces[span["trace_id"]] = spans
            if (
                span["span_id"] not in spans
                and len(spans) >= self.max_spans_per_trace
            ):
                self.dropped_spans += 1
                return False
            spans[span["span_id"]] = span
        return True

    def ingest(self, spans: Any) -> int:
        """Bulk ``add`` for a piggybacked batch; returns spans accepted."""
        if not isinstance(spans, (list, tuple)):
            return 0
        return sum(1 for s in spans if self.add(s))

    def open(
        self,
        trace_id: str,
        name: str,
        parent_span_id: Optional[str] = None,
        *,
        start_clock: float = 0.0,
        process: str = "controller",
        attributes: Optional[Mapping[str, Any]] = None,
        span_id: Optional[str] = None,
        links: Optional[Sequence[Mapping[str, Any]]] = None,
    ) -> Optional[str]:
        """Record an OPEN span (duration unknown yet) and return its id, or
        None when tracing is disabled. ``start_clock`` is whatever monotonic
        clock the caller will later pass to :meth:`finish` — the controller
        uses its own (injectable) clock."""
        if not enabled():
            return None
        sid = span_id or new_span_id()
        span: Dict[str, Any] = {
            "trace_id": trace_id,
            "span_id": sid,
            "parent_span_id": parent_span_id,
            "name": name,
            "start_wall": time.time(),
            "start_mono": float(start_clock),
            "duration_ms": None,
            "process": process,
            "attributes": dict(attributes or {}),
        }
        if links:
            span["links"] = [dict(link) for link in links]
        ok = self.add(span)
        return sid if ok else None

    def add_links(
        self,
        trace_id: str,
        span_id: Optional[str],
        links: Sequence[Mapping[str, Any]],
    ) -> None:
        """Append cross-trace links to a stored span (the serving batch
        job's root learns its riders only after the job is submitted, so
        links land post-``open``). No-op when the span is absent."""
        if span_id is None or not links:
            return
        with self._lock:
            span = self._traces.get(trace_id, {}).get(span_id)
            if span is None:
                return
            span.setdefault("links", []).extend(dict(link) for link in links)

    def links(self, trace_id: str, span_id: str) -> List[Dict[str, Any]]:
        """The stored links of one span (empty when absent/link-free)."""
        with self._lock:
            span = self._traces.get(trace_id, {}).get(span_id)
            return [dict(link) for link in span.get("links", [])] \
                if span else []

    def finish(
        self,
        trace_id: str,
        span_id: Optional[str],
        end_clock: float,
        attributes: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """Close an open span: duration = ``end_clock`` − its
        ``start_mono`` (same clock as :meth:`open`'s ``start_clock``)."""
        if span_id is None:
            return
        with self._lock:
            span = self._traces.get(trace_id, {}).get(span_id)
            if span is None:
                return
            span["duration_ms"] = round(
                max(0.0, float(end_clock) - float(span.get("start_mono", 0.0)))
                * 1e3, 3,
            )
            if attributes:
                span.setdefault("attributes", {}).update(attributes)

    def spans(self, trace_id: str) -> Optional[List[Dict[str, Any]]]:
        with self._lock:
            spans = self._traces.get(trace_id)
            if spans is None:
                return None
            return [dict(s) for s in spans.values()]

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def assemble(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The ``GET /v1/trace/{job_id}`` body: spans sorted by wall start,
        orphans (dangling ``parent_span_id``) flagged, completeness = one
        root + no orphans + every span closed."""
        spans = self.spans(trace_id)
        if spans is None:
            return None
        return assemble(trace_id, spans)

    def summaries(self, limit: int = 20) -> List[Dict[str, Any]]:
        """Newest-first trace listing for ``GET /v1/traces``."""
        with self._lock:
            items = [
                (tid, [dict(s) for s in spans.values()])
                for tid, spans in self._traces.items()
            ]
        out: List[Dict[str, Any]] = []
        for tid, spans in reversed(items):
            roots = [s for s in spans if s.get("parent_span_id") is None]
            root = min(
                roots, key=lambda s: s.get("start_wall", 0.0)
            ) if roots else None
            out.append({
                "trace_id": tid,
                "n_spans": len(spans),
                "root_name": root.get("name") if root else None,
                "root_duration_ms": root.get("duration_ms") if root else None,
                "complete": _complete(spans),
            })
            if len(out) >= max(1, int(limit)):
                break
        return out


def _complete(spans: Sequence[Mapping[str, Any]]) -> bool:
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if s.get("parent_span_id") is None]
    orphans = [
        s for s in spans
        if s.get("parent_span_id") is not None
        and s["parent_span_id"] not in ids
    ]
    open_spans = [s for s in spans if s.get("duration_ms") is None]
    return len(roots) == 1 and not orphans and not open_spans


# ---- assembly and exporters (pure functions of span dicts) ----

def assemble(trace_id: str, spans: Sequence[Mapping[str, Any]]) -> Dict[str, Any]:
    """The ``GET /v1/trace/{job_id}`` body the reference's store serves:
    spans sorted by wall start, roots, orphans (a dangling parent) and open
    spans listed, complete = one root, no orphan, every span closed."""
    ids = {s["span_id"] for s in spans}
    ordered = sorted((dict(s) for s in spans),
                     key=lambda s: (s.get("start_wall", 0.0), s.get("start_mono", 0.0)))
    roots = [s["span_id"] for s in ordered if s.get("parent_span_id") is None]
    orphans = [s["span_id"] for s in ordered
               if s.get("parent_span_id") is not None and s["parent_span_id"] not in ids]
    open_ids = [s["span_id"] for s in ordered if s.get("duration_ms") is None]
    return {
        "trace_id": trace_id,
        "spans": ordered,
        "root_span_id": roots[0] if len(roots) == 1 else None,
        "roots": roots,
        "orphans": orphans,
        "open_spans": open_ids,
        "complete": len(roots) == 1 and not orphans and not open_ids,
    }


def to_jsonl(spans: Iterable[Mapping[str, Any]]) -> str:
    return "".join(json.dumps(dict(s), sort_keys=True, default=str) + "\n" for s in spans)


def from_jsonl(text: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        span = json.loads(line)
        if _valid_span(span):
            out.append(span)
    return out


def to_chrome_trace(spans: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Chrome-trace / Perfetto JSON: complete ("X") events in microseconds
    on the wall clock, one pid per producing process with its
    ``process_name`` metadata event. Open spans export with ``dur=0`` and
    ``args.incomplete``."""
    pids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        proc = str(s.get("process") or "unknown")
        pid = pids.get(proc)
        if pid is None:
            pid = len(pids) + 1
            pids[proc] = pid
            events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                           "args": {"name": proc}})
        dur_ms = s.get("duration_ms")
        ev: Dict[str, Any] = {
            "ph": "X",
            "name": str(s.get("name", "?")),
            "cat": "agent-tpu",
            "ts": float(s.get("start_wall", 0.0)) * 1e6,
            "dur": max(0.0, float(dur_ms or 0.0)) * 1e3,
            "pid": pid,
            "tid": 0,
            "args": {
                "trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_span_id": s.get("parent_span_id"),
                **(s.get("attributes") or {}),
            },
        }
        if dur_ms is None:
            ev["args"]["incomplete"] = True
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(obj: Any) -> List[str]:
    """Structural check of a Chrome-trace export (what Perfetto's JSON
    importer requires); returns the problems, empty when it loads."""
    if not isinstance(obj, Mapping):
        return ["trace is not a JSON object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    problems: List[str] = []
    for i, ev in enumerate(events):
        if not isinstance(ev, Mapping):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: missing name")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"event {i}: missing int pid")
        if ph == "X":
            for key in ("ts", "dur"):
                v = ev.get(key)
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    problems.append(f"event {i}: missing numeric {key}")
                elif key == "dur" and v < 0:
                    problems.append(f"event {i}: negative dur")
    return problems


def phase_breakdown(assembled: Mapping[str, Any]) -> str:
    """One line of an assembled trace's seconds by phase."""
    spans = assembled.get("spans") or []
    totals: Dict[str, float] = {}
    order: List[str] = []
    for s in spans:
        dur = s.get("duration_ms")
        if dur is None:
            continue
        name = str(s.get("name", "?"))
        if name not in totals:
            order.append(name)
        totals[name] = totals.get(name, 0.0) + float(dur)
    root_id = assembled.get("root_span_id")
    root = next((s for s in spans if s.get("span_id") == root_id), None)
    total = (root or {}).get("duration_ms")
    parts = " | ".join(f"{name} {totals[name]:.1f}ms"
                       for name in order if name != (root or {}).get("name"))
    head = f"trace {assembled.get('trace_id')}"
    if total is not None:
        head += f": total {float(total):.1f}ms"
    return f"{head} = {parts}" if parts else head
