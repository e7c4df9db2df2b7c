"""Workflow DAG validation and expansion.

A workflow is a fan-out/fan-in graph of *stages* submitted as one unit —
e.g. tokenize -> N classify shards -> risk_accumulate -> summarize report.
This module is the pure half of the engine:

- ``parse_workflow`` validates the submit document (acyclic, known ops,
  bounded stage count and fan-out width, sane per-stage knobs) and returns
  a frozen ``WorkflowSpec``.
- ``expand_workflow`` lowers the spec into ``PlannedJob``s — ordinary
  controller jobs with *generalized* dep edges. Every planned job carries
  the job-id-level ``after`` list the controller's existing dep-gating
  already understands, so the two-party ``__collect_partials__`` special
  case (MPMD summarize, disagg prefill->decode) becomes just a DAG of
  depth 2.
- ``critical_path_lengths`` computes, per stage, the longest remaining
  path to a sink (in stages). The scheduler uses it for
  critical-path-first ordering: within a priority tier the stage with the
  most downstream work drains first, which for a linear chain degenerates
  to plain FIFO (pinned by a property test in ``tests/test_flow.py``).

The controller (``controller/core.py``) owns the stateful half: journaling
the graph, replay, the single workflow trace tree, DependencyFailed
cascades, and partition placement (whole-DAG by graph id).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_MAX_STAGES = 32
DEFAULT_MAX_WIDTH = 64

# Stage names become job-id components (``{workflow_id}-{stage}[-{i}]``) and
# trace span names; keep them to a shell/URL-safe charset.
_STAGE_NAME_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")


class DagError(ValueError):
    """Invalid workflow document — maps to HTTP 400 at the front door."""


@dataclass(frozen=True)
class StageSpec:
    """One validated stage of a workflow graph."""

    name: str
    op: str
    payload: Dict[str, Any] = field(default_factory=dict)
    after: Tuple[str, ...] = ()
    fan_out: int = 1
    priority: Optional[int] = None       # None -> workflow default
    required_labels: Dict[str, Any] = field(default_factory=dict)
    max_attempts: Optional[int] = None   # None -> controller default
    # Deliver upstream results as ``payload["partials"]`` at lease time
    # (the generalized ``__collect_partials__`` contract). On by default
    # for dependent stages; a stage that only wants ordering can opt out.
    collect: bool = True


@dataclass(frozen=True)
class WorkflowSpec:
    """A validated, acyclic workflow graph."""

    stages: Tuple[StageSpec, ...]

    def by_name(self) -> Dict[str, StageSpec]:
        return {s.name: s for s in self.stages}


@dataclass(frozen=True)
class PlannedJob:
    """One expanded stage instance — an ordinary controller job to be."""

    job_id: str
    stage: str
    op: str
    payload: Dict[str, Any]
    after: Tuple[str, ...]          # upstream JOB ids (not stage names)
    priority: int
    critical_path: int              # longest remaining path, in stages
    required_labels: Dict[str, Any]
    max_attempts: Optional[int]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise DagError(msg)


def parse_workflow(
    doc: Any,
    known_ops: Sequence[str],
    max_stages: int = DEFAULT_MAX_STAGES,
    max_width: int = DEFAULT_MAX_WIDTH,
) -> WorkflowSpec:
    """Validate a submit document -> ``WorkflowSpec``; raise ``DagError``."""
    _require(isinstance(doc, dict), "workflow must be an object")
    raw_stages = doc.get("stages")
    _require(
        isinstance(raw_stages, list) and len(raw_stages) > 0,
        "workflow.stages must be a non-empty list",
    )
    _require(
        len(raw_stages) <= max_stages,
        f"workflow has {len(raw_stages)} stages; limit is {max_stages} "
        "(FLOW_MAX_STAGES)",
    )
    ops = set(known_ops)
    names: set = set()
    stages: List[StageSpec] = []
    for i, raw in enumerate(raw_stages):
        _require(isinstance(raw, dict), f"stage[{i}] must be an object")
        name = raw.get("name")
        _require(
            isinstance(name, str) and bool(_STAGE_NAME_RE.match(name)),
            f"stage[{i}].name must match {_STAGE_NAME_RE.pattern}",
        )
        _require(name not in names, f"duplicate stage name {name!r}")
        names.add(name)
        op = raw.get("op")
        _require(isinstance(op, str) and op != "", f"stage {name!r}: op required")
        _require(
            op in ops,
            f"stage {name!r}: unknown op {op!r}; known ops: {sorted(ops)}",
        )
        payload = raw.get("payload", {})
        _require(
            isinstance(payload, dict), f"stage {name!r}: payload must be an object"
        )
        after_raw = raw.get("after", [])
        _require(
            isinstance(after_raw, (list, tuple))
            and all(isinstance(a, str) for a in after_raw),
            f"stage {name!r}: after must be a list of stage names",
        )
        _require(
            len(set(after_raw)) == len(after_raw),
            f"stage {name!r}: duplicate entries in after",
        )
        fan_out = raw.get("fan_out", 1)
        _require(
            isinstance(fan_out, int) and not isinstance(fan_out, bool)
            and 1 <= fan_out <= max_width,
            f"stage {name!r}: fan_out must be an int in [1, {max_width}] "
            "(FLOW_MAX_WIDTH)",
        )
        priority = raw.get("priority")
        if priority is not None:
            _require(
                isinstance(priority, int) and not isinstance(priority, bool)
                and 0 <= priority <= 9,
                f"stage {name!r}: priority must be an int in [0, 9]",
            )
        labels = raw.get("required_labels", {})
        _require(
            isinstance(labels, dict)
            and all(
                isinstance(v, (str, int, float, bool)) for v in labels.values()
            ),
            f"stage {name!r}: required_labels must map to scalars",
        )
        max_attempts = raw.get("max_attempts")
        if max_attempts is not None:
            _require(
                isinstance(max_attempts, int) and not isinstance(max_attempts, bool)
                and max_attempts >= 1,
                f"stage {name!r}: max_attempts must be an int >= 1",
            )
        collect = raw.get("collect", True)
        _require(
            isinstance(collect, bool), f"stage {name!r}: collect must be a bool"
        )
        stages.append(
            StageSpec(
                name=name,
                op=op,
                payload=dict(payload),
                after=tuple(after_raw),
                fan_out=fan_out,
                priority=priority,
                required_labels=dict(labels),
                max_attempts=max_attempts,
                collect=collect,
            )
        )
    for st in stages:
        for dep in st.after:
            _require(
                dep in names, f"stage {st.name!r}: after references unknown "
                f"stage {dep!r}"
            )
            _require(dep != st.name, f"stage {st.name!r} depends on itself")
    spec = WorkflowSpec(stages=tuple(stages))
    toposort_stages(spec)  # raises DagError on cycles
    return spec


def toposort_stages(spec: WorkflowSpec) -> List[str]:
    """Kahn's algorithm over stage names; raise ``DagError`` on a cycle.

    Ties resolve in declaration order so expansion is deterministic."""
    indeg: Dict[str, int] = {s.name: len(s.after) for s in spec.stages}
    dependents: Dict[str, List[str]] = {s.name: [] for s in spec.stages}
    for s in spec.stages:
        for dep in s.after:
            dependents[dep].append(s.name)
    order: List[str] = []
    ready = [s.name for s in spec.stages if indeg[s.name] == 0]
    while ready:
        name = ready.pop(0)
        order.append(name)
        for d in dependents[name]:
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    if len(order) != len(spec.stages):
        cyclic = sorted(n for n, d in indeg.items() if d > 0)
        raise DagError(f"workflow graph has a cycle through stages {cyclic}")
    return order


def critical_path_lengths(spec: WorkflowSpec) -> Dict[str, int]:
    """Stage -> longest remaining path to a sink, counted in stages.

    A sink stage scores 1; each upstream stage scores 1 + the max over its
    dependents. For a linear chain of k stages the values are k..1 — i.e.
    strictly decreasing along submit order, so critical-path-first ordering
    equals plain FIFO there (the property test's invariant)."""
    dependents: Dict[str, List[str]] = {s.name: [] for s in spec.stages}
    for s in spec.stages:
        for dep in s.after:
            dependents[dep].append(s.name)
    cp: Dict[str, int] = {}
    for name in reversed(toposort_stages(spec)):
        downstream = [cp[d] for d in dependents[name]]
        cp[name] = 1 + (max(downstream) if downstream else 0)
    return cp


def stage_job_ids(workflow_id: str, stage: StageSpec) -> List[str]:
    """Deterministic job ids for a stage's instances (replay-stable)."""
    if stage.fan_out == 1:
        return [f"{workflow_id}-{stage.name}"]
    return [f"{workflow_id}-{stage.name}-{i}" for i in range(stage.fan_out)]


def expand_workflow(
    spec: WorkflowSpec,
    workflow_id: str,
    default_priority: int = 5,
) -> List[PlannedJob]:
    """Lower a validated spec into per-instance ``PlannedJob``s.

    Fan-in semantics: every instance of a dependent stage waits on EVERY
    instance of each upstream stage (``after`` lists all upstream job ids,
    in stage-declaration then shard order — the order ``partials`` will be
    materialized in at lease time). Fan-out instances get
    ``fan_index``/``fan_out`` stamped into their payload so ops can shard
    deterministically."""
    by_name = spec.by_name()
    ids: Dict[str, List[str]] = {
        s.name: stage_job_ids(workflow_id, s) for s in spec.stages
    }
    cp = critical_path_lengths(spec)
    planned: List[PlannedJob] = []
    for name in toposort_stages(spec):
        st = by_name[name]
        upstream: List[str] = []
        for dep in st.after:
            upstream.extend(ids[dep])
        for i, job_id in enumerate(ids[name]):
            payload = dict(st.payload)
            if st.fan_out > 1:
                payload["fan_index"] = i
                payload["fan_out"] = st.fan_out
            if upstream and st.collect:
                payload["__collect_partials__"] = True
            planned.append(
                PlannedJob(
                    job_id=job_id,
                    stage=name,
                    op=st.op,
                    payload=payload,
                    after=tuple(upstream),
                    priority=st.priority if st.priority is not None
                    else default_priority,
                    critical_path=cp[name],
                    required_labels=dict(st.required_labels),
                    max_attempts=st.max_attempts,
                )
            )
    return planned


def graph_doc(spec: WorkflowSpec) -> Dict[str, Any]:
    """JSON-able graph document — journaled with the workflow so replay,
    standby promotion, and ``GET /v1/workflows/{id}`` all see the same
    structure the submitter sent (post-validation)."""
    return {
        "stages": [
            {
                "name": s.name,
                "op": s.op,
                "payload": s.payload,
                "after": list(s.after),
                "fan_out": s.fan_out,
                "priority": s.priority,
                "required_labels": s.required_labels,
                "max_attempts": s.max_attempts,
                "collect": s.collect,
            }
            for s in spec.stages
        ]
    }


def spec_from_graph_doc(doc: Dict[str, Any]) -> WorkflowSpec:
    """Rebuild a spec from a journaled ``graph_doc`` (trusted — already
    validated at submit time; replay must not re-reject it if limits
    tightened between restarts)."""
    stages = tuple(
        StageSpec(
            name=raw["name"],
            op=raw["op"],
            payload=dict(raw.get("payload", {})),
            after=tuple(raw.get("after", ())),
            fan_out=int(raw.get("fan_out", 1)),
            priority=raw.get("priority"),
            required_labels=dict(raw.get("required_labels", {})),
            max_attempts=raw.get("max_attempts"),
            collect=bool(raw.get("collect", True)),
        )
        for raw in doc.get("stages", [])
    )
    return WorkflowSpec(stages=stages)
