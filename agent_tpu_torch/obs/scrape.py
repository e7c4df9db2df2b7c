"""Scrape-side helpers: read ``GET /v1/metrics`` and ``/v1/trace`` back.

``bench.py`` and ``scripts/drain_at_scale.py`` attribute drain time per op
by scraping the controller's exposition instead of re-deriving spans from
result bodies (``utils/spans.py`` stays as the fallback when scraping is
unavailable — e.g. a controller predating the endpoint), and fetch the
slowest job's assembled trace for a per-phase breakdown line. Stdlib-only, like the rest of ``agent_tpu_torch.obs``.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Dict, Iterable, Optional

from agent_tpu_torch.obs.metrics import parse_exposition


def fetch_metrics_text(
    base_url: str, timeout: float = 10.0
) -> Optional[str]:
    """GET ``<base_url>/v1/metrics`` → exposition text, or None on any
    failure (callers fall back to result-body spans)."""
    url = base_url.rstrip("/") + "/v1/metrics"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            if resp.status != 200:
                return None
            return resp.read().decode("utf-8", errors="replace")
    except Exception:  # noqa: BLE001 — scrape is best-effort by contract
        return None


def op_phase_seconds(
    text: str,
    ops: Iterable[str],
    phases: Iterable[str] = ("execute", "fetch"),
) -> Dict[str, float]:
    """Sum ``task_phase_seconds_sum{op,phase}`` over ``phases`` per op —
    the scraped equivalent of ``utils.spans.op_span_ms`` (which sums
    ``device_ms + fetch_ms``; the execute phase is the device-dispatch
    span). Series carrying an ``agent`` label and the fleet-merged ones
    would double-count if both were summed; only unlabeled (fleet/merged)
    series count."""
    phases = set(phases)
    out = {op: 0.0 for op in ops}
    try:
        samples = parse_exposition(text)
    except ValueError:
        return out
    for labels, value in samples.get("task_phase_seconds_sum", []):
        if "agent" in labels:
            continue
        op = labels.get("op")
        if op in out and labels.get("phase") in phases:
            out[op] += value
    return out


def fetch_health(
    base_url: str, timeout: float = 10.0
) -> Optional[Dict[str, Any]]:
    """``GET /v1/health`` → the fleet verdict body, or None on
    any failure. Callers that promised health reporting (bench,
    drain_at_scale) must fail loudly on None instead of omitting the
    fields silently."""
    out = fetch_json(base_url, "/v1/health", timeout=timeout)
    return out if isinstance(out, dict) else None


# ---- trace endpoints ----

def fetch_json(
    base_url: str, path: str, timeout: float = 10.0
) -> Optional[Any]:
    """GET ``<base_url><path>`` → parsed JSON, or None on any failure."""
    url = base_url.rstrip("/") + path
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            if resp.status != 200:
                return None
            return json.loads(resp.read().decode("utf-8", errors="replace"))
    except Exception:  # noqa: BLE001 — scrape is best-effort by contract
        return None


def fetch_trace(
    base_url: str, job_id: str, timeout: float = 10.0
) -> Optional[Dict[str, Any]]:
    """``GET /v1/trace/{job_id}`` → the assembled span tree, or None."""
    out = fetch_json(base_url, f"/v1/trace/{job_id}", timeout=timeout)
    return out if isinstance(out, dict) else None


def slowest_trace(
    base_url: str, limit: int = 64, timeout: float = 10.0
) -> Optional[Dict[str, Any]]:
    """The assembled trace of the slowest job in the controller's trace
    window (largest closed root duration) — what the bench/drain scripts
    print a phase-breakdown line for. None when the trace path is down."""
    listing = fetch_json(base_url, f"/v1/traces?limit={int(limit)}",
                         timeout=timeout)
    if not isinstance(listing, dict):
        return None
    candidates = [
        t for t in listing.get("traces", [])
        if isinstance(t, dict)
        and isinstance(t.get("root_duration_ms"), (int, float))
    ]
    if not candidates:
        return None
    worst = max(candidates, key=lambda t: t["root_duration_ms"])
    return fetch_trace(base_url, worst["trace_id"], timeout=timeout)


# ---- stage/execute overlap ----

def _merge_intervals(ivals):
    """Sorted-union of (t0, t1) wall intervals."""
    merged = []
    for t0, t1 in sorted(ivals):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return merged


def _overlap_seconds(ival, merged):
    t0, t1 = ival
    total = 0.0
    for m0, m1 in merged:
        lo, hi = max(t0, m0), min(t1, m1)
        if hi > lo:
            total += hi - lo
        if m0 >= t1:
            break
    return total


def overlap_from_spans(spans) -> Optional[Dict[str, Any]]:
    """Cross-job stage/execute concurrency from assembled trace spans: the
    fraction of stage wall time hidden under SOME execute span (across
    jobs — pipelining hides job B's staging behind job A's execute), plus
    per-phase p50s. The acceptance picture of the staging pool: overlap →
    1.0 and stage p50 ≤ execute p50 mean staging is invisible behind the
    device. None when no closed stage/execute spans exist."""
    stage, execute = [], []
    for span in spans:
        if not isinstance(span, dict):
            continue
        dur = span.get("duration_ms")
        start = span.get("start_wall")
        if not isinstance(dur, (int, float)) or \
                not isinstance(start, (int, float)):
            continue
        ival = (float(start), float(start) + float(dur) / 1e3)
        if span.get("name") == "stage":
            stage.append(ival)
        elif span.get("name") == "execute":
            execute.append(ival)
    if not stage or not execute:
        return None
    merged = _merge_intervals(execute)
    stage_total = sum(t1 - t0 for t0, t1 in stage)
    hidden = sum(_overlap_seconds(iv, merged) for iv in stage)

    def p50_ms(ivals):
        durs = sorted((t1 - t0) * 1e3 for t0, t1 in ivals)
        return durs[len(durs) // 2]

    return {
        "overlap_ratio": round(hidden / stage_total, 4) if stage_total else 1.0,
        "stage_total_s": round(stage_total, 3),
        "execute_total_s": round(
            sum(t1 - t0 for t0, t1 in execute), 3
        ),
        "stage_p50_ms": round(p50_ms(stage), 3),
        "execute_p50_ms": round(p50_ms(execute), 3),
        "n_stage_spans": len(stage),
        "n_execute_spans": len(execute),
    }


def collect_trace_spans(
    base_url: str, limit: int = 64, timeout: float = 10.0
) -> Optional[list]:
    """Every span of the controller's newest ``limit`` traces
    (``/v1/traces`` + per-job ``/v1/trace/{id}``), or None when the trace
    path is down."""
    listing = fetch_json(base_url, f"/v1/traces?limit={int(limit)}",
                         timeout=timeout)
    if not isinstance(listing, dict):
        return None
    spans: list = []
    for entry in listing.get("traces", []):
        if not isinstance(entry, dict) or not entry.get("trace_id"):
            continue
        assembled = fetch_trace(base_url, entry["trace_id"], timeout=timeout)
        if assembled:
            spans.extend(assembled.get("spans", []))
    return spans


def stage_execute_overlap(
    base_url: str, limit: int = 64, timeout: float = 10.0
) -> Optional[Dict[str, Any]]:
    """:func:`overlap_from_spans` over the controller's newest ``limit``
    traces. None when the trace path is down or no stage/execute spans
    assembled — callers that promised the breakdown (drain_at_scale) must
    fail loudly on None."""
    spans = collect_trace_spans(base_url, limit=limit, timeout=timeout)
    if spans is None:
        return None
    return overlap_from_spans(spans)


def overlap_by_process(spans) -> Dict[str, Dict[str, Any]]:
    """Per-AGENT stage/execute overlap: spans grouped by their
    emitting process (``"agent:<name>"``), each group fed through
    :func:`overlap_from_spans` — the fleet-drain attribution that tells a
    well-overlapped member from one whose staging starves its device.
    Controller spans (``process == "controller"``) carry no stage/execute
    phases and are skipped. ``{agent_name: overlap_dict}``; agents with no
    closed stage+execute pair are absent."""
    groups: Dict[str, list] = {}
    for span in spans or []:
        if not isinstance(span, dict):
            continue
        proc = span.get("process")
        if isinstance(proc, str) and proc.startswith("agent:"):
            groups.setdefault(proc[len("agent:"):], []).append(span)
    out: Dict[str, Dict[str, Any]] = {}
    for name, group in groups.items():
        overlap = overlap_from_spans(group)
        if overlap is not None:
            out[name] = overlap
    return out


def stage_execute_overlap_by_agent(
    base_url: str, limit: int = 64, timeout: float = 10.0
) -> Optional[Dict[str, Dict[str, Any]]]:
    """:func:`overlap_by_process` over the controller's newest ``limit``
    traces; None when the trace path is down."""
    spans = collect_trace_spans(base_url, limit=limit, timeout=timeout)
    if spans is None:
        return None
    return overlap_by_process(spans)
