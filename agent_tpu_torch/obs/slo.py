"""SLO engine: declarative objectives, sliding windows, burn-rate alerts.

The judgment layer over the metric/trace firehose: counters and causal
traces record what happened, but nothing else *evaluates* them against an
objective. This module turns submit→apply latencies and
success/failure outcomes into:

- **attainment** — the fraction of requests meeting each latency/availability
  target over a sliding window;
- **error-budget burn rate** — Google-SRE style: the rate at which the
  objective's error budget (``1 - target``) is being consumed, measured over
  a short (default 5m) and a long (default 1h) window;
- **alert states** — ``ok | warn | page`` via multi-window thresholds with
  hysteresis (a level is entered when BOTH windows exceed its threshold and
  only exits once the short-window burn falls below ``exit_frac`` of the
  entry threshold, so a burn oscillating around the line cannot flap the
  pager).

Objectives are declarative and env/JSON-configured
(``SLO_SPEC='[{"tier":8,"p99_ms":250,"availability":0.999}]'``), keyed by
any subset of ``{tier, tenant, op}`` — an absent key matches everything.
``tier`` is the scheduler's priority tier, so "the interactive
class" is simply ``{"tier": 8}``.

Design notes:

- **Sliding multi-window histogram.** Each objective owns a ring of
  time-bucketed cells (cell width = ``window_short / 5``); a cell carries
  fixed-bucket latency counts (the same ``DEFAULT_BUCKETS`` the metrics
  histograms use), exact over-threshold counts per latency target, and an
  error count. Window reads merge whole cells, so a "5m window" is accurate
  to one cell width — the documented granularity, the price of O(1) memory.
- **Observation is O(objectives).** One ``observe`` per terminal job: match
  each objective, bump a handful of ints. No allocation on the hot path
  beyond the once-per-cell rollover.
- **Injectable clock.** The tracker runs on the controller's monotonic
  clock so tests (and the CI smoke) drive window rollover deterministically.
- **No env reads here.** ``SLO_ENABLED`` gating lives in the controller
  (``config.SloConfig``); a tracker that exists is always on.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from agent_tpu_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    MetricsRegistry,
    histogram_quantile,
)

# Alert severity order (gauge encoding: slo_alert_state value).
STATES = ("ok", "warn", "page")
_RANK = {s: i for i, s in enumerate(STATES)}

# The built-in objectives when SLO_SPEC is unset: judge the interactive
# priority tier on tail latency and
# availability, plus the serving path's time-to-first-token
# (``metric: "ttft"``, fed by the controller's /v1/infer completion
# fan-out; nothing else observes that metric, so the objective idles on
# batch-only deployments). Deliberately generous (1s p99 latency, 2.5s
# p99 TTFT) — a default must not page a healthy bulk-oriented deployment;
# operators tighten it per deployment.
DEFAULT_SLO_SPEC = (
    '[{"name": "interactive", "tier": 8, "p99_ms": 1000, '
    '"availability": 0.999},'
    ' {"name": "interactive_ttft", "tier": 8, "metric": "ttft", '
    '"p99_ms": 2500, "availability": 0.999}]'
)

# Observation streams an objective may judge: submit→apply latency (the
# default every terminal job feeds) or serving time-to-first-token.
METRICS = ("latency", "ttft")

# Latency percentile keys the spec may carry: "p50_ms" → quantile 0.50.
_PCTL_KEYS = (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99))


@dataclass(frozen=True)
class Objective:
    """One declarative objective. Selector fields (``tier``/``tenant``/
    ``op``) are exact-match filters; None matches everything. Targets:
    ``pXX_ms`` ("XX% of matching requests complete within T ms") and
    ``availability`` ("this fraction must succeed")."""

    name: str
    tier: Optional[int] = None
    tenant: Optional[str] = None
    op: Optional[str] = None
    p50_ms: Optional[float] = None
    p95_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    availability: Optional[float] = None
    # Which observation stream this objective judges: "latency"
    # (submit→apply, the historical stream) or "ttft" (serving
    # time-to-first-token). An objective only sees observations of its own
    # metric — a TTFT target never judges batch-job latencies.
    metric: str = "latency"

    def matches(
        self, tier: Any, tenant: Any, op: Any, metric: str = "latency"
    ) -> bool:
        if self.metric != metric:
            return False
        if self.tier is not None and tier != self.tier:
            return False
        if self.tenant is not None and tenant != self.tenant:
            return False
        if self.op is not None and op != self.op:
            return False
        return True

    def latency_targets(self) -> List[Tuple[str, float, float]]:
        """``[(key, budget_fraction, threshold_seconds), ...]`` — a p99
        target means at most 1% of requests may exceed the threshold, so
        its error budget is 0.01."""
        out = []
        for key, q in _PCTL_KEYS:
            t_ms = getattr(self, key)
            if t_ms is not None:
                out.append((key, 1.0 - q, float(t_ms) / 1e3))
        return out

    def selector(self) -> Dict[str, Any]:
        return {
            k: v
            for k, v in (
                ("tier", self.tier), ("tenant", self.tenant), ("op", self.op)
            )
            if v is not None
        }


def parse_slo_spec(raw: Optional[str]) -> List[Objective]:
    """``SLO_SPEC`` JSON → objectives. Empty/None → the built-in default.
    Malformed specs raise ValueError at parse time (controller boot) — a
    typo'd objective silently judging nothing is the failure mode this
    refuses."""
    text = (raw or "").strip() or DEFAULT_SLO_SPEC
    try:
        entries = json.loads(text)
    except ValueError as exc:
        raise ValueError(f"SLO_SPEC is not valid JSON: {exc}") from exc
    if not isinstance(entries, list):
        raise ValueError("SLO_SPEC must be a JSON list of objectives")
    out: List[Objective] = []
    seen = set()
    for i, e in enumerate(entries):
        if not isinstance(e, Mapping):
            raise ValueError(f"SLO_SPEC[{i}] must be an object, got {e!r}")
        unknown = set(e) - {
            "name", "tier", "tenant", "op", "metric",
            "p50_ms", "p95_ms", "p99_ms", "availability",
        }
        if unknown:
            raise ValueError(f"SLO_SPEC[{i}]: unknown keys {sorted(unknown)}")
        metric = e.get("metric", "latency")
        if metric not in METRICS:
            raise ValueError(
                f"SLO_SPEC[{i}]: metric must be one of {METRICS}, "
                f"got {metric!r}"
            )
        tier = e.get("tier")
        if tier is not None and (
            isinstance(tier, bool) or not isinstance(tier, int)
        ):
            raise ValueError(f"SLO_SPEC[{i}]: tier must be an int")
        for key in ("p50_ms", "p95_ms", "p99_ms"):
            v = e.get(key)
            if v is not None and (
                isinstance(v, bool)
                or not isinstance(v, (int, float)) or v <= 0
            ):
                raise ValueError(f"SLO_SPEC[{i}]: {key} must be > 0")
        avail = e.get("availability")
        if avail is not None and (
            isinstance(avail, bool)
            or not isinstance(avail, (int, float))
            or not 0.0 < avail < 1.0
        ):
            raise ValueError(
                f"SLO_SPEC[{i}]: availability must be in (0, 1)"
            )
        if avail is None and not any(
            e.get(k) is not None for k, _q in _PCTL_KEYS
        ):
            raise ValueError(
                f"SLO_SPEC[{i}]: needs at least one target "
                "(pXX_ms or availability)"
            )
        name = e.get("name")
        if name is None:
            sel = "_".join(
                f"{k}{e[k]}" for k in ("tier", "tenant", "op")
                if e.get(k) is not None
            )
            name = sel or f"objective{i}"
        name = str(name)
        if name in seen:
            raise ValueError(f"SLO_SPEC[{i}]: duplicate objective name {name!r}")
        seen.add(name)
        out.append(Objective(
            name=name,
            tier=tier,
            tenant=str(e["tenant"]) if e.get("tenant") is not None else None,
            op=str(e["op"]) if e.get("op") is not None else None,
            p50_ms=e.get("p50_ms"),
            p95_ms=e.get("p95_ms"),
            p99_ms=e.get("p99_ms"),
            availability=avail,
            metric=str(metric),
        ))
    return out


class _Cell:
    """One time cell of the sliding window: fixed-bucket latency counts plus
    exact per-target breach counts (bucket edges rarely align with a target
    threshold, so breaches are counted at observe time, not re-derived)."""

    __slots__ = ("bin", "counts", "total", "sum", "errors", "slow")

    def __init__(self, bin_index: int, n_targets: int, n_buckets: int) -> None:
        self.bin = bin_index
        self.counts = [0] * (n_buckets + 1)  # +Inf overflow slot
        self.total = 0
        self.sum = 0.0
        self.errors = 0
        self.slow = [0] * n_targets


class _ObjectiveWindow:
    """Ring of cells for one objective. Cell width = short_window / 5 (the
    SRE convention: a window sees ≥ 5 cells, so a read is accurate to 20%
    of the short window); ring length covers the long window."""

    def __init__(
        self,
        objective: Objective,
        short_sec: float,
        long_sec: float,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        self.objective = objective
        self.buckets = tuple(float(b) for b in buckets)
        self.cell_sec = max(short_sec / 5.0, 1e-6)
        self.n_cells = int(long_sec / self.cell_sec) + 1
        self.targets = objective.latency_targets()
        self._cells: "collections.deque[_Cell]" = collections.deque(
            maxlen=self.n_cells
        )
        self.state = "ok"
        self.state_since: Optional[float] = None

    def observe(self, latency_s: float, ok: bool, now: float) -> None:
        bin_index = int(now / self.cell_sec)
        cell = self._cells[-1] if self._cells else None
        if cell is None or cell.bin != bin_index:
            cell = _Cell(bin_index, len(self.targets), len(self.buckets))
            self._cells.append(cell)
        v = float(latency_s)
        i = len(self.buckets)
        for j, bound in enumerate(self.buckets):
            if v <= bound:
                i = j
                break
        cell.counts[i] += 1
        cell.total += 1
        cell.sum += v
        if not ok:
            cell.errors += 1
        for t, (_key, _budget, threshold) in enumerate(self.targets):
            if v > threshold:
                cell.slow[t] += 1

    def window(self, seconds: float, now: float) -> Dict[str, Any]:
        """Merged view of the cells inside ``[now - seconds, now]`` (whole
        cells — accuracy is one cell width)."""
        min_bin = int((now - seconds) / self.cell_sec)
        counts = [0] * (len(self.buckets) + 1)
        total = 0
        total_sum = 0.0
        errors = 0
        slow = [0] * len(self.targets)
        for cell in self._cells:
            if cell.bin < min_bin:
                continue
            for i, c in enumerate(cell.counts):
                counts[i] += c
            total += cell.total
            total_sum += cell.sum
            errors += cell.errors
            for t, s in enumerate(cell.slow):
                slow[t] += s
        return {
            "counts": counts, "total": total, "sum": total_sum,
            "errors": errors, "slow": slow,
        }


def _window_stats(
    ow: _ObjectiveWindow, w: Dict[str, Any]
) -> Dict[str, Any]:
    """Burn rate / attainment / quantiles for one merged window view.

    Burn rate per target = (bad fraction) / (error budget); the objective's
    burn is the max across targets — the binding constraint pages first.
    """
    total = w["total"]
    obj = ow.objective
    out: Dict[str, Any] = {
        "requests": total,
        "burn_rate": 0.0,
        "attainment": None,
        "targets": {},
    }
    if total <= 0:
        return out
    burn = 0.0
    attain = 1.0
    for t, (key, budget, threshold) in enumerate(ow.targets):
        bad_frac = w["slow"][t] / total
        target_burn = bad_frac / budget if budget > 0 else 0.0
        burn = max(burn, target_burn)
        attained = 1.0 - bad_frac
        attain = min(attain, attained)
        out["targets"][key] = {
            "threshold_ms": round(threshold * 1e3, 3),
            "attained": round(attained, 6),
            "target": round(1.0 - budget, 6),
            "burn_rate": round(target_burn, 4),
        }
    if obj.availability is not None:
        budget = 1.0 - obj.availability
        bad_frac = w["errors"] / total
        target_burn = bad_frac / budget if budget > 0 else 0.0
        burn = max(burn, target_burn)
        attained = 1.0 - bad_frac
        attain = min(attain, attained)
        out["targets"]["availability"] = {
            "attained": round(attained, 6),
            "target": round(obj.availability, 6),
            "burn_rate": round(target_burn, 4),
        }
    out["burn_rate"] = round(burn, 4)
    out["attainment"] = round(attain, 6)
    for q, label in ((0.5, "p50_ms"), (0.99, "p99_ms")):
        est = histogram_quantile(ow.buckets, w["counts"], q)
        out[label] = round(est * 1e3, 3) if est is not None else None
    return out


class SloTracker:
    """Per-objective sliding windows + the burn-rate alert state machine.

    ``on_alert(result_dict, old_state, new_state)`` fires on every state
    transition (under the tracker lock held briefly; callers must not call
    back into the tracker from it). The controller uses it for recorder
    events and the page-entry flight-recorder auto-dump.
    """

    def __init__(
        self,
        objectives: Sequence[Objective],
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = None,
        window_short_sec: float = 300.0,
        window_long_sec: float = 3600.0,
        burn_warn: float = 3.0,
        burn_page: float = 10.0,
        burn_exit_frac: float = 0.5,
        on_alert: Optional[Callable[..., None]] = None,
    ) -> None:
        self.objectives = list(objectives)
        self.window_short_sec = float(window_short_sec)
        self.window_long_sec = max(float(window_long_sec), self.window_short_sec)
        self.burn_warn = float(burn_warn)
        self.burn_page = max(float(burn_page), self.burn_warn)
        self.burn_exit_frac = min(1.0, max(0.0, float(burn_exit_frac)))
        self.on_alert = on_alert
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._windows = [
            _ObjectiveWindow(
                o, self.window_short_sec, self.window_long_sec
            )
            for o in self.objectives
        ]
        self._last_eval: Optional[List[Dict[str, Any]]] = None
        self._last_eval_at = float("-inf")
        self._m_attain = self._m_burn = self._m_budget = None
        self._m_state = self._m_transitions = None
        if registry is not None:
            self._m_attain = registry.gauge(
                "slo_attainment",
                "Fraction of requests meeting the objective's binding "
                "target, per sliding window", ("objective", "window"))
            self._m_burn = registry.gauge(
                "slo_burn_rate",
                "Error-budget burn rate (1.0 = budget consumed exactly at "
                "the window's pace)", ("objective", "window"))
            self._m_budget = registry.gauge(
                "slo_error_budget_remaining",
                "Error budget left over the long window (1 = untouched, "
                "0 = exhausted)", ("objective",))
            self._m_state = registry.gauge(
                "slo_alert_state",
                "Burn-rate alert state (0=ok, 1=warn, 2=page)",
                ("objective",))
            self._m_transitions = registry.counter(
                "slo_alert_transitions_total",
                "Alert state transitions by entered state",
                ("objective", "state"))

    # ---- feed ----

    def observe(
        self,
        latency_s: float,
        ok: bool,
        tier: Any = None,
        tenant: Any = None,
        op: Any = None,
        now: Optional[float] = None,
        metric: str = "latency",
    ) -> None:
        """Record one completed request against every matching objective.
        O(objectives); a handful of integer bumps per match. ``metric``
        routes the observation stream — submit→apply latencies feed the
        default ``latency`` objectives, serving TTFT samples feed
        ``metric: "ttft"`` ones, never each other."""
        if now is None:
            now = self._clock()
        with self._lock:
            for ow in self._windows:
                if ow.objective.matches(tier, tenant, op, metric=metric):
                    ow.observe(latency_s, ok, now)

    # ---- judgment ----

    def _next_state(self, cur: str, burn_s: float, burn_l: float) -> str:
        """Multi-window thresholds with hysteresis: enter a level when BOTH
        windows burn above it; hold the current level until the short burn
        falls below ``exit_frac`` of its entry threshold (the short window
        recovers first, so recovery is prompt but not flappy)."""
        if burn_s >= self.burn_page and burn_l >= self.burn_page:
            target = "page"
        elif burn_s >= self.burn_warn and burn_l >= self.burn_warn:
            target = "warn"
        else:
            target = "ok"
        if _RANK[target] >= _RANK[cur]:
            return target
        exit_thr = (
            self.burn_page if cur == "page" else self.burn_warn
        ) * self.burn_exit_frac
        if burn_s >= exit_thr:
            return cur  # hysteresis hold
        return target

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Judge every objective now: window stats, burn rates, alert state
        (advancing the state machine), gauges. Returns one dict per
        objective — the ``slo.objectives`` block of ``GET /v1/health``."""
        if now is None:
            now = self._clock()
        results: List[Dict[str, Any]] = []
        transitions: List[Tuple[Dict[str, Any], str, str]] = []
        with self._lock:
            for ow in self._windows:
                short = _window_stats(
                    ow, ow.window(self.window_short_sec, now)
                )
                long = _window_stats(ow, ow.window(self.window_long_sec, now))
                old = ow.state
                new = self._next_state(
                    old, short["burn_rate"], long["burn_rate"]
                )
                if new != old:
                    ow.state = new
                    ow.state_since = now
                budget_left = max(0.0, 1.0 - long["burn_rate"])
                result = {
                    "objective": ow.objective.name,
                    **ow.objective.selector(),
                    "state": ow.state,
                    "windows": {"short": short, "long": long},
                    "attainment": short["attainment"],
                    "burn_rate_short": short["burn_rate"],
                    "burn_rate_long": long["burn_rate"],
                    "error_budget_remaining": round(budget_left, 6),
                }
                results.append(result)
                if new != old:
                    transitions.append((result, old, new))
                name = ow.objective.name
                if self._m_state is not None:
                    for win, stats in (("short", short), ("long", long)):
                        if stats["attainment"] is not None:
                            self._m_attain.set(
                                stats["attainment"],
                                objective=name, window=win,
                            )
                        self._m_burn.set(
                            stats["burn_rate"], objective=name, window=win
                        )
                    self._m_budget.set(budget_left, objective=name)
                    self._m_state.set(_RANK[ow.state], objective=name)
            self._last_eval = results
            self._last_eval_at = now
        for result, old, new in transitions:
            if self._m_transitions is not None:
                self._m_transitions.inc(
                    objective=result["objective"], state=new
                )
            if self.on_alert is not None:
                self.on_alert(result, old, new)
        return results

    def maybe_evaluate(
        self, now: Optional[float] = None, min_interval_sec: float = 1.0
    ) -> List[Dict[str, Any]]:
        """Rate-limited :meth:`evaluate` for hot paths (the lease handler):
        reuses the last judgment when it is younger than
        ``min_interval_sec``, bounding SLO cost per lease to a dict read."""
        if now is None:
            now = self._clock()
        with self._lock:
            fresh = (
                self._last_eval is not None
                and now - self._last_eval_at < min_interval_sec
            )
            if fresh:
                return self._last_eval
        return self.evaluate(now)

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {w.objective.name: w.state for w in self._windows}

    def active_alerts(self, min_state: str = "warn") -> List[Dict[str, Any]]:
        """Objectives currently at or above ``min_state`` (from the LAST
        evaluation — call ``maybe_evaluate`` first), as the compact shape
        the lease response piggybacks (``{objective, state, tier?, op?,
        tenant?}``) so agents can react (page-entry flight-recorder dump)."""
        rank = _RANK[min_state]
        with self._lock:
            out = []
            for ow in self._windows:
                if _RANK[ow.state] >= rank:
                    out.append({
                        "objective": ow.objective.name,
                        "state": ow.state,
                        **ow.objective.selector(),
                    })
            return out
