"""Dependency-free metrics: counters, gauges and fixed-bucket histograms —
the port of ``agent_tpu.obs.metrics``.

The agent owns a ``MetricsRegistry`` (thread-safe, label-aware); its
``snapshot()`` is a plain JSON-able dict that rides every lease's
``metrics`` channel, in the reference's snapshot shape, where the
reference's controller merges it into the fleet view. Histograms carry their
bucket bounds in the snapshot. The staging pool's
autotuner reads ``task_phase_seconds`` from the same registry.

The controller's half follows the registry: ``merge_snapshots`` sums
per-agent snapshots into the fleet view, ``render_snapshots`` renders
snapshots into one Prometheus text exposition (exemplars included),
``histogram_quantile`` estimates a quantile from bucket counts, and
``parse_exposition`` / ``parse_exemplars`` / ``validate_exposition`` read
and check an exposition on the scrape side.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

# Seconds-oriented bounds: task phases run 5 ms to minutes. +Inf is implicit
# (the overflow slot).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(value: Any) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_num(value: float) -> str:
    """Prometheus sample value: integers render bare, floats via repr."""
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_bound(bound: float) -> str:
    """``le`` label text: '0.005', '1', '+Inf'."""
    if bound == float("inf"):
        return "+Inf"
    return "%g" % bound


class _Metric:
    """Base: one named family holding labeled series. Series mutation is
    guarded by the owning registry's lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name!r}")
        self.name = name
        self.help = help
        self.labelnames: Tuple[str, ...] = tuple(labelnames)
        self._lock = lock
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Mapping[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: labels {sorted(labels)} != declared "
                             f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up ({amount})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-bucket histogram. Each series stores per-bucket (non-cumulative)
    counts with a final +Inf overflow slot, plus sum and count."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, labelnames, lock)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"{name}: buckets must be sorted and unique")
        if any(b != b or b == float("inf") for b in bounds):
            raise ValueError(f"{name}: buckets must be finite (+Inf is implicit)")
        self.buckets = bounds

    def observe(self, value: float, exemplar: Optional[Mapping[str, Any]] = None,
                **labels: Any) -> None:
        """Record one observation. ``exemplar`` (a small label set like
        ``{"trace_id": job_id}``) is attached to the landing bucket — the
        latest observation wins."""
        v = float(value)
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0, "count": 0}
                self._series[key] = series
            i = len(self.buckets)  # +Inf slot
            for j, bound in enumerate(self.buckets):
                if v <= bound:
                    i = j
                    break
            series["counts"][i] += 1
            series["sum"] += v
            series["count"] += 1
            if exemplar:
                series.setdefault("exemplars", {})[str(i)] = {
                    "labels": {str(k): str(lv) for k, lv in exemplar.items()},
                    "value": v,
                    "ts": time.time(),
                }


class MetricsRegistry:
    """Thread-safe named collection of metrics; get-or-create semantics so
    independent modules can reference the same family."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labelnames: Sequence[str],
                       **kwargs: Any) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls or existing.labelnames != tuple(labelnames):
                    raise ValueError(f"metric {name!r} re-registered with a different "
                                     "type/labels")
                return existing
            metric = cls(name, help, labelnames, self._lock, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump of every series — the lease-push wire format."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, m in self._metrics.items():
                fam: Dict[str, Any] = {"type": m.kind, "help": m.help,
                                       "labels": list(m.labelnames), "series": []}
                if isinstance(m, Histogram):
                    fam["buckets"] = list(m.buckets)
                for key, value in m._series.items():
                    labels = dict(zip(m.labelnames, key))
                    if isinstance(m, Histogram):
                        entry = {"labels": labels, "counts": list(value["counts"]),
                                 "sum": value["sum"], "count": value["count"]}
                        if value.get("exemplars"):
                            entry["exemplars"] = {k: dict(v)
                                                  for k, v in value["exemplars"].items()}
                        fam["series"].append(entry)
                    else:
                        fam["series"].append({"labels": labels, "value": value})
                out[name] = fam
        return out

    def render(self) -> str:
        return render_snapshots([(self.snapshot(), {})])


# ---- process-global default (standalone callers; tests inject instances) ----

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


# ---- snapshot algebra ----

def _series_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def merge_snapshots(snapshots: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Sum same-name/same-labels series across snapshots (the fleet merge:
    one snapshot per agent → fleet totals). Counters, gauges, and histogram
    buckets all add; families whose type or buckets disagree keep the first
    definition and skip conflicting series (a half-upgraded fleet must not
    corrupt the merged view)."""
    out: Dict[str, Any] = {}
    for snap in snapshots:
        if not isinstance(snap, Mapping):
            continue
        for name, fam in snap.items():
            if not isinstance(fam, Mapping) or "series" not in fam:
                continue
            dst = out.get(name)
            if dst is None:
                dst = {
                    "type": fam.get("type", "untyped"),
                    "help": fam.get("help", ""),
                    "labels": list(fam.get("labels", [])),
                    "series": [],
                    "_index": {},
                }
                if "buckets" in fam:
                    dst["buckets"] = list(fam["buckets"])
                out[name] = dst
            fam_buckets = list(fam["buckets"]) if "buckets" in fam else None
            if dst["type"] != fam.get("type") or \
                    dst.get("buckets") != fam_buckets:
                continue
            for s in fam.get("series", []):
                labels = s.get("labels", {})
                key = _series_key(labels)
                have = dst["_index"].get(key)
                if dst["type"] == "histogram":
                    if have is None:
                        have = {
                            "labels": dict(labels),
                            "counts": [0] * len(s.get("counts", [])),
                            "sum": 0.0,
                            "count": 0,
                        }
                        dst["_index"][key] = have
                        dst["series"].append(have)
                    counts = s.get("counts", [])
                    if len(counts) == len(have["counts"]):
                        have["counts"] = [
                            a + b for a, b in zip(have["counts"], counts)
                        ]
                        have["sum"] += float(s.get("sum", 0.0))
                        have["count"] += int(s.get("count", 0))
                        for slot, ex in (s.get("exemplars") or {}).items():
                            if not isinstance(ex, Mapping):
                                continue
                            dst_ex = have.setdefault("exemplars", {})
                            prev = dst_ex.get(slot)
                            # Latest observation wins across the fleet.
                            if prev is None or float(ex.get("ts", 0.0)) >= \
                                    float(prev.get("ts", 0.0)):
                                dst_ex[slot] = dict(ex)
                else:
                    if have is None:
                        have = {"labels": dict(labels), "value": 0.0}
                        dst["_index"][key] = have
                        dst["series"].append(have)
                    have["value"] += float(s.get("value", 0.0))
    for fam in out.values():
        fam.pop("_index", None)
    return out


def render_snapshots(
    parts: Sequence[Tuple[Mapping[str, Any], Mapping[str, str]]]
) -> str:
    """Render snapshots into one Prometheus text exposition.

    ``parts`` is ``[(snapshot, extra_labels), ...]`` — extra labels (e.g.
    ``{"agent": "tpu-vm-3"}``) are stamped onto every series of that
    snapshot, which is how one exposition can carry the controller's own
    series next to per-agent or fleet-merged ones without name collisions.
    One HELP/TYPE header per family regardless of how many parts carry it;
    a family re-appearing with a different type is skipped (exposition
    validity beats completeness).
    """
    families: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for snap, extra in parts:
        if not isinstance(snap, Mapping):
            continue
        for name, fam in snap.items():
            if not isinstance(fam, Mapping) or not _NAME_RE.match(str(name)):
                continue
            entry = families.get(name)
            if entry is None:
                entry = {
                    "type": fam.get("type", "untyped"),
                    "help": fam.get("help", ""),
                    "chunks": [],
                }
                families[name] = entry
                order.append(name)
            elif entry["type"] != fam.get("type"):
                continue
            entry["chunks"].append((fam, dict(extra or {})))

    lines: List[str] = []
    for name in order:
        entry = families[name]
        kind = entry["type"]
        if entry["help"]:
            lines.append(f"# HELP {name} {_escape_help(entry['help'])}")
        lines.append(f"# TYPE {name} {kind}")
        for fam, extra in entry["chunks"]:
            for s in fam.get("series", []):
                labels = {**s.get("labels", {}), **extra}
                if kind == "histogram":
                    bounds = [float(b) for b in fam.get("buckets", [])]
                    counts = list(s.get("counts", []))
                    exemplars = s.get("exemplars") or {}
                    cum = 0
                    for j, (bound, c) in enumerate(zip(bounds, counts)):
                        cum += c
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels_text({**labels, 'le': _fmt_bound(bound)})}"
                            f" {cum}"
                            f"{_exemplar_text(exemplars.get(str(j)))}"
                        )
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels_text({**labels, 'le': '+Inf'})}"
                        f" {int(s.get('count', 0))}"
                        f"{_exemplar_text(exemplars.get(str(len(bounds))))}"
                    )
                    lines.append(
                        f"{name}_sum{_labels_text(labels)}"
                        f" {_fmt_num(s.get('sum', 0.0))}"
                    )
                    lines.append(
                        f"{name}_count{_labels_text(labels)}"
                        f" {int(s.get('count', 0))}"
                    )
                else:
                    lines.append(
                        f"{name}{_labels_text(labels)}"
                        f" {_fmt_num(s.get('value', 0.0))}"
                    )
    return "\n".join(lines) + ("\n" if lines else "")


def _labels_text(labels: Mapping[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _exemplar_text(exemplar: Optional[Mapping[str, Any]]) -> str:
    """OpenMetrics exemplar suffix for one bucket sample:
    `` # {trace_id="job-x"} 0.052 1700000000.5`` — the metrics→traces link
   . Empty string when the bucket carries none."""
    if not exemplar or not isinstance(exemplar.get("labels"), Mapping):
        return ""
    labels = _labels_text(exemplar["labels"])
    if not labels:
        return ""
    out = f" # {labels} {_fmt_num(float(exemplar.get('value', 0.0)))}"
    ts = exemplar.get("ts")
    if isinstance(ts, (int, float)) and not isinstance(ts, bool):
        out += f" {round(float(ts), 3)}"
    return out


def histogram_quantile(
    buckets: Sequence[float], counts: Sequence[int], q: float
) -> Optional[float]:
    """Estimate the q-quantile (0..1) from per-bucket counts (+Inf slot
    last), linearly interpolating within the landing bucket — the same
    estimate Prometheus's ``histogram_quantile`` makes. None when empty.
    Values in the +Inf slot clamp to the largest finite bound.

    **Pinned error bound**: for observations within
    the finite bucket range, the estimate lands in the same bucket as the
    exact sample quantile, so the absolute error is **at most one bucket
    width** (the width of the bucket containing the true quantile). This
    holds for FLEET-MERGED snapshots too: ``merge_snapshots`` sums
    per-bucket counts losslessly (every agent shares the fixed
    ``DEFAULT_BUCKETS``), so a merged estimate is exactly the estimate the
    pooled samples would have produced — merging adds NO error beyond the
    single-histogram bound. Observations beyond the largest finite bound
    land in +Inf and clamp to that bound, where the error is unbounded by
    construction; size the top bucket above the latencies you must judge."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target:
            if i >= len(buckets):  # +Inf slot
                return float(buckets[-1]) if buckets else None
            lower = float(buckets[i - 1]) if i > 0 else 0.0
            upper = float(buckets[i])
            if c <= 0:
                return upper
            frac = (target - (cum - c)) / c
            return lower + (upper - lower) * frac
    return float(buckets[-1]) if buckets else None


# ---- exposition parsing / validation (the scrape side) ----

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"        # metric name
    r"(?:\{(.*)\})?"                        # optional label block
    r"\s+"
    r"([^\s]+)"                             # value
    r"(?:\s+[0-9]+)?$"                      # optional timestamp
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'
)
# OpenMetrics exemplar suffix on a sample line:
#   `` # {trace_id="job-x"} 0.052 1700000000.5`` (timestamp optional).
# Split off BEFORE the sample regex — the greedy label block would
# otherwise swallow the exemplar's braces into the labels.
_EXEMPLAR_SUFFIX_RE = re.compile(
    r"\s#\s\{(.*)\}\s+([^\s]+)(?:\s+([0-9.eE+-]+))?\s*$"
)


def _split_exemplar(
    line: str,
) -> Tuple[str, Optional[Tuple[str, str, Optional[str]]]]:
    m = _EXEMPLAR_SUFFIX_RE.search(line)
    if m is None:
        return line, None
    return line[: m.start()], (m.group(1), m.group(2), m.group(3))


def _unescape_label(value: str) -> str:
    return (
        value.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")
    )


def parse_exposition(
    text: str,
) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Prometheus text → ``{sample_name: [(labels, value), ...]}``.

    Histogram component samples keep their suffixed names
    (``x_bucket``/``x_sum``/``x_count``). Malformed lines raise ValueError —
    scraping callers that prefer tolerance should run
    ``validate_exposition`` first.
    """
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        line, _exemplar = _split_exemplar(line)
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name, labelblock, raw = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if labelblock:
            consumed = 0
            for pm in _LABEL_PAIR_RE.finditer(labelblock):
                labels[pm.group(1)] = _unescape_label(pm.group(2))
                consumed += 1
            # every comma-separated pair must have parsed
            expect = [p for p in re.split(r",(?=[a-zA-Z_])", labelblock) if p]
            if consumed != len(expect):
                raise ValueError(
                    f"line {lineno}: malformed labels {labelblock!r}"
                )
        try:
            value = float(raw)
        except ValueError as exc:
            raise ValueError(
                f"line {lineno}: non-numeric value {raw!r}"
            ) from exc
        out.setdefault(name, []).append((labels, value))
    return out


def parse_exemplars(
    text: str,
) -> Dict[str, List[Tuple[Dict[str, str], Dict[str, str], float]]]:
    """Exemplars per sample name: ``{sample_name: [(sample_labels,
    exemplar_labels, exemplar_value), ...]}`` — what the trace-pipeline
    smoke uses to assert ``task_phase_seconds`` buckets link to real job
    ids. Lines without exemplars are skipped; malformed ones raise."""
    out: Dict[str, List[Tuple[Dict[str, str], Dict[str, str], float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        line, exemplar = _split_exemplar(line)
        if exemplar is None:
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        labels: Dict[str, str] = {}
        if m.group(2):
            for pm in _LABEL_PAIR_RE.finditer(m.group(2)):
                labels[pm.group(1)] = _unescape_label(pm.group(2))
        ex_block, ex_raw, _ex_ts = exemplar
        ex_labels: Dict[str, str] = {}
        for pm in _LABEL_PAIR_RE.finditer(ex_block):
            ex_labels[pm.group(1)] = _unescape_label(pm.group(2))
        try:
            ex_value = float(ex_raw)
        except ValueError as exc:
            raise ValueError(
                f"line {lineno}: non-numeric exemplar value {ex_raw!r}"
            ) from exc
        out.setdefault(m.group(1), []).append((labels, ex_labels, ex_value))
    return out


def validate_exposition(
    text: str, required: Iterable[str] = ()
) -> List[str]:
    """Structural check of one exposition; returns problems (empty = valid).

    Catches: malformed sample/comment lines, samples whose family carries no
    ``# TYPE`` declaration, duplicate TYPE declarations, histogram families
    missing their ``_sum``/``_count``/``+Inf`` samples, and missing
    ``required`` family names. This is the checker
    scrape-side checks and the tests share.
    """
    problems: List[str] = []
    types: Dict[str, str] = {}
    samples: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped:
            continue
        if stripped.startswith("#"):
            parts = stripped.split(None, 3)
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"
                ):
                    problems.append(f"line {lineno}: malformed TYPE line")
                elif parts[2] in types:
                    problems.append(
                        f"line {lineno}: duplicate TYPE for {parts[2]}"
                    )
                else:
                    types[parts[2]] = parts[3]
            continue
        stripped, exemplar = _split_exemplar(stripped)
        m = _SAMPLE_RE.match(stripped)
        if m is None:
            problems.append(f"line {lineno}: malformed sample {stripped!r}")
            continue
        name, labelblock, raw = m.group(1), m.group(2), m.group(3)
        if exemplar is not None:
            if not name.endswith("_bucket"):
                problems.append(
                    f"line {lineno}: exemplar on non-bucket sample {name}"
                )
            elif not _LABEL_PAIR_RE.search(exemplar[0]):
                problems.append(
                    f"line {lineno}: malformed exemplar labels "
                    f"{exemplar[0]!r}"
                )
            else:
                try:
                    float(exemplar[1])
                except ValueError:
                    problems.append(
                        f"line {lineno}: non-numeric exemplar value "
                        f"{exemplar[1]!r}"
                    )
        try:
            float(raw)
        except ValueError:
            problems.append(f"line {lineno}: non-numeric value {raw!r}")
            continue
        labels: Dict[str, str] = {}
        if labelblock:
            for pm in _LABEL_PAIR_RE.finditer(labelblock):
                labels[pm.group(1)] = _unescape_label(pm.group(2))
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)] if name.endswith(suffix) else None
            if base and types.get(base) == "histogram":
                family = base
                break
        if family not in types:
            problems.append(
                f"line {lineno}: sample {name} has no TYPE declaration"
            )
        samples.setdefault(name, []).append((labels, float(raw)))
    for fam, kind in types.items():
        if kind != "histogram":
            continue
        if not any(
            f"{fam}{sfx}" in samples for sfx in ("_bucket", "_sum", "_count")
        ):
            continue  # declared but unobserved family — legal exposition
        if f"{fam}_sum" not in samples or f"{fam}_count" not in samples:
            problems.append(f"histogram {fam} missing _sum/_count samples")
        if not any(
            lbl.get("le") == "+Inf" for lbl, _ in samples.get(f"{fam}_bucket", [])
        ):
            problems.append(f"histogram {fam} missing +Inf bucket")
    for name in required:
        present = name in types or name in samples or any(
            s.startswith(name + "_") for s in samples
        )
        if not present:
            problems.append(f"required series {name} absent")
    return problems
