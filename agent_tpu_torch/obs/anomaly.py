"""Rolling-baseline anomaly detection over the telemetry stream.

Each watched series keeps a bounded baseline of recent sample values and
scores every new value with a robust z-score: ``z = 0.6745·(x − median) /
MAD`` (0.6745 makes the MAD consistent with σ under normality). Median and
MAD shrug off the very outliers we hunt — a mean/stddev baseline gets
dragged toward the anomaly and stops seeing it.

Guards keep a calm seeded drain at exactly zero false positives:

- **warmup gate** — no verdicts until the baseline holds ``warmup``
  samples (the first sweeps of a drain are startup transients, not
  anomalies);
- **MAD floor** — a near-constant series has MAD ≈ 0 and would fire on
  noise; the floor is ``max(mad, mad_floor_frac·|median|, watch floor)``;
- **absolute delta floor** — per-watch ``min_delta``: queue depth moving
  1→3 is not an incident no matter how tight the baseline;
- **confirmation** — ``confirm`` consecutive anomalous samples open an
  episode; one episode emits one event (the incident layer's dedup rides
  this). Anomalous values never join the baseline, so the baseline can't
  normalize an ongoing incident; ``clear`` consecutive calm samples close
  the episode.

Deterministic: verdicts are a pure function of the sample sequence — the
chaos drill replays the same seed and gets the same (single) anomaly.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from agent_tpu_torch.obs.metrics import histogram_quantile

Sample = Mapping[str, Any]  # {"wall": float, "data": {fam: {key: value}}}

DEFAULT_WINDOW = 60
DEFAULT_WARMUP = 12
DEFAULT_Z = 8.0
DEFAULT_CONFIRM = 2
DEFAULT_CLEAR = 5
MAD_CONSISTENCY = 0.6745


def _fam_sum(sample: Sample, family: str) -> Optional[float]:
    series = (sample.get("data") or {}).get(family)
    if not series:
        return None
    return float(sum(series.values()))


def gauge_sum(family: str) -> Callable[[Optional[Sample], Sample],
                                       Optional[float]]:
    def extract(prev: Optional[Sample], cur: Sample) -> Optional[float]:
        return _fam_sum(cur, family)
    return extract


def gauge_mean(family: str) -> Callable[[Optional[Sample], Sample],
                                        Optional[float]]:
    def extract(prev: Optional[Sample], cur: Sample) -> Optional[float]:
        series = (cur.get("data") or {}).get(family)
        if not series:
            return None
        return float(sum(series.values())) / len(series)
    return extract


def counter_rate(family: str) -> Callable[[Optional[Sample], Sample],
                                          Optional[float]]:
    def extract(prev: Optional[Sample], cur: Sample) -> Optional[float]:
        if prev is None:
            return None
        v0, v1 = _fam_sum(prev, family), _fam_sum(cur, family)
        if v0 is None or v1 is None:
            return None
        dt = float(cur.get("wall", 0.0)) - float(prev.get("wall", 0.0))
        if dt <= 0:
            return None
        return max(0.0, (v1 - v0) / dt)
    return extract


def hist_quantile(family: str, q: float) -> Callable[
    [Optional[Sample], Sample], Optional[float]
]:
    """Quantile of the observations BETWEEN two samples, from the
    flattened ``<family>_bucket`` per-slot counter deltas (each slot is
    monotone; flatten emits the ``le`` label inside the series key)."""
    bucket_fam = f"{family}_bucket"

    def extract(prev: Optional[Sample], cur: Sample) -> Optional[float]:
        if prev is None:
            return None
        cur_b = (cur.get("data") or {}).get(bucket_fam)
        prev_b = (prev.get("data") or {}).get(bucket_fam) or {}
        if not cur_b:
            return None
        increases: Dict[float, float] = {}
        inf_inc = 0.0
        for key, v in cur_b.items():
            inc = max(0.0, float(v) - float(prev_b.get(key, 0.0)))
            try:
                labels = dict(json.loads(key))
            except ValueError:
                continue
            le = labels.get("le")
            if le == "+Inf":
                inf_inc += inc
            else:
                try:
                    edge = float(le)
                except (TypeError, ValueError):
                    continue
                increases[edge] = increases.get(edge, 0.0) + inc
        edges = sorted(increases)
        counts = [increases[e] for e in edges] + [inf_inc]
        if sum(counts) <= 0:
            return None  # no observations this interval — no signal
        return histogram_quantile(edges, counts, q)
    return extract


class Watch:
    """One monitored scalar derived from the sample stream."""

    def __init__(
        self,
        name: str,
        extract: Callable[[Optional[Sample], Sample], Optional[float]],
        direction: str = "high",   # "high" | "low" | "both"
        min_delta: float = 0.0,    # absolute |x - median| floor
        mad_floor: float = 1e-9,   # absolute MAD floor
    ) -> None:
        self.name = name
        self.extract = extract
        self.direction = direction
        self.min_delta = float(min_delta)
        self.mad_floor = float(mad_floor)


def default_watches() -> List[Watch]:
    """The five default watches: TTFT p99, queue depth, lease-error rate,
    KV-free, duty. Floors sized so ordinary drain jitter never clears
    them."""
    return [
        Watch("ttft_p99", hist_quantile("serve_ttft_seconds", 0.99),
              direction="high", min_delta=0.2, mad_floor=0.01),
        Watch("queue_depth", gauge_sum("controller_queue_depth"),
              direction="high", min_delta=10.0, mad_floor=1.0),
        Watch("lease_error_rate", counter_rate("result_post_failures_total"),
              direction="high", min_delta=0.5, mad_floor=0.1),
        Watch("kv_free", gauge_sum("serve_kv_blocks_free"),
              direction="low", min_delta=16.0, mad_floor=2.0),
        Watch("duty", gauge_mean("device_duty_cycle"),
              direction="low", min_delta=0.25, mad_floor=0.02),
    ]


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


class AnomalyDetector:
    """Feed with consecutive samples via :meth:`observe`; confirmed
    anomalies come back as event dicts, open episodes show in
    :meth:`active` (the /v1/health ``anomaly`` warn reason)."""

    def __init__(
        self,
        watches: Optional[Sequence[Watch]] = None,
        window: int = DEFAULT_WINDOW,
        warmup: int = DEFAULT_WARMUP,
        z_thresh: float = DEFAULT_Z,
        mad_floor_frac: float = 0.05,
        confirm: int = DEFAULT_CONFIRM,
        clear: int = DEFAULT_CLEAR,
    ) -> None:
        self.watches = list(watches) if watches is not None \
            else default_watches()
        self.window = max(4, int(window))
        self.warmup = max(2, int(warmup))
        self.z_thresh = max(1.0, float(z_thresh))
        self.mad_floor_frac = max(0.0, float(mad_floor_frac))
        self.confirm = max(1, int(confirm))
        self.clear = max(1, int(clear))
        self._state: Dict[str, Dict[str, Any]] = {
            w.name: {
                "baseline": [], "streak": 0, "calm": 0,
                "active": None, "episodes": 0,
            }
            for w in self.watches
        }
        self.events_total = 0

    def _score(self, watch: Watch, baseline: List[float],
               x: float) -> Optional[Dict[str, Any]]:
        """Anomaly verdict for one value against one baseline, or None
        when calm."""
        med = _median(baseline)
        mad = _median([abs(v - med) for v in baseline])
        mad_eff = max(
            mad, self.mad_floor_frac * abs(med), watch.mad_floor,
        )
        z = MAD_CONSISTENCY * (x - med) / mad_eff
        delta = x - med
        high = (
            watch.direction in ("high", "both")
            and z >= self.z_thresh and delta >= watch.min_delta
        )
        low = (
            watch.direction in ("low", "both")
            and -z >= self.z_thresh and -delta >= watch.min_delta
        )
        if not high and not low:
            return None
        return {
            "watch": watch.name,
            "value": round(x, 6),
            "baseline_median": round(med, 6),
            "mad": round(mad_eff, 6),
            "z": round(z, 3),
            "direction": "high" if high else "low",
        }

    def observe(
        self, prev: Optional[Sample], sample: Sample
    ) -> List[Dict[str, Any]]:
        """Score one sample; returns newly-CONFIRMED anomaly events
        (one per watch per episode)."""
        events: List[Dict[str, Any]] = []
        wall = float(sample.get("wall", 0.0))
        for watch in self.watches:
            st = self._state[watch.name]
            try:
                x = watch.extract(prev, sample)
            except Exception:  # noqa: BLE001 — a malformed sample must
                # not kill the sweep; this watch just skips the beat.
                x = None
            if x is None:
                continue
            baseline: List[float] = st["baseline"]
            if len(baseline) < self.warmup:
                baseline.append(x)
                continue
            verdict = self._score(watch, baseline, x)
            if verdict is None:
                baseline.append(x)
                if len(baseline) > self.window:
                    del baseline[: len(baseline) - self.window]
                st["streak"] = 0
                if st["active"] is not None:
                    st["calm"] += 1
                    if st["calm"] >= self.clear:
                        st["active"] = None
                        st["calm"] = 0
                continue
            # Anomalous: hold it OUT of the baseline.
            st["calm"] = 0
            st["streak"] += 1
            if st["streak"] >= self.confirm and st["active"] is None:
                verdict["wall"] = round(wall, 3)
                st["active"] = verdict
                st["episodes"] += 1
                self.events_total += 1
                events.append(dict(verdict))
            elif st["active"] is not None:
                st["active"]["value"] = verdict["value"]
                st["active"]["z"] = verdict["z"]
        return events

    def active(self) -> List[Dict[str, Any]]:
        return [
            dict(st["active"])
            for st in self._state.values()
            if st["active"] is not None
        ]

    def stats(self) -> Dict[str, Any]:
        return {
            "watches": {
                name: {
                    "baseline_n": len(st["baseline"]),
                    "episodes": st["episodes"],
                    "active": st["active"] is not None,
                }
                for name, st in self._state.items()
            },
            "events_total": self.events_total,
        }
