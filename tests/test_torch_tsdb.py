"""The port's time-series ring and durable store (``agent_tpu_torch.obs.
timeseries``, ``obs.tsdb``) against the reference's: the inputs of
``tests/test_tsdb.py`` and seeded streams of counters, gauges and histogram
buckets go through both packages, with their clocks injected, and give the
same flattened samples, rates, ring series and queries, the same files on
disk, the same tiers, retention and torn-tail reopen, and the same
quantiles (equal floats: both compute them the same way)."""

import json
import os
import random

import pytest

from agent_tpu.obs import timeseries as jax_ts
from agent_tpu.obs import tsdb as jax_tsdb
from agent_tpu_torch.obs import metrics as torch_metrics
from agent_tpu_torch.obs import timeseries as torch_ts
from agent_tpu_torch.obs import tsdb as torch_tsdb

PKGS = {"jax": (jax_ts, jax_tsdb), "torch": (torch_ts, torch_tsdb)}
T0 = 1_700_000_000.0
EDGES = ["0.1", "0.5", "1.0", "+Inf"]


def _key(**labels):
    return json.dumps(sorted(labels.items()), separators=(",", ":"))


def _sample(rng, i):
    """One flattened sample: two counters, a gauge and a histogram's
    cumulative ``le`` slots, over two ops."""
    data = {}
    for op in ("classify", "risk"):
        data.setdefault("tasks_total", {})[_key(op=op)] = float(i * (2 if op == "risk" else 1))
        data.setdefault("queue_depth", {})[_key(op=op)] = float(rng.randrange(10))
        cum = 0.0
        for le in EDGES:
            cum += float(rng.randrange(3))
            data.setdefault("lat_bucket", {})[_key(op=op, le=le)] = cum * (i + 1)
    return data


def _files(root):
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            full = os.path.join(dirpath, name)
            out[os.path.relpath(full, root)] = open(full, "rb").read()
    return dict(sorted(out.items()))


def _drive_store(tsdb, root, seed, n=240, cadence=10.0, **kw):
    rng = random.Random(seed)
    clock = [T0]
    st = tsdb.TsdbStore(root, clock=lambda: clock[0], **kw)
    for i in range(n):
        clock[0] = T0 + i * cadence
        st.append_sample(clock[0], _sample(rng, i))
    st.flush()
    out = []
    for name in ("tasks_total", "queue_depth", "lat_bucket"):
        for step in (None, 60, 600):
            for rate in (False, True):
                out.append(st.query(name, rate=rate, since=T0 + 100, step=step))
        out.append(st.query(name, label_filter={"op": "risk"}, since=T0,
                            until=T0 + 700))
    for step in (None, 60, 600):
        series = st.query("lat_bucket", since=T0, step=step)["series"]
        out.append([tsdb.quantile_from_bucket_series(series, q) for q in (0.5, 0.9, 0.99)])
    out.append(st.samples(since=T0 + 50, until=T0 + 120))
    out.append(st.aggregates(60, since=T0))
    stats = st.stats()
    out.append({k: v for k, v in stats.items() if k != "dir"})
    out.append(st.gc(now=T0 + n * cadence + 5000))
    st.close()
    out.append(_files(root))
    return out


@pytest.mark.parametrize("kw", [{}, {"segment_max_bytes": 512},
                                {"segment_max_bytes": 512, "max_bytes": 4096},
                                {"retention_raw_sec": 600.0, "retention_1m_sec": 1200.0}],
                         ids=["default", "rotating", "byte-cap", "age-retention"])
def test_store_queries_and_files_match_the_reference(tmp_path, kw):
    got = {}
    for pkg, (_ts, tsdb) in PKGS.items():
        got[pkg] = _drive_store(tsdb, str(tmp_path / pkg), seed=3, **kw)
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["series"]  # the queries saw data


def test_reopen_skips_a_torn_tail_like_the_reference(tmp_path):
    got = {}
    for pkg, (_ts, tsdb) in PKGS.items():
        root = str(tmp_path / pkg)
        _drive_store(tsdb, root, seed=1, n=30)
        raw = sorted(f for f in os.listdir(root) if f.startswith("tsdb.seg"))[-1]
        with open(os.path.join(root, raw), "a", encoding="utf-8") as f:
            f.write('{"ev":"s","wall":170')  # the mid-append crash
        st = tsdb.TsdbStore(root, clock=lambda: T0 + 999)
        before = st.query("tasks_total", since=0)
        st.append_sample(T0 + 900, {"tasks_total": {_key(op="x"): 30.0}})
        st.flush()
        got[pkg] = (before, st.query("tasks_total", since=0), st.stats()["samples_appended"])
        st.close()
    assert got["torch"] == got["jax"]


def _snapshots(rng, i):
    reg = torch_metrics.MetricsRegistry()
    reg.counter("tasks_total", "tasks", ("op",)).inc(i + 1, op="classify")
    reg.gauge("queue_depth", "depth").set(rng.randrange(5))
    h = reg.histogram("lat_seconds", "lat", ("op",), buckets=(0.1, 1.0))
    for _ in range(rng.randrange(4)):
        h.observe(rng.random() * 2, op="risk")
    return [reg.snapshot(), {"bad": 1}, "skip"]


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_matches_the_reference(seed):
    got = {}
    for pkg, (ts, tsdb) in PKGS.items():
        rng = random.Random(seed)
        clock = [0.0]
        ring = ts.TimeSeriesRing(window_sec=60, interval_sec=5, clock=lambda: clock[0])
        hooked = []
        ring.on_sample = lambda wall, mono, data: hooked.append((wall, mono, data))
        taken = []
        for i in range(40):
            clock[0] = i * 2.5
            taken.append(ring.maybe_sample(lambda: _snapshots(rng, i), wall=T0 + i * 2.5))
        out = [taken, hooked, len(ring), ring.names(), ring.last_wall(),
               ring.samples_since(T0 + 50, limit=3)]
        for name in ("tasks_total", "queue_depth", "lat_seconds_bucket", "nope"):
            out.append(ring.series(name))
            out.append(ring.series(name, label_filter={"op": "risk"}, window_sec=30))
            out.append(ring.query(name, window_sec=40, rate=True))
            out.append(tsdb.query_history(name, since=T0 + 20, step=5, rate=True, ring=ring))
        got[pkg] = out
    assert got["torch"] == got["jax"]


def test_flatten_and_rates_match_the_reference():
    rng = random.Random(5)
    for i in range(5):
        for snap in _snapshots(rng, i)[:1]:
            assert torch_ts.flatten_snapshot(snap) == jax_ts.flatten_snapshot(snap)
    pts = [(float(t), float(v)) for t, v in zip([0, 1, 1, 3, 2, 7], [0, 5, 6, 2, 9, 12])]
    assert torch_ts.points_to_rates(pts) == jax_ts.points_to_rates(pts)
    series = [{"labels": {"le": le}, "points": [[T0, 0.0], [T0 + 60, float(c)]]}
              for le, c in zip(EDGES, (1, 4, 9, 10))]
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert torch_tsdb.quantile_from_bucket_series(series, q) == \
            jax_tsdb.quantile_from_bucket_series(series, q)
