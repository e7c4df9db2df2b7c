"""The port's anomaly detector and incident bundler
(``agent_tpu_torch.obs.anomaly``, ``obs.incident``) against the
reference's: a seeded sample stream carrying the five default watches'
families (TTFT buckets, queue depth, post failures, free KV blocks, duty),
with injected spikes, gives both detectors the same confirmed events, open
episodes and counters; the same incidents give both bundlers the same
ids, truncation, rate limiting, listings and files, including a reopen
that reindexes the directory (under pytest's ``tmp_path``)."""

import json
import os
import random

import pytest

from agent_tpu.config import ObsConfig as JaxObsConfig
from agent_tpu.obs import anomaly as jax_anomaly
from agent_tpu.obs import incident as jax_incident
from agent_tpu_torch.config import ObsConfig
from agent_tpu_torch.obs import anomaly as torch_anomaly
from agent_tpu_torch.obs import incident as torch_incident

T0 = 1_700_000_000.0


def _k(**labels):
    return json.dumps(sorted(labels.items()), separators=(",", ":"))


def _samples(seed, n=220):
    rng = random.Random(seed)
    out, fails, buckets = [], 0.0, {"0.1": 0.0, "0.5": 0.0, "2.5": 0.0, "+Inf": 0.0}
    for i in range(n):
        spike = i in range(90, 100) or i in range(160, 163)
        fails += rng.random() * (40 if spike else 0.2)
        for _ in range(rng.randrange(1, 6)):
            x = rng.random() * (3.0 if spike else 0.3)
            for le in buckets:
                if le == "+Inf" or x <= float(le):
                    buckets[le] += 1
        data = {
            "serve_ttft_seconds_bucket": {_k(le=le): c for le, c in buckets.items()},
            "controller_queue_depth": {_k(policy="fair"): float(rng.randrange(3) +
                                                               (80 if spike else 0))},
            "result_post_failures_total": {_k(agent="a"): fails},
            "serve_kv_blocks_free": {_k(agent="a"): 500.0 - (400 if spike else rng.random())},
            "device_duty_cycle": {_k(agent="a"): 0.9 - (0.6 if spike else rng.random() * 0.02),
                                  _k(agent="b"): 0.85},
        }
        if i % 50 == 7:
            data = {"unrelated": {_k(): 1.0}}
        out.append({"wall": T0 + 10 * i, "data": data})
    return out


def _detect(mod, seed, **kw):
    det = mod.AnomalyDetector(**kw)
    prev, out = None, []
    for s in _samples(seed):
        out.append(det.observe(prev, s))
        out.append(det.active())
        prev = s
    out.append(det.stats())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [{}, {"window": 20, "warmup": 6, "z_thresh": 4.0, "confirm": 1,
                                     "clear": 2}], ids=["defaults", "eager"])
def test_detector_matches_the_reference(seed, kw):
    got, want = _detect(torch_anomaly, seed, **kw), _detect(jax_anomaly, seed, **kw)
    assert got == want
    assert any(events for events in want[:-1:2])  # the spikes were confirmed


def test_extractors_match_the_reference():
    samples = _samples(4, 30)
    for name in ("serve_ttft_seconds", "controller_queue_depth", "device_duty_cycle",
                 "result_post_failures_total", "absent"):
        pairs = [(torch_anomaly.gauge_sum(name), jax_anomaly.gauge_sum(name)),
                 (torch_anomaly.gauge_mean(name), jax_anomaly.gauge_mean(name)),
                 (torch_anomaly.counter_rate(name), jax_anomaly.counter_rate(name)),
                 (torch_anomaly.hist_quantile(name, 0.99), jax_anomaly.hist_quantile(name, 0.99))]
        for ours, theirs in pairs:
            for prev, cur in zip([None] + samples, samples):
                assert ours(prev, cur) == theirs(prev, cur)
    assert [w.name for w in torch_anomaly.default_watches()] == \
        [w.name for w in jax_anomaly.default_watches()]


def _bundle(mod, root, seed):
    rng = random.Random(seed)
    clock = [T0]
    b = mod.IncidentBundler(directory=root, capacity=4, min_interval_sec=60.0,
                            max_bundle_bytes=4096, clock=lambda: clock[0])
    out = []
    for i in range(14):
        clock[0] += rng.choice([10.0, 30.0, 90.0])
        sections = {"traces": [{"span": j, "pad": "x" * rng.randrange(1500)} for j in range(4)],
                    "metrics": {"q": rng.random()}, "log": ["line"] * rng.randrange(200)}
        inc = b.capture(rng.choice(["slo_page", "anomaly"]), rng.choice(["ttft", "ttft", "queue"]),
                        {"state": "page", "n": i}, sections,
                        wall=None if i % 3 else clock[0] + 0.5)
        out.append(inc and (inc["id"], inc.get("truncated_sections"), sorted(inc["sections"])))
    out.append(b.list())
    out.append([b.get(h["id"]) for h in b.list()] + [b.get("inc-missing")])
    out.append({k: v for k, v in b.stats().items() if k != "dir"})
    again = mod.IncidentBundler(directory=root, clock=lambda: clock[0])
    out.append(again.list())
    out.append({k: v for k, v in again.stats().items() if k != "dir"})
    out.append(sorted(os.listdir(root)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_incident_bundles_match_the_reference(tmp_path, seed):
    got = _bundle(torch_incident, str(tmp_path / "torch"), seed)
    want = _bundle(jax_incident, str(tmp_path / "jax"), seed)
    assert got == want
    assert any(x is None for x in want[:14]) and any(x and x[1] for x in want[:14])


def test_memory_only_bundler_matches_the_reference():
    outs = []
    for mod in (torch_incident, jax_incident):
        b = mod.IncidentBundler(clock=lambda: T0)
        outs.append((b.capture("slo_page", "x", {"a": 1}, {"s": [1, 2]}), b.list(), b.stats()))
    assert outs[0] == outs[1]


ENV = {"USAGE_ENABLED": "0", "USAGE_TOP_K": "0", "USAGE_MAX_JOBS": "3",
       "USAGE_COST_PER_CHIP_HOUR": "2.5", "TSDB_ENABLED": "no", "TSDB_WINDOW": "1",
       "TSDB_INTERVAL": "0.01", "TSDB_DIR": " /x ", "TSDB_SEGMENT_BYTES": "9",
       "TSDB_RETENTION_RAW_SEC": "-1", "TSDB_MAX_BYTES": "-2", "ANOMALY_ENABLED": "0",
       "ANOMALY_WINDOW": "1", "ANOMALY_WARMUP": "1", "ANOMALY_Z": "0.5",
       "ANOMALY_CONFIRM": "0", "ANOMALY_CLEAR": "0", "INCIDENT_DIR": "d",
       "INCIDENT_CAPACITY": "0", "INCIDENT_MIN_INTERVAL_SEC": "-4", "INCIDENT_WORST_K": "-1",
       "PROFILE_HOST_ENABLED": "off", "PROFILE_HOST_HZ": "0", "PROFILE_CAPTURE_DIR": "c"}


@pytest.mark.parametrize("env", [{}, ENV], ids=["defaults", "set"])
def test_obs_config_from_env_matches_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert vars(ObsConfig.from_env()) == vars(JaxObsConfig.from_env())
