"""The port's SLO engine (``agent_tpu_torch.obs.slo``) against the
reference's (``agent_tpu.obs.slo``): the specs of ``tests/test_slo.py``
parse to the same objectives (and the malformed ones raise the same
message); a seeded stream of latencies and outcomes, on an injected clock,
gives both trackers the same attainment, burn rates, budgets, alert states,
transitions, alert callbacks and gauges. Floats are compared equal: both
packages do the same arithmetic in the same order."""

import dataclasses
import json
import random

import pytest

from agent_tpu import config as jax_config
from agent_tpu.obs import metrics as jax_metrics
from agent_tpu.obs import slo as jax_slo
from agent_tpu_torch import config as torch_config
from agent_tpu_torch.obs import metrics as torch_metrics
from agent_tpu_torch.obs import slo as torch_slo

PKGS = {"jax": (jax_slo, jax_metrics), "torch": (torch_slo, torch_metrics)}

SPECS = [
    "",
    None,
    json.dumps([{"name": "interactive", "tier": 8, "p99_ms": 250, "availability": 0.999},
                {"name": "bulk", "op": "map_classify_tpu", "p50_ms": 400, "p95_ms": 900},
                {"name": "acme", "tenant": "acme", "availability": 0.99},
                {"name": "ttft", "metric": "ttft", "p99_ms": 800}]),
]
BAD_SPECS = ["{", "{}", "[1]", '[{"name": "a", "bogus": 1}]', '[{"name": "a", "tier": true}]',
             '[{"name": "a", "p99_ms": -5}]', '[{"name": "a", "availability": 1.5}]',
             '[{"name": "a", "metric": "tokens"}]', '[{"p99_ms": 5}]',
             '[{"name": "a", "p99_ms": 5}, {"name": "a", "p99_ms": 6}]', '[{"name": "a"}]']


@pytest.mark.parametrize("spec", SPECS, ids=["empty", "none", "four"])
def test_specs_parse_to_the_reference_objectives(spec):
    got = [dataclasses.asdict(o) for o in torch_slo.parse_slo_spec(spec)]
    want = [dataclasses.asdict(o) for o in jax_slo.parse_slo_spec(spec)]
    assert got == want
    for o, w in zip(torch_slo.parse_slo_spec(spec), jax_slo.parse_slo_spec(spec)):
        assert o.latency_targets() == w.latency_targets() and o.selector() == w.selector()


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_the_reference_message(spec):
    try:
        jax_slo.parse_slo_spec(spec)
        want = None
    except ValueError as exc:
        want = str(exc)
    try:
        torch_slo.parse_slo_spec(spec)
        got = None
    except ValueError as exc:
        got = str(exc)
    assert got == want


def _drive(pkg, seed, spec, burst_at=(200, 320)):
    slo, metrics = PKGS[pkg]
    rng = random.Random(seed)
    clock = [1000.0]
    reg = metrics.MetricsRegistry()
    alerts = []
    tr = slo.SloTracker(slo.parse_slo_spec(spec), registry=reg, clock=lambda: clock[0],
                        window_short_sec=60.0, window_long_sec=600.0, burn_warn=2.0,
                        burn_page=6.0, on_alert=lambda *a, **kw: alerts.append((a, kw)))
    out = []
    for i in range(600):
        clock[0] += rng.choice([0.5, 1.0, 2.0])
        bad = burst_at[0] <= i < burst_at[1]
        latency = rng.random() * (3.0 if bad else 0.3)
        ok = rng.random() > (0.2 if bad else 0.001)
        tr.observe(latency, ok, tier=rng.choice([8, 4]), tenant=rng.choice(["acme", "b"]),
                   op=rng.choice(["map_classify_tpu", "echo"]),
                   metric=rng.choice(["latency", "latency", "ttft"]))
        if i % 25 == 0:
            out.append(tr.evaluate())
            out.append((tr.states(), tr.active_alerts(), tr.active_alerts("page")))
        out.append(tr.maybe_evaluate(min_interval_sec=5.0) is not None)
    out.append(alerts)
    out.append(reg.snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spec", SPECS[::2], ids=["default", "four"])
def test_tracker_matches_the_reference(spec, seed):
    got, want = _drive("torch", seed, spec), _drive("jax", seed, spec)
    assert got == want
    assert any(r["state"] != "ok" for ev in want[:-2] if isinstance(ev, list) for r in ev)


@pytest.mark.parametrize("env", [{}, {"SLO_ENABLED": "0", "SLO_SPEC": "[]",
                                      "SLO_WINDOW_SHORT_SEC": "0", "SLO_WINDOW_LONG_SEC": "5",
                                      "SLO_BURN_WARN": "-1", "SLO_BURN_PAGE": "20",
                                      "SLO_BURN_EXIT_FRAC": "3", "HEALTH_AGENT_STALE_SEC": "0"}],
                         ids=["defaults", "set"])
def test_slo_config_from_env_matches_the_reference(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert vars(torch_config.SloConfig.from_env()) == vars(jax_config.SloConfig.from_env())
