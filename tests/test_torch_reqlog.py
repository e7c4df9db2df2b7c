"""The port's request log (``agent_tpu_torch.obs.reqlog``) against the
reference's (``agent_tpu.obs.reqlog``): a seeded stream of serving
records (completions, errors, slow TTFTs, sampled-out ids) gives both logs
the same keep reasons, the same newest-first views under every filter, the
same counters and the same dominant TTFT component."""

import random

import pytest

from agent_tpu.obs import reqlog as jax_reqlog
from agent_tpu_torch.obs import reqlog as torch_reqlog


def _records(seed, n=400):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        rec = {"req_id": f"r{rng.randrange(10**6)}", "tenant": rng.choice(["acme", "b", "c"]),
               "outcome": rng.choice(["completed"] * 8 + ["failed", "rejected"]),
               "ts": 1_700_000_000.0 + i}
        if rng.random() < 0.9:
            rec["ttft_ms"] = rng.expovariate(1 / 80.0) * (5 if i % 97 == 0 else 1)
        rec["components"] = {k: rng.random() * 50 for k in ("queue", "prefill", "wire")}
        out.append(rec)
    return out


def _drive(mod, seed, capacity, sample):
    log = mod.RequestLog(capacity=capacity, sample=sample)
    out = [log.add(dict(r)) for r in _records(seed)]
    for kw in ({}, {"tenant": "acme"}, {"outcome": "failed"}, {"slow": True},
               {"limit": 5}, {"tenant": "b", "slow": True, "limit": 3}):
        out.append(log.snapshot(**kw))
    out.append((log.stats(), len(log)))
    out.append([mod.dominant_component(r["components"]) for r in _records(seed, 20)])
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("capacity,sample", [(1024, 1.0), (64, 0.25), (16, 0.0)])
def test_request_log_matches_the_reference(seed, capacity, sample):
    got = _drive(torch_reqlog, seed, capacity, sample)
    want = _drive(jax_reqlog, seed, capacity, sample)
    assert got == want


def test_dominant_component_edge_cases():
    for comp in ({}, None, {"a": True, "b": "x"}, {"a": 0.0, "b": 0.0}, {"a": 2, "b": 2.0}):
        assert torch_reqlog.dominant_component(comp) == jax_reqlog.dominant_component(comp)
