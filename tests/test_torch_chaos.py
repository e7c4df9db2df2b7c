"""The port's chaos primitives (``chaos.py``) against the reference's on the
CPU: for the same seed and the same call sequence ``FaultPlan`` draws the
same faults, delays and counts; ``ChaosSession`` injects the same fault
pattern over the same posts (and counts it into
``chaos_faults_injected_total``); ``LoopbackSession`` answers leases,
results, submits (with the 429) and workflows as the port's controller
server does; and the port's agent drains a port controller through a
``ChaosSession`` with every shard applied once. Every comparison is exact."""

import random
import time

import pytest

import agent_tpu.chaos as ref_chaos
import agent_tpu.config as ref_config
import agent_tpu.obs.metrics as ref_metrics
import agent_tpu_torch.chaos as port_chaos
import agent_tpu_torch.config as port_config
import agent_tpu_torch.obs.metrics as port_metrics
from agent_tpu.controller.core import Controller as RefController
from agent_tpu_torch.controller.core import Controller

SIDES = {"port": (port_chaos, port_config, port_metrics, Controller),
         "ref": (ref_chaos, ref_config, ref_metrics, RefController)}
KINDS = ("drop_request", "drop_response", "http_500", "duplicate_result", "delay",
         "drop_lease", "duplicate_task", "stale_epoch", "agent_crash", "spot_reclaim",
         "hard_kill", "controller_kill")


def _plan_trace(side, seed):
    chaos = SIDES[side][0]
    rng = random.Random(seed)
    probs = {k: rng.choice([0.0, 0.05, 0.3, 0.9]) for k in KINDS}
    plan = chaos.FaultPlan(seed=seed, delay_max_sec=0.5, **probs)
    calls = [rng.choice(KINDS) for _ in range(500)]
    out = [(k, plan.decide(k)) for k in calls]
    out.append(round(plan.draw_delay(), 12))
    return out, dict(plan.counts), plan.total_injected()


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_fault_plans_draw_the_references_pattern(seed):
    assert _plan_trace("port", seed) == _plan_trace("ref", seed)


class Recorder:
    """A stand-in inner session: answers 200 and logs what reached it."""

    def __init__(self, chaos):
        self.chaos = chaos
        self.seen = []

    def post(self, url, json=None, timeout=None):  # noqa: A002
        self.seen.append((url, json))
        return self.chaos._FakeResponse(200, {"ok": True, "n": len(self.seen)})


def _session_trace(side, seed):
    chaos, _, metrics, _ = SIDES[side]
    plan = chaos.FaultPlan(seed=seed, drop_request=0.1, drop_response=0.1, http_500=0.1,
                           duplicate_result=0.2, delay=0.1, delay_max_sec=0.2)
    registry = metrics.MetricsRegistry()
    slept = []
    inner = Recorder(chaos)
    session = chaos.ChaosSession(inner, plan, registry=registry, sleep=slept.append)
    out = []
    for i in range(300):
        path = ("/v1/leases", "/v1/results", "/v1/jobs", "/v1/workflows", "/v1/x")[i % 5]
        try:
            resp = session.post(f"http://c{path}", json={"i": i})
            out.append((resp.status_code, resp.json()))
        except chaos.ChaosTransportError as exc:
            out.append(("transport", str(exc)))
    text = registry.render()
    return out, inner.seen, [round(s, 12) for s in slept], dict(plan.counts), text


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_sessions_inject_alike_and_count_what_they_inject(seed):
    port, ref = _session_trace("port", seed), _session_trace("ref", seed)
    assert port == ref
    counts, text = port[3], port[4]
    parsed = port_metrics.parse_exposition(text)["chaos_faults_injected_total"]
    assert sum(v for _, v in parsed) == sum(counts.values()) > 0


def _loopback_trace(side):
    chaos, config, _, ctrl_cls = SIDES[side]
    c = ctrl_cls(sched=config.SchedConfig(max_pending=3),
                 flow=config.FlowConfig(cache_enabled=False))
    s = chaos.LoopbackSession(c)
    out = []

    def post(path, body):
        resp = s.post(f"http://loopback{path}", json=body)
        try:
            out.append((path, resp.status_code, resp.json()))
        except ValueError:
            out.append((path, resp.status_code, None))
        return resp

    for i in range(4):
        post("/v1/jobs", {"op": "echo", "payload": {"i": i}, "job_id": f"j{i}",
                          "tenant": "acme", "priority": 5})
    post("/v1/jobs", {"op": "echo", "payload": {}, "max_attempts": "x"})
    lease = post("/v1/leases", {"agent": "a", "capabilities": {"ops": ["echo"]},
                                "max_tasks": 2}).json()
    for t in lease["tasks"]:
        post("/v1/results", {"lease_id": lease["lease_id"], "job_id": t["id"],
                             "job_epoch": t["job_epoch"], "status": "succeeded",
                             "result": {"ok": True}})
    post("/v1/results", {"lease_id": lease["lease_id"], "job_id": "j0", "job_epoch": 0,
                         "status": "succeeded"})
    post("/v1/leases", {"agent": "a", "max_tasks": 0, "draining": True})
    post("/v1/workflows", {"workflow_id": "wf-1", "stages": [{"name": "a", "op": "echo"}]})
    post("/v1/workflows", {"stages": "bad"})
    post("/v1/nope", {})
    out.append(c.counts())
    c.close()
    return [[o[0], o[1], _strip(o[2])] if isinstance(o, tuple) else o for o in out]


def _strip(body):
    if isinstance(body, dict):
        return {k: _strip(v) for k, v in body.items() if k not in ("lease_id", "trace")}
    if isinstance(body, list):
        return [_strip(v) for v in body]
    return body


def test_the_loopback_answers_as_the_reference():
    assert _loopback_trace("port") == _loopback_trace("ref")


def test_the_port_agent_drains_through_chaos_applying_each_job_once():
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.config import AgentConfig, Config

    c = Controller(lease_ttl_sec=2.0, sweep_interval_sec=0.05, requeue_delay_sec=0.0,
                   flow=port_config.FlowConfig(cache_enabled=False))
    ids = [c.submit("echo", {"i": i}) for i in range(30)]
    plan = port_chaos.FaultPlan(seed=9, drop_request=0.1, drop_response=0.1, http_500=0.1,
                                duplicate_result=0.2)
    registry = port_metrics.MetricsRegistry()
    agent = Agent(Config(agent=AgentConfig(
        controller_url="http://loopback", agent_name="chaos", tasks=("echo",),
        idle_sleep_sec=0.001, error_backoff_sec=0.001, retry_base_sec=0.001,
        retry_max_sec=0.01, pipeline_depth=0)),
        session=port_chaos.ChaosSession(port_chaos.LoopbackSession(c), plan,
                                        registry=registry))
    agent._profile = {}
    # A lease whose response the plan drops stays leased until its 2 s TTL
    # expires, and a job can lose several leases in a row: the drain is
    # bounded by the clock, which sets those expiries, not by a count of
    # steps, whose pace a loaded host changes.
    deadline = time.monotonic() + 120.0
    while not (c.drained() and not len(agent.spool)) and time.monotonic() < deadline:
        agent.step()
    assert c.drained()
    snaps = [c.job_snapshot(j) for j in ids]
    assert all(s["state"] == "succeeded" and s["result"]["echo"] == {"i": i}
               for i, s in enumerate(snaps))
    billed = c.usage.job_billed_attempts()
    assert [billed.get(j) for j in ids] == [1] * len(ids)
    injected = port_metrics.parse_exposition(registry.render())["chaos_faults_injected_total"]
    assert sum(v for _, v in injected) == plan.total_injected() > 0
    assert plan.counts.get("duplicate_result", 0) > 0
