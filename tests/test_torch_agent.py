"""The port's agent (``agent_tpu_torch.agent``) against the reference's
controller, in-process, on a CPU runtime at a small f32 config.

A ``map_classify_tpu`` CSV job (plus host-op jobs) is drained twice — by the
serial ``step()`` loop over ``agent_tpu.chaos.LoopbackSession``, and by the
``PipelineRunner`` over a real ``ControllerServer`` with the port's urllib
session — and held to the reference ``Agent``'s drain of the same jobs:
top-k within ``SCORE_TOL`` with the tie rule of
``tests/test_torch_map_classify.py``, host-op results exactly. Also: ``b1``
negotiation, the ``UnknownOp`` result, malformed-task salvage, a 503 on a
result post spooled and redelivered exactly once, ``request_drain``
releasing the unstarted remainder of a lease, a host-ops-only agent that
never builds a runtime, a device-op agent that fails at start without CUDA,
and the entry point's exit codes. Serving: ``serve_summarize`` jobs that
the reference controller's ``/v1/infer`` front door coalesced are served
by the port's agent (serial loop, and the pipelined runner's continuous
loop with several jobs sharing one decode engine) with the reference
agent's answers, and a job whose decode is in flight when the agent stops
still posts its answers."""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from agent_tpu.agent.app import Agent as JaxAgent
from agent_tpu.chaos import LoopbackSession
from agent_tpu.config import AgentConfig as JaxAgentConfig
from agent_tpu.config import Config as JaxConfig
from agent_tpu.config import FlowConfig
from agent_tpu.config import ServeConfig as JaxServeConfig
from agent_tpu.controller import Controller, ControllerServer
from agent_tpu.ops.serve_infer import reset_engines as jax_reset_engines
from agent_tpu.runtime.runtime import get_runtime as jax_get_runtime
from agent_tpu_torch.agent import app
from agent_tpu_torch.agent.app import Agent
from agent_tpu_torch.agent.pipeline import PipelineRunner
from agent_tpu_torch.config import AgentConfig, Config
from agent_tpu_torch.ops import serve_infer
from agent_tpu_torch.runtime.runtime import TorchRuntime
from tests.test_torch_map_classify import _assert_topk_agree

ROOT = Path(__file__).resolve().parent.parent
# Where a session stands in for the controller: a local port nothing listens
# on, so a stray request fails at once and never leaves the host.
LOCAL = "http://127.0.0.1:9"
SMALL_F32 = {"d_model": 32, "n_heads": 2, "n_layers": 1, "d_ff": 64, "max_len": 64,
             "n_classes": 40, "dtype": "float32"}
CLASSIFY_EXTRA = {"text_field": "text", "result_format": "columnar", "allow_fallback": False,
                  "topk": 5, "model_config": SMALL_F32}
N_ROWS, SHARD = 300, 100
HOST_JOBS = [
    ("echo", {"x": [1, "two"]}),
    ("risk_accumulate", {"values": [1.5, -2.0, 3.25, 7.0]}),
    ("map_tokenize", {"items": ["a b", "cde"], "chunk_size": 2}),
]
VOLATILE = ("duration_ms", "timings", "trace", "usage", "elapsed_ms", "compute_time_ms")
TASKS = ("map_classify_tpu", "read_csv_shard") + tuple(op for op, _ in HOST_JOBS)


@pytest.fixture(scope="module")
def drain_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("drain") / "drain.csv"
    with open(path, "w") as f:
        f.write("id,text,risk\n")
        for i in range(N_ROWS):
            f.write(f'{i},"drain record {i} with a payload of text",{i % 89}\n')
    return str(path)


@pytest.fixture(scope="module")
def torch_rt():
    return TorchRuntime(device="cpu")


def _submit(controller, csv_path):
    """The drain's jobs -> (classify shard ids, {op: host job id})."""
    shards, _ = controller.submit_csv_job(csv_path, total_rows=N_ROWS, shard_size=SHARD,
                                          map_op="map_classify_tpu",
                                          extra_payload=CLASSIFY_EXTRA)
    host = {op: controller.submit(op, dict(payload)) for op, payload in HOST_JOBS}
    host["read_csv_shard"] = controller.submit(
        "read_csv_shard", {"source_uri": csv_path, "start_row": 290, "shard_size": 20})
    return shards, host


def _config(url, tasks=TASKS, **kw):
    return Config(agent=AgentConfig(controller_url=url, agent_name="port-agent", tasks=tasks,
                                    idle_sleep_sec=0.01, error_backoff_sec=0.01,
                                    max_tasks=kw.pop("max_tasks", 4), **kw))


def _serial_drain(agent, controller, max_steps=50):
    for _ in range(max_steps):
        agent.step()
        if controller.drained():
            return
    raise AssertionError(f"not drained: {controller.counts()}")


def _pipelined_drain(agent, controller, timeout=60.0):
    """Run the pipelined runner until the controller drains."""
    def watch():
        deadline = time.monotonic() + timeout
        while not controller.drained() and time.monotonic() < deadline:
            time.sleep(0.01)
        agent.running = False

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    PipelineRunner(agent, depth=2).run()
    watcher.join(timeout=10)
    assert not watcher.is_alive() and controller.drained(), controller.counts()


@pytest.fixture(scope="module")
def reference_results(drain_csv):
    """The reference agent's drain of the same jobs on the JAX CPU runtime."""
    controller = Controller()
    shards, host = _submit(controller, drain_csv)
    cfg = JaxConfig(agent=JaxAgentConfig(controller_url=LOCAL, agent_name="ref",
                                         tasks=TASKS, idle_sleep_sec=0.01, max_tasks=4))
    agent = JaxAgent(config=cfg, session=LoopbackSession(controller),
                     runtime=jax_get_runtime())
    agent._profile = {"tier": "test"}
    _serial_drain(agent, controller)
    results = controller.results()
    return [results[j] for j in shards], {op: results[j] for op, j in host.items()}


def _check_against_reference(controller, shards, host, reference_results):
    assert controller.counts().get("failed", 0) == 0, controller.counts()
    results = controller.results()
    ref_shards, ref_host = reference_results
    for job_id, want in zip(shards, ref_shards):
        got = results[job_id]
        assert got["ok"] and got["device"] == "cpu" and "fallback" not in got
        assert got["n_rows"] == want["n_rows"] == SHARD
        _assert_topk_agree(got["indices"], got["scores"], want["indices"], want["scores"])
    for op, job_id in host.items():
        got = {k: v for k, v in results[job_id].items() if k not in VOLATILE}
        want = {k: v for k, v in ref_host[op].items() if k not in VOLATILE}
        assert got == want, op


def test_serial_drain_over_loopback_matches_the_reference(drain_csv, torch_rt,
                                                          reference_results):
    controller = Controller()
    shards, host = _submit(controller, drain_csv)
    agent = Agent(_config(LOCAL), session=LoopbackSession(controller),
                  runtime=torch_rt)
    agent._profile = {"tier": "test"}
    _serial_drain(agent, controller)
    assert agent.wire_format == "b1"
    _check_against_reference(controller, shards, host, reference_results)
    assert agent.m_tasks.value(op="map_classify_tpu", status="succeeded") == N_ROWS // SHARD


def test_pipelined_drain_over_http_matches_the_reference(drain_csv, torch_rt,
                                                         reference_results):
    controller = Controller()
    shards, host = _submit(controller, drain_csv)
    with ControllerServer(controller) as server:
        agent = Agent(_config(server.url), runtime=torch_rt)  # the urllib session
        assert type(agent.session).__name__ == "UrllibSession"
        _pipelined_drain(agent, controller)
    assert agent.wire_format == "b1"
    _check_against_reference(controller, shards, host, reference_results)
    snap = agent.obs.snapshot()
    phases = {s["labels"]["phase"] for s in snap["task_phase_seconds"]["series"]
              if s["labels"]["op"] == "map_classify_tpu"}
    assert phases == {"stage", "queue", "execute", "fetch", "finalize"}
    results = controller.results()
    assert set(results[shards[0]]["timings"]) == {"stage_ms", "queue_ms", "device_ms",
                                                  "fetch_ms", "finalize_ms"}


def test_json_only_controller_keeps_plain_lists(drain_csv, torch_rt):
    controller = Controller()
    shards, _ = controller.submit_csv_job(drain_csv, total_rows=SHARD, shard_size=SHARD,
                                          map_op="map_classify_tpu",
                                          extra_payload=CLASSIFY_EXTRA)
    agent = Agent(_config(LOCAL, wire_binary=False),
                  session=LoopbackSession(controller), runtime=torch_rt)
    agent._profile = {"tier": "test"}
    _serial_drain(agent, controller)
    assert agent.wire_format is None
    assert len(controller.results()[shards[0]]["indices"]) == SHARD


class _Recorder:
    """A session that leases one batch of tasks once, then idles, and
    records every result body."""

    def __init__(self, tasks):
        self.tasks, self.results = list(tasks), []

    def post(self, url, json=None, timeout=None):  # noqa: A002
        if url.endswith("/v1/leases"):
            if json["max_tasks"] and self.tasks:
                tasks, self.tasks = self.tasks, []
                return _Resp(200, {"lease_id": "L1", "tasks": tasks, "wire": "b1"})
            return _Resp(204, None)
        self.results.append(json)
        return _Resp(200, {"accepted": True})


class _Resp:
    def __init__(self, status, body):
        self.status_code, self._body = status, body

    def json(self):
        return self._body


BAD_TASKS = [
    {"id": "unknown-1", "op": "no_such_op", "payload": {}, "job_epoch": 3},
    {"id": "bad-1", "op": "echo", "payload": ["not", "a", "dict"], "job_epoch": 4},
    {"id": "bad-2", "op": "echo", "payload": {"__bin__": "!!"}, "job_epoch": 5},
    {"op": "echo", "payload": {}},  # no id: nothing to report against
    {"id": "ok-1", "op": "echo", "payload": {"v": 1}, "job_epoch": 6},
]


@pytest.mark.parametrize("loop", ["serial", "pipelined"])
def test_unknown_op_and_malformed_tasks(loop):
    session = _Recorder(BAD_TASKS)
    agent = Agent(_config(LOCAL, tasks=("echo",)), session=session)
    agent._profile = {"tier": "test"}
    agent.post_session_factory = lambda: session
    if loop == "serial":
        agent.step()
    else:
        def stop():
            deadline = time.monotonic() + 30
            while len(session.results) < 4 and time.monotonic() < deadline:
                time.sleep(0.01)
            agent.running = False

        t = threading.Thread(target=stop, daemon=True)
        t.start()
        PipelineRunner(agent, depth=2).run()
        t.join(timeout=10)
    by_id = {r["job_id"]: r for r in session.results if r["status"] != "released"}
    assert set(by_id) == {"unknown-1", "bad-1", "bad-2", "ok-1"}
    assert by_id["unknown-1"]["status"] == "failed"
    assert by_id["unknown-1"]["error"]["type"] == "UnknownOp"
    assert by_id["unknown-1"]["job_epoch"] == 3
    for jid in ("bad-1", "bad-2"):
        assert by_id[jid]["status"] == "failed" and by_id[jid]["error"]["type"] == "ValueError"
        assert by_id[jid]["job_epoch"] is None  # salvaged by id alone
    assert by_id["ok-1"]["status"] == "succeeded"
    assert by_id["ok-1"]["result"]["echo"] == {"v": 1}


class _FailFirstResult:
    """LoopbackSession whose first result post answers 503."""

    def __init__(self, controller):
        self.inner, self.failed, self.result_posts = LoopbackSession(controller), False, []

    def post(self, url, json=None, timeout=None):  # noqa: A002
        if url.endswith("/v1/results"):
            self.result_posts.append(json["job_id"])
            if not self.failed:
                self.failed = True
                return _Resp(503, {"error": "unavailable"})
        return self.inner.post(url, json=json, timeout=timeout)


def test_503_result_is_spooled_and_redelivered_once():
    controller = Controller()
    job = controller.submit("echo", {"x": 1})
    session = _FailFirstResult(controller)
    agent = Agent(_config(LOCAL, tasks=("echo",)), session=session)
    agent._profile = {"tier": "test"}
    agent.step()
    assert len(agent.spool) == 1 and not controller.drained()
    assert agent.m_post_fail.value(op="echo") == 1
    agent.step()  # the next iteration redelivers before leasing
    assert controller.drained() and len(agent.spool) == 0
    assert session.result_posts == [job, job]
    assert agent.m_redeliveries.value(outcome="delivered") == 1
    assert controller.results()[job]["echo"] == {"x": 1}


class _DrainAfterFirstResult:
    def __init__(self, controller):
        self.inner, self.agent = LoopbackSession(controller), None

    def post(self, url, json=None, timeout=None):  # noqa: A002
        out = self.inner.post(url, json=json, timeout=timeout)
        if url.endswith("/v1/results") and json["status"] == "succeeded":
            self.agent.request_drain("test")
        return out


def test_request_drain_releases_the_rest_of_the_lease():
    controller = Controller()
    jobs = [controller.submit("echo", {"i": i}) for i in range(4)]
    session = _DrainAfterFirstResult(controller)
    agent = Agent(_config(LOCAL, tasks=("echo",), max_tasks=4), session=session)
    agent._profile = {"tier": "test"}
    session.agent = agent
    agent.run(max_steps=5)
    assert agent.draining and agent.tasks_done == 1
    assert agent.m_tasks.value(op="echo", status="released") == 3
    # Released jobs lease again at once, without waiting out the lease TTL.
    other = Agent(_config(LOCAL, tasks=("echo",), max_tasks=4),
                  session=LoopbackSession(controller))
    other._profile = {"tier": "test"}
    _serial_drain(other, controller, max_steps=5)
    assert set(controller.results()) == set(jobs)


def test_host_ops_agent_never_builds_a_runtime(monkeypatch, drain_csv):
    from agent_tpu_torch.runtime import runtime as rt_mod

    def no_runtime(*a, **k):
        raise AssertionError("a host-ops agent built a runtime")

    monkeypatch.setattr(rt_mod, "get_runtime", no_runtime)
    monkeypatch.setattr(rt_mod, "TorchRuntime", no_runtime)
    controller = Controller()
    big = controller.submit("risk_accumulate", {"values": [0.5] * 5000})
    csv_job = controller.submit("read_csv_shard", {"source_uri": drain_csv, "shard_size": 3})
    with ControllerServer(controller) as server:
        agent = Agent(_config(server.url, tasks=("echo", "read_csv_shard", "risk_accumulate")))
        assert agent.runtime is None
        _pipelined_drain(agent, controller)
    assert agent.runtime is None
    results = controller.results()
    assert results[big]["sum"] == 2500.0 and "device" not in results[big]
    assert results[csv_job]["count"] == 3


def test_device_op_agent_fails_at_start_without_cuda(monkeypatch):
    from agent_tpu_torch.runtime import runtime as rt_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(rt_mod, "_runtime", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Agent(_config(LOCAL, tasks=("echo", "map_classify_tpu")))
    monkeypatch.setenv("TASKS", "echo,map_classify_tpu")
    monkeypatch.setenv("CONTROLLER_URL", LOCAL)
    assert app.main() == 1


@pytest.mark.parametrize("tasks", ["none", "echo,no_such_op"])
def test_main_refuses_bad_tasks(monkeypatch, tasks):
    monkeypatch.setenv("TASKS", tasks)
    monkeypatch.setenv("CONTROLLER_URL", LOCAL)
    assert app.main() == 2


def test_entry_point_drains_and_exits_on_sigterm(drain_csv, tmp_path):
    """``python -m agent_tpu_torch.agent.app`` against a real controller:
    it drains host-op jobs, then SIGTERM drains it and it exits 0."""
    controller = Controller()
    jobs = [controller.submit("echo", {"i": 1}),
            controller.submit("read_csv_shard", {"source_uri": drain_csv, "shard_size": 5})]
    env = dict(os.environ, TASKS="echo,read_csv_shard", IDLE_SLEEP_SEC="0.05",
               AGENT_NAME="entry-test", PYTHONPATH=str(ROOT))
    with ControllerServer(controller) as server:
        env["CONTROLLER_URL"] = server.url
        proc = subprocess.Popen([sys.executable, "-m", "agent_tpu_torch.agent.app"], env=env,
                                cwd=str(tmp_path), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.monotonic() + 60
            while not controller.drained() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert controller.drained()
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert proc.returncode == 0, out
    assert "drain requested" in out and "agent drained" in out
    assert set(controller.results()) == set(jobs)


# ---- serving through the reference controller's front door ----

SERVE_S2S = {"d_model": 32, "n_heads": 4, "n_enc_layers": 1, "n_dec_layers": 1, "d_ff": 64,
             "max_src_len": 64, "max_tgt_len": 20, "dtype": "float32"}
# One length bucket (< 64 bytes), so every batch job shares one engine.
SERVE_REQUESTS = [(f"serve request {i} " + "w" * (i % 5), 2 + (5 * i) % 17)
                  for i in range(12)]


def _serve_controller(max_batch=4):
    return Controller(serve=JaxServeConfig(max_wait_ms=0.0, max_batch=max_batch),
                      flow=FlowConfig(cache_enabled=False))


def _submit_serving(controller, requests, num_beams):
    rids = [controller.submit_infer("summarize", text, params={
        "model_config": SERVE_S2S, "max_length": limit, "num_beams": num_beams})
        for text, limit in requests]
    controller._serve_pump()  # the batch jobs exist before any agent leases
    return rids


def _serve_answers(controller, rids):
    controller._serve_pump()
    snaps = [controller.infer_snapshot(rid) for rid in rids]
    assert all(s["state"] == "done" for s in snaps), snaps
    return [{k: s["result"][k] for k in ("summary", "tokens", "steps")} for s in snaps]


def _reference_serving(requests, num_beams):
    jax_reset_engines()
    controller = _serve_controller()
    rids = _submit_serving(controller, requests, num_beams)
    cfg = JaxConfig(agent=JaxAgentConfig(controller_url=LOCAL, agent_name="ref",
                                         tasks=("serve_summarize",), idle_sleep_sec=0.01,
                                         max_tasks=4))
    agent = JaxAgent(config=cfg, session=LoopbackSession(controller),
                     runtime=jax_get_runtime())
    agent._profile = {"tier": "test"}
    _serial_drain(agent, controller)
    return _serve_answers(controller, rids)


def _serving_agent(controller, torch_rt, max_tasks=4):
    serve_infer.reset_engines()
    agent = Agent(_config(LOCAL, tasks=("serve_summarize",), max_tasks=max_tasks),
                  session=LoopbackSession(controller), runtime=torch_rt)
    agent._profile = {"tier": "test"}
    agent.post_session_factory = lambda: LoopbackSession(controller)
    return agent


@pytest.mark.parametrize("num_beams", [1, 2], ids=["greedy", "beam2"])
@pytest.mark.parametrize("loop", ["serial", "pipelined"])
def test_serving_jobs_answer_as_the_reference_agent(torch_rt, loop, num_beams):
    want = _reference_serving(SERVE_REQUESTS, num_beams)
    controller = _serve_controller()
    rids = _submit_serving(controller, SERVE_REQUESTS, num_beams)
    assert len(controller.serve_door.job_ids()) == 3
    agent = _serving_agent(controller, torch_rt)
    if loop == "serial":
        _serial_drain(agent, controller)
    else:
        _pipelined_drain(agent, controller)
        assert len(serve_infer._ENGINES) == 1  # the three jobs shared one engine
        assert agent.m_serve_occupancy.value() == 0
    assert _serve_answers(controller, rids) == want
    assert controller.counts().get("failed", 0) == 0
    assert agent.m_tasks.value(op="serve_summarize", status="succeeded") == 3


def test_in_flight_decode_posts_after_the_agent_stops(torch_rt):
    """The agent stops right after admitting the one job: the runner keeps
    stepping the engine through the stop and the job posts every answer."""
    requests = SERVE_REQUESTS[:8]
    want = _reference_serving(requests, 1)
    controller = _serve_controller(max_batch=8)
    rids = _submit_serving(controller, requests, 1)
    agent = _serving_agent(controller, torch_rt, max_tasks=1)
    fn = agent.handlers["serve_summarize"]
    seen = {}

    def op(payload, ctx=None):
        return fn(payload, ctx)

    for hook in ("stage", "execute", "finalize", "serve_pump", "serve_done", "serve_collect"):
        setattr(op, hook, getattr(fn, hook))

    def admit(state, ctx=None):
        handle = fn.serve_admit(state, ctx)
        seen["live"] = handle["engine"].occupancy
        agent.running = False  # the stop arrives with decode in flight
        return handle

    op.serve_admit = admit
    agent.handlers["serve_summarize"] = op
    runner = threading.Thread(target=PipelineRunner(agent, depth=2).run, daemon=True)
    runner.start()
    runner.join(timeout=60)
    assert not runner.is_alive()
    assert seen["live"] == len(requests)
    assert controller.drained() and controller.counts().get("failed", 0) == 0
    assert _serve_answers(controller, rids) == want


@pytest.mark.parametrize("op", ["serve_classify", "serve_summarize", "serve_prefill",
                                "serve_decode", "summarize_encode", "summarize_decode"])
def test_serving_op_agent_fails_at_start_without_cuda(monkeypatch, op):
    """Each serving op reaches the runtime, so an agent serving it builds
    one on cuda:0 when it starts."""
    from agent_tpu_torch.runtime import runtime as rt_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(rt_mod, "_runtime", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Agent(_config(LOCAL, tasks=("echo", op)))


def test_two_engines_each_step_once_a_pass(torch_rt):
    """Greedy and beam jobs in one drain ride two engines; the continuous
    loop steps each engine once a pass (its steps equal its pumps), and
    every answer is the reference agent's."""
    greedy, beam = SERVE_REQUESTS[:6], SERVE_REQUESTS[6:]
    want = _reference_serving(greedy, 1) + _reference_serving(beam, 2)
    controller = _serve_controller()
    rids = _submit_serving(controller, greedy, 1) + _submit_serving(controller, beam, 2)
    agent = _serving_agent(controller, torch_rt)
    fn = agent.handlers["serve_summarize"]
    pumps = {}

    def op(payload, ctx=None):
        return fn(payload, ctx)

    for hook in ("stage", "execute", "finalize", "serve_admit", "serve_done", "serve_collect"):
        setattr(op, hook, getattr(fn, hook))

    def pump(handle):
        pumps[id(handle["engine"])] = pumps.get(id(handle["engine"]), 0) + 1
        return fn.serve_pump(handle)

    op.serve_pump = pump
    agent.handlers["serve_summarize"] = op
    _pipelined_drain(agent, controller)
    engines = list(serve_infer._ENGINES.values())
    assert len(engines) == 2
    assert sorted(pumps.values()) == sorted(e.steps_run for e in engines)
    assert _serve_answers(controller, rids) == want


# ---- the usage block ----

USAGE_REQUESTS = [("usage request one", 4), ("usage request two", 5)] * 2


def _usage_drain(agent_factory, drain_csv, loop):
    """A read_csv_shard job and two serve_summarize jobs (the second's two
    requests repeat the first's, so they hit the prefix cache) drained by
    the agent ``agent_factory(controller)`` builds -> {job: usage}."""
    controller = _serve_controller(max_batch=2)
    csv_job = controller.submit("read_csv_shard", {"source_uri": drain_csv, "start_row": 10,
                                                    "shard_size": 25})
    controller.submit_infer("summarize", USAGE_REQUESTS[0][0], params={
        "model_config": SERVE_S2S, "max_length": USAGE_REQUESTS[0][1]})
    controller.submit_infer("summarize", USAGE_REQUESTS[1][0], params={
        "model_config": SERVE_S2S, "max_length": USAGE_REQUESTS[1][1]})
    controller._serve_pump()
    agent = agent_factory(controller)
    if loop == "serial":
        _serial_drain(agent, controller)
    else:
        _pipelined_drain(agent, controller)
    rids = [controller.submit_infer("summarize", text, params={
        "model_config": SERVE_S2S, "max_length": limit}) for text, limit in USAGE_REQUESTS[2:]]
    controller._serve_pump()
    if loop == "serial":
        _serial_drain(agent, controller)
    else:
        agent.running = True
        _pipelined_drain(agent, controller)
    _serve_answers(controller, rids)
    results = controller.results()
    serve_jobs = [j for j, r in results.items() if r.get("op") == "serve_summarize"]
    return results[csv_job].get("usage"), sorted(
        (results[j].get("usage") or {} for j in serve_jobs),
        key=lambda u: u.get("cache_hit_rows", 0.0))


@pytest.mark.parametrize("loop", ["serial", "pipelined"])
def test_results_carry_the_op_usage_as_the_reference_agent(torch_rt, drain_csv, loop):
    """The port's agent forwards the op's usage block (rows, and the serving
    ops' cache_hit_rows) into every result, as the reference's agent does in
    both loops, so the reference controller's showback ledger bills it."""
    def reference(controller):
        jax_reset_engines()
        cfg = JaxConfig(agent=JaxAgentConfig(
            controller_url=LOCAL, agent_name="ref", tasks=("read_csv_shard", "serve_summarize"),
            idle_sleep_sec=0.01, max_tasks=4))
        agent = JaxAgent(config=cfg, session=LoopbackSession(controller),
                         runtime=jax_get_runtime())
        agent._profile = {"tier": "test"}
        return agent

    def port(controller):
        agent = _serving_agent(controller, torch_rt)
        agent.handlers = {**agent.handlers, **app.load_ops(["read_csv_shard"])}
        return agent

    want_csv, want_serve = _usage_drain(reference, drain_csv, "serial")
    got_csv, got_serve = _usage_drain(port, drain_csv, loop)
    assert got_csv["rows"] == want_csv["rows"] == 25.0
    keys = ("rows", "cache_hit_rows")
    assert [{k: u.get(k) for k in keys} for u in got_serve] == \
        [{k: u.get(k) for k in keys} for u in want_serve]
    assert got_serve[-1]["cache_hit_rows"] == 2.0
