"""The port's tracing (``agent_tpu_torch.obs.trace``) against the
reference's: the span ring, the exporters and the wire dicts, with the
expectations of ``tests/test_trace.py``; and the port's agent draining
jobs of the reference's ``Controller`` (``chaos.LoopbackSession``) into one
complete causal span tree per job, stage/queue/execute/post parented to
the controller's lease span, assembled by the reference's ``TraceStore``.
Every comparison here is exact (no tolerance): spans are dicts of ids and
strings, and the times are compared only by order."""

import json
import threading
import time

import pytest

from agent_tpu.chaos import LoopbackSession
from agent_tpu.controller.core import Controller
from agent_tpu.obs import trace as ref_trace
from agent_tpu_torch.agent.app import Agent
from agent_tpu_torch.agent.pipeline import PipelineRunner
from agent_tpu_torch.config import AgentConfig, Config
from agent_tpu_torch.obs import trace as obs_trace
from agent_tpu_torch.obs.trace import (
    SpanBuffer,
    TraceContext,
    assemble,
    current,
    from_jsonl,
    make_span,
    new_span_id,
    phase_breakdown,
    to_chrome_trace,
    to_jsonl,
    use_context,
    validate_chrome_trace,
)


@pytest.fixture(autouse=True)
def _tracing_on():
    """Tracing on in both packages for every test here, whatever the env;
    the env-driven default is restored afterwards."""
    obs_trace.set_enabled(True)
    ref_trace.set_enabled(True)
    yield
    obs_trace.set_enabled(None)
    ref_trace.set_enabled(None)


def _span(trace_id="t1", span_id=None, parent=None, name="x", **kw):
    return make_span(name, trace_id, parent, span_id=span_id or new_span_id(),
                     start_mono=0.0, duration_s=kw.pop("duration_s", 0.001), **kw)


def _agent(controller, name="trace-agent", tasks=("echo",), max_tasks=2, session=None,
           runtime=None):
    cfg = Config(agent=AgentConfig(controller_url="http://127.0.0.1:9", agent_name=name,
                                   tasks=tasks, max_tasks=max_tasks, idle_sleep_sec=0.0))
    agent = Agent(config=cfg, session=session or LoopbackSession(controller), runtime=runtime)
    agent._profile = {"tier": "test"}
    return agent


def _drain_serial(controller, n_steps=10, **kw):
    agent = _agent(controller, **kw)
    agent.run(max_steps=n_steps)
    return agent


# ---- the span ring ----

class TestSpanBuffer:
    def test_ring_is_bounded_and_counts_drops(self):
        buf = SpanBuffer(capacity=8)
        for i in range(100):
            buf.add(_span(span_id=f"s{i}"))
        assert len(buf) == 8
        assert buf.dropped == 92
        assert [s["span_id"] for s in buf.spans()] == [f"s{i}" for i in range(92, 100)]

    def test_drain_and_requeue(self):
        buf = SpanBuffer(capacity=8)
        buf.add(_span(span_id="a"))
        buf.add(_span(span_id="b"))
        taken = buf.drain()
        assert [s["span_id"] for s in taken] == ["a", "b"]
        assert len(buf) == 0
        buf.requeue(taken)
        assert len(buf) == 2

    def test_disabled_short_circuits(self):
        obs_trace.set_enabled(False)
        buf = SpanBuffer()
        buf.add(_span())
        assert len(buf) == 0

    def test_malformed_spans_rejected(self):
        buf = SpanBuffer()
        buf.add({"span_id": "x"})
        buf.add({"trace_id": "t"})
        buf.add("not a span")
        assert len(buf) == 0

    def test_span_objects_go_on_the_wire(self):
        buf = SpanBuffer()
        buf.add(obs_trace.Span(trace_id="t", span_id="s", name="n"))
        (wire,) = buf.drain()
        assert wire == ref_trace.Span(trace_id="t", span_id="s", name="n").to_wire()


@pytest.mark.parametrize("env,want", [(None, True), ("", True), ("1", True), ("on", True),
                                      ("0", False), ("false", False), ("off", False)])
def test_trace_enabled_env_matches_the_reference(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("TRACE_ENABLED", raising=False)
    else:
        monkeypatch.setenv("TRACE_ENABLED", env)
    obs_trace.set_enabled(None)
    ref_trace.set_enabled(None)
    assert obs_trace.enabled() is ref_trace.enabled() is want


def test_make_span_wire_dict_matches_the_reference_key_for_key():
    kw = dict(start_mono=12.5, duration_s=0.25, process="agent:a", span_id="s1",
              attributes={"op": "echo"})
    ours = make_span("execute", "job-1", "lease-span", **kw)
    ref = ref_trace.make_span("execute", "job-1", "lease-span", **kw)
    assert list(ours) == list(ref)
    assert {k: v for k, v in ours.items() if k != "start_wall"} == \
        {k: v for k, v in ref.items() if k != "start_wall"}
    assert abs(ours["start_wall"] - ref["start_wall"]) < 1.0
    store = ref_trace.TraceStore()
    assert store.add(ours)  # the reference store ingests it unchanged


def test_ambient_context_nests_and_restores():
    assert current() is None
    outer = TraceContext(trace_id="t", parent_span_id="p")
    with use_context(outer):
        with use_context(TraceContext(trace_id="t2")):
            assert current().trace_id == "t2"
        assert current() is outer
    assert current() is None


# ---- assembly and exporters ----

class TestExporters:
    def test_jsonl_round_trip(self):
        spans = [_span(span_id="a"), _span(span_id="b", parent="a")]
        back = from_jsonl(to_jsonl(spans))
        assert back == [json.loads(json.dumps(s)) for s in spans]
        assert to_jsonl(spans) == ref_trace.to_jsonl(spans)

    def test_chrome_trace_schema_valid(self):
        spans = [_span(span_id="a", process="controller"),
                 _span(span_id="b", parent="a", process="agent:w1")]
        ct = to_chrome_trace(spans)
        assert validate_chrome_trace(ct) == []
        xs = [e for e in ct["traceEvents"] if e["ph"] == "X"]
        ms = [e for e in ct["traceEvents"] if e["ph"] == "M"]
        assert len(xs) == 2 and len(ms) == 2
        assert xs[0]["pid"] != xs[1]["pid"]
        assert all(e["dur"] >= 0 and e["ts"] > 0 for e in xs)
        assert xs[1]["args"]["parent_span_id"] == "a"
        assert ct == ref_trace.to_chrome_trace(spans)

    def test_chrome_trace_open_span_exports_incomplete(self):
        span = _span(span_id="a")
        span["duration_ms"] = None
        ct = to_chrome_trace([span])
        assert validate_chrome_trace(ct) == []
        (x,) = [e for e in ct["traceEvents"] if e["ph"] == "X"]
        assert x["dur"] == 0 and x["args"]["incomplete"] is True

    @pytest.mark.parametrize("bad", [[], {"traceEvents": "nope"},
                                     {"traceEvents": [{"ph": "X", "name": "x", "pid": 1}]},
                                     {"traceEvents": [{"ph": "B", "name": "x", "pid": 1}]},
                                     {"traceEvents": [{"ph": "X", "name": "x", "pid": 1,
                                                       "ts": 0, "dur": -1}]}])
    def test_validate_chrome_trace_catches_garbage(self, bad):
        assert validate_chrome_trace(bad) != []
        assert validate_chrome_trace(bad) == ref_trace.validate_chrome_trace(bad)

    def test_assemble_and_phase_breakdown_match_the_reference_store(self):
        store = ref_trace.TraceStore()
        root = store.open("job-1", "submit", start_clock=0.0)
        store.add(_span(trace_id="job-1", parent=root, name="execute", duration_s=0.2))
        store.add(_span(trace_id="job-1", parent="missing", name="post"))
        store.finish("job-1", root, 0.5)
        spans = store.spans("job-1")
        ours, ref = assemble("job-1", spans), store.assemble("job-1")
        assert ours == ref
        assert ours["orphans"] and not ours["complete"]
        line = phase_breakdown(ours)
        assert line == ref_trace.phase_breakdown(ref)
        assert "job-1" in line and "execute 200.0ms" in line and "total 500.0ms" in line


# ---- the port's agent against the reference controller ----

def _by_name(t):
    out = {}
    for s in t["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_loopback_drain_yields_causal_span_tree():
    """Each drained job's trace is one complete tree: the controller's
    submit root with its lease, and the port agent's stage/execute/post
    parented to the lease span; execute before post on the timeline."""
    c = Controller()
    jids = [c.submit("echo", {"i": i}) for i in range(3)]
    _drain_serial(c)
    assert c.drained()
    for jid in jids:
        t = c.trace_json(jid)
        assert t is not None and t["complete"], t
        assert t["orphans"] == [] and t["open_spans"] == []
        by_name = _by_name(t)
        for name in ("submit", "sched.decide", "lease", "stage", "execute", "post", "apply"):
            assert name in by_name, (name, sorted(by_name))
        root = by_name["submit"][0]
        assert root["span_id"] == t["root_span_id"] and root["parent_span_id"] is None
        lease = by_name["lease"][0]
        assert lease["parent_span_id"] == root["span_id"]
        for phase in ("stage", "execute", "post"):
            (span,) = by_name[phase]
            assert span["parent_span_id"] == lease["span_id"]
            assert span["process"] == "agent:trace-agent"
        names = [s["name"] for s in t["spans"]]
        assert names.index("execute") < names.index("post")
        assert assemble(jid, c.traces.spans(jid)) == t


SMALL_F32 = {"d_model": 32, "n_heads": 2, "n_layers": 1, "d_ff": 64, "max_len": 64,
             "n_classes": 8, "dtype": "float32"}


def test_pipelined_drain_adds_the_queue_span():
    """The pipelined runner's phases from its own clocks, each once, under
    the lease span: stage, queue, execute and post for a phased op
    (map_classify_tpu on a CPU runtime), queue, execute and post for a
    whole one (echo)."""
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    c = Controller()
    classify = [c.submit("map_classify_tpu", {"texts": [f"row {i}", "two"], "topk": 2,
                                              "model_config": SMALL_F32,
                                              "allow_fallback": False}) for i in range(3)]
    echo = [c.submit("echo", {"i": i}) for i in range(2)]
    agent = _agent(c, name="pipe-agent", tasks=("echo", "map_classify_tpu"),
                   runtime=TorchRuntime(device="cpu"))
    agent.post_session_factory = lambda: LoopbackSession(c)

    def stop():
        deadline = time.monotonic() + 30
        while not c.drained() and time.monotonic() < deadline:
            time.sleep(0.01)
        agent.running = False

    watcher = threading.Thread(target=stop, daemon=True)
    watcher.start()
    PipelineRunner(agent, depth=2).run()
    watcher.join(timeout=10)
    assert not watcher.is_alive() and c.drained()
    for jids, phases in ((classify, ("stage", "queue", "execute", "post")),
                         (echo, ("queue", "execute", "post"))):
        for jid in jids:
            t = c.trace_json(jid)
            assert t["complete"], t
            by_name = _by_name(t)
            (lease,) = by_name["lease"]
            assert {n for n in by_name if by_name[n][0]["process"] == "agent:pipe-agent"} \
                == set(phases)
            for phase in phases:
                (span,) = by_name[phase]
                assert span["parent_span_id"] == lease["span_id"]
            assert by_name["post"][0]["attributes"]["finalize_ms"] >= 0


def test_task_wire_carries_trace_context_only_when_enabled():
    c = Controller()
    jid = c.submit("echo", {})
    agent = _agent(c)
    lease_id, (task,) = agent.lease_once()
    assert agent.task_trace(task) == (jid, task["trace"]["span_id"])
    ctx = agent.task_context(task, jid, lease_id)
    assert ctx.tags["trace"]["span_id"] == task["trace"]["span_id"]

    obs_trace.set_enabled(False)
    ref_trace.set_enabled(False)
    c2 = Controller()
    jid2 = c2.submit("echo", {})
    agent2 = _agent(c2)
    lease_id2, (task2,) = agent2.lease_once()
    assert "trace" not in task2 and agent2.task_trace(task2) == (None, None)
    agent2.run_task(lease_id2, task2)
    assert len(agent2.tracer) == 0
    assert c2.trace_json(jid2) is None


def test_trace_disabled_drain_still_clean():
    """TRACE_ENABLED=0 on both sides: the drain completes, no span
    anywhere, and the result's trace tags carry no span id."""
    obs_trace.set_enabled(False)
    ref_trace.set_enabled(False)
    c = Controller()
    jid = c.submit("echo", {"x": 1})
    agent = _drain_serial(c, n_steps=4)
    assert c.drained()
    assert len(agent.tracer) == 0
    assert c.trace_json(jid) is None and c.traces_json() == []
    trace = c.job_snapshot(jid)["result"]["trace"]
    assert "span_id" not in trace and trace["job_id"] == jid


def test_agent_tracing_off_ships_no_span_to_a_tracing_controller():
    """The agent's own switch: a controller that mints trace context gets
    back only its own spans."""
    c = Controller()
    jid = c.submit("echo", {"x": 1})
    obs_trace.set_enabled(False)
    agent = _drain_serial(c, n_steps=4)
    assert c.drained() and len(agent.tracer) == 0
    procs = {s["process"] for s in c.traces.spans(jid)}
    assert not [p for p in procs if p.startswith("agent:")]


def test_fenced_result_spans_still_ingested():
    """A stale-epoch (fenced) result's agent spans still land on the
    timeline: the execution happened, only its application was refused."""
    c = Controller()
    c.inject("stale_epoch")
    jid = c.submit("echo", {})
    agent = _drain_serial(c, n_steps=1)
    assert c.job_snapshot(jid)["state"] != "succeeded"
    assert c.stale_results == 1
    agent.push_metrics()
    agent_spans = [s for s in c.traces.spans(jid) or [] if s["process"].startswith("agent:")]
    assert any(s["name"] == "execute" for s in agent_spans)


class _Resp:
    def __init__(self, status, body):
        self.status_code, self._body = status, body

    def json(self):
        return self._body


class _FailFirstResult:
    """LoopbackSession whose first result post answers 503; records every
    span each body carried."""

    def __init__(self, controller):
        self.inner, self.failed, self.shipped = LoopbackSession(controller), False, []

    def post(self, url, json=None, timeout=None):  # noqa: A002
        spans = json.get("spans") or (json.get("metrics") or {}).get("spans") or []
        if url.endswith("/v1/results") and not self.failed:
            self.failed = True
            return _Resp(503, {"error": "unavailable"})
        self.shipped += [s["span_id"] for s in spans]
        return self.inner.post(url, json=json, timeout=timeout)


def test_spans_requeued_after_a_503_arrive_once():
    """The spool path: the spans of a failed result post are requeued,
    ship with the next lease, and each reaches the controller once; the
    redelivered result's trace is complete with a result.redeliver span."""
    c = Controller()
    jid = c.submit("echo", {"x": 1})
    session = _FailFirstResult(c)
    agent = _agent(c, session=session)
    agent.step()
    assert len(agent.spool) == 1 and len(agent.tracer) == 3  # stage, execute, post
    agent.step()
    agent.push_metrics()
    assert c.drained()
    assert len(session.shipped) == len(set(session.shipped))
    t = c.trace_json(jid)
    assert t["complete"], t
    by_name = _by_name(t)
    for phase in ("stage", "execute", "post", "result.redeliver"):
        assert len(by_name[phase]) == 1, phase
    assert by_name["result.redeliver"][0]["attributes"]["outcome"] == "delivered"
