"""The agent's parts against the reference's: the config read from the same
environment, the staging autotune's arithmetic and gate, the result spool
(bounded ring, JSONL persistence, torn lines), the metrics snapshot's shape,
the worker profile's cpu block, and the urllib session's response contract
(status, JSON, text; a transport failure raises)."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from agent_tpu.agent.spool import ResultSpool as JaxSpool
from agent_tpu.config import AgentConfig as JaxAgentConfig
from agent_tpu.config import SizingConfig as JaxSizingConfig
from agent_tpu.data import staging as jax_staging
from agent_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from agent_tpu.sizing.profile import detect_cpu as jax_detect_cpu
from agent_tpu_torch.agent.spool import ResultSpool
from agent_tpu_torch.config import AgentConfig, SizingConfig
from agent_tpu_torch.data import staging
from agent_tpu_torch.obs.metrics import MetricsRegistry
from agent_tpu_torch.sizing.profile import build_worker_profile, detect_cpu
from agent_tpu_torch.utils.http import UrllibSession

ENV = {
    "CONTROLLER_URL": "http://127.0.0.1:8080/", "AGENT_NAME": "a1", "HTTP_TIMEOUT_SEC": "3",
    "IDLE_SLEEP_SEC": "0.5", "MAX_TASKS": "0", "LEASE_TIMEOUT_MS": "900",
    "ERROR_BACKOFF_SEC": "bad", "TASKS": "echo, map_classify_tpu,echo",
    "AGENT_LABELS": "zone=a,gpu", "PIPELINE_DEPTH": "3", "STAGE_WORKERS": "2",
    "STAGE_AUTOTUNE": "off", "FEED_DOUBLE_BUFFER": "no", "WIRE_BINARY": "0",
    "RETRY_BASE_SEC": "0.1", "RETRY_MAX_SEC": "5", "RETRY_DEADLINE_SEC": "7",
    "RESULT_SPOOL_PATH": "/tmp/spool.jsonl", "RESULT_SPOOL_MAX": "-3",
    "CPU_RESERVED_CORES_CAP": "2", "CPU_PIPELINE_FACTOR": "1.5",
}


@pytest.mark.parametrize("env", [{}, ENV], ids=["defaults", "set"])
def test_config_reads_the_reference_environment(monkeypatch, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = AgentConfig.from_env(), JaxAgentConfig.from_env()
    for field in got.__dataclass_fields__:
        assert getattr(got, field) == getattr(want, field), field
    assert SizingConfig.from_env().__dict__ == JaxSizingConfig.from_env().__dict__


@pytest.mark.parametrize("stage_s,exec_s,cap", [
    (0.0, 1.0, 4), (1.0, 0.0, 4), (0.3, 0.1, 4), (0.3, 0.1, 2), (0.05, 0.1, 4), (9.0, 1.0, 4),
])
def test_autotune_wants_what_the_reference_wants(stage_s, exec_s, cap):
    assert staging.desired_workers(stage_s, exec_s, cap) == \
        jax_staging.desired_workers(stage_s, exec_s, cap)


def test_adjustable_gate_limits_and_widens():
    gate = staging.AdjustableGate(1)
    assert gate.acquire(timeout=0.01) and not gate.acquire(timeout=0.01)
    gate.set_limit(2)
    assert gate.acquire(timeout=0.01)
    gate.release()
    gate.release()
    assert gate.limit == 2


def test_phase_ratio_sampler_reads_the_registry():
    reg = MetricsRegistry()
    hist = reg.histogram("task_phase_seconds", "", ("op", "phase"))
    sampler = staging.PhaseRatioSampler(reg)
    assert sampler.sample() is None
    for _ in range(3):
        hist.observe(0.3, op="x", phase="stage")
        hist.observe(0.1, op="x", phase="execute")
    stage_s, exec_s = sampler.sample()
    assert stage_s == pytest.approx(0.3) and exec_s == pytest.approx(0.1)
    assert sampler.sample() is None  # no fresh samples since


def test_metrics_snapshot_has_the_reference_shape():
    def fill(reg):
        reg.counter("tasks_total", "t", ("op", "status")).inc(op="echo", status="ok")
        reg.gauge("queue_depth", "q", ("queue",)).set(3, queue="staged")
        reg.histogram("task_phase_seconds", "h", ("op", "phase")).observe(
            0.02, op="echo", phase="stage")
        return reg.snapshot()

    got, want = fill(MetricsRegistry()), fill(JaxRegistry())
    assert got == want
    with pytest.raises(ValueError):
        MetricsRegistry().counter("x").inc(-1)


def _spool_ops(spool):
    for i in range(5):
        spool.put("L", f"j{i}", i, "succeeded", result={"i": i}, op="echo")
    spool.pop_head()
    return [ResultSpool.wire_body(e) for e in spool.entries()]


def test_spool_ring_and_persistence_match_the_reference(tmp_path):
    got = _spool_ops(ResultSpool(capacity=3, path=str(tmp_path / "p.jsonl")))
    want = _spool_ops(JaxSpool(capacity=3, path=str(tmp_path / "j.jsonl")))
    assert got == want and [b["job_id"] for b in got] == ["j3", "j4"]
    reloaded = ResultSpool(capacity=3, path=str(tmp_path / "p.jsonl"))
    assert [ResultSpool.wire_body(e) for e in reloaded.entries()] == got
    with open(tmp_path / "p.jsonl", "a") as f:
        f.write('{"torn": ')
    torn = ResultSpool(capacity=3, path=str(tmp_path / "p.jsonl"))
    assert len(torn) == 2 and torn.load_skipped == 1


def test_worker_profile_cpu_block_and_no_tpu_block():
    profile = build_worker_profile()
    assert profile["cpu"] == jax_detect_cpu(JaxSizingConfig()) == detect_cpu()
    assert profile["schema"] == "worker_profile/v2" and "tpu" not in profile
    assert set(profile["gpu"]) >= {"gpu_present", "gpus", "max_gpu_workers"}
    assert profile["limits"] == {"max_payload_bytes": 262_144, "max_tokens": 2_048}


class _Echo(BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802 — http.server's name
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        code = body.get("code", 200)
        self.send_response(code)
        self.end_headers()
        if code != 204:
            self.wfile.write(b"not json" if body.get("text") else json.dumps(body).encode())

    def log_message(self, *args):
        pass


@pytest.fixture
def echo_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_urllib_session_answers_like_requests(echo_server):
    s = UrllibSession()
    ok = s.post(echo_server + "/v1/leases", json={"a": [1, "☕"]}, timeout=5)
    assert ok.status_code == 200 and ok.json() == {"a": [1, "☕"]}
    assert s.post(echo_server, json={"code": 204}, timeout=5).status_code == 204
    err = s.post(echo_server, json={"code": 503}, timeout=5)
    assert err.status_code == 503 and err.json()["code"] == 503
    text = s.post(echo_server, json={"code": 400, "text": True}, timeout=5)
    assert text.status_code == 400 and text.text == "not json"
    with pytest.raises(ValueError):
        text.json()
    with pytest.raises(OSError):
        s.post("http://127.0.0.1:9/v1/leases", json={}, timeout=5)
