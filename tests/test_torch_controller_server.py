"""The port's ControllerServer against the reference's, over HTTP on
127.0.0.1, on the CPU: the port's Agent (an explicit CPU runtime, the
pipelined runner) drains a small-width classify CSV and host jobs through
either server with equal results; ``POST /v1/infer`` (blocking, and
``wait: false`` then ``GET /v1/infer/{id}?wait_ms=``) for classify and
summarize, colocated and disaggregated, answers equal to the serve op run
directly on each batch job's payload; the admission 429 carries
retry_after_ms in the reference's shape; and every GET route answers with
the reference's status and keys for the same state. Also the shard-size
hint: the port's ``gpu`` block holds the reference's formula, and the
controller splits a CSV by it."""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import agent_tpu.config as ref_config
from agent_tpu.controller import Controller as RefController
from agent_tpu.controller import ControllerServer as RefServer
from agent_tpu.sizing.profile import _tpu_batch_hints
from agent_tpu_torch import config as port_config
from agent_tpu_torch.agent.app import Agent
from agent_tpu_torch.agent.pipeline import PipelineRunner
from agent_tpu_torch.config import AgentConfig, Config
from agent_tpu_torch.controller import Controller, ControllerServer
from agent_tpu_torch.ops import load_ops, serve_infer
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime
from agent_tpu_torch.sizing import profile as sizing
from tests.test_torch_map_classify import _assert_topk_agree

SMALL_F32 = {"d_model": 32, "n_heads": 2, "n_layers": 1, "d_ff": 64, "max_len": 64,
             "n_classes": 40, "dtype": "float32"}
SERVE_S2S = {"d_model": 32, "n_heads": 4, "n_enc_layers": 1, "n_dec_layers": 1, "d_ff": 64,
             "max_src_len": 128, "max_tgt_len": 8, "dtype": "float32"}
EXTRA = {"text_field": "text", "result_format": "columnar", "allow_fallback": False,
         "topk": 5, "model_config": SMALL_F32}
VOLATILE = ("duration_ms", "timings", "trace", "usage", "elapsed_ms", "compute_time_ms")
SIDES = {"port": (Controller, ControllerServer, port_config),
         "ref": (RefController, RefServer, ref_config)}


def http(url: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            return resp.status, (json.loads(raw) if raw and "json" in ctype else raw.decode())
    except urllib.error.HTTPError as exc:
        raw = exc.read()
        return exc.code, json.loads(raw) if raw else None


@pytest.fixture(scope="module")
def rt():
    return TorchRuntime(device="cpu")


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("drain") / "drain.csv"
    with open(path, "w") as f:
        f.write("id,text,risk\n")
        for i in range(240):
            f.write(f'{i},"drain record {i} with a payload of text",{i % 89}\n')
    return str(path)


def _agent(url, rt, tasks, name="port-agent"):
    return Agent(Config(agent=AgentConfig(controller_url=url, agent_name=name, tasks=tasks,
                                          idle_sleep_sec=0.005, max_tasks=4)), runtime=rt)


def _drain(agent, done, timeout=60.0):
    """The pipelined runner on this thread until ``done()``."""
    def watch():
        deadline = time.monotonic() + timeout
        while not done() and time.monotonic() < deadline:
            time.sleep(0.005)
        agent.running = False

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    PipelineRunner(agent, depth=2).run()
    watcher.join(timeout=10)
    assert done()


def _csv_drain(side, rt, csv_path):
    ctrl_cls, server_cls, config = SIDES[side]
    c = ctrl_cls(flow=config.FlowConfig(cache_enabled=False))
    with server_cls(c) as srv:
        status, out = http(f"{srv.url}/v1/jobs", {
            "source_uri": csv_path, "total_rows": 240, "shard_size": 80,
            "map_op": "map_classify_tpu", "extra_payload": EXTRA})
        assert status == 200
        host = [http(f"{srv.url}/v1/jobs", {"op": op, "payload": payload})[1]["job_id"]
                for op, payload in (("echo", {"x": [1, "two"]}),
                                    ("risk_accumulate", {"values": [1.5, -2.0, 3.25]}),
                                    ("read_csv_shard", {"source_uri": csv_path,
                                                        "start_row": 230, "shard_size": 20}))]
        agent = _agent(srv.url, rt, ("map_classify_tpu", "echo", "risk_accumulate",
                                     "read_csv_shard"))
        _drain(agent, c.drained)
        snaps = [http(f"{srv.url}/v1/jobs/{j}")[1] for j in out["job_ids"] + host]
    assert all(s["state"] == "succeeded" and s["attempts"] == 1 for s in snaps), snaps
    return [{k: v for k, v in s["result"].items() if k not in VOLATILE} for s in snaps]


def test_the_agent_drains_either_server_alike(rt, csv_path):
    got, want = _csv_drain("port", rt, csv_path), _csv_drain("ref", rt, csv_path)
    for g, w in zip(got[:3], want[:3]):
        assert g["n_rows"] == w["n_rows"] == 80 and g["device"] == w["device"] == "cpu"
        _assert_topk_agree(g["indices"], g["scores"], w["indices"], w["scores"])
    assert got[3:] == want[3:]


INFER = {
    "classify": [("a text to classify " + "x" * n, {"model_config": SMALL_F32, "topk": 3})
                 for n in (0, 40, 90, 200)],
    "summarize": [("a text to summarize " + "y" * n, {"model_config": SERVE_S2S,
                                                       "max_length": 2 + n % 5})
                  for n in (0, 33, 77, 150)],
}
SERVE_OP = {"classify": "serve_classify", "summarize": "serve_summarize"}


@pytest.mark.parametrize("op,disagg,blocking", [
    ("classify", False, True), ("classify", False, False), ("summarize", False, True),
    ("summarize", True, True), ("summarize", True, False)])
def test_infer_answers_equal_the_serve_op_on_each_batch(rt, op, disagg, blocking):
    serve_infer.reset_engines()
    c = Controller(serve=port_config.ServeConfig(max_wait_ms=5.0, disaggregated=disagg),
                   flow=port_config.FlowConfig(cache_enabled=False))
    tasks = ("serve_prefill", "serve_decode") if disagg else (SERVE_OP[op],)
    answers = [None] * len(INFER[op])
    with ControllerServer(c) as srv:
        def post(i, text, params):
            body = {"op": op, "text": text, "params": params}
            if blocking:
                answers[i] = http(f"{srv.url}/v1/infer", body)
            else:
                status, out = http(f"{srv.url}/v1/infer", dict(body, wait=False))
                assert status == 200 and out["state"] == "queued"
                answers[i] = http(f"{srv.url}/v1/infer/{out['req_id']}?wait_ms=30000")

        clients = [threading.Thread(target=post, args=(i, *req), daemon=True)
                   for i, req in enumerate(INFER[op])]
        for t in clients:
            t.start()
        _drain(_agent(srv.url, rt, tasks), lambda: not any(t.is_alive() for t in clients))
        assert all(status == 200 and a["state"] == "done" for status, a in answers), answers
        jobs = {a["job_id"] for _, a in answers}
        ops = load_ops([SERVE_OP[op]])
        ctx = OpContext(runtime=rt)
        direct = {}
        for j in jobs:
            payload = {k: v for k, v in c.job(j).payload.items() if k != "partials"}
            if disagg:
                assert c.job(j).op == "serve_decode" and len(c.job(j).after_order) == 1
            for r in ops[SERVE_OP[op]](payload, ctx)["results"]:
                direct[r["req_id"]] = r
    keys = ("indices", "scores") if op == "classify" else ("summary", "tokens", "steps")
    for _, a in answers:
        assert {k: a["result"][k] for k in keys} == {k: direct[a["req_id"]][k] for k in keys}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_admission_answers_429_with_retry_after(side):
    ctrl_cls, server_cls, config = SIDES[side]
    c = ctrl_cls(serve=config.ServeConfig(max_pending=2))
    with server_cls(c) as srv:
        codes = [http(f"{srv.url}/v1/infer", {"op": "classify", "text": f"t{i}",
                                              "wait": False}) for i in range(4)]
    assert [s for s, _ in codes] == [200, 200, 429, 429]
    refused = codes[2][1]
    assert set(refused) == {"error", "retry_after_ms", "tenant", "scope"}
    assert refused["retry_after_ms"] > 0


def _same_state(side, tmp_path):
    """One state on either server: jobs, a workflow, a lease and a result, a
    queued infer request -> (server, ids to GET)."""
    ctrl_cls, server_cls, config = SIDES[side]
    c = ctrl_cls(obs=config.ObsConfig(tsdb_interval_sec=0.0),
                 flow=config.FlowConfig(cache_enabled=False))
    srv = server_cls(c).start()
    j = c.submit("echo", {"x": 1}, job_id="j1", tenant="acme")
    c.submit("echo", {"x": 2}, job_id="j2")
    c.submit_workflow({"stages": [{"name": "a", "op": "echo"}]}, workflow_id="wf-1")
    out = c.lease("agent-1", capabilities={"ops": ["echo"]}, max_tasks=1,
                  metrics={"cpu_util": 0.5})
    c.report(out["lease_id"], out["tasks"][0]["id"], out["tasks"][0]["job_epoch"],
             "succeeded", result={"ok": True})
    rid = c.submit_infer("classify", "a request")
    return srv, {"job": j, "req": rid}


ROUTES = ["/v1/status", "/v1/metrics", "/v1/jobs/{job}", "/v1/jobs/nope", "/v1/workflows",
          "/v1/workflows/wf-1", "/v1/workflows/nope", "/v1/usage", "/v1/traces",
          "/v1/trace/{job}", "/v1/trace/{req}", "/v1/debug/events", "/v1/debug/requests",
          "/v1/timeseries?name=controller_queue_depth", "/v1/timeseries/export",
          "/v1/incidents", "/v1/profile/host", "/v1/profile/captures", "/v1/infer/{req}",
          "/v1/health", "/v1/depth", "/v1/nope"]


def test_every_get_route_answers_with_the_references_keys(tmp_path):
    servers = {side: _same_state(side, tmp_path) for side in SIDES}
    try:
        for route in ROUTES:
            answers = {}
            for side, (srv, ids) in servers.items():
                status, body = http(srv.url + route.format(**ids))
                shape = sorted(body) if isinstance(body, dict) else type(body).__name__
                answers[side] = (status, shape)
            assert answers["port"] == answers["ref"], route
    finally:
        for srv, _ in servers.values():
            srv.stop()
            srv.controller.close()


@pytest.mark.parametrize("chips,mem_mb", [(1, 81_559), (4, 81_559), (1, 16_384), (2, 100),
                                          (8, 196_608)])
def test_the_gpu_blocks_hint_is_the_references_formula(chips, mem_mb):
    want = _tpu_batch_hints({"n_chips": chips, "hbm_bytes_per_chip": mem_mb * 2**20})
    assert sizing.batch_hints(chips, mem_mb * 2**20) == want


def test_the_profile_carries_the_hint_and_the_controller_splits_by_it(monkeypatch, tmp_path):
    monkeypatch.setattr(sizing, "detect_gpu", lambda: {
        "gpu_present": True, "max_gpu_workers": 2,
        "gpus": [{"name": "NVIDIA H100 80GB HBM3", "memory_mb": 81_559},
                 {"name": "NVIDIA H100 80GB HBM3", "memory_mb": 81_559}]})
    profile = sizing.build_worker_profile()
    assert (profile["gpu"]["suggested_batch"], profile["gpu"]["suggested_shard_rows"]) == (
        2048, 32_768)
    disabled = sizing.build_worker_profile(device=port_config.DeviceConfig(tpu_disabled=True))
    assert "suggested_shard_rows" not in disabled["gpu"] and disabled["gpu"]["disabled"]
    c = Controller()
    c.lease("a", capabilities={"ops": ["echo"]}, worker_profile=profile)
    shards, _ = c.submit_csv_job(str(tmp_path / "x.csv"), 70_000)
    assert [c.job(s).payload["shard_size"] for s in shards] == [32_768, 32_768, 4_464]
