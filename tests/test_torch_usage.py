"""The port's agent feeding the reference controller's accounting: usage
stamps the reference's ``UsageLedger`` reconciles with the fleet's
``device_busy_seconds_total`` (within 1 %, as ``tests/test_usage.py``),
the duty, FLOPs and MFU gauges, profile captures requested through the
reference controller's lease alerts (torch.profiler on a CPU runtime), the
SLO page dump, the ``CONTROLLER_URLS`` failover list, and the device knobs
(``TPU_DISABLED``, ``PALLAS_ATTN``, ``CHIP_SLICE``, ``PROFILE_DIR``) held to
``agent_tpu.config``'s parsing. Comparisons are exact unless a tolerance is
stated beside them."""

import json
import os
import time

import pytest
import torch

from agent_tpu.chaos import LoopbackSession
from agent_tpu.config import AgentConfig as JaxAgentConfig
from agent_tpu.config import DeviceConfig as JaxDeviceConfig
from agent_tpu.controller.core import Controller
from agent_tpu.runtime.runtime import parse_chip_slice as jax_parse_chip_slice
from agent_tpu_torch.agent.app import Agent, main
from agent_tpu_torch.config import AgentConfig, Config, DeviceConfig
from agent_tpu_torch.ops._model_common import encoder_fwd_flops
from agent_tpu_torch.runtime import runtime as rt_mod
from agent_tpu_torch.runtime.runtime import TorchRuntime, parse_chip_slice
from tests.test_journal import FlakySession
from tests.test_slo import FakeClock, make_controller, run_jobs

SMALL_F32 = {"d_model": 32, "n_heads": 2, "n_layers": 1, "d_ff": 64, "max_len": 64,
             "n_classes": 8, "dtype": "float32"}
LOCAL = "http://127.0.0.1:9"


def _make_agent(controller, name="usage-test", tasks=("risk_accumulate",), runtime=None,
                session=None, **kw):
    cfg = Config(agent=AgentConfig(controller_url=LOCAL, agent_name=name, tasks=tasks,
                                   max_tasks=4, idle_sleep_sec=0.0, error_backoff_sec=0.0,
                                   **kw))
    agent = Agent(config=cfg, session=session or LoopbackSession(controller), runtime=runtime)
    agent._profile = {"tier": "test"}
    return agent


def _drain(controller, agent, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while not controller.drained() and time.monotonic() < deadline:
        leased = agent.lease_once()
        if leased is None:
            controller.sweep()
            continue
        lease_id, tasks = leased
        for task in tasks:
            agent.run_task(lease_id, task)
    agent.push_metrics()
    assert controller.drained(), controller.counts()


def _build_csv(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        f.write("id,text,risk\n")
        for i in range(rows):
            f.write(f'{i},"r {i}",{i % 5}\n')


@pytest.fixture(scope="module")
def cpu_rt():
    return TorchRuntime(device="cpu")


# ---- usage ----

def test_two_tenant_reconciliation(tmp_path):
    """Two tenants' CSV jobs drained by the port's agent: the reference
    ledger bills 8 tasks, 100 rows a tenant, and its device seconds equal
    the fleet's busy counter within 1 %."""
    csv = str(tmp_path / "r.csv")
    _build_csv(csv, 100)
    c = Controller(lease_ttl_sec=30.0)
    for tenant in ("alpha", "beta"):
        c.submit_csv_job(csv, total_rows=100, shard_size=25, map_op="risk_accumulate",
                         extra_payload={"field": "risk"}, tenant=tenant)
    agent = _make_agent(c)
    _drain(c, agent)
    usage = c.usage_json()
    assert usage["billed_tasks"] == 8
    assert set(usage["by_tenant"]) == {"alpha", "beta"}
    for t in ("alpha", "beta"):
        assert usage["by_tenant"][t]["rows"] == 100
        assert usage["by_tenant"][t]["tasks"] == 4
    busy = sum(s["value"] for s in c.fleet_snapshot()
               .get("device_busy_seconds_total", {}).get("series", []))
    ledger = usage["totals"]["device_seconds"]
    assert busy > 0
    assert abs(ledger - busy) <= 0.01 * busy
    assert usage["pending_by_tenant"] == {}
    c.close()


def test_usage_rides_result_bodies():
    c = Controller(lease_ttl_sec=30.0)
    agent = _make_agent(c, tasks=("echo",))
    jid = c.submit("echo", {"v": 1}, tenant="t")
    _drain(c, agent)
    usage = c.job_snapshot(jid)["result"]["usage"]
    assert usage["device_s"] > 0 and usage["host_s"] >= 0 and usage["chips"] == 1.0
    assert "flops" not in usage  # echo stamps no analytic FLOPs
    c.close()


def test_tenant_plumbs_through_task_wire():
    c = Controller(lease_ttl_sec=0.01)
    agent = _make_agent(c, tasks=("echo",))
    jid_t = c.submit("echo", {"v": 1}, tenant="acme")
    jid_d = c.submit("echo", {"v": 2})
    _drain(c, agent)
    assert c.job_snapshot(jid_t)["result"]["trace"]["tenant"] == "acme"
    assert "tenant" not in c.job_snapshot(jid_d)["result"]["trace"]
    c.close()


def test_classify_usage_flops_duty_and_mfu(monkeypatch, cpu_rt):
    """map_classify_tpu on a CPU runtime: each result's usage FLOPs are
    encoder_fwd_flops of its staged shape (exact), its device_s sums to
    the busy counter (1e-9 relative: one float sum in another order), the
    duty is in (0, 1], and the MFU is FLOPs / busy / PEAK_TFLOPS (5e-7
    absolute: the gauge rounds to 6 decimal places)."""
    monkeypatch.setenv("PEAK_TFLOPS", "0.001")
    c = Controller(lease_ttl_sec=30.0)
    from agent_tpu_torch.ops import load_ops

    op = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    payloads = [{"texts": t, "topk": 2, "model_config": SMALL_F32, "allow_fallback": False}
                for t in (["alpha beta", "gamma"], ["one two three four five six seven"] * 3)]
    jids = [c.submit("map_classify_tpu", dict(p)) for p in payloads]
    agent = _make_agent(c, tasks=("map_classify_tpu",), runtime=cpu_rt)
    _drain(c, agent)
    results = [c.job_snapshot(j)["result"] for j in jids]
    d, f, n = SMALL_F32["d_model"], SMALL_F32["d_ff"], SMALL_F32["n_layers"]
    for payload, r in zip(payloads, results):
        _, state = op.stage(dict(payload))
        want = sum(encoder_fwd_flops(ids.shape[0], ids.shape[1], d, f, n,
                                     SMALL_F32["n_classes"]) for ids, _, _ in state["chunks"])
        assert r["usage"]["flops"] == want > 0
    flops_series = agent.obs.snapshot()["device_flops_total"]["series"]
    assert sum(s["value"] for s in flops_series) == sum(r["usage"]["flops"] for r in results)
    busy = agent.m_device_busy.value(op="map_classify_tpu")
    assert sum(r["usage"]["device_s"] for r in results) == pytest.approx(busy, rel=1e-9)
    assert 0 < agent.m_duty.value() <= 1
    flops = sum(r["usage"]["flops"] for r in results)
    assert agent.m_mfu.value(op="map_classify_tpu") == pytest.approx(flops / busy / 1e9,
                                                                      rel=0, abs=5e-7)
    c.close()


def test_mfu_absent_without_a_peak(monkeypatch, cpu_rt):
    monkeypatch.delenv("PEAK_TFLOPS", raising=False)
    c = Controller(lease_ttl_sec=30.0)
    c.submit("map_classify_tpu", {"texts": ["a b"], "topk": 2, "model_config": SMALL_F32,
                                  "allow_fallback": False})
    agent = _make_agent(c, tasks=("map_classify_tpu",), runtime=cpu_rt)
    _drain(c, agent)
    assert agent.obs.snapshot()["device_mfu"]["series"] == []
    assert agent.obs.snapshot()["device_flops_total"]["series"]
    c.close()


def test_a_shared_serving_step_stamps_no_usage():
    """An engine step shared by several jobs is charged to the busy counter
    once and stamps no job's usage (tags None), as the reference."""
    agent = _make_agent(Controller(), tasks=("echo",))
    agent.note_device_time("serve_summarize", 0.25, None)
    tags = {}
    agent.note_device_time("serve_summarize", 0.5, tags)
    assert agent.m_device_busy.value(op="serve_summarize") == 0.75
    assert tags["usage"] == {"device_s": 0.5, "chips": 1.0}


# ---- device memory on a statless backend ----

def test_hbm_gauges_absent_on_statless_backend(cpu_rt):
    c = Controller()
    agent = _make_agent(c, runtime=cpu_rt)
    metrics = agent._metrics()
    assert agent.obs.snapshot()["device_hbm_bytes"]["series"] == []
    assert "hbm_bytes_in_use" not in metrics["device"]
    c.close()


# ---- profile captures ----

def test_capture_round_trip_through_alerts(tmp_path, monkeypatch, cpu_rt):
    monkeypatch.setenv("PROFILE_CAPTURE_DIR", str(tmp_path / "caps"))
    c = Controller(lease_ttl_sec=30.0)
    agent = _make_agent(c, name="cap-agent", tasks=("echo",), runtime=cpu_rt)
    req = c.request_capture("cap-agent", op="echo")
    c.submit("echo", {"v": 1})
    _drain(c, agent)
    (rec,) = c.captures_json()["captures"]
    assert rec["capture_id"] == req["capture_id"]
    assert rec["status"] == "done", rec
    assert os.path.isdir(rec["artifact"])
    assert rec["summary"]["n_trace_files"] >= 1
    with open(os.path.join(rec["artifact"], "trace.json")) as fh:
        trace = json.load(fh)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "op:echo" in names
    c.close()


def test_capture_wrong_agent_never_fires(cpu_rt):
    c = Controller(lease_ttl_sec=30.0)
    agent = _make_agent(c, name="right-agent", tasks=("echo",), runtime=cpu_rt)
    c.request_capture("other-agent", op="echo")
    c.submit("echo", {"v": 1})
    _drain(c, agent)
    rec = c.captures_json()["captures"][0]
    assert rec["status"] == "requested"
    c.close()


def test_capture_inside_a_running_profiler_is_an_error_record(tmp_path, monkeypatch):
    """The agent never nests a profiler session: under one already
    recording, the capture completes with an error and the task runs."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setenv("PROFILE_CAPTURE_DIR", str(tmp_path))
    c = Controller(lease_ttl_sec=30.0)
    agent = _make_agent(c, name="nest", tasks=("echo",))
    c.request_capture("nest", op="echo")
    jid = c.submit("echo", {"v": 1})
    with profile(activities=[ProfilerActivity.CPU]):
        _drain(c, agent)
    (rec,) = c.captures_json()["captures"]
    assert rec["status"] == "error" and "already recording" in rec["error"]
    assert c.job_snapshot(jid)["state"] == "succeeded"
    c.close()


def test_profile_dir_traces_the_first_tasks(tmp_path, cpu_rt):
    cfg = Config(agent=AgentConfig(controller_url=LOCAL, agent_name="prof", tasks=("echo",),
                                   max_tasks=4, idle_sleep_sec=0.0),
                 device=DeviceConfig(profile_dir=str(tmp_path / "prof"), profile_tasks=2))
    c = Controller(lease_ttl_sec=30.0)
    for i in range(3):
        c.submit("echo", {"v": i})
    agent = Agent(config=cfg, session=LoopbackSession(c), runtime=cpu_rt)
    agent._profile = {"tier": "test"}
    _drain(c, agent)
    files = sorted(os.listdir(tmp_path / "prof"))
    assert len(files) == 2 and agent.profiled_tasks == 2
    for name in files:
        with open(tmp_path / "prof" / name) as fh:
            assert "op:echo" in {e.get("name") for e in json.load(fh)["traceEvents"]}
    c.close()


# ---- SLO page dump ----

def test_lease_page_alert_dumps_the_agent_recorder_once(tmp_path, monkeypatch):
    monkeypatch.setenv("FLIGHT_RECORDER_DIR", str(tmp_path))
    clock = FakeClock()
    c = make_controller(clock)
    run_jobs(c, clock, 10, 0.5)
    clock.advance(1.1)
    agent = _make_agent(c, name="pagee", tasks=("echo",))
    jid = c.submit("echo", {"x": 3})
    leased = agent.lease_once()
    assert leased is not None
    assert len(agent.slo_dump_paths) == 1
    assert "agent-pagee-slo-echo" in agent.slo_dump_paths[0]
    assert agent.slo_dump_paths[0].startswith(str(tmp_path))
    events = [json.loads(line) for line in open(agent.slo_dump_paths[0])]
    assert any(e["kind"] == "slo_page" and e["op"] == "echo" for e in events)
    # The lease is recorded after the dump, as the reference orders them.
    assert any(e["kind"] == "lease" and jid in e["job_ids"] for e in agent.recorder.events())
    c.submit("echo", {"x": 4})
    clock.advance(1.1)
    agent.lease_once()
    assert len(agent.slo_dump_paths) == 1  # the same episode dumps once
    agent.note_alerts([])  # the episode clears and re-arms
    agent.note_alerts([{"objective": "echo", "state": "page", "op": "echo"}])
    assert len(agent.slo_dump_paths) == 2


# ---- CONTROLLER_URLS failover ----

def _failover_agent(controller, urls, down):
    cfg = Config(agent=AgentConfig(controller_url=urls[0], controller_urls=tuple(urls),
                                   agent_name="fo", tasks=("echo",), idle_sleep_sec=0.01,
                                   error_backoff_sec=0.01, retry_base_sec=0.005,
                                   retry_max_sec=0.02, pipeline_depth=0))
    session = FlakySession(controller, down)
    agent = Agent(config=cfg, session=session)
    agent._profile = {"tier": "test"}
    return agent, session


def test_transport_error_rotates_sticky():
    c = Controller()
    jid = c.submit("echo", {"v": 1})
    agent, _ = _failover_agent(c, ["http://primary", "http://standby"], ["http://primary"])
    assert agent.active_controller_url() == "http://primary"
    agent.step()
    assert agent.active_controller_url() == "http://standby"
    assert agent.step() is True
    assert c.job_snapshot(jid)["state"] == "succeeded"
    (fo,) = agent.obs.snapshot()["controller_failovers_total"]["series"]
    assert fo["value"] == 1
    (ev,) = agent.recorder.events()[:1]
    assert ev["kind"] == "controller_failover" and ev["failed"] == "http://primary"
    assert ev["active"] == "http://standby"
    agent.step()
    assert agent.active_controller_url() == "http://standby"


def test_spool_redelivers_to_standby():
    c = Controller()
    jid = c.submit("echo", {"v": 2})
    agent, session = _failover_agent(c, ["http://primary", "http://standby"], [])
    lease = c.lease("fo", {"ops": ["echo"]})
    session.down = ["http://primary"]
    t = lease["tasks"][0]
    assert agent.post_result(lease["lease_id"], jid, t["job_epoch"], "succeeded",
                             {"ok": True}, op="echo") is False
    assert len(agent.spool) == 1 and agent.active_controller_url() == "http://standby"
    assert agent.flush_spool(force=True) == 1
    assert c.job_snapshot(jid)["state"] == "succeeded" and len(agent.spool) == 0


def test_single_url_never_rotates():
    c = Controller()
    agent, _ = _failover_agent(c, ["http://primary"], ["http://primary"])
    agent.step()
    assert agent.active_controller_url() == "http://primary"
    assert not agent.obs.snapshot()["controller_failovers_total"]["series"]


@pytest.mark.parametrize("env", [
    {"CONTROLLER_URLS": "http://p:8080, http://s:8080/"},
    {"CONTROLLER_URLS": "http://p:8080,http://s:8080", "CONTROLLER_URL": "http://x:1/"},
    {"CONTROLLER_URL": "http://only:2"},
    {"CONTROLLER_URLS": " , "},
    {},
])
def test_controller_urls_precedence_matches_the_reference(monkeypatch, env):
    for name in ("CONTROLLER_URL", "CONTROLLER_URLS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours, ref = AgentConfig.from_env(), JaxAgentConfig.from_env()
    assert (ours.controller_url, ours.controller_urls) == \
        (ref.controller_url, ref.controller_urls)


def test_an_agent_puts_controller_url_first_in_its_list():
    agent = Agent(Config(agent=AgentConfig(controller_url="http://x",
                                           controller_urls=("http://a", "http://b"),
                                           tasks=("echo",))), session=object())
    assert agent._controller_urls == ["http://x", "http://a", "http://b"]
    assert agent.active_controller_url() == "http://x"


# ---- device knobs ----

@pytest.mark.parametrize("env", [
    {},
    {"TPU_DISABLED": "1", "PALLAS_ATTN": "0", "CHIP_SLICE": " 1:1 ", "PROFILE_DIR": "/p",
     "PROFILE_TASKS": "3", "TPU_QUANT": "INT8"},
    {"TPU_DISABLED": "yes", "PALLAS_ATTN": "off", "PROFILE_TASKS": "x"},
    {"TPU_DISABLED": "", "PALLAS_ATTN": "", "CHIP_SLICE": ""},
])
def test_device_knobs_parse_as_the_reference(monkeypatch, env):
    for name in ("TPU_DISABLED", "PALLAS_ATTN", "CHIP_SLICE", "PROFILE_DIR", "PROFILE_TASKS",
                 "TPU_QUANT"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ours, ref = DeviceConfig.from_env(), JaxDeviceConfig.from_env()
    for name in ("quant", "tpu_disabled", "pallas_attn", "chip_slice", "profile_dir",
                 "profile_tasks"):
        assert getattr(ours, name) == getattr(ref, name), name


@pytest.mark.parametrize("spec", ["0:1", "3:2", "1", "a:b", "-1:1", "0:0", "1:2:3"])
def test_chip_slice_parses_as_the_reference(spec):
    try:
        want = jax_parse_chip_slice(spec)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            parse_chip_slice(spec)
        assert str(got.value) == str(exc)
    else:
        assert parse_chip_slice(spec) == want


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_chip_slice_of_several_cards_is_refused(monkeypatch):
    """A slice of several cards takes them, on dp unless MESH_SHAPE says
    otherwise (the reference's ``apply_chip_slice``); only a slice past the
    visible cards is refused."""
    _cards(monkeypatch, 4)
    rt = TorchRuntime(config=DeviceConfig(chip_slice="1:2"))
    assert rt.devices == [torch.device("cuda", 1), torch.device("cuda", 2)]
    assert rt.mesh.shape["dp"] == 2 and rt.device == torch.device("cuda", 1)
    rt = TorchRuntime(config=DeviceConfig(chip_slice="0:4", mesh_shape={"tp": 2}))
    assert rt.mesh.shape["dp"] == 2 and rt.mesh.shape["tp"] == 2
    with pytest.raises(ValueError, match=r"wants cards \[3, 5\) but only 4 are visible"):
        TorchRuntime(config=DeviceConfig(chip_slice="3:2"))


def test_chip_slice_picks_its_card(monkeypatch):
    _cards(monkeypatch, 2)
    rt = TorchRuntime(config=DeviceConfig(chip_slice="1:1"))
    assert rt.device == torch.device("cuda", 1) and rt.devices == [rt.device]
    with pytest.raises(ValueError, match="wants card 2 but only 2 are visible"):
        TorchRuntime(config=DeviceConfig(chip_slice="2:1"))
    # An explicit device wins over the slice, as in the reference.
    assert TorchRuntime(device="cpu", config=DeviceConfig(chip_slice="1:2")).platform == "cpu"


def test_pallas_attn_off_is_refused_on_a_cuda_runtime(monkeypatch):
    _cards(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="PALLAS_ATTN=0"):
        TorchRuntime(device="cuda:0", config=DeviceConfig(pallas_attn=False))
    # On the CPU the plain versions run either way.
    assert TorchRuntime(device="cpu", config=DeviceConfig(pallas_attn=False)).platform == "cpu"


def test_pallas_attn_off_fails_the_agent_at_start(monkeypatch):
    _cards(monkeypatch, 1)
    monkeypatch.setattr(rt_mod, "_runtime", None)
    for name, value in (("TASKS", "echo,map_classify_tpu"), ("CONTROLLER_URL", LOCAL),
                        ("PALLAS_ATTN", "0")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("TPU_DISABLED", raising=False)
    monkeypatch.delenv("CHIP_SLICE", raising=False)
    assert main() == 1
    monkeypatch.setattr(rt_mod, "_runtime", None)


def test_tpu_disabled_is_an_explicit_cpu_runtime(monkeypatch, capsys):
    _cards(monkeypatch, 1)
    monkeypatch.setattr(rt_mod, "_runtime", None)
    try:
        agent = Agent(Config(agent=AgentConfig(controller_url=LOCAL,
                                               tasks=("echo", "map_classify_tpu")),
                             device=DeviceConfig(tpu_disabled=True)), session=object())
        assert agent.runtime.platform == "cpu"
        assert agent.runtime.describe()["platform"] == "cpu"
        assert "TPU_DISABLED set" in capsys.readouterr().out
        gpu = agent.worker_profile()["gpu"]
        assert gpu["disabled"] is True and gpu["max_gpu_workers"] == 0
        assert agent.worker_profile()["tier"] == "cpu"
    finally:
        monkeypatch.setattr(rt_mod, "_runtime", None)


def test_chip_slice_rides_the_capabilities():
    agent = Agent(Config(agent=AgentConfig(controller_url=LOCAL, tasks=("echo",)),
                         device=DeviceConfig(chip_slice="0:1")), session=object())
    assert agent.capabilities()["chip_slice"] == "0:1"
    assert "chip_slice" not in Agent(Config(agent=AgentConfig(
        controller_url=LOCAL, tasks=("echo",))), session=object()).capabilities()
