"""The port's flight recorder, utilization accounting and device memory
telemetry (``agent_tpu_torch.obs.recorder``, ``.health``, ``.profile``)
against the reference's, and the port's agent against the reference's
``ControllerServer``: the trace tags reach the stored results, and the
agent's and controller's recorder dumps correlate on one job's lease ids
(``tests/test_obs.py``). No card here: the CUDA readers are driven through
monkeypatched ``torch.cuda`` functions, and the H100 peak through a
monkeypatched ``torch.cuda.get_device_name``. Comparisons are exact unless
a tolerance is stated beside them."""

import json
import os
import signal
import threading
import time

import pytest
import torch

from agent_tpu.controller.core import Controller
from agent_tpu.controller.server import ControllerServer
from agent_tpu.obs import health as ref_health
from agent_tpu.obs import recorder as ref_recorder
from agent_tpu_torch.agent.app import Agent
from agent_tpu_torch.config import AgentConfig, Config
from agent_tpu_torch.obs import health, profile
from agent_tpu_torch.obs.recorder import FlightRecorder, default_dump_path, install_sigusr1_dump
from agent_tpu_torch.runtime.runtime import TorchRuntime

TINY = {"d_model": 32, "n_heads": 2, "n_layers": 1, "d_ff": 64, "max_len": 64,
        "n_classes": 8, "dtype": "float32"}


# ---- flight recorder ----

class TestFlightRecorder:
    def test_ring_is_bounded_and_filters(self):
        rec = FlightRecorder(capacity=4, clock=lambda: 5.0)
        for i in range(10):
            rec.record("phase", job_id=f"j{i % 2}", req_id="r" if i == 9 else None)
        assert len(rec) == 4 and rec.dropped == 6
        assert [e["job_id"] for e in rec.events(job_id="j1")] == ["j1", "j1"]
        assert len(rec.events(job_id="j1", req_id="r")) == 1
        seqs = [e["seq"] for e in rec.events()]
        assert seqs == sorted(seqs) and all(e["ts"] == 5.0 for e in rec.events())
        rec.clear()
        assert len(rec) == 0

    def test_dump_is_jsonl_oldest_first_and_survives_odd_values(self, tmp_path):
        rec = FlightRecorder()
        rec.record("lease", lease_id="L1", job_ids=["a", "b"])
        rec.record("error", job_id="a", value=object())
        path = str(tmp_path / "dump.jsonl")
        assert rec.dump(path) == 2
        events = [json.loads(line) for line in open(path)]
        assert [e["kind"] for e in events] == ["lease", "error"]
        assert set(events[0]) == {"ts", "mono", "seq", "kind", "lease_id", "job_ids"}
        assert isinstance(events[1]["value"], str)
        assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]

    def test_event_shape_matches_the_reference(self):
        ours, ref = FlightRecorder(clock=lambda: 1.0), ref_recorder.FlightRecorder(
            clock=lambda: 1.0)
        ours.record("task", job_id="j", op="echo")
        ref.record("task", job_id="j", op="echo")
        assert list(ours.events()[0]) == list(ref.events()[0])

    def test_default_dump_path(self, monkeypatch, tmp_path):
        monkeypatch.setenv("FLIGHT_RECORDER_DIR", str(tmp_path))
        path = default_dump_path("agent-a b/c")
        assert path == str(tmp_path / f"agent_tpu_torch_flight_agent-a_b_c_{os.getpid()}.jsonl")
        monkeypatch.delenv("FLIGHT_RECORDER_DIR")
        assert os.path.dirname(default_dump_path("x")) == __import__("tempfile").gettempdir()

    def test_sigusr1_dumps_the_ring(self, tmp_path, capsys):
        rec = FlightRecorder()
        rec.record("lease", lease_id="L1")
        path = str(tmp_path / "usr1.jsonl")
        before = signal.getsignal(signal.SIGUSR1)
        try:
            assert install_sigusr1_dump(rec, path) == path
            os.kill(os.getpid(), signal.SIGUSR1)
            deadline = time.monotonic() + 10
            while not os.path.exists(path) and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            signal.signal(signal.SIGUSR1, before)
        assert [json.loads(line)["kind"] for line in open(path)] == ["lease"]
        assert "flight recorder dumped 1 events" in capsys.readouterr().out

    def test_sigusr1_off_the_main_thread_is_a_soft_none(self):
        out = []
        t = threading.Thread(target=lambda: out.append(
            install_sigusr1_dump(FlightRecorder(), "/nonexistent/x.jsonl")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and out == [None]


# ---- utilization ----

class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.mark.parametrize("steps", [
    [(0.5, 0.2), (1.0, 0.3), (70.0, 0.1)],
    [(0.1, 0.0), (0.2, 5.0), (0.3, -1.0)],
    [(float(i), 0.05) for i in range(1, 130)],
])
def test_rolling_window_matches_the_reference(steps):
    """Same busy spans at the same clock readings: the same totals and
    fractions (exact: the same float operations in the same order)."""
    c1, c2 = _Clock(), _Clock()
    ours, ref = health.RollingWindow(60.0, clock=c1), ref_health.RollingWindow(60.0, clock=c2)
    for dt, busy in steps:
        c1.t += dt
        c2.t += dt
        ours.add(busy)
        ref.add(busy)
        assert ours.total() == ref.total()
        assert ours.fraction() == ref.fraction()
        assert 0.0 <= ours.fraction() <= 1.0


class _Rt:
    def __init__(self, device):
        self.device = torch.device(device)
        self.devices = [self.device]


class TestPeakFlops:
    def test_env_override_first(self, monkeypatch):
        monkeypatch.setenv("PEAK_TFLOPS", "123.5")
        assert health.resolve_peak_flops(None) == 123.5e12
        assert health.resolve_peak_flops(_Rt("cpu")) == 123.5e12

    def test_cpu_and_no_runtime_give_none(self, monkeypatch):
        monkeypatch.delenv("PEAK_TFLOPS", raising=False)
        assert health.resolve_peak_flops(None) is None
        assert health.resolve_peak_flops(TorchRuntime(device="cpu")) is None
        monkeypatch.setenv("PEAK_TFLOPS", "not a number")
        assert health.resolve_peak_flops(_Rt("cpu")) is None

    @pytest.mark.parametrize("name,tflops", [("NVIDIA H100 80GB HBM3", 989.4),
                                             ("NVIDIA H100 PCIe", 756.0),
                                             ("NVIDIA H100 NVL", 835.0),
                                             ("NVIDIA A100-SXM4-80GB", None),
                                             ("TPU v5 lite", None)])
    def test_card_name_table(self, monkeypatch, name, tflops):
        monkeypatch.delenv("PEAK_TFLOPS", raising=False)
        seen = []
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None: seen.append(d) or name)
        got = health.resolve_peak_flops(_Rt("cuda:0"))
        assert got == (tflops * 1e12 if tflops else None)
        assert seen == [torch.device("cuda", 0)]

    def test_a_failing_name_read_gives_none(self, monkeypatch):
        monkeypatch.delenv("PEAK_TFLOPS", raising=False)

        def boom(d=None):
            raise RuntimeError("CUDA unavailable")

        monkeypatch.setattr(torch.cuda, "get_device_name", boom)
        assert health.resolve_peak_flops(_Rt("cuda:0")) is None


# ---- device memory ----

def _fake_cards(monkeypatch, stats, total=80 * 2**30):
    """torch.cuda's readers over fake cards: ``stats[index]`` (an exception
    raises)."""
    def memory_stats(index):
        v = stats[index]
        if isinstance(v, Exception):
            raise v
        return v

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda index: (total // 2, total))


class TestDeviceMemory:
    def test_cpu_contributes_nothing(self):
        assert profile.device_memory_stats([torch.device("cpu")] * 4) == []
        assert profile.hbm_totals(["cpu"]) is None
        assert TorchRuntime(device="cpu").describe().get("hbm_bytes_in_use") is None

    def test_a_card_listed_twice_counts_once(self, monkeypatch):
        _fake_cards(monkeypatch, {0: {"allocated_bytes.all.current": 5,
                                      "allocated_bytes.all.peak": 9}})
        out = profile.device_memory_stats([torch.device("cuda", 0)] * 2)
        assert out == [{"device": "0", "platform": "cuda", "limit": 80 * 2**30,
                        "used": 5, "peak": 9}]
        totals = profile.hbm_totals(["cuda:0", "cuda:0"])
        assert (totals["used"], totals["peak"], totals["limit"]) == (5, 9, 80 * 2**30)

    def test_partial_and_raising_cards(self, monkeypatch):
        _fake_cards(monkeypatch, {0: {"allocated_bytes.all.current": 5},
                                  1: RuntimeError("boom"),
                                  2: {"allocated_bytes.all.peak": 7}})
        out = profile.device_memory_stats(["cuda:0", "cuda:1", "cuda:2", "cpu"])
        assert [e["device"] for e in out] == ["0", "2"]
        assert "peak" not in out[0] and "used" not in out[1]
        totals = profile.hbm_totals(["cuda:0", "cuda:1", "cuda:2"])
        assert totals["used"] == 5 and totals["peak"] == 7 and totals["limit"] == 2 * 80 * 2**30

    def test_agent_gauges_cover_every_card_once(self, monkeypatch):
        _fake_cards(monkeypatch, {0: {"allocated_bytes.all.current": 5,
                                      "allocated_bytes.all.peak": 9},
                                  1: {"allocated_bytes.all.current": 7}})

        class _Ring:
            devices = [torch.device("cuda", 0)] * 2 + [torch.device("cuda", 1)]

            def describe(self):
                return {"platform": "cuda", "n_devices": 3}

        agent = Agent(Config(agent=AgentConfig(controller_url="http://127.0.0.1:9",
                                               tasks=("echo",))), session=object())
        agent.runtime = _Ring()
        agent._metrics()
        got = {(s["labels"]["device"], s["labels"]["kind"]): s["value"]
               for s in agent.obs.snapshot()["device_hbm_bytes"]["series"]}
        assert got == {("0", "used"): 5, ("0", "peak"): 9, ("0", "limit"): 80 * 2**30,
                       ("1", "used"): 7, ("1", "limit"): 80 * 2**30}


# ---- the port's agent against the reference's ControllerServer ----

def _drain_pipelined(controller, server, runtime, tasks=("map_classify_tpu",)):
    cfg = Config(agent=AgentConfig(controller_url=server.url, agent_name="obs-pipe",
                                   tasks=tasks, idle_sleep_sec=0.0, pipeline_depth=2))
    agent = Agent(config=cfg, runtime=runtime)
    agent._profile = {"tier": "test"}

    def watch():
        deadline = time.time() + 120
        while not controller.drained() and time.time() < deadline:
            time.sleep(0.02)
        agent.shutdown()

    threading.Thread(target=watch, daemon=True).start()
    agent.run()
    return agent


@pytest.fixture(scope="module")
def runtime():
    return TorchRuntime(device="cpu")


def test_trace_propagates_into_result_bodies(runtime):
    """trace={job_id, attempt, lease_id} stamped at lease time reaches the
    stored result through ctx.tags."""
    c = Controller()
    jid = c.submit("map_classify_tpu", {"texts": ["trace row"], "topk": 2,
                                        "model_config": dict(TINY), "allow_fallback": False})
    with ControllerServer(c) as server:
        _drain_pipelined(c, server, runtime)
    trace = c.job_snapshot(jid)["result"]["trace"]
    assert trace["job_id"] == jid and trace["attempt"] == 1
    assert isinstance(trace["lease_id"], str) and trace["lease_id"]
    evs = [e for e in c.recorder.events() if e.get("job_id") == jid]
    assert {"submit", "lease", "result"} <= {e["kind"] for e in evs}
    assert any(e.get("lease_id") == trace["lease_id"] for e in evs)


def test_flight_recorder_dumps_correlate_across_both_sides(runtime, tmp_path):
    """A missing shard file fails the job (a retry, then dead). The
    agent's and the controller's dumps both carry the job's events, and
    share its lease ids."""
    c = Controller()
    jid = c.submit("map_classify_tpu", {"source_uri": str(tmp_path / "missing.csv"),
                                        "start_row": 0, "shard_size": 8})
    with ControllerServer(c) as server:
        agent = _drain_pipelined(c, server, runtime)
    assert c.job_snapshot(jid)["state"] == "dead"
    a_path, c_path = str(tmp_path / "agent.jsonl"), str(tmp_path / "controller.jsonl")
    agent.recorder.dump(a_path)
    c.recorder.dump(c_path)
    a_mine = [e for e in map(json.loads, open(a_path)) if e.get("job_id") == jid]
    c_mine = [e for e in map(json.loads, open(c_path)) if e.get("job_id") == jid]
    errors = [e for e in a_mine if e["kind"] == "error"]
    assert len(errors) == 2
    assert errors[0]["type"] in ("FileNotFoundError", "OSError")
    assert sum(1 for e in c_mine if e["kind"] == "lease") == 2
    assert sum(1 for e in c_mine if e["kind"] == "result" and e["state"] == "failed") == 2
    a_leases = {e.get("lease_id") for e in a_mine if e.get("lease_id")}
    c_leases = {e.get("lease_id") for e in c_mine if e.get("lease_id")}
    assert a_leases & c_leases
