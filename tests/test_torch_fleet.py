"""The port's device-pinned fleets against the reference's
(tests/test_fleet.py): each member's environment in the ``cpu`` and
``cuda`` shapes, the chip slice from config to capabilities, the
readiness gate, the warm-up's exit 3, and a real two-member CPU fleet
draining the reference's controller."""

import json
import os
import subprocess
import sys
import time

import pytest

from agent_tpu.agent import fleet as jax_fleet
from agent_tpu_torch.agent import fleet
from agent_tpu_torch.agent.app import Agent
from agent_tpu_torch.config import AgentConfig, Config, DeviceConfig
from agent_tpu_torch.runtime.runtime import parse_chip_slice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"d_model": 32, "n_heads": 2, "n_layers": 1, "d_ff": 64, "max_len": 32,
        "n_classes": 5, "dtype": "float32"}


class TestChipSlice:
    @pytest.mark.parametrize("i,k", [(0, 1), (1, 1), (2, 2), (3, 4)])
    def test_fleet_slice_is_the_reference_s(self, i, k):
        assert fleet.fleet_slice(i, k) == jax_fleet.fleet_slice(i, k)
        assert parse_chip_slice(fleet.fleet_slice(i, k)) == (i * k, k)

    def test_config_reads_chip_slice_env(self, monkeypatch):
        monkeypatch.setenv("CHIP_SLICE", "2:2")
        assert DeviceConfig.from_env().chip_slice == "2:2"
        monkeypatch.delenv("CHIP_SLICE")
        assert DeviceConfig.from_env().chip_slice == ""

    def test_agent_capabilities_advertise_slice(self):
        cfg = Config(agent=AgentConfig(tasks=("echo",)), device=DeviceConfig(chip_slice="1:3"))
        assert Agent(config=cfg, session=object()).capabilities()["chip_slice"] == "1:3"
        plain = Agent(config=Config(agent=AgentConfig(tasks=("echo",))), session=object())
        assert "chip_slice" not in plain.capabilities()


class TestFleetEnv:
    def test_cpu_members_ask_for_the_cpu_with_disjoint_slices(self):
        envs = [fleet.agent_env(i, 2, 2, controller_url="http://c:1", tasks="echo",
                                platform="cpu", base_env={"XLA_FLAGS": "--keep=1"})
                for i in range(2)]
        ref = [jax_fleet.agent_env(i, 2, 2, controller_url="http://c:1", tasks="echo",
                                   platform="cpu", base_env={}) for i in range(2)]
        assert [e["CHIP_SLICE"] for e in envs] == [e["CHIP_SLICE"] for e in ref] == ["0:2", "2:2"]
        assert [e["AGENT_NAME"] for e in envs] == [e["AGENT_NAME"] for e in ref]
        for e in envs:
            assert e["TPU_DISABLED"] == "1" and "CUDA_VISIBLE_DEVICES" not in e
            assert e["XLA_FLAGS"] == "--keep=1"  # untouched: it means nothing to torch
            assert (e["CONTROLLER_URL"], e["TASKS"]) == ("http://c:1", "echo")
            assert e["PYTHONPATH"].split(os.pathsep)[0] == REPO

    def test_cuda_members_pin_at_process_level(self):
        env = fleet.agent_env(1, 4, 2, controller_url="http://c:1", tasks="echo",
                              platform="cuda", base_env={"TPU_DISABLED": "1"})
        ref = jax_fleet.agent_env(1, 4, 2, controller_url="http://c:1", tasks="echo",
                                  platform="tpu", base_env={})
        assert env["CUDA_VISIBLE_DEVICES"] == ref["TPU_VISIBLE_DEVICES"] == "2,3"
        assert env["CHIP_SLICE"] == ref["CHIP_SLICE"] == "0:2"
        assert "TPU_DISABLED" not in env

    @pytest.mark.parametrize("platform", fleet.PLATFORMS)
    def test_mesh_and_warm_ride_through(self, platform):
        env = fleet.agent_env(0, 1, 4, controller_url="http://c:1", tasks="echo",
                              platform=platform, base_env={}, mesh_shape="dp=4",
                              warm_file="/w.json", extra_env={"IDLE_SLEEP_SEC": "0.01"})
        assert env["MESH_SHAPE"] == "dp=4" and env["AGENT_WARM_FILE"] == "/w.json"
        assert env["IDLE_SLEEP_SEC"] == "0.01"

    def test_bounds_and_platform(self):
        with pytest.raises(ValueError):
            fleet.agent_env(2, 2, 1, controller_url="u", tasks="t", base_env={})
        with pytest.raises(ValueError):
            fleet.agent_env(0, 1, 0, controller_url="u", tasks="t", base_env={})
        with pytest.raises(ValueError, match="platform"):
            fleet.agent_env(0, 1, 1, controller_url="u", tasks="t", base_env={}, platform="tpu")

    def test_a_cpu_member_s_runtime_is_the_cpu(self, monkeypatch):
        from agent_tpu_torch.runtime.runtime import TorchRuntime

        env = fleet.agent_env(1, 2, 1, controller_url="u", tasks="echo", base_env={})
        for k in ("TPU_DISABLED", "CHIP_SLICE"):
            monkeypatch.setenv(k, env[k])
        rt = TorchRuntime(config=DeviceConfig.from_env())
        assert rt.platform == "cpu" and rt.describe()["chip_slice"] == "1:1"


class TestWaitForAgents:
    @staticmethod
    def _agents_fn(*snapshots):
        seq = list(snapshots)
        return lambda: seq.pop(0) if len(seq) > 1 else seq[0]

    def test_all_ready_immediately(self):
        assert fleet.wait_for_agents(self._agents_fn({"a": {}, "b": {}}), ["a", "b"], timeout=1.0)

    def test_partial_readiness_converges(self):
        fn = self._agents_fn({}, {"a": {}}, {"a": {}, "b": {}})
        assert fleet.wait_for_agents(fn, ["a", "b"], timeout=5.0)

    def test_partial_readiness_times_out(self):
        t0 = time.monotonic()
        assert not fleet.wait_for_agents(self._agents_fn({"a": {}}), ["a", "b"], timeout=0.4)
        assert time.monotonic() - t0 >= 0.3

    def test_agents_fn_errors_tolerated_until_timeout(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise ConnectionError("controller still starting")
            return {"a": {}}

        assert fleet.wait_for_agents(flaky, ["a"], timeout=5.0) and calls["n"] >= 3

    def test_dead_member_aborts_the_wait(self):
        class DeadProc:
            returncode = 3

            def poll(self):
                return 3

        t0 = time.monotonic()
        assert not fleet.wait_for_agents(self._agents_fn({}), ["a"], timeout=30.0,
                                         fleet=fleet.Fleet([DeadProc()], ["a"]))
        assert time.monotonic() - t0 < 5.0


def _warm_file(tmp_path, specs) -> str:
    path = tmp_path / "warm.json"
    path.write_text(json.dumps(specs))
    return str(path)


class TestWarm:
    def test_a_failed_warm_up_exits_3(self, tmp_path):
        env = fleet.agent_env(0, 1, controller_url="http://127.0.0.1:9", tasks="echo",
                              warm_file=_warm_file(tmp_path, [{"op": "map_classify_tpu",
                                                               "payload": {}}]))
        proc = subprocess.run([sys.executable, "-m", "agent_tpu_torch.agent.fleet"], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 3, proc.stdout[-2000:] + proc.stderr[-2000:]
        assert "fleet warmup failed" in proc.stdout

    def test_warm_from_file_runs_each_op_on_the_cpu(self, tmp_path, monkeypatch):
        from agent_tpu_torch.runtime import runtime

        monkeypatch.setenv("TPU_DISABLED", "1")
        runtime.reset_runtime()
        try:
            path = _warm_file(tmp_path, [
                {"op": "echo", "payload": {"x": 1}},
                {"op": "map_classify_tpu", "payload": {"texts": ["a", "b"],
                                                       "model_config": TINY}}])
            assert fleet.warm_from_file(path) == 2
            assert runtime.get_runtime().platform == "cpu"
            with pytest.raises(ValueError):
                fleet.warm_from_file(_warm_file(tmp_path, {"op": "echo"}))
        finally:
            runtime.reset_runtime()


def test_two_member_cpu_fleet_drains_the_reference_controller(tmp_path):
    """Two warmed members lease from the reference's ControllerServer over
    HTTP; every job succeeds, on a member of the fleet, and the classify
    results equal the op's in this process."""
    from agent_tpu.controller.core import Controller
    from agent_tpu.controller.server import ControllerServer
    from agent_tpu_torch.ops import get_op
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    payload = {"texts": [f"fleet row {i}" for i in range(6)], "model_config": TINY, "topk": 3}
    ctrl = Controller()
    with ControllerServer(ctrl) as srv:
        handle = fleet.spawn_fleet(
            2, controller_url=srv.url, tasks="echo,map_tokenize,map_classify_tpu",
            warm_file=_warm_file(tmp_path, [{"op": "map_classify_tpu", "payload": payload}]),
            extra_env={"IDLE_SLEEP_SEC": "0.05", "PIPELINE_DEPTH": "0"},
            log_dir=str(tmp_path / "logs"))
        try:
            assert fleet.wait_for_agents(ctrl.agents_summary, handle.names, timeout=120.0,
                                         fleet=handle), handle.poll_failures()
            jobs = [ctrl.submit("echo", {"i": i}) for i in range(8)]
            jobs += [ctrl.submit("map_tokenize", {"text": f"row {i}"}) for i in range(4)]
            classify = [ctrl.submit("map_classify_tpu", dict(payload)) for _ in range(4)]
            deadline = time.monotonic() + 120.0
            while not ctrl.drained() and time.monotonic() < deadline:
                time.sleep(0.1)
            assert ctrl.drained(), ctrl.counts()
            snaps = [ctrl.job_snapshot(j) for j in jobs + classify]
            assert {s["state"] for s in snaps} == {"succeeded"}, snaps
            assert {s["agent"] for s in snaps} <= set(handle.names)
            want = get_op("map_classify_tpu")(dict(payload), OpContext(
                runtime=TorchRuntime(device="cpu")))
            for j in classify:
                assert ctrl.job_snapshot(j)["result"]["results"] == want["results"]
        finally:
            handle.stop(timeout=30.0)
    assert [p.returncode for p in handle.procs] == [0, 0]
    assert handle.alive() == 0


def test_the_agent_pushes_its_kernel_launches(monkeypatch):
    """A member's row-1 launch counter rides its lease metrics (chip_smoke
    phase 18 reads it from the stand-in)."""
    import chip_smoke
    from agent_tpu_torch.kernels import flash_attention as fa

    agent = Agent(config=Config(agent=AgentConfig(tasks=("echo",))), session=object())
    monkeypatch.setitem(fa.LAUNCH_COUNTS, "flash_attention", 7)
    snap = agent._metrics()["obs"]
    assert chip_smoke.obs_values(snap, "kernel_launches", kernel="flash_attention") == [7]
    assert chip_smoke.obs_values(snap, "kernel_launches", kernel="flash_fold") == [
        fa.LAUNCH_COUNTS["flash_fold"]]


def test_the_cli_refuses_no_agents_and_stops_on_a_dead_member(tmp_path, capsys):
    """``fleet_cli`` (scripts/fleet.py's flags): --agents 0 exits 2; a
    member whose warm-up fails (exit 3) ends the wait, and the CLI exits 1."""
    from agent_tpu_torch.agent import fleet_cli

    assert fleet_cli.main(["--agents", "0", "--controller", "http://127.0.0.1:9"]) == 2
    warm = _warm_file(tmp_path, [{"op": "map_classify_tpu", "payload": {}}])
    assert fleet_cli.main(["--agents", "1", "--controller", "http://127.0.0.1:9",
                           "--tasks", "echo", "--warm-file", warm,
                           "--log-dir", str(tmp_path / "logs"),
                           "--ready-timeout", "60"]) == 1
    assert "NOT ready" in capsys.readouterr().out
    assert "fleet warmup failed" in (tmp_path / "logs" / "fleet-0.log").read_text()
