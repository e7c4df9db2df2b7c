"""The port's leader/follower wiring in one process, against the
reference's (tests/test_distributed.py): the pass-throughs without a
coordinator, the sentinels, the default leader, the runtime's ``dist``,
the config's parse, and the broadcast's buckets and ceiling."""

import pytest

from agent_tpu.runtime import distributed as jax_dist
from agent_tpu_torch.config import Config, DeviceConfig
from agent_tpu_torch.runtime import distributed
from agent_tpu_torch.runtime.distributed import (DistInfo, broadcast_task, is_keepalive,
                                                 is_shutdown, maybe_initialize)


def test_maybe_initialize_without_coordinator_is_single_process():
    info = maybe_initialize(None)
    assert info == DistInfo(process_index=0, process_count=1) and info.is_leader
    assert jax_dist.maybe_initialize(None) == jax_dist.DistInfo(0, 1)
    assert maybe_initialize("", 2, 1) == DistInfo(0, 1)


def test_broadcast_task_single_process_passthrough():
    task = {"op": "echo", "payload": {"x": [1, 2, 3]}}
    assert broadcast_task(task) is task
    assert broadcast_task(None) is None
    assert distributed._broadcast_bytes(b"abc") == b"abc"
    assert distributed.all_gather_object({"a": 1}) == [{"a": 1}]


def test_sentinels():
    assert is_shutdown(distributed._SHUTDOWN) and jax_dist.is_shutdown(distributed._SHUTDOWN)
    assert distributed._SHUTDOWN == jax_dist._SHUTDOWN
    for other in (None, {"op": "echo"}, distributed._KEEPALIVE):
        assert not is_shutdown(other)
    assert is_keepalive(distributed._KEEPALIVE)
    assert not is_keepalive(distributed._SHUTDOWN) and not is_keepalive(None)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 100_000, 1 << 20, (1 << 26) - 1])
def test_bucket_matches_the_reference(n):
    assert distributed._bucket(n) == jax_dist._bucket(n)
    assert distributed._bucket(n) >= max(n, distributed.MIN_BCAST_BYTES)


def test_the_limits_are_the_reference_s():
    assert (distributed.MIN_BCAST_BYTES, distributed.MAX_TASK_BYTES) == \
        (jax_dist.MIN_BCAST_BYTES, jax_dist.MAX_TASK_BYTES) == (4096, 1 << 26)


def test_a_payload_over_the_ceiling_raises_before_any_collective(monkeypatch):
    monkeypatch.setattr(distributed, "current", lambda: DistInfo(0, 2))
    with pytest.raises(ValueError, match="exceeds"):
        distributed._broadcast_bytes(b"x" * (distributed.MAX_TASK_BYTES + 1))


def test_a_coordinator_without_the_counts_raises():
    with pytest.raises(ValueError, match="NUM_PROCESSES and PROCESS_ID"):
        maybe_initialize("localhost:1", None, 0)


def test_agent_dist_info_default_is_leader(monkeypatch):
    from agent_tpu_torch.agent.app import Agent

    monkeypatch.setenv("TASKS", "echo")
    agent = Agent(config=Config.from_env(), session=object())
    info = agent._dist_info()
    assert info.process_count == 1 and info.is_leader and agent.dist == info


def test_follower_loop_exits_immediately_single_process(monkeypatch):
    from agent_tpu_torch.agent.app import Agent

    monkeypatch.setenv("TASKS", "echo")
    agent = Agent(config=Config.from_env(), session=object())
    agent.run_follower()
    assert agent.tasks_done == 0


def test_runtime_exposes_dist_info():
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    rt = TorchRuntime(device="cpu")
    assert rt.dist.process_count == 1 and rt.dist.is_leader
    assert not rt.mesh.spans_processes and rt.mesh.local_positions() == [
        {"dp": 0, "tp": 0, "sp": 0}]
    rt.require_local("map_classify_tpu")  # one process: nothing to refuse


@pytest.mark.parametrize("env,want", [
    ({}, (None, None, None)),
    ({"COORDINATOR_ADDRESS": "h:1", "NUM_PROCESSES": "2", "PROCESS_ID": "1"}, ("h:1", 2, 1)),
    ({"COORDINATOR_ADDRESS": "h:1", "NUM_PROCESSES": "x", "PROCESS_ID": "0"}, ("h:1", None, 0)),
    ({"PROCESS_ID": "bad"}, (None, None, None)),
    ({"PROCESS_ID": "3.0", "NUM_PROCESSES": "0"}, (None, None, 3)),
])
def test_config_reads_the_trio_as_the_reference(monkeypatch, env, want):
    from agent_tpu.config import DeviceConfig as JaxDeviceConfig

    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = DeviceConfig.from_env(), JaxDeviceConfig.from_env()
    got = (ours.coordinator_address, ours.num_processes, ours.process_id)
    assert got == want == (theirs.coordinator_address, theirs.num_processes,
                           theirs.process_id)


def test_mesh_owners_and_local_positions():
    import torch

    from agent_tpu_torch.runtime.mesh import build_mesh

    mesh = build_mesh(["cpu"] * 4, {"dp": 2, "tp": 2}, owners=[0, 0, 1, 1], process_index=1)
    assert mesh.spans_processes and mesh.owner_at(dp=1, tp=0) == 1
    assert not mesh.is_local(dp=0, tp=1) and mesh.is_local(dp=1, tp=1)
    assert mesh.local_positions() == [{"dp": 1, "tp": 0, "sp": 0}, {"dp": 1, "tp": 1, "sp": 0}]
    assert mesh.device_at(dp=1) == torch.device("cpu")
    alone = build_mesh(["cpu"] * 2, {"dp": 2}, owners=[1, 1], process_index=1)
    assert not alone.spans_processes
    with pytest.raises(ValueError, match="owners"):
        build_mesh(["cpu"] * 2, None, owners=[0])
