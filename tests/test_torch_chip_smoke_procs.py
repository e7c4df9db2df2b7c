"""A rehearsal of chip_smoke's phase 18 on the CPU at toy size: (a) two
agent processes joined on a free port, the leader draining the stand-in
controller (echo, map_tokenize, risk_accumulate over the cross-process dp
2) and the planted follower that skips a task; (b) a two-member fleet
warmed and draining phase 10's CSV, its results equal to the serial op's;
(c) a tp 2 encoder saved sharded and restored onto tp 2, dp 2 × tp 2 and
one device. "The card" is the CPU: the processes ask for it
(TPU_DISABLED=1), the fleet's members too (FLEET_PLATFORM "cpu"), and, as
no kernel launches there, the members' progress is read from their
tasks_total counter instead of the row-1 launch counter."""

import numpy as np
import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import encoder
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(2)

TINY = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 128, "max_len": 64,
        "n_classes": 16, "dtype": "float32"}


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    for name, value in (("CARD", "cpu"), ("BERT_BASE", TINY), ("DRAIN_ROWS", 384),
                        ("DRAIN_SHARD", 128), ("PROC_RISK_VALUES", 8192),
                        ("FLEET_PLATFORM", "cpu"), ("PROC_DEADLINE_S", 150),
                        ("FLEET_DEADLINE_S", 150)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setenv("TPU_DISABLED", "1")
    for name in ("synchronize",):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)

    def counting(fn):
        def run(*args, **kw):
            fa.LAUNCH_COUNTS["flash_attention"] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(fa, "flash_attention", counting(fa.flash_attention))
    yield tmp_path
    chip_smoke.SEEDED.clear()
    chip_smoke.reset_counts(fa)


def test_leader_and_follower_rehearsal(rehearsal):
    report = chip_smoke.procs_phase(2, str(rehearsal))
    assert report["rcs"] == [0, 0] and report["follower_tasks_done"] == [[5]]
    assert report["risk"]["device"] == "mesh" and report["risk"]["count"] == 8192
    assert report["risk"]["sum"] == report["risk_vs_one_process_dp"]["sum"]
    assert report["planted_skip"]["caught"]
    assert report["planted_skip"]["follower_tasks_done"] == [[3]]
    assert len(report["stage_ms_by_task"]) == 5


def test_procs_ok_needs_every_task_on_every_follower():
    run = {"rcs": [0, 0, 0], "follower_tasks_done": [[5], [5]]}
    assert chip_smoke.procs_ok(run, 5)
    assert not chip_smoke.procs_ok(dict(run, follower_tasks_done=[[5], [4]]), 5)
    assert not chip_smoke.procs_ok(dict(run, follower_tasks_done=[[5], []]), 5)
    assert not chip_smoke.procs_ok(dict(run, rcs=[0, 1, 0]), 5)
    log = '[agent-tpu-torch] follower up {"process": 1}\n' \
          '[agent-tpu-torch] follower drained {"tasks_done": 7}\n'
    assert chip_smoke.follower_tasks(log) == [7]


def test_fleet_rehearsal(rehearsal, monkeypatch):
    monkeypatch.setattr(chip_smoke, "fleet_launches", lambda ctrl, name: sum(
        chip_smoke.obs_values(ctrl.agent_obs.get(name), "tasks_total", op="map_classify_tpu")))
    path = str(rehearsal / "drain.csv")
    chip_smoke.write_drain_csv(path)
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    serial, wall = chip_smoke.serial_shards(classify, TorchRuntime(device="cpu"),
                                            chip_smoke.drain_payloads(path)[2])
    report = chip_smoke.fleet_phase(2, path, serial, 384 / wall, None, str(rehearsal))
    assert report["equal_to_serial"] and report["rcs"] == [0, 0]
    assert sum(report["shards_by_member"].values()) == 3
    assert all(n > 0 for n in report["row1_launches_by_member"].values())


def test_fleet_fails_on_results_that_differ(rehearsal, monkeypatch):
    monkeypatch.setattr(chip_smoke, "fleet_launches", lambda ctrl, name: 1.0)
    path = str(rehearsal / "drain.csv")
    chip_smoke.write_drain_csv(path)
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    serial, _ = chip_smoke.serial_shards(classify, TorchRuntime(device="cpu"),
                                         chip_smoke.drain_payloads(path)[2])
    serial[1] = dict(serial[1], scores=[[0.0] * 5] * 128)
    with pytest.raises(SystemExit, match="18 \\(b\\)"):
        chip_smoke.fleet_phase(1, path, serial, 1.0, None, str(rehearsal))


def test_checkpoint_rehearsal(rehearsal):
    chip_smoke.SEEDED["dense"] = encoder.init_params(encoder.EncoderConfig(**TINY),
                                                     "classify-default")
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    texts = chip_smoke.random_texts(chip_smoke.random.Random(1), 8, 20, 60)
    report = chip_smoke.checkpoint_phase(fa, classify, texts, str(rehearsal))
    assert report["files"].keys() == {"index.json", "shard-00000.safetensors",
                                      "shard-00001.safetensors"}
    tp2 = report["restored"]["tp2"]
    assert tp2["leaves_bitwise"] and tp2["probabilities_bitwise"]
    assert tp2["planted_one_ulp_caught"]
    assert report["restored"]["dp2_tp2"]["vs_saved"]["ok"]
    assert report["restored"]["one_device"]["vs_saved"]["max_prob_diff"] < 1e-5
    assert {n: r["row1_launches"] for n, r in report["restored"].items()} == {
        "tp2": 4, "dp2_tp2": 8, "one_device": 2}


def test_the_stand_in_lists_the_agents_that_polled(rehearsal):
    from agent_tpu_torch.agent.fleet_cli import http_agents
    from agent_tpu_torch.utils.http import UrllibSession

    with chip_smoke.StandInController() as ctrl:
        assert http_agents(ctrl.url) == {}
        ctrl.agent_cap = 1
        ids = [ctrl.submit("echo", {"i": i}) for i in range(3)]
        body = {"agent": "a-1", "capabilities": {"ops": ["echo"]}, "max_tasks": 8}
        lease = UrllibSession().post(ctrl.url + "/v1/leases", json=body, timeout=5).json()
        assert len(lease["tasks"]) == 1 and ctrl.jobs[ids[0]]["agent"] == "a-1"
        # a-1 holds its one task: nothing more until it reports
        assert UrllibSession().post(ctrl.url + "/v1/leases", json=body,
                                    timeout=5).status_code == 204
        other = UrllibSession().post(ctrl.url + "/v1/leases", json=dict(body, agent="a-2"),
                                     timeout=5).json()
        assert [t["id"] for t in other["tasks"]] == [ids[1]]
        assert set(http_agents(ctrl.url)) == {"a-1", "a-2"}
        assert http_agents(ctrl.url)["a-1"]["polls"] == 2
