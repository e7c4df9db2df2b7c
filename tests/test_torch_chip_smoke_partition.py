"""A rehearsal of chip_smoke's phases 21 and 22 on the CPU at toy width:
the router, two partition controllers and p0's hot standby in processes of
their own, the partitioned drain by an agent process with the partition
map, the kill of p0's primary and the promotion, the autoscaler's scale-up
and scale-down of a process fleet under two LoadGen schedules, and the
chaos drain. "The card" is the CPU: the processes ask for it
(TPU_DISABLED=1), the fleet's members too (ELASTIC_PLATFORM "cpu"); no
kernel launches there, so an agent process's row-1 counter is read as
n_layers times each dispatch chunk of its runs (phase 21) or its busy
seconds (phase 22's members), while this process counts its own launches.
Planted faults must each fail their phase: a standby that never promotes,
a shard applied twice, a member that exits non-zero."""

import sys

import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(2)

TINY = {"d_model": 32, "n_heads": 2, "n_layers": 2, "d_ff": 64, "max_len": 64,
        "n_classes": 16, "dtype": "float32"}
NEVER_PROMOTES = (
    "import signal, sys, time\n"
    "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
    "signal.signal(signal.SIGUSR1, signal.SIG_IGN)\n"
    "print('[agent-tpu-standby] tailing a journal (SIGUSR1 promotes)', flush=True)\n"
    "time.sleep(600)\n")


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    for name, value in (("CARD", "cpu"), ("BERT_BASE", TINY), ("DRAIN_ROWS", 768),
                        ("DRAIN_SHARD", 128), ("ELASTIC_PLATFORM", "cpu"),
                        ("LOAD_SECONDS", 8.0), ("LOAD_INFER_RATE", 8.0),
                        ("LOAD_INFER_BURST", (0.5, 6.0, 3.0)), ("LOAD_JOBS_RATE", 3.0),
                        ("LOAD_JOB_ROWS", 64), ("PART_SERVE_MAX_PENDING", 2),
                        # members that poll an empty queue every 0.5 s leave
                        # jobs queued between polls: the queue the scale-up reads
                        ("ELASTIC_EXTRA_ENV", {"IDLE_SLEEP_SEC": "0.5"}),
                        ("ELASTIC_DEADLINE_S", 120), ("DRAIN_TIMEOUT_S", 120),
                        ("PROMOTE_DEADLINE_S", 30),
                        ("ELASTIC_SCALER", dict(chip_smoke.ELASTIC_SCALER,
                                                up_queue_per_agent=0.5))):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setenv("TPU_DISABLED", "1")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    def counting(fn):
        def run(*args, **kw):
            fa.LAUNCH_COUNTS["flash_attention"] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(fa, "flash_attention", counting(fa.flash_attention))
    path = str(tmp_path / "drain.csv")
    chip_smoke.write_drain_csv(path)
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    rt = TorchRuntime(device="cpu")
    shards = chip_smoke.drain_payloads(path)[2]
    serial, _ = chip_smoke.serial_shards(classify, rt, shards)
    chunks = [len(classify.stage(dict(p))[1]["chunks"]) for p in shards]
    real_gauge = chip_smoke.agent_gauge

    def gauge(plane, family, agent, **labels):
        """No kernel launches on the CPU: phase 21's agent launches n_layers
        times each chunk of its runs, a member as its busy milliseconds."""
        if family != "kernel_launches":
            return real_gauge(plane, family, agent, **labels)
        if agent.startswith("chip-smoke-part-"):
            runs = chip_smoke.fleet_counter(plane, "tasks_total", op="map_classify_tpu",
                                            status="succeeded")
            return TINY["n_layers"] * (1 + chunks[0] * runs)
        return 1e3 * real_gauge(plane, "device_busy_seconds_total", agent)

    monkeypatch.setattr(chip_smoke, "agent_gauge", gauge)
    yield {"tmp": tmp_path, "path": path, "rt": rt, "serial": serial, "chunks": chunks}
    chip_smoke.reset_counts(fa)


def test_phases_21_and_22_rehearsal(rehearsal):
    r = rehearsal
    tmp = str(r["tmp"])
    with chip_smoke.PartitionedPlane(tmp) as plane:
        driver = chip_smoke.elastic_driver(plane, tmp)
        try:
            started = chip_smoke.start_partition_drain(plane, r["path"], tmp)
            part = chip_smoke.partition_phase(fa, plane, started, r["serial"], r["chunks"])
            elastic = chip_smoke.elastic_phase(fa, OpContext(runtime=r["rt"]), plane, driver, 5)
        finally:
            driver.stop_all(timeout=60)
        chaos = chip_smoke.chaos_phase(fa, r["rt"], plane, r["path"], r["serial"], r["chunks"])
    assert plane.rcs == {"router": 0, "standby": 0, "p1": 0}
    assert part["shards"] == 12 and part["billed_once"] == 12 and part["agent_exit_code"] == 0
    assert part["partition_of_source"] == {"p0": "p0", "p1": "p1"}
    assert part["routing"]["lease_grants_stolen_total"] >= 1
    assert part["failover_gap_s"] > 0 and part["standby_promotion"]["lag_bytes"] >= 0
    assert elastic["scale_ups"] >= 1 and elastic["scale_downs"] >= 1
    assert elastic["replacements"] == 0
    assert all(m["exit_code"] == 0 for m in elastic["members"].values())
    assert elastic["infer_agreement"]["ok"] and elastic["jobs_agreement"]["ok"]
    assert chaos["equal_to_serial"] and chaos["billed_attempts"] == [1] * 4
    assert chaos["fault_counts"] and chaos["launches"] == chaos["launches_want"]


def test_a_standby_that_never_promotes_fails_phase_21(rehearsal, monkeypatch):
    monkeypatch.setattr(chip_smoke, "STANDBY_CMD", [sys.executable, "-c", NEVER_PROMOTES])
    monkeypatch.setattr(chip_smoke, "PROMOTE_DEADLINE_S", 3)
    r = rehearsal
    with pytest.raises(SystemExit, match="promoted"):
        with chip_smoke.PartitionedPlane(str(r["tmp"])) as plane:
            started = chip_smoke.start_partition_drain(plane, r["path"], str(r["tmp"]))
            chip_smoke.partition_phase(fa, plane, started, r["serial"], r["chunks"])


def test_a_shard_applied_twice_fails_phase_21(rehearsal, monkeypatch):
    real = chip_smoke.submit_partitioned

    def twice(plane, sources, extra):
        out = real(plane, sources, extra)
        payload = dict(extra, source_uri=sources["p1"], start_row=0,
                       shard_size=chip_smoke.DRAIN_SHARD)
        status, _ = chip_smoke.http_json(plane.url + "/v1/jobs", {
            "op": "map_classify_tpu", "payload": payload,
            "required_labels": chip_smoke.PART_LABELS})
        assert status == 200
        return out

    monkeypatch.setattr(chip_smoke, "submit_partitioned", twice)
    r = rehearsal
    with pytest.raises(SystemExit, match="phase 21 failed"):
        with chip_smoke.PartitionedPlane(str(r["tmp"])) as plane:
            started = chip_smoke.start_partition_drain(plane, r["path"], str(r["tmp"]))
            chip_smoke.partition_phase(fa, plane, started, r["serial"], r["chunks"])


def test_a_member_that_exits_non_zero_fails_phase_22(rehearsal, monkeypatch):
    monkeypatch.setattr(chip_smoke, "ELASTIC_EXTRA_ENV", {"TASKS": "map_classify_tpu,no_such_op"})
    r = rehearsal
    with pytest.raises(SystemExit, match="member"):
        with chip_smoke.PartitionedPlane(str(r["tmp"])) as plane:
            driver = chip_smoke.elastic_driver(plane, str(r["tmp"]))
            try:
                chip_smoke.elastic_phase(fa, OpContext(runtime=r["rt"]), plane, driver, 5)
            finally:
                driver.stop_all(timeout=30)
    assert [h.get("rc") not in (None, 0) for h in driver.history.values()] == [True]
