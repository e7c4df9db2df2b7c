"""A rehearsal of chip_smoke's phase 15 on the CPU at toy size: the port's
pipelined agent drains the stand-in controller's classify shards with
tracing off and on, every shard's spans assemble into a complete tree,
the usage stamps reconcile with the busy counter the agent shipped (within
1 %) and with the staged shapes' FLOPs (exactly), every result equals the
serial run's bit for bit, the PROFILE_DIR trace and the capture's artifact
are written (the CPU has no CUDA kernel events to find in them), the
slo_page alert dumps the recorder, and the failover list rotates once. The
MFU gauge needs a peak: PEAK_TFLOPS on the CPU, without which the phase
fails. Also phase 10's entry point with ``TPU_DISABLED=1`` (a CPU runtime
in its own process): SIGUSR1 dumps its recorder and SIGTERM ends it."""

import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.runtime import TorchRuntime

TINY = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 64, "max_len": 64,
        "dtype": "float32"}


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    for name, value in (("CARD", "cpu"), ("BERT_BASE", TINY), ("DRAIN_ROWS", 384),
                        ("DRAIN_SHARD", 128), ("DRAIN_TIMEOUT_S", 120), ("ENTRY_SHARD", 16)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    plain = fa.make_flash_attention

    def counting(mesh=None):
        attn = plain(mesh)

        def run(q, k, v, mask):
            fa.LAUNCH_COUNTS["flash_attention"] += 1
            return attn(q, k, v, mask)

        return run

    monkeypatch.setattr(fa, "make_flash_attention", counting)
    path = str(tmp_path / "drain.csv")
    chip_smoke.write_drain_csv(path)
    yield path
    chip_smoke.reset_counts(fa)


def _phase(path):
    """Phase 15 on a stand-in of its own, with phase 10's shards, their
    serial results and staged states at toy size."""
    rt = TorchRuntime(device="cpu")
    op = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    _, _, shards, _ = chip_smoke.drain_payloads(path)
    serial, _ = chip_smoke.serial_shards(op, rt, shards)
    staged = [op.stage(dict(p))[1] for p in shards]
    with chip_smoke.StandInController() as ctrl:
        report = chip_smoke.telemetry_phase(fa, rt, ctrl, shards, serial, staged)
        assert ctrl.stale == 0
    return report


def test_telemetry_phase_rehearsal(rehearsal, monkeypatch, capsys):
    monkeypatch.setenv("PEAK_TFLOPS", "1")
    report = _phase(rehearsal)
    assert report["spans_per_job"] == 6  # submit, lease, stage, queue, execute, post
    assert report["launches"] == TINY["n_layers"] * 3
    assert report["launched_per_shard"] == [TINY["n_layers"]]
    usage = report["usage"]
    assert abs(usage["device_s"] - usage["busy_counter_s"]) <= 0.01 * usage["busy_counter_s"]
    assert usage["flops"] == usage["staged_flops"] > 0 and usage["chips"] == [1.0]
    assert 0 < report["device_mfu"] <= 1 and report["peak_tflops"] == 1.0
    assert 0 < report["device_duty_cycle"] <= 1
    assert report["flash_fwd_sm90_traced"] == {"profile_dir": 0, "capture": 0}
    assert report["slo_dump_events"] > 0
    assert report["failover"]["failed"] == chip_smoke.DEAD_CONTROLLER
    assert '"phase": "telemetry"' in capsys.readouterr().out


def test_telemetry_phase_fails_without_a_peak(rehearsal, monkeypatch):
    monkeypatch.delenv("PEAK_TFLOPS", raising=False)
    with pytest.raises(SystemExit, match=r"device_mfu \[\] \(peak None\)"):
        _phase(rehearsal)


def test_entry_point_sigusr1_rehearsal(rehearsal, monkeypatch):
    monkeypatch.setenv("TPU_DISABLED", "1")
    report = chip_smoke.entry_point_phase(rehearsal)
    assert report["exit_code"] == 0 and report["exit_code_tasks_none"] == 2
    assert report["sigusr1_dump_leases"] >= 1
