"""A rehearsal of chip_smoke's phase 10 on the CPU at toy size: the port's
Agent drains the stand-in controller's classify, summarize and
risk_accumulate shards through the pipelined runner, the shards' results
agree bit for bit with the ops run serially, and the serving kernel's
wrapper is reached n_layers times per dispatch chunk. On the CPU the
wrapper runs its plain version and counts nothing, so the rehearsal counts
calls of the attention function instead (the card's run counts launches).
Phase 10 ends with phase 15 (the telemetry), whose MFU gauge needs a peak:
PEAK_TFLOPS on the CPU."""

import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.runtime.runtime import TorchRuntime

TINY = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 64, "max_len": 64,
        "dtype": "float32"}


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    for name, value in (("CARD", "cpu"), ("BERT_BASE", TINY), ("DRAIN_ROWS", 384),
                        ("DRAIN_SHARD", 128), ("DRAIN_RISK_VALUES", 4096 + 3),
                        ("S2S_MAX_NEW", 3), ("DRAIN_TIMEOUT_S", 120)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setenv("PEAK_TFLOPS", "1")
    plain = fa.make_flash_attention

    def counting(mesh=None):
        attn = plain(mesh)

        def run(q, k, v, mask):
            fa.LAUNCH_COUNTS["flash_attention"] += 1
            return attn(q, k, v, mask)

        return run

    monkeypatch.setattr(fa, "make_flash_attention", counting)

    def profile(fn):
        before = fa.LAUNCH_COUNTS["flash_attention"]
        fn()
        n = fa.LAUNCH_COUNTS["flash_attention"] - before
        return {"wall_ms": 1.0, "device_ms": 0.0, "idle_share": None, "device_ms_by_kind": {},
                "profile_attempts": 1, "flash_fwd_launches": {"flash_fwd_sm90": n}}

    monkeypatch.setattr(chip_smoke, "profile_call", profile)
    path = str(tmp_path / "drain.csv")
    chip_smoke.write_drain_csv(path)
    yield path
    chip_smoke.reset_counts(fa)


def test_drain_phase_rehearsal(rehearsal, capsys):
    report = chip_smoke.drain_phase(fa, TorchRuntime(device="cpu"), rehearsal)
    assert report["rows"] == 384 and report["dispatch_chunks"] == [1, 1, 1]
    assert report["launches"] == TINY["n_layers"] * 3
    assert report["b1_leases"] >= 5 and report["risk"]["device"] == "mesh"
    assert set(report["p50_phase_ms"]) == {"stage_ms", "queue_ms", "device_ms", "fetch_ms",
                                           "finalize_ms"}
    assert report["telemetry"]["launches"] == TINY["n_layers"] * 3
    out = capsys.readouterr().out
    assert '"phase": "drain"' in out and out.index('"phase": "drain"') < out.index(
        '"phase": "telemetry"')


def test_stand_in_controller_fences_epochs_and_counts_posts(rehearsal):
    from agent_tpu_torch.utils.http import UrllibSession

    with chip_smoke.StandInController() as ctrl:
        job = ctrl.submit("echo", {"x": 1})
        s = UrllibSession()
        assert s.post(ctrl.url + "/v1/leases", json={"capabilities": {"ops": ["other"]},
                                                     "max_tasks": 1}, timeout=5).status_code == 204
        lease = s.post(ctrl.url + "/v1/leases", json={
            "capabilities": {"ops": ["echo"], "wire_formats": ["b1"]}, "max_tasks": 4},
            timeout=5).json()
        assert lease["wire"] == "b1" and lease["tasks"][0]["job_epoch"] == 1
        body = {"lease_id": lease["lease_id"], "job_id": job, "job_epoch": 0,
                "status": "succeeded", "result": {"ok": True}}
        assert s.post(ctrl.url + "/v1/results", json=body, timeout=5).json()["accepted"] is False
        body["job_epoch"] = 1
        assert s.post(ctrl.url + "/v1/results", json=body, timeout=5).json()["accepted"] is True
        assert ctrl.drained() and ctrl.stale == 1
        with pytest.raises(SystemExit, match="posted 2 times"):
            ctrl.outcome([job])
