"""A rehearsal of chip_smoke's phase 10 on the CPU at toy size: the port's
Agent drains the port's controller's classify, summarize and
risk_accumulate shards through the pipelined runner, the shards' results
agree bit for bit with the ops run serially, and the serving kernel's
wrapper is reached n_layers times per dispatch chunk. On the CPU the
wrapper runs its plain version and counts nothing, so the rehearsal counts
calls of the attention function instead (the card's run counts launches).
nvidia-smi's inventory is stubbed with a small card, so that the agent's
profile carries a shard-size hint the phase checks against the formula.
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
    from agent_tpu_torch.sizing import profile as sizing

    # 512 MiB: 8 rows a step, 128-row shards (the formula's floor).
    monkeypatch.setattr(sizing, "detect_gpu", lambda: {
        "gpu_present": True, "gpus": [{"name": "a small card", "memory_mb": 512}],
        "max_gpu_workers": 1})
    path = str(tmp_path / "drain.csv")
    chip_smoke.write_drain_csv(path)
    yield path
    chip_smoke.reset_counts(fa)


def test_drain_phase_rehearsal(rehearsal, capsys):
    report = chip_smoke.drain_phase(fa, TorchRuntime(device="cpu"), rehearsal)
    assert report["rows"] == 384 and report["dispatch_chunks"] == [1, 1, 1]
    assert report["launches"] == TINY["n_layers"] * 3
    assert report["b1_results"] == 3 and report["b1_tasks_sent"] == 0  # CSV-addressed tasks
    assert report["risk"]["device"] == "mesh"
    assert report["shard_hint"] == {"controller": 128, "formula": 128, "cards": 1,
                                    "memory_mb": 512, "shard_rows": 128}
    assert report["lease_http_bytes"]["out"] > 0 and report["result_http_bytes_in"] > 0
    assert set(report["p50_phase_ms"]) == {"stage_ms", "queue_ms", "device_ms", "fetch_ms",
                                           "finalize_ms"}
    assert report["telemetry"]["launches"] == TINY["n_layers"] * 3
    out = capsys.readouterr().out
    assert '"phase": "drain"' in out and out.index('"phase": "drain"') < out.index(
        '"phase": "telemetry"')


def test_port_controller_fences_epochs_and_counts_refused_posts(rehearsal):
    from agent_tpu_torch.utils.http import UrllibSession

    with chip_smoke.PortController() as ctrl:
        job = ctrl.submit("echo", {"x": 1})
        s = UrllibSession()
        assert s.post(ctrl.url + "/v1/leases", json={"capabilities": {"ops": ["other"]},
                                                     "max_tasks": 1}, timeout=5).status_code == 204
        lease = s.post(ctrl.url + "/v1/leases", json={
            "agent": "a", "capabilities": {"ops": ["echo"], "wire_formats": ["b1"]},
            "max_tasks": 4}, timeout=5).json()
        assert lease["wire"] == "b1" and lease["tasks"][0]["job_epoch"] == 0
        body = {"lease_id": lease["lease_id"], "job_id": job, "job_epoch": 1,
                "status": "succeeded", "result": {"ok": True}}
        assert s.post(ctrl.url + "/v1/results", json=body, timeout=5).json()["accepted"] is False
        body["job_epoch"] = 0
        assert s.post(ctrl.url + "/v1/results", json=body, timeout=5).json()["accepted"] is True
        assert s.post(ctrl.url + "/v1/results", json=body, timeout=5).json()["accepted"] is False
        assert ctrl.drained() and ctrl.fenced() == {"stale_epoch": 1, "duplicate": 1,
                                                    "unknown_job": 0}
        with pytest.raises(SystemExit, match="refused posts"):
            ctrl.outcome([job])
