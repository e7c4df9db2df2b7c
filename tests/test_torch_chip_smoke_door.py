"""A rehearsal of chip_smoke's phase 20 on the CPU at toy size: the port's
``ControllerServer`` with the default ServeConfig and one pipelined port
agent offering serve_classify; client threads post blocking ``POST
/v1/infer`` classify requests of 20-900 bytes (every length bucket), each
answer held to serve_classify's direct answer on the same text, the batches by
bucket and flush reason to ``serve_batches_total`` and ``GET /v1/status``,
the kernel wrapper's calls to n_layers a job; then two max_batch loads of
one bucket posted at once, flushed "full"; then the burst against
max_pending, whose 429s carry retry_after_ms and whose retries succeed. On
the CPU the wrapper runs its plain version and counts nothing, so the
rehearsal counts calls of the attention function instead (the card's run
counts launches); a batch whose forward skips it must fail the phase."""

import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

TINY = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 64, "max_len": 64,
        "dtype": "float32"}


@pytest.fixture
def rehearsal(monkeypatch):
    for name, value in (("CARD", "cpu"), ("BERT_BASE", TINY), ("DOOR_REQUESTS", 96),
                        ("DOOR_CLIENTS", 4), ("DOOR_BURST", 12), ("DOOR_BURST_PENDING", 4),
                        ("DRAIN_TIMEOUT_S", 120)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    calls = {"n": 0, "skip": None}
    plain = fa.make_flash_attention

    def counting(mesh=None):
        attn = plain(mesh)

        def run(q, k, v, mask):
            calls["n"] += 1
            if calls["n"] != calls["skip"]:
                fa.LAUNCH_COUNTS["flash_attention"] += 1
            return attn(q, k, v, mask)

        return run

    monkeypatch.setattr(fa, "make_flash_attention", counting)
    rt = TorchRuntime(device="cpu")
    yield rt, OpContext(runtime=rt), calls
    chip_smoke.reset_counts(fa)


def test_front_door_phase_rehearsal(rehearsal, capsys):
    rt, ctx, _ = rehearsal
    report = chip_smoke.front_door_phase(fa, rt, ctx, 3)
    assert report["requests"] == 96 and report["agreement"]["ok"]
    assert report["agreement"]["non_tie_flips"] == 0
    assert report["launches"] == report["launches_want"] == TINY["n_layers"] * report["batches"]
    assert report["agent_tasks"] == report["batches"] > 0
    assert set(report["batches_by_bucket"]) == {"64", "128", "256", "512", "1024"}
    assert sum(report["batches_by_reason"].values()) == report["batches"]
    assert report["serve_batches_total"] == {r: report["batches_by_reason"].get(r, 0)
                                             for r in ("full", "deadline")}
    assert report["status_requests"] == {"done": 96}
    # At most DOOR_CLIENTS requests wait at once: no bucket fills to 16.
    assert report["riders_per_batch"]["max"] <= 4 and "full" not in report["batches_by_reason"]
    assert {"bucket_wait", "queue_wait"} <= set(report["ttft_components_ms"])
    loaded = report["loaded_burst"]
    assert loaded["batches"] == [(64, "full", 16)] * 2 and loaded["serve_batches_full"] == 2
    assert loaded["launches"] == TINY["n_layers"] * 2 and loaded["agreement"]["ok"]
    burst = report["burst"]
    assert burst["refused_429"] == 12 - 4 and burst["retries"] >= 8
    assert burst["agreement"]["ok"] and min(burst["retry_after_ms"]) > 0
    assert '"phase": "front_door"' in capsys.readouterr().out


def test_a_batch_that_skips_the_kernel_fails_the_phase(rehearsal):
    rt, ctx, calls = rehearsal
    calls["skip"] = 3  # the second job's first layer does not count
    with pytest.raises(SystemExit, match="the front door failed"):
        chip_smoke.front_door_phase(fa, rt, ctx, 3)


def test_front_door_batches_follow_the_controllers_bucketing():
    bodies = [{"op": "summarize", "text": "x" * n, "params": {"max_length": 4}}
              for n in (10, 70, 20, 300, 30)]
    batches = chip_smoke.front_door_batches("summarize", bodies)
    assert [(b["bucket"], [r["req_id"] for r in b["requests"]]) for b in batches] == [
        (64, ["q0000", "q0002", "q0004"]), (128, ["q0001"]), (512, ["q0003"])]
    assert all(r["max_length"] == 4 for b in batches for r in b["requests"])
