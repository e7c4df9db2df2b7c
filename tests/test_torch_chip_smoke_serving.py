"""A rehearsal of chip_smoke's phase 13 on the CPU at toy size: the engine
against the static batch on bench.py's stream, the engine's exactness
checks with their planted trash-block fault, requests through the port's
``POST /v1/infer`` front door and pipelined agent (``serve_summarize``
jobs), the disaggregated chain the controller makes of them
(``serve_prefill`` -> ``serve_decode`` over ``b1``), ``summarize_encode`` ->
``summarize_decode`` against ``map_summarize``, and ``serve_classify``. On the CPU the kernel
wrapper runs its plain version and counts nothing, so the rehearsal counts
calls of the attention function instead (the card's run counts launches)."""

import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.ops import load_ops, serve_infer
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

SERVE_TINY = {"d_model": 32, "n_heads": 4, "n_enc_layers": 2, "n_dec_layers": 1, "d_ff": 64,
              "max_src_len": 512, "max_tgt_len": 16, "dtype": "float32"}
BERT_TINY = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 64, "max_len": 64,
             "dtype": "float32"}


@pytest.fixture
def rehearsal(monkeypatch):
    for name, value in (("CARD", "cpu"), ("SERVE_MODEL", SERVE_TINY), ("SERVE_REQUESTS", 24),
                        ("SERVE_SLOTS", 4), ("SERVE_WIDE_SLOTS", 8), ("SERVE_WARM", 4),
                        ("SERVE_PROFILE_STEPS", 3), ("SERVE_EXACT_REQUESTS", 12),
                        ("SERVE_AGENT_JOBS", (3, 5)), ("DISAGG_REQUESTS", 8),
                        ("MPMD_ROWS", 4), ("S2S_MAX_NEW", 3), ("BERT_BASE", BERT_TINY),
                        ("DRAIN_TIMEOUT_S", 120)):
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

    def profile(fn):
        fn()
        return {"wall_ms": 1.0, "device_ms": 0.0, "idle_share": None, "kernels_launched": 0,
                "host_blocked_reads": 0, "host_blocked_ms": 0.0, "device_ms_by_kind": {},
                "top_kernels": [], "profile_attempts": 1}

    monkeypatch.setattr(chip_smoke, "profile_call", profile)
    serve_infer.reset_engines()
    yield
    serve_infer.reset_engines()
    chip_smoke.reset_counts(fa)


def test_serving_phase_rehearsal(rehearsal, capsys):
    report = chip_smoke.serving_phase(fa, TorchRuntime(device="cpu"), {"launches": 0})
    assert report["stream_prefill_launches"] == SERVE_TINY["n_enc_layers"]
    greedy, beam, wide = report["engine_vs_static"]
    assert (greedy["slots"], beam["num_beams"], wide["slots"]) == (4, 4, 8)
    # The greedy and beam legs decode the first quarter of the stream, the
    # wide leg twice its slots.
    assert [leg["requests"] for leg in (greedy, beam, wide)] == [6, 6, 16]
    for leg in (greedy, beam, wide):
        assert leg["tokens"] > 0
        assert leg["kv_blocks_free"] == leg["kv_blocks_total"] > 0
        assert leg["engine_steps"] <= leg["static_steps"]
    assert greedy["profile_steps"]["steps"] == 3
    assert "profile_steps" not in beam and "profile_steps" not in wide
    exact = report["exactness_f32"]
    assert exact["beams1_paged_equal"] == exact["beams4_cpu_paged_equal"] == 12
    assert exact["planted_no_trash_repoint_changed"] > 0
    agent = report["agent"]
    # 8 requests of one bucket: one batch, flushed at the deadline
    assert agent["jobs"] == [8] and agent["engines"] == 1 and agent["batches_as_predicted"]
    assert agent["launches"] == agent["launches_want"] == SERVE_TINY["n_enc_layers"]
    disagg = report["disagg"]
    assert disagg["hit_rate"] >= 0.5 and disagg["prefill_b1"] == len(disagg["jobs"])
    assert disagg["equal_to_colocated"] and disagg["decode_launches"] == 0
    assert {"queue_wait", "prefill", "handoff", "first_decode"} <= set(
        disagg["ttft_components_ms"])
    assert report["mpmd"]["launches"] == {"encode": SERVE_TINY["n_enc_layers"], "decode": 0}
    assert '"phase": "serving"' in capsys.readouterr().out


def test_serving_cases_follow_the_serve_stage(rehearsal):
    cases = chip_smoke.serving_cases(load_ops(["serve_summarize"])["serve_summarize"])
    names = [name.split("/")[0] for name, *_ in cases]
    assert names[:2] == ["serve_admit8", "serve_stream240"]
    assert names.count("serve_agent") == 1 and names.count("serve_disagg") == 2
    for _, (B, H, Lq, Lk, D), lengths, dtype in cases:
        assert (H, D, Lq) == (4, 8, Lk) and len(lengths) == B and max(lengths) <= Lk
        assert dtype == torch.float32


def test_serve_classify_check_rehearsal(rehearsal, capsys):
    texts = ["a first request", "another request to classify", "x"]
    report = chip_smoke.serve_classify_check(fa, OpContext(runtime=TorchRuntime(device="cpu")),
                                             texts, 3)
    assert report["equal_to_map_classify"] and report["launches"] == BERT_TINY["n_layers"]
    assert '"phase": "serve_classify"' in capsys.readouterr().out
