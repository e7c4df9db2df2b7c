"""A rehearsal of chip_smoke's phase 24 on the CPU at toy width: the port
of ``scripts/check_serving_pipeline.py`` run in process through its legs
(the serving-off drain, serving beside the drain through one pipelined
agent, the colocated and split summarize stacks) on a CPU runtime, then the
phase's gates: every job on the runtime's device with no fallback, row 1
counted as ``mix_want`` says in each leg and in all, no result post
refused, and the serving load inside the drain's window. On the CPU the
kernel wrapper runs its plain version and counts nothing, so the rehearsal
counts calls of the attention function instead (the card's run counts
launches). The load window is cut to 1 s (12 seeded arrivals) and the bulk
to 48 shards of 512 rows, which outlast it and the decode steps the agent
interleaves with them; a drain of one shard ends before the window does
and must fail the overlap gate. Phase 3's cases at the phase's shapes (its
first bulk shard, the batches its front doors form of the script's
requests) are staged at the same toy width."""

import json

import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.runtime import TorchRuntime
from agent_tpu_torch.scripts import check_serving_pipeline as csp

torch.set_num_threads(2)

TINY = {"d_model": 32, "n_heads": 2, "n_layers": 2, "d_ff": 64, "max_len": 64,
        "dtype": "float32"}


@pytest.fixture
def rehearsal(monkeypatch):
    for name, value in (("CARD", "cpu"), ("BERT_BASE", TINY), ("SERVE_MODEL", csp.TINY_S2S),
                        ("MIX_SHARD", 512), ("MIX_ROWS", 48 * 512),
                        ("MIX_DISAGG_ROWS", 4 * 512)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(csp, "LOAD_SECONDS", 1.0)
    monkeypatch.setattr(csp, "N_INFER", 12)
    plain = fa.make_flash_attention

    def counting(mesh=None):
        attn = plain(mesh)

        def run(q, k, v, mask):
            fa.LAUNCH_COUNTS["flash_attention"] += 1
            return attn(q, k, v, mask)

        return run

    monkeypatch.setattr(fa, "make_flash_attention", counting)
    yield TorchRuntime(device="cpu")
    chip_smoke.reset_counts(fa)


def test_phase_24_rehearsal(rehearsal, capsys):
    report = chip_smoke.serving_mix_phase(fa, rehearsal, "cpu")
    assert report["devices"] == ["cpu"] and report["fallbacks"] == 0
    assert report["launches"] == report["launches_want"] > 0
    for name, stack in report["by_stack"].items():
        assert stack["launches"] == stack["launches_want"], name
    assert report["by_stack"]["reference"]["jobs_by_op"] == {"map_classify_tpu": 48}
    assert report["by_stack"]["split"]["by_agent"]["smoke-decode"]["ops"] == [
        "map_classify_tpu", "serve_decode"]
    assert report["by_stack"]["split"]["by_agent"]["smoke-prefill"]["ops"] == ["serve_prefill"]
    assert report["split_ops"] == ["map_classify_tpu", "serve_decode", "serve_prefill"]
    assert report["prefix_hits_split"] > 0 and report["max_occupancy"] > 1
    assert report["requests"] >= 12 + csp.VOLLEY
    assert report["slo_requests_seen"] >= report["requests"]
    assert not any(report["refused_result_posts"].values())
    window = report["window_s"]
    assert 0 < window["first_request_wall"] < window["last_answer_wall"] \
        < window["last_bulk_result_wall"]
    assert report["overlap_s"] > 0
    assert all(v > 0 for v in report["drain_rows_per_s"].values())
    assert '"phase": "serving_mix"' in capsys.readouterr().out


def test_a_drain_that_ends_before_the_load_window_fails_the_overlap_gate(
        rehearsal, monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "MIX_ROWS", 512)
    monkeypatch.setattr(chip_smoke, "MIX_DISAGG_ROWS", 512)
    with pytest.raises(SystemExit, match="phase 24 failed"):
        chip_smoke.serving_mix_phase(fa, rehearsal, "cpu")
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{") and '"phase": "serving_mix"' in ln)
    report = json.loads(line)
    # The bars and every other gate held: the overlap alone failed.
    assert report["launches"] == report["launches_want"] and report["devices"] == ["cpu"]
    assert report["window_s"]["last_answer_wall"] > report["window_s"]["last_bulk_result_wall"]


def test_phase_3_holds_row_1_at_phase_24s_shapes(tmp_path, monkeypatch):
    for name, value in (("BERT_BASE", TINY), ("SERVE_MODEL", csp.TINY_S2S)):
        monkeypatch.setattr(chip_smoke, name, value)
    classify, serve = (load_ops([op])[op] for op in ("map_classify_tpu", "serve_summarize"))
    path = str(tmp_path / "drain.csv")
    chip_smoke.write_drain_csv(path, 700)
    shard = chip_smoke.staged_cases(classify, [("mix_shard", chip_smoke.mix_payload(path, 0, 512),
                                                512)])
    assert sum(c[1][0] for c in shard) == 512
    cases = chip_smoke.serving_mix_cases(classify, serve)
    sizes = {}  # requests a batch (the classify op pads its rows with keyless ones)
    for name, (B, H, Lq, Lk, D), lengths, dtype in cases:
        leg = name.split("/")[0]
        sizes.setdefault(leg, []).append(sum(n > 0 for n in lengths))
        width = TINY if leg.endswith("_classify") else csp.TINY_S2S
        assert (H, D) == (width["n_heads"], width["d_model"] // width["n_heads"]), name
        assert Lq == Lk and len(lengths) == B and 0 < max(lengths) <= Lk, name
        assert dtype == torch.float32
    assert set(sizes) == {"mix_warm_classify", "mix_warm_summarize", "mix_load_classify",
                          "mix_load_summarize", "mix_volley_summarize", "mix_split_summarize"}
    serving, split = csp.SERVE_KNOBS["max_batch"], csp.SPLIT_SERVE_KNOBS["max_batch"]
    assert sizes["mix_warm_classify"] == [1] and 1 in sizes["mix_warm_summarize"]
    assert max(sizes["mix_volley_summarize"]) == serving
    assert max(sizes["mix_load_classify"] + sizes["mix_load_summarize"]) == serving
    assert max(sizes["mix_split_summarize"]) == split
    # Every request of the LoadGen schedule is in a staged batch once.
    load = csp.traffic(TINY, csp.TINY_S2S).schedule(csp.LOAD_SECONDS)
    assert sum(sizes["mix_load_classify"] + sizes["mix_load_summarize"]) == len(load)
