"""A rehearsal of chip_smoke's phase 16 on the CPU at toy size: serving on
every mesh of MESH_SERVING and BERT on tp 2 against one device, the small
f32 models, the ring with dp and tp, training on dp 2 × tp 2,
risk_accumulate on dp 4 and the planted faults, with "the card" the CPU
(every shard of a mesh on it). On the CPU the kernel wrappers run their
plain versions and count nothing, so the rehearsal counts calls of the
kernel entry points instead (the card's run counts launches)."""

import numpy as np
import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import encoder
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.parallel import collectives

torch.set_num_threads(2)

TINY = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 128, "max_len": 64,
        "n_classes": 16, "dtype": "float32"}
LONG_TINY = {"d_model": 64, "n_heads": 2, "max_len": 64, "dtype": "float32"}
HF = dict(chip_smoke.BERT_BASE_UNCASED, vocab_size=600, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=128, max_position_embeddings=64)


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    for name, value in (("CARD", "cpu"), ("BERT_BASE", TINY), ("MOE_EXPERTS", 4),
                        ("MESH_REPS", 1), ("MESH_RISK_VALUES", 4096)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "MESH_SERVING", {
        name: (shape, dict(extra, moe_experts=4) if "moe_experts" in extra else extra)
        for name, (shape, extra) in chip_smoke.MESH_SERVING.items()})
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "profile_call", lambda fn: fn() and {
        "flash_fwd_launches": {"flash_fwd_sm90": 2 * TINY["n_layers"]}})

    def counting(fn, kernels):
        def run(*args, **kw):
            for kernel in kernels:
                fa.LAUNCH_COUNTS[kernel] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(fa, "flash_attention", counting(fa.flash_attention, ["flash_attention"]))
    monkeypatch.setattr(fa, "flash_fold", counting(fa.flash_fold, ["flash_fold"]))
    monkeypatch.setattr(fa, "flash_attention_trainable",
                        counting(fa.flash_attention_trainable, chip_smoke.TRAIN_KERNELS))
    chip_smoke.SEEDED.update(
        dense=encoder.init_params(encoder.EncoderConfig(**TINY), "classify-default"),
        moe=encoder.init_params(encoder.EncoderConfig(**TINY, moe_experts=4),
                                "classify-default"))
    yield tmp_path
    chip_smoke.SEEDED.clear()
    chip_smoke.reset_counts(fa)


def _inputs(tmp):
    """Phase 4's texts, phase 11's BERT payload, phase 5's long payload and
    phase 6's first batch, at toy size."""
    d = str(tmp / "bert")
    chip_smoke.write_hf_checkpoint(d, HF, chip_smoke.bert_state_dict(HF, 1, torch.float32))
    words = chip_smoke.write_wordpiece_vocab(d, HF["vocab_size"], 1)
    rng = np.random.default_rng(0)
    bert = {"model_path": d, "texts": [" ".join(rng.choice(words, 6)) for _ in range(8)]}
    texts = chip_smoke.random_texts(chip_smoke.random.Random(1), 8, 20, 60)
    long_payload = {"texts": chip_smoke.random_texts(chip_smoke.random.Random(2), 4, 40, 60),
                    "model_config": LONG_TINY, "topk": 3}
    rows, labels = chip_smoke.keyword_rows(32, 3)
    batch = chip_smoke.first_train_batch({"texts": rows, "labels": labels, "batch_size": 8,
                                          "epochs": 1, "seed": 0, "model_config": TINY})
    return texts, bert, long_payload, batch


def test_mesh_phase_rehearsal(rehearsal, capsys):
    texts, bert, long_payload, batch = _inputs(rehearsal)
    report = chip_smoke.mesh_phase(fa, "a card, 700 W", texts, bert, long_payload, batch, 100.0)
    serving = report["serving"]
    assert serving["tp2"]["row1_launches"] == 4 and serving["dp2_tp2"]["row1_launches"] == 8
    assert serving["pp2"]["row1_launches"] == 4
    assert serving["dp2_model_config_pp2"]["row1_launches"] == 4
    assert serving["moe_ep2"]["row1_launches"] == 2
    assert serving["moe_dp2_ep4"]["row1_launches"] == 4
    assert serving["bert_tp2"]["row1_launches"] == 4
    assert all(r["vs_one_device"]["ok"] for r in serving.values() if "vs_one_device" in r)
    assert serving["tp2_split_block_bytes"]["shards"][0] * 2 == \
        serving["tp2_split_block_bytes"]["one_device"]
    assert report["ring"]["dp2_sp2"]["fold_launches"] == 4 * 4 * 2
    assert report["train"]["launches_per_step"] == {k: 8 for k in chip_smoke.TRAIN_KERNELS}
    # the totals are counted over every run, the warm-ups included
    steps = chip_smoke.MESH_TRAIN_STEPS + 1
    assert report["train"]["launches"] == {k: 8 * steps for k in chip_smoke.TRAIN_KERNELS}
    assert report["ring"]["dp2_sp2"]["fold_launches_total"] == (4 * 4 * 2
                                                                * (chip_smoke.MESH_REPS + 1))
    faults = report["planted_faults"]
    for name in ("tp_sum_drops_shard1", "bias_on_every_shard", "pp_skips_stage1",
                 "ep_expert1_to_shard0"):
        assert faults[name]["honest_rel_l2"] <= 1e-5 < faults[name]["planted_rel_l2"], name
    assert faults["w8a8_row_scale"]["exact"] and not \
        faults["w8a8_row_scale"]["planted_local_scale_exact"]
    assert report["risk_accumulate"]["overflow"]["sum"] == float("inf")
    assert report["unsharded_selections"] == 0
    assert '"phase": "meshes"' in capsys.readouterr().out


def test_mesh_serving_fails_a_planted_tp_sum(rehearsal, monkeypatch):
    """With a tp sum that keeps shard 0's partial alone, serving on the
    meshes disagrees with one device and the phase fails."""
    texts, bert, _, _ = _inputs(rehearsal)
    monkeypatch.setattr(collectives, "all_reduce_sum",
                        lambda parts: collectives.broadcast(parts[0], [p.device for p in parts]))
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    with pytest.raises(SystemExit, match="disagrees with one device"):
        chip_smoke.mesh_serving(fa, classify, texts, bert)


@pytest.mark.parametrize("shape,conf,want", [({"tp": 2}, {}, 4), ({"dp": 2, "tp": 2}, {}, 8),
                                             ({"pp": 2}, {}, 4), ({"dp": 2}, {"pp": 2}, 4),
                                             ({"ep": 2}, {}, 2), ({"dp": 2, "ep": 4}, {}, 4)])
def test_mesh_launches(rehearsal, shape, conf, want):
    assert chip_smoke.mesh_launches(shape, dict(TINY, **conf)) == want
