"""A rehearsal of chip_smoke's phase 17 on the CPU at toy size: T5, BART
and the seq2seq on tp 2 and dp 2 × tp 2 against one device, the ring on
tp 2 × sp 2, the quantized and f32 legs, the continuous engine's pools on
tp 2, the prefix cache and summarize_mpmd, with "the card" the CPU (every
shard of a mesh on it). On the CPU the kernel wrappers run their plain
versions and count nothing, so the rehearsal counts calls of the kernel
entry points instead (the card's run counts launches)."""

import json
import os

import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import bart
from agent_tpu_torch.ops import map_summarize as summarize_op
from tests.test_torch_t5 import hf_state_dict as t5_state_dict

torch.set_num_threads(2)

T5_TINY = dict(chip_smoke.T5_LARGE, vocab_size=64, d_model=48, d_kv=32, num_heads=4,
               num_layers=2, num_decoder_layers=1, d_ff=64)
BART_TINY = dict(chip_smoke.BART_LARGE_CNN, vocab_size=1200, d_model=32, encoder_layers=2,
                 decoder_layers=1, encoder_attention_heads=2, decoder_attention_heads=2,
                 encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=128)
SERVE_TINY = {"d_model": 32, "n_heads": 4, "n_enc_layers": 2, "n_dec_layers": 1, "d_ff": 64,
              "max_src_len": 128, "max_tgt_len": 16}
S2S_SMALL = {"d_model": 32, "n_heads": 4, "n_enc_layers": 1, "n_dec_layers": 1, "d_ff": 64,
             "max_src_len": 64, "max_tgt_len": 8, "dtype": "float32"}


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    for name, value in (("CARD", "cpu"), ("T5_LARGE", T5_TINY), ("T5_MAX_NEW", 3),
                        ("BART_LARGE_CNN", BART_TINY), ("BART_MAX_NEW", 3),
                        ("BART_CHECK_ROWS", 2), ("S2S_ROWS", 2), ("S2S_BEAM_ROWS", 2),
                        ("S2S_MAX_NEW", 3), ("SMALL_S2S_F32", S2S_SMALL), ("DEC_ROWS", 2),
                        ("MPMD_ROWS", 2), ("SERVE_MODEL", SERVE_TINY), ("SERVE_REQUESTS", 10),
                        ("SERVE_SLOTS", 4), ("SERVE_WARM", 2), ("DEC_SERVE_F32_REQUESTS", 6)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "profile_call", lambda fn: fn() and {
        "flash_fwd_launches": {"flash_fwd_sm90": 2 * chip_smoke.S2S_ENC_LAYERS}})

    def counting(fn, kernel):
        def run(*args, **kw):
            fa.LAUNCH_COUNTS[kernel] += 1
            return fn(*args, **kw)
        return run

    for name in ("flash_attention", "flash_attention_t5", "flash_fold"):
        monkeypatch.setattr(fa, name, counting(getattr(fa, name), name))
    yield tmp_path
    chip_smoke.reset_counts(fa)


def _checkpoints(tmp):
    """Phase 9's T5 directory with its staged requests, and phase 12's BART
    directory with its requests, at toy size."""
    t5_dir = str(tmp / "t5")
    os.makedirs(t5_dir)
    with open(os.path.join(t5_dir, "config.json"), "w") as fh:
        json.dump(T5_TINY, fh)
    torch.save({k: torch.from_numpy(v) for k, v in t5_state_dict(T5_TINY, 3).items()},
               os.path.join(t5_dir, "pytorch_model.bin"))
    cfg = summarize_op._get_cfg({"model_path": t5_dir}, "t5", t5_dir)
    rows = chip_smoke.t5_rows(4, T5_TINY["vocab_size"], (8, 12), 5)
    t5_requests = [("t5_greedy", chip_smoke.stage_t5(summarize_op, t5_dir, cfg, rows, 1), 1, 4),
                   ("t5_beam4", chip_smoke.stage_t5(summarize_op, t5_dir, cfg, rows[:2], 4),
                    4, 2)]
    bart_dir = str(tmp / "bart")
    os.makedirs(bart_dir)
    words = chip_smoke.write_bpe_vocab(bart_dir, 600, 3)
    chip_smoke.write_hf_checkpoint(bart_dir, BART_TINY, chip_smoke.bart_state_dict(
        BART_TINY, 2, torch.float32))
    texts = chip_smoke.bart_texts(bart.hf_bpe(bart_dir), words, 4, (20, 40), 4)
    return t5_dir, t5_requests, bart_dir, chip_smoke.bart_requests(bart_dir, texts)


def test_decoder_mesh_phase_rehearsal(rehearsal, capsys):
    t5_dir, t5_requests, bart_dir, bart_reqs = _checkpoints(rehearsal)
    tally = chip_smoke.decoder_mesh_phase(fa, "a card, 700 W", t5_dir, t5_requests, bart_dir,
                                          bart_reqs, 100.0)
    tally = {path: {k: n for k, n in counts.items() if n} for path, counts in tally.items()}
    n_t5 = T5_TINY["num_layers"]
    # Row 3: every encoder layer on each shard, two runs of the greedy
    # request (warm, timed) and one of the beams'; the logp checks are not
    # main-path runs and are not tallied.
    assert tally["map_summarize_t5_large_tp2"] == {"flash_attention_t5": n_t5 * 2 * 3}
    assert tally["map_summarize_t5_large_dp2_tp2"] == {"flash_attention_t5": n_t5 * 4 * 3}
    assert tally["map_summarize_bart_tp2"] == {"flash_attention": 2 * 2 * 2}
    enc = chip_smoke.S2S_ENC_LAYERS
    assert tally["map_summarize_dp2_tp2"] == {"flash_attention": enc * 4 * 4}  # 2 requests x 2
    assert tally["map_summarize_tp2_sp2"] == {"flash_fold": enc * 4 * 2 * 2}
    for mode in ("none", "int8", "w8a16"):
        for dtype in ("float32", "bfloat16"):
            assert tally[f"map_summarize_{mode}_{dtype}_tp2"] == {"flash_attention": enc * 2}
    assert tally["serve_engine_prefill_tp2"] == {"flash_attention": 2 * SERVE_TINY["n_enc_layers"]}
    assert tally["serve_summarize_tp2"] == {"flash_attention": 2 * SERVE_TINY["n_enc_layers"]}
    assert tally["summarize_encode_tp2"] == {"flash_attention": enc * 2}
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if '"phase": "decoder_meshes"' in ln)
    t5 = line["t5_large"]
    tol = chip_smoke.LOGP_TOL["bfloat16"]
    assert max(t5["logp_vs_one_device"].values()) <= tol
    assert t5["bias_std_1_tp2_logp"] <= tol < t5["planted_next_shard_columns_logp"]
    assert line["selection"]["unsharded"] == 0 and line["selection"]["t5_dense"] == 0
    assert line["serving"]["f32_first_requests_equal"]
    assert line["serving"]["prefix_cache"]["warm"]["hits"] == 1
    pools = line["serving"]["pool_bytes"]
    assert pools["shards"] == [pools["one_device"] // 2] * 2
    assert set(line["quant"]) == {f"{m}_{d}" for m in ("none", "int8", "w8a16")
                                  for d in ("float32", "bfloat16")}
    assert line["mpmd"]["equal"] and all(line["seq2seq"]["small_f32_tp2_vs_cpu"].values())


def test_the_planted_bias_columns_fail_the_t5_check(rehearsal, monkeypatch):
    """With the honest tp 2 run given the next shard's bias columns too,
    the T5 leg's check fails."""
    from agent_tpu_torch.models import t5

    t5_dir, t5_requests, _, _ = _checkpoints(rehearsal)
    monkeypatch.setattr(t5, "bias_columns", chip_smoke.next_shard_columns(t5.bias_columns))
    with pytest.raises(SystemExit, match="T5 on a mesh disagrees"):
        chip_smoke.dec_t5(fa, t5_dir, t5_requests, {})


def test_quant_leg_fails_below_the_float_control(rehearsal, monkeypatch):
    """A quantized mode whose token share falls below the float control's
    less the slack fails the leg (here the slack is negative, as a wrong
    sharded table would lower the share)."""
    from agent_tpu_torch.ops import load_ops

    monkeypatch.setattr(chip_smoke, "AGREEMENT_SLACK", -0.5)
    with pytest.raises(SystemExit, match="less than the float control's"):
        chip_smoke.dec_quant(fa, load_ops(["map_summarize"])["map_summarize"], {})


def test_decoder_cards_phase_rehearsal(rehearsal, monkeypatch, capsys):
    """``--cards N``'s decoder checks with the N "cards" CPU shards."""
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    monkeypatch.setattr(chip_smoke, "DEC_CARDS_ROWS", 2)
    monkeypatch.setattr(chip_smoke, "mesh_runtime", lambda shape, distinct=False: TorchRuntime(
        devices=["cpu"] * int(chip_smoke.np.prod(list(shape.values()))), mesh_shape=shape))
    chip_smoke.decoder_cards_phase(fa, 2)
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if '"phase": "decoder_cards"' in ln)
    assert line["small_f32_vs_cpu"] and line["cards"] == 2
    assert line["t5_logp_vs_one_card"] <= chip_smoke.LOGP_TOL["bfloat16"]
