"""A rehearsal of chip_smoke's phase 14 on the CPU at toy size: classify in
bf16, int8 and w8a16 with agreement and the small int8 request, the MoE
encoder served and trained, the seq2seq, T5 and BART summaries in w8a16,
the continuous engine in w8a16, and the small model's int8 and w8a16 engine
on the "card" (here the CPU) against the CPU. On the CPU the kernel
wrappers run their plain versions and count nothing, so the rehearsal
counts calls of the attention functions instead (the card's run counts
launches)."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import bart
from agent_tpu_torch.ops import map_summarize as summarize_op
from agent_tpu_torch.runtime.runtime import TorchRuntime
from tests.test_torch_t5 import hf_state_dict as t5_state_dict

torch.set_num_threads(2)

BERT_TINY = {"d_model": 32, "n_heads": 2, "n_layers": 2, "d_ff": 64, "max_len": 64,
             "n_classes": 16, "dtype": "float32"}
SERVE_TINY = {"d_model": 32, "n_heads": 4, "n_enc_layers": 2, "n_dec_layers": 1, "d_ff": 64,
              "max_src_len": 128, "max_tgt_len": 16, "dtype": "float32"}
S2S_SMALL = {"d_model": 32, "n_heads": 4, "n_enc_layers": 1, "n_dec_layers": 1, "d_ff": 64,
             "max_src_len": 64, "max_tgt_len": 8, "dtype": "float32"}
T5_TINY = dict(chip_smoke.T5_LARGE, vocab_size=64, d_model=48, d_kv=32, num_heads=3,
               num_layers=2, num_decoder_layers=1, d_ff=64)
BART_TINY = dict(chip_smoke.BART_LARGE_CNN, vocab_size=1200, d_model=32, encoder_layers=2,
                 decoder_layers=1, encoder_attention_heads=2, decoder_attention_heads=2,
                 encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=128)


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    for name, value in (("CARD", "cpu"), ("BERT_BASE", BERT_TINY), ("QUANT_ROWS", 6),
                        ("QUANT_TEXT_LEN", 40), ("AGREEMENT_ROWS", 12), ("AGREEMENT_CHUNK", 8),
                        ("MOE_EXPERTS", 2), ("MOE_TRAIN_STEPS", 2), ("QUANT_REPS", 2),
                        ("S2S_ROWS", 4), ("S2S_BEAM_ROWS", 2), ("S2S_MAX_NEW", 3),
                        ("DECODE_AGREEMENT_ROWS", 8), ("DECODE_AGREEMENT_SRC", 16),
                        ("T5_LARGE", T5_TINY), ("T5_MAX_NEW", 3), ("BART_LARGE_CNN", BART_TINY),
                        ("BART_MAX_NEW", 3), ("BART_QUANT_ROWS", 2), ("SERVE_MODEL", SERVE_TINY),
                        ("SERVE_REQUESTS", 10), ("SERVE_SLOTS", 4), ("SERVE_WARM", 2),
                        ("SMALL_S2S_F32", S2S_SMALL), ("SERVE_EXACT_REQUESTS", 6)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    plain, plain_t5, plain_train = (fa.make_flash_attention, fa.make_flash_attention_t5,
                                    fa.make_flash_attention_trainable)

    def counting(make, kernels):
        def build(mesh=None):
            attn = make(mesh)

            def run(*args, **kw):
                for kernel in kernels:
                    fa.LAUNCH_COUNTS[kernel] += 1
                return attn(*args, **kw)

            return run

        return build

    monkeypatch.setattr(fa, "make_flash_attention", counting(plain, ["flash_attention"]))
    monkeypatch.setattr(fa, "make_flash_attention_t5", counting(plain_t5, ["flash_attention_t5"]))
    monkeypatch.setattr(fa, "make_flash_attention_trainable",
                        counting(plain_train, chip_smoke.TRAIN_KERNELS))
    yield tmp_path
    chip_smoke.reset_counts(fa)


def _checkpoints(tmp):
    """Phase 9's T5 directory with its staged greedy request, and phase 12's
    BART directory with its requests, at toy size."""
    t5_dir = str(tmp / "t5")
    os.makedirs(t5_dir)
    with open(os.path.join(t5_dir, "config.json"), "w") as fh:
        json.dump(T5_TINY, fh)
    torch.save({k: torch.from_numpy(v) for k, v in t5_state_dict(T5_TINY, 3).items()},
               os.path.join(t5_dir, "pytorch_model.bin"))
    cfg = summarize_op._get_cfg({"model_path": t5_dir}, "t5", t5_dir)
    rows = chip_smoke.t5_rows(4, T5_TINY["vocab_size"], (8, 12), 5)
    t5_requests = [("t5_greedy", chip_smoke.stage_t5(summarize_op, t5_dir, cfg, rows, 1), 1, 4)]
    bart_dir = str(tmp / "bart")
    os.makedirs(bart_dir)
    words = chip_smoke.write_bpe_vocab(bart_dir, 600, 3)
    chip_smoke.write_hf_checkpoint(bart_dir, BART_TINY, chip_smoke.bart_state_dict(
        BART_TINY, 2, torch.float32, std=0.3))
    texts = chip_smoke.bart_texts(bart.hf_bpe(bart_dir), words, 3, (20, 40), 4)
    return t5_dir, t5_requests, bart_dir, chip_smoke.bart_requests(bart_dir, texts)


def test_quant_moe_phase_rehearsal(rehearsal, capsys):
    t5_dir, t5_requests, bart_dir, bart_reqs = _checkpoints(rehearsal)
    texts, labels = chip_smoke.keyword_rows(8, 1, 20, 40)
    train_batch = chip_smoke.first_train_batch(dict(
        chip_smoke.TRAIN, batch_size=4, texts=texts, labels=labels, model_config=BERT_TINY))
    rt = TorchRuntime(device="cpu")
    report = chip_smoke.quant_moe_phase(fa, rt, "a card, 700 W", train_batch, t5_dir,
                                        t5_requests, bart_dir, bart_reqs)
    n_layers = BERT_TINY["n_layers"]
    classify = report["classify"]
    for mode in ("none", "int8", "w8a16"):
        assert classify[mode]["row1_launches"] == n_layers * 3  # warm-up + 2 timed
        assert classify[mode]["rows_per_s"] > 0
    assert classify["int8"]["resident_weight_bytes"] < classify["none"]["resident_weight_bytes"]
    assert 0 <= classify["w8a16"]["top1_agreement_vs_bf16"] <= 1
    assert classify["top1_agreement_floor"] == classify["top1_agreement_control_f32_vs_bf16"] \
        - chip_smoke.AGREEMENT_SLACK
    assert classify["int8_small_request"]["int_mm_rows"] == 16
    moe = report["moe"]
    assert moe["n_layers"] == n_layers
    assert moe["classify_int8"]["row1_launches"] == moe["classify_none"]["row1_launches"] == \
        n_layers * 3
    train = moe["train"]
    assert train["launches"] == {k: n_layers * 2 for k in chip_smoke.TRAIN_KERNELS}  # 2 steps
    assert np.isfinite(train["aux_loss"]) and train["aux_loss"] > 0
    assert train["aux_loss_before"] > 0
    moe_exact = report["moe_exactness_f32"]
    assert moe_exact["grads_max_rel_l2"] <= chip_smoke.MOE_F32_REL_TOL
    assert len(moe_exact["losses_card"]) == chip_smoke.MOE_F32_STEPS
    s2s = report["summarize_seq2seq"]
    assert s2s["launches"] == {"none": 2 * 3 * 4, "w8a16": 2 * 3 * 4}  # 2 requests x 3 runs
    assert 0 <= s2s["decode_agreement"]["token_w8a16_vs_bf16"] <= 1
    t5 = report["summarize_t5_large"]
    assert t5["launches"] == {"w8a16": 2 * 3, "none": 2 * 3}
    assert t5["w8a16"]["resident_weight_bytes"] < t5["none"]["resident_weight_bytes"]
    assert report["summarize_bart"]["launches"] == {"w8a16": 2 * 3, "none": 2 * 3}
    engine = report["engine"]
    assert engine["prefill_launches"] == 2 * SERVE_TINY["n_enc_layers"] and engine["tokens"] > 0
    exact = report["engine_exactness_f32"]
    assert exact["int8"]["card_equal_cpu"] == exact["w8a16"]["card_equal_cpu"] == 6
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if '"phase": "quant_moe"' in ln)
    assert line["nvidia_smi"] == "a card, 700 W"
    assert not rt.describe()["models_resident"]


def _classify_ctx():
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.runtime.context import OpContext

    rt = TorchRuntime(device="cpu")
    return load_ops(["map_classify_tpu"])["map_classify_tpu"], OpContext(runtime=rt), rt


def test_quant_classify_fails_below_the_agreement_floor(rehearsal, monkeypatch):
    """A quantized mode whose top-1 agreement with bf16 falls below the f32
    control's less the slack fails the phase (here the floor is raised
    above 1, as a wrong int8 layout would lower the agreement)."""
    classify, ctx, rt = _classify_ctx()
    monkeypatch.setattr(chip_smoke, "AGREEMENT_SLACK", -0.5)
    with pytest.raises(SystemExit, match="beyond the f32 control"):
        chip_smoke.quant_classify(fa, classify, ctx, rt)


def test_moe_exactness_catches_a_card_side_fault(rehearsal):
    """The small f32 MoE's card-vs-CPU check fails when the "card" side's
    training attention is off by one part in a thousand."""
    rt = TorchRuntime(device="cpu")
    assert chip_smoke.moe_exactness_f32(rt)["grads_max_rel_l2"] <= chip_smoke.MOE_F32_REL_TOL
    plain = rt.train_attention_fn()
    rt.train_attention_fn = lambda: (lambda *a, **k: plain(*a, **k) * 1.001)
    with pytest.raises(SystemExit, match="disagrees with the CPU"):
        chip_smoke.moe_exactness_f32(rt)


def test_held_resident_catches_weights_the_op_built(rehearsal):
    """``place_seeded`` puts every mode's weights under the op's key, so a
    request finds them; a request in a mode it did not place makes the op
    build its own, which ``held_resident`` refuses."""
    from agent_tpu_torch.models import encoder

    classify, ctx, rt = _classify_ctx()
    configs = {m: dict(BERT_TINY, quant=m) for m in ("none", "int8")}
    chip_smoke.place_seeded(rt, configs, encoder.init_params(encoder.EncoderConfig(**BERT_TINY)))
    for conf in configs.values():
        assert classify({"texts": ["a b"], "model_config": conf}, ctx)["ok"]
    chip_smoke.held_resident(rt, configs)
    assert classify({"texts": ["a b"], "model_config": dict(BERT_TINY, quant="w8a16")}, ctx)["ok"]
    with pytest.raises(SystemExit, match="built weights of its own"):
        chip_smoke.held_resident(rt, configs)
