"""A rehearsal of chip_smoke's phases 11 (BERT) and 12 (BART) on the CPU at
toy size: the checkpoint directories written as the card's run writes them
(HF names, torch.save and the port's safetensors writer, synthetic
wordpiece and byte-level BPE vocabularies), served through the ops, with
every check of the phases passing. On the CPU the kernel wrappers run their
plain versions and count nothing, so the rehearsal counts calls of the
serving attention and of the fold instead (the card's run counts
launches)."""

import json
import os

import pytest
import torch

import chip_smoke
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import bart, bert
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(2)

TINY_BERT = dict(chip_smoke.BERT_BASE_UNCASED, vocab_size=700, hidden_size=64,
                 num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
                 max_position_embeddings=64)
TINY_BART = dict(chip_smoke.BART_LARGE_CNN, vocab_size=1200, d_model=64, encoder_layers=2,
                 decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
                 encoder_ffn_dim=128, decoder_ffn_dim=128, max_position_embeddings=96)


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    for name, value in (("CARD", "cpu"), ("BERT_BASE_UNCASED", TINY_BERT),
                        ("BART_LARGE_CNN", TINY_BART), ("REPS", 1), ("DRAIN_ROWS", 96),
                        ("DRAIN_SHARD", 64), ("BERT_ROWS", 6), ("BERT_WORDS", (3, 12)),
                        ("BERT_LONG_PIECES", 64), ("BART_ROWS", 3), ("BART_BEAM_ROWS", 2),
                        ("BART_MAX_NEW", 5), ("BART_MIN_LENGTH", 3), ("BART_TOKENS", (40, 90)),
                        ("BART_CHECK_ROWS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    plain, plain_fold = fa.make_flash_attention, fa.flash_fold

    def counting(mesh=None):
        attn = plain(mesh)

        def run(q, k, v, mask):
            fa.LAUNCH_COUNTS["flash_attention"] += 1
            return attn(q, k, v, mask)

        return run

    def counting_fold(*args):
        fa.LAUNCH_COUNTS["flash_fold"] += 1
        return plain_fold(*args)

    monkeypatch.setattr(fa, "make_flash_attention", counting)
    monkeypatch.setattr(fa, "flash_fold", counting_fold)

    def profile(fn):
        before = fa.LAUNCH_COUNTS["flash_attention"]
        fn()
        n = fa.LAUNCH_COUNTS["flash_attention"] - before
        return {"wall_ms": 1.0, "device_ms": 0.0, "idle_share": None, "device_ms_by_kind": {},
                "profile_attempts": 1, "flash_fwd_launches": {"flash_fwd_sm90": n}}

    monkeypatch.setattr(chip_smoke, "profile_call", profile)
    csv = str(tmp_path / "drain.csv")
    chip_smoke.write_drain_csv(csv)
    yield tmp_path, csv
    chip_smoke.reset_counts(fa)


def _checkpoint(path, hf, state_dict, seed):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf, fh)
    return state_dict(hf, seed, torch.float32)


def test_bert_phase_rehearsal(rehearsal, capsys):
    tmp, csv = rehearsal
    ckpt = str(tmp / "bert")
    sd = _checkpoint(ckpt, TINY_BERT, chip_smoke.bert_state_dict, 0)
    words = chip_smoke.write_wordpiece_vocab(ckpt, TINY_BERT["vocab_size"], 1)
    requests = chip_smoke.bert_requests(ckpt, csv, words)
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    cases = chip_smoke.staged_cases(classify, requests)
    assert [c[1][1:] for c in cases] == [(2, c[1][2], c[1][2], 32) for c in cases]
    assert any(c[0].startswith("bert_text512/B1xL64") for c in cases)
    chip_smoke.write_hf_checkpoint(ckpt, TINY_BERT, sd)
    run = chip_smoke.bert_phase(fa, classify, TorchRuntime(device="cpu"), ckpt, requests)
    assert run["launches"] == TINY_BERT["num_hidden_layers"] * 3 * 2  # 3 requests, 2 runs
    assert run["fold_launches"] == TINY_BERT["num_hidden_layers"] * 4 * 2
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if '"phase": "bert"' in ln)
    assert line["safetensors"]["results_equal_to_bin"] and line["vs_plain_attention"]["ok"]


def test_bart_phase_rehearsal(rehearsal, capsys):
    tmp, _ = rehearsal
    ckpt = str(tmp / "bart")
    sd = _checkpoint(ckpt, TINY_BART, chip_smoke.bart_state_dict, 2)
    words = chip_smoke.write_bpe_vocab(ckpt, 600, 3)
    tok = bart.hf_bpe(ckpt)
    texts = chip_smoke.bart_texts(tok, words, 3, (40, 90), 4)
    assert all(38 <= len(tok.encode(t)) <= 90 for t in texts)
    requests = chip_smoke.bart_requests(ckpt, texts)
    summarize = load_ops(["map_summarize"])["map_summarize"]
    cases = chip_smoke.staged_cases(summarize, requests)
    assert all(c[1][1] == 2 and c[1][4] == 32 for c in cases)
    chip_smoke.write_hf_checkpoint(ckpt, TINY_BART, sd, safetensors=True)
    run = chip_smoke.bart_phase(fa, summarize, TorchRuntime(device="cpu"), ckpt, requests)
    assert run["launches"] == TINY_BART["encoder_layers"] * 2 * 2  # 2 requests, 2 runs
    line = next(json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                if '"phase": "bart"' in ln)
    assert line["f32_first_rows"]["kernel_equals_plain"]
    greedy = line["requests"][0]["forced_ids"]
    assert greedy["rows"] == 3 and greedy["first_not_forced_bos"] == 0


@pytest.mark.parametrize("family", ["bert", "bart"])
def test_the_phases_configs_load_as_in_the_reference(family, tmp_path):
    """bert-base-uncased's and bart-large-cnn's config.json, as the phases
    write them, give the same config in both packages (num_labels 2; the
    forced ids 0 and 2; vocab 50264)."""
    from agent_tpu.models import bart as jax_bart
    from agent_tpu.models import bert as jax_bert

    hf, port, ref = {"bert": (chip_smoke.BERT_BASE_UNCASED, bert.BertConfig,
                              jax_bert.BertConfig),
                     "bart": (chip_smoke.BART_LARGE_CNN, bart.BartConfig,
                              jax_bart.BartConfig)}[family]
    (tmp_path / "config.json").write_text(json.dumps(hf))
    got = port.from_hf_json(str(tmp_path / "config.json"))
    want = ref.from_hf_json(str(tmp_path / "config.json"))
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}
    if family == "bert":
        assert (got.hidden_size, got.num_layers, got.num_labels) == (768, 12, 2)
    else:
        assert (got.d_model, got.n_enc_layers, got.forced_bos_id, got.forced_eos_id,
                got.vocab_size) == (1024, 12, 0, 2, 50264)
