"""Rehearses chip_smoke phase 23 (the north-star drain's entry point) on the
CPU at toy size: a tiny BERT checkpoint, 256 rows, ``TPU_DISABLED=1`` for
the drain's process. Every gate but the launch count holds; on the CPU no
kernel launches, so the phase must fail that gate alone."""

from __future__ import annotations

import json
import os

import pytest
import torch

import chip_smoke
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.runtime import TorchRuntime

TINY_BERT = dict(chip_smoke.BERT_BASE_UNCASED, vocab_size=700, hidden_size=64,
                 num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
                 max_position_embeddings=64)


def test_drain_at_scale_phase_rehearsal(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(chip_smoke, "CARD", "cpu")
    monkeypatch.setattr(chip_smoke, "AT_SCALE_ROWS", 256)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setenv("TPU_DISABLED", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    ckpt = str(tmp_path / "bert")
    os.makedirs(ckpt)
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump(TINY_BERT, fh)
    chip_smoke.write_wordpiece_vocab(ckpt, TINY_BERT["vocab_size"], 1)
    chip_smoke.write_hf_checkpoint(ckpt, TINY_BERT,
                                   chip_smoke.bert_state_dict(TINY_BERT, 0, torch.float32))
    ops = load_ops(["map_classify_tpu", "map_summarize"])
    with pytest.raises(SystemExit, match="phase 23 failed"):
        chip_smoke.drain_at_scale_phase(ops["map_classify_tpu"], ops["map_summarize"],
                                        TorchRuntime(device="cpu"), ckpt, "smi line")
    out = capsys.readouterr().out
    run = next(json.loads(ln) for ln in out.splitlines() if '"phase": "drain_at_scale"' in ln)
    assert run["failed"] == ["row1_launches"]
    assert run["returncode"] == 0 and run["platform"] == "cpu" and run["row1_launches"] == 0
    assert run["rows_written"] == {"map_classify_tpu": 256, "map_summarize": 256}
    assert run["sink_lines"] == {"map_classify_tpu": 256, "map_summarize": 256}
    assert run["first_shard_equal_here"] == {"map_classify_tpu": True, "map_summarize": True}
    assert "drain_at_scale: " in out and "smi line" in out
