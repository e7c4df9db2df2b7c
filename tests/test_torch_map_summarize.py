"""map_summarize through the port's registry on a CPU TorchRuntime against
the JAX op on the JAX CPU runtime: for the in-house seq2seq the same
summaries, result keys and ``bad_input`` messages; for T5 the device phase
(``_decode_chunks``) gives the same tokens, and T5 text without
``sentencepiece`` raises the reference's gate error."""

import json
import os

import numpy as np
import pytest
import torch

from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.ops import map_summarize as jax_op
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import get_runtime as jax_get_runtime
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.ops import map_summarize as op
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import HostCopy, TorchRuntime

from tests.test_torch_t5 import HF_TINY, hf_state_dict

torch.set_num_threads(1)

SMALL = {"d_model": 64, "n_heads": 2, "n_enc_layers": 2, "n_dec_layers": 2, "d_ff": 128,
         "max_src_len": 64, "max_tgt_len": 16, "dtype": "float32"}
TEXTS = ["first doc", "a second, somewhat longer document " * 2, "naïve café ☕", "x" * 90]


@pytest.fixture(scope="module")
def jax_summarize():
    ctx = JaxOpContext(runtime=jax_get_runtime())
    fn = jax_get_op("map_summarize")
    return lambda payload: fn(dict(payload), ctx)


@pytest.fixture(scope="module")
def torch_rt():
    return TorchRuntime(device="cpu")


@pytest.fixture(scope="module")
def summarize(torch_rt):
    fn = load_ops(["map_summarize"])["map_summarize"]
    return lambda payload, ctx=None: fn(dict(payload), ctx or OpContext(runtime=torch_rt))


@pytest.mark.parametrize("extra", [
    {"text": "a long document " * 4, "max_length": 12},
    {"texts": TEXTS, "max_length": 10},
    {"texts": TEXTS, "max_length": 10, "min_length": 6},
    {"texts": TEXTS[:3], "max_length": 8, "num_beams": 4},
    {"texts": TEXTS[:3], "max_length": 8, "num_beams": 3, "length_penalty": 2.0,
     "early_stopping": True},
    {"texts": TEXTS[:2], "max_length": 40},  # capped at max_tgt_len
], ids=["text", "texts", "min_length", "beam4", "beam3_lp2_early", "capped"])
def test_summaries_match_jax(summarize, jax_summarize, extra):
    payload = {"model_config": SMALL, **extra}
    got, want = summarize(payload), jax_summarize(payload)
    assert got["ok"] and want["ok"]
    assert got["device"] == "cpu"
    assert set(got) == set(want)
    for key in ("op", "model", "num_beams", "summary"):
        assert got[key] == want[key], key
    assert got.get("summaries") == want.get("summaries")


def test_default_model_matches_jax(summarize, jax_summarize):
    """The default config (bf16, d_head 32) with the default model id: the
    same contract, and summaries of the expected count."""
    payload = {"texts": ["default model row %d" % i for i in range(3)], "max_length": 6}
    got, want = summarize(payload), jax_summarize(payload)
    assert set(got) == set(want) and got["model"] == want["model"] == "summarize-default"
    assert len(got["summaries"]) == 3 and all(isinstance(s, str) for s in got["summaries"])


def test_output_uri_sink_matches_jax(summarize, jax_summarize, tmp_path):
    base = {"texts": TEXTS, "model_config": SMALL, "max_length": 8, "start_row": 30}
    got = summarize(dict(base, output_uri=str(tmp_path / "port")))
    want = jax_summarize(dict(base, output_uri=str(tmp_path / "jax")))
    assert set(got) == set(want) and got["rows_written"] == want["rows_written"] == len(TEXTS)
    assert os.path.basename(got["output_path"]) == os.path.basename(want["output_path"])
    with open(got["output_path"]) as fg, open(want["output_path"]) as fw:
        assert [json.loads(x) for x in fg] == [json.loads(x) for x in fw]


@pytest.mark.parametrize("payload", [
    {}, {"text": ""}, {"texts": []}, {"texts": ["ok", ""]}, {"texts": "nope"},
    {"text": "x", "max_length": 0}, {"text": "x", "max_length": True},
    {"text": "x", "num_beams": 0}, {"text": "x", "num_beams": 17},
    {"text": "x", "length_penalty": 5.0}, {"text": "x", "length_penalty": "1"},
    {"text": "x", "early_stopping": 1}, {"text": "x", "min_length": -1},
    {"text": "x", "start_row": -1}, {"text": "x", "output_uri": ""},
], ids=lambda p: ",".join(f"{k}={v!r}" for k, v in p.items()) or "empty")
def test_bad_input_matches_jax(summarize, jax_summarize, payload):
    got, want = summarize(payload), jax_summarize(payload)
    assert got["ok"] is False and want["ok"] is False
    assert got == want


@pytest.mark.parametrize("payload,needle", [
    # source_uri is served now (its parity cases are below); a malformed
    # shard address stays a soft error.
    ({"source_uri": "", "start_row": 0}, "source_uri"),
    # quant int8 serves now (tests/test_torch_quant.py); an unknown mode
    # stays a soft error, as in the reference.
    ({"text": "x", "model_config": {"quant": "int4"}}, "quant"),
    # float16 was refused until the port took the reference's dtype names;
    # it serves now, through dense attention (the kernels take bf16/f32).
    ({"text": "x", "model_config": dict(SMALL, dtype="float16"), "max_length": 4}, None),
], ids=["payload0-source_uri", "payload1-quant", "payload2-dtype"])
def test_unported_features_are_soft(summarize, payload, needle):
    out = summarize(payload)
    if needle is None:
        assert out["ok"] is True and isinstance(out["summary"], str), out
    else:
        assert out["ok"] is False and needle in out["error"], out


def test_quant_env_is_soft(summarize, jax_summarize, monkeypatch):
    """Refused until the port had quantized serving: TPU_QUANT=w8a16 now
    serves the seq2seq weight-only quantized, with the reference's
    summaries."""
    monkeypatch.setenv("TPU_QUANT", "w8a16")
    payload = {"texts": TEXTS, "model_config": SMALL, "max_length": 8}
    got, want = summarize(payload), jax_summarize(payload)
    assert got["ok"] and got["summaries"] == want["summaries"]


def test_bart_checkpoint_is_soft(summarize, jax_summarize, tmp_path):
    """A BART checkpoint directory is served now (it was refused until the
    port had BART; tests/test_torch_bart.py holds it to the reference): a
    config.json without BART's fields fails the request as the reference's
    does, and a whole checkpoint gives the reference's summaries, quantized
    (w8a16) too."""
    import chip_smoke

    (tmp_path / "config.json").write_text(json.dumps({"model_type": "bart"}))
    with pytest.raises(KeyError) as got:
        summarize({"text": "x", "model_path": str(tmp_path)})
    with pytest.raises(KeyError) as want:
        jax_summarize({"text": "x", "model_path": str(tmp_path)})
    assert str(got.value) == str(want.value)
    words = chip_smoke.write_bpe_vocab(str(tmp_path), 200, 3)
    hf = dict(chip_smoke.BART_LARGE_CNN, vocab_size=len(json.load(open(
        tmp_path / "vocab.json"))), d_model=64, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=32)
    chip_smoke.write_hf_checkpoint(str(tmp_path), hf,
                                   chip_smoke.bart_state_dict(hf, 2, torch.float32, std=0.3))
    payload = {"texts": [" ".join(words[:5]), words[6]], "model_path": str(tmp_path),
               "max_length": 6, "model_config": {"dtype": "float32"}}
    assert summarize(payload)["summaries"] == jax_summarize(payload)["summaries"]
    quantized = dict(payload, model_config={"dtype": "float32", "quant": "w8a16"})
    assert summarize(quantized)["summaries"] == jax_summarize(quantized)["summaries"]


def test_other_checkpoint_dir_raises_as_the_reference_does(summarize, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "bert"}))
    with pytest.raises(RuntimeError, match="not a BART/T5 one"):
        summarize({"text": "x", "model_path": str(tmp_path)})
    with pytest.raises(RuntimeError, match="not a BART/T5 one"):
        jax_get_op("map_summarize")({"text": "x", "model_path": str(tmp_path)})


def test_sp_mesh_serves_with_ring_attention(summarize):
    """On an sp mesh the seq2seq encoder attends through ring attention."""
    payload = {"texts": TEXTS, "model_config": SMALL, "max_length": 8}
    ring_rt = TorchRuntime(devices=["cpu"] * 2, mesh_shape={"sp": 2})
    before = fa.SELECTION_COUNTS["ring"]
    got = summarize(payload, OpContext(runtime=ring_rt))
    assert fa.SELECTION_COUNTS["ring"] == before + SMALL["n_enc_layers"]
    assert got["summaries"] == summarize(payload)["summaries"]


class _BrokenRuntime:
    def __init__(self):
        self.tags = {}
        self.runtime = None

    def require_runtime(self):
        raise RuntimeError("device wedged")


def test_failure_is_never_retried_on_cpu(summarize):
    with pytest.raises(RuntimeError, match="device wedged"):
        summarize({"text": "x", "model_config": SMALL}, _BrokenRuntime())


def test_force_cpu_is_an_explicit_request(summarize, monkeypatch):
    monkeypatch.setenv("SUMMARIZE_FORCE_CPU", "1")
    out = summarize({"text": "x", "model_config": SMALL}, _BrokenRuntime())
    assert out["ok"] and out["device"] == "cpu"
    monkeypatch.setenv("SUMMARIZE_FORCE_CPU", "0")
    with pytest.raises(RuntimeError, match="device wedged"):
        summarize({"text": "x", "model_config": SMALL}, _BrokenRuntime())


def test_phases_defer_the_fetch(summarize, torch_rt):
    ctx = OpContext(runtime=torch_rt)
    payload = {"texts": ["deferred a", "deferred b"], "model_config": SMALL, "max_length": 6}
    phase, state = op.stage(payload, ctx)
    assert phase == "staged"
    state = op.execute(state, ctx)
    assert all(isinstance(t, HostCopy) for t, _ in state["token_chunks"])
    out = op.finalize(state, ctx)
    assert out["ok"] and len(out["summaries"]) == 2
    assert set(ctx.tags["timings"]) == {"stage_ms", "queue_ms", "device_ms", "fetch_ms"}
    assert ctx.tags["usage"]["rows"] == 2 and ctx.tags["device_attr"]["flops"] > 0
    assert out["summaries"] == summarize(payload)["summaries"]


def test_flops_estimate_matches_jax():
    from agent_tpu.ops._model_common import seq2seq_fwd_flops as jax_flops
    from agent_tpu_torch.ops._model_common import seq2seq_fwd_flops

    args = (64, 512, 32, 1024, 4096, 24, 24)
    for kw in ({}, {"vocab_size": 32128, "num_beams": 4}):
        assert seq2seq_fwd_flops(*args, **kw) == jax_flops(*args, **kw)


@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory):
    hf = dict(HF_TINY, feed_forward_proj="relu", tie_word_embeddings=True)
    d = tmp_path_factory.mktemp("t5_ckpt")
    (d / "config.json").write_text(json.dumps(hf))
    torch.save({k: torch.from_numpy(v) for k, v in hf_state_dict(hf, seed=9).items()},
               d / "pytorch_model.bin")
    return str(d)


@pytest.mark.parametrize("beams", [1, 3])
def test_t5_device_phase_matches_jax(t5_dir, torch_rt, beams):
    """The T5 family's device phase on ids staged with the op's bucketing:
    the same tokens as the reference's _decode_chunks."""
    from agent_tpu.models import t5 as jax_t5
    from agent_tpu_torch.models import t5

    rng = np.random.default_rng(4)
    rows = [list(rng.integers(2, 64, n)) + [1] for n in (5, 11, 3)]
    # 8 rows: the reference's CPU test mesh has dp = 8.
    ids = np.zeros((8, 16), dtype=np.uint16)
    lengths = np.zeros(8, dtype=np.int32)
    for r, row in enumerate(rows):
        ids[r, :len(row)] = row
        lengths[r] = len(row)
    chunks = [(ids, lengths, len(rows))]
    cfg = t5.T5Config.from_hf_json(os.path.join(t5_dir, "config.json"), dtype="float32")
    jcfg = jax_t5.T5Config.from_hf_json(os.path.join(t5_dir, "config.json"), dtype="float32")
    sel = fa.SELECTION_COUNTS["t5_flash"]
    got = op._decode_chunks(torch_rt, chunks, t5_dir, cfg, 6, beams, family="t5")
    assert fa.SELECTION_COUNTS["t5_flash"] == sel + cfg.n_enc_layers
    want = jax_op._decode_chunks(jax_get_runtime(), chunks, t5_dir, jcfg, 6, beams, family="t5")
    (g, n), (w, _) = got[0], want[0]
    np.testing.assert_array_equal(g.numpy()[:n], np.asarray(w)[:n])


def test_t5_text_without_sentencepiece_raises_the_gate(summarize, t5_dir):
    try:
        import sentencepiece  # noqa: F401
        pytest.skip("sentencepiece installed; the gate is not reachable")
    except ImportError:
        pass
    payload = {"texts": ["row text"], "model_path": t5_dir, "max_length": 4}
    with pytest.raises(RuntimeError) as got:
        summarize(payload)
    with pytest.raises(RuntimeError) as want:
        jax_get_op("map_summarize")(dict(payload), JaxOpContext(runtime=jax_get_runtime()))
    assert str(got.value) == str(want.value) and "sentencepiece" in str(got.value)


def test_not_a_dict_is_soft():
    assert load_ops(["map_summarize"])["map_summarize"]("not a dict")["ok"] is False


# ---- CSV shard addressing (source_uri) ----


@pytest.fixture(scope="module")
def summarize_csv(tmp_path_factory):
    """Rows with a blank cell (row 2) and a quoted newline (row 5)."""
    path = tmp_path_factory.mktemp("summarize_csv") / "docs.csv"
    cells = [f'"{t}"' for t in TEXTS] + ['"two\nlines"', "plain doc"]
    cells.insert(2, "")
    lines = ["id,text,title"] + [f"{i},{c},t{i}" for i, c in enumerate(cells)]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("extra", [
    {},
    {"start_row": 1, "shard_size": 3},
    {"text_field": "title", "num_beams": 2},
], ids=["blank_cell", "middle", "title_field_beam2"])
def test_source_uri_matches_jax(summarize, jax_summarize, summarize_csv, extra):
    payload = dict(extra, source_uri=summarize_csv, model_config=SMALL, max_length=8)
    got, want = summarize(payload), jax_summarize(payload)
    assert got["ok"] and want["ok"]
    assert got["summaries"] == want["summaries"] and got["summary"] == want["summary"]
    if not extra:
        assert got["summaries"][2] == ""  # the blank cell: an empty summary
        assert all(got["summaries"][i] for i in (0, 1, 3))


@pytest.mark.parametrize("extra,exc", [
    ({"text_field": ""}, None),
    ({"start_row": "1"}, None),
    ({"text_field": "missing"}, RuntimeError),
    ({"start_row": 50}, RuntimeError),
    ({"source_uri": "/nonexistent/docs.csv"}, OSError),
], ids=["empty_text_field", "str_start_row", "no_column", "past_end", "no_file"])
def test_source_uri_errors_like_jax(summarize, jax_summarize, summarize_csv, extra, exc):
    payload = dict({"source_uri": summarize_csv, "model_config": SMALL}, **extra)
    if exc is None:
        got, want = summarize(payload), jax_summarize(payload)
        assert got["ok"] is False and got == want
        return
    with pytest.raises(exc):
        jax_summarize(payload)
    with pytest.raises(exc):
        summarize(payload)


def test_b1_summaries_decode_to_the_json_list(summarize, torch_rt, summarize_csv):
    from agent_tpu.data import wire as jax_wire

    payload = {"source_uri": summarize_csv, "model_config": SMALL, "max_length": 6}
    ctx = OpContext(runtime=torch_rt, tags={"wire": "b1"})
    out = summarize(payload, ctx)
    assert "summaries" not in out and "__bin__" in out
    assert jax_wire.decode_result(out)["summaries"] == summarize(payload)["summaries"]
