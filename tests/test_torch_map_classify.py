"""map_classify_tpu through the port's registry on a CPU TorchRuntime must
return what the JAX op returns on the JAX CPU runtime for the same payloads:
top-k indices equal up to ties, scores within 1e-3, the same contract."""

import json
import os

import numpy as np
import pytest
import torch

from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import get_runtime as jax_get_runtime
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.ops import map_classify_tpu as op
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

SCORE_TOL = 1e-3
SMALL = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 128, "max_len": 64,
         "n_classes": 40}


@pytest.fixture(scope="module")
def jax_classify():
    ctx = JaxOpContext(runtime=jax_get_runtime())
    fn = jax_get_op("map_classify_tpu")
    return lambda payload: fn(dict(payload), ctx)


@pytest.fixture(scope="module")
def torch_rt():
    return TorchRuntime(device="cpu")


@pytest.fixture(scope="module")
def classify(torch_rt):
    fn = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    return lambda payload, ctx=None: fn(dict(payload), ctx or OpContext(runtime=torch_rt))


def _assert_topk_agree(got_idx, got_scores, want_idx, want_scores):
    """Scores agree per rank; an index may differ only where the reference
    scores the port's class (or the top-k cutoff) within the tolerance — a
    tie the two programs may break either way."""
    np.testing.assert_allclose(got_scores, want_scores, atol=SCORE_TOL)
    for gi, gs, wi, ws in zip(got_idx, got_scores, want_idx, want_scores):
        for p, (g, w) in enumerate(zip(gi, wi)):
            if g == w:
                continue
            ref = ws[wi.index(g)] if g in wi else ws[-1]
            assert abs(ref - gs[p]) <= SCORE_TOL, (gi, gs, wi, ws)


def _rows(result):
    per_row = [r["topk"] for r in result["results"]] if "results" in result \
        else [result["topk"]]
    return ([[e["index"] for e in r] for r in per_row],
            [[e["score"] for e in r] for r in per_row])


TEXTS = ["hello world", "", "a somewhat longer row of text " * 3, "naïve café ☕",
         "row with a \x00 NUL byte", "x" * 70]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["text", "texts", "input"])
def test_rows_match_jax(classify, jax_classify, kind, dtype):
    payload = {"model_config": dict(SMALL, dtype=dtype), "topk": 4}
    if kind == "text":
        payload["text"] = "classify this sentence"
    elif kind == "texts":
        payload["texts"] = TEXTS
    else:
        payload["input"] = [int(x) for x in np.random.default_rng(3).integers(0, 260, 37)]
    got, want = classify(payload), jax_classify(payload)
    assert got["ok"] and want["ok"]
    assert got["device"] == "cpu" and "fallback" not in got
    assert got["n_rows"] == want["n_rows"]
    assert set(got) == set(want)
    for entry in got["topk"]:
        assert set(entry) == {"index", "score"}
    scores = [e["score"] for e in got["topk"]]
    assert scores == sorted(scores, reverse=True)
    _assert_topk_agree(*_rows(got), *_rows(want))


def test_columnar_matches_jax(classify, jax_classify):
    payload = {"texts": TEXTS, "model_config": SMALL, "topk": 3,
               "result_format": "columnar"}
    got, want = classify(payload), jax_classify(payload)
    assert "results" not in got and "topk" not in got
    assert len(got["indices"]) == len(TEXTS) and len(got["indices"][0]) == 3
    _assert_topk_agree(got["indices"], got["scores"], want["indices"], want["scores"])


def test_default_model_matches_jax(classify, jax_classify):
    """The default encoder (d_head 32) with the default model id."""
    payload = {"texts": ["default model row %d" % i for i in range(5)], "topk": 5}
    got, want = classify(payload), jax_classify(payload)
    _assert_topk_agree(*_rows(got), *_rows(want))


def test_output_uri_sink_matches_jax(classify, jax_classify, tmp_path):
    base = {"texts": TEXTS, "model_config": SMALL, "topk": 2, "start_row": 40}
    got = classify(dict(base, output_uri=str(tmp_path / "port")))
    want = jax_classify(dict(base, output_uri=str(tmp_path / "jax")))
    assert got["rows_written"] == want["rows_written"] == len(TEXTS)
    assert os.path.basename(got["output_path"]) == os.path.basename(want["output_path"])
    with open(got["output_path"]) as fg, open(want["output_path"]) as fw:
        g_rows = [json.loads(line) for line in fg]
        w_rows = [json.loads(line) for line in fw]
    _assert_topk_agree([r["indices"] for r in g_rows], [r["scores"] for r in g_rows],
                       [r["indices"] for r in w_rows], [r["scores"] for r in w_rows])


def test_oversize_batch_chunks(classify, monkeypatch):
    monkeypatch.setattr(op, "MAX_BATCH", 4)
    texts = [f"row {i}" for i in range(11)]
    whole = classify({"texts": texts, "model_config": SMALL, "result_format": "columnar"})
    monkeypatch.undo()
    ref = classify({"texts": texts, "model_config": SMALL, "result_format": "columnar"})
    assert whole["n_rows"] == 11 and len(whole["indices"]) == 11
    _assert_topk_agree(whole["indices"], whole["scores"], ref["indices"], ref["scores"])


@pytest.mark.parametrize("payload,needle", [
    ({"topk": 0, "input": [1]}, "topk"),
    ({"topk": -2, "text": "x"}, "topk"),
    ({"texts": []}, "texts"),
    ({"input": []}, "input"),
    ({"input": [1, "x"]}, "numeric"),
    ({"input": [0, 99999]}, "out of range"),
    ({"input": [-1]}, "out of range"),
    ({}, "payload requires"),
    ({"texts": ["x"], "result_format": "nope"}, "result_format"),
    ({"source_uri": "", "start_row": 0}, "source_uri"),  # a malformed shard address
    # quant int8, moe_experts and pp serve now (tests/test_torch_quant.py,
    # test_torch_moe.py, test_torch_pipeline.py); an unknown mode, a pp the
    # one-device runtime cannot hold and MoE over pp stay soft errors.
    ({"text": "x", "model_config": {"quant": "int4"}}, "quant"),
    ({"text": "x", "model_config": {"pp": 2}}, "pp=2 does not divide the 1-device mesh"),
    ({"text": "x", "model_config": {"moe_experts": 4, "pp": 2}}, "cannot combine"),
    ({"text": "x", "start_row": -1}, "start_row"),
], ids=["payload0-topk", "payload1-topk", "payload2-texts", "payload3-input",
        "payload4-numeric", "payload5-out of range", "payload6-out of range",
        "payload7-payload requires", "payload8-result_format", "payload9-source_uri",
        "payload10-quant", "payload11-pp", "payload12-moe_experts", "payload13-start_row"])
def test_bad_input_is_soft(classify, payload, needle):
    out = classify(payload)
    assert out["ok"] is False and needle in out["error"], out


def test_hf_checkpoint_model_path_is_soft(classify, jax_classify, tmp_path):
    """An HF checkpoint directory serves the BERT family now (it was refused
    until the port had it; tests/test_torch_bert.py holds it to the
    reference): a config.json without BERT's fields fails the request as the
    reference's does, and a whole checkpoint gives the reference's top-k."""
    import chip_smoke

    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(KeyError) as got:
        classify({"text": "x", "model_path": str(tmp_path)})
    with pytest.raises(KeyError) as want:
        jax_classify({"text": "x", "model_path": str(tmp_path)})
    assert str(got.value) == str(want.value)
    hf = dict(chip_smoke.BERT_BASE_UNCASED, vocab_size=300, hidden_size=64,
              num_hidden_layers=1, num_attention_heads=2, intermediate_size=64,
              max_position_embeddings=32)
    chip_smoke.write_hf_checkpoint(str(tmp_path), hf,
                                   chip_smoke.bert_state_dict(hf, 1, torch.float32, std=0.2))
    chip_smoke.write_wordpiece_vocab(str(tmp_path), hf["vocab_size"], 2)
    payload = {"texts": ["a b c", "hello world"], "model_path": str(tmp_path), "topk": 2,
               "model_config": {"dtype": "float32"}}
    got, want = _rows(classify(payload)), _rows(jax_classify(payload))
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], atol=2e-5)


def test_not_a_dict_is_soft():
    fn = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    assert fn("not a dict")["ok"] is False


class _BrokenRuntime:
    def __init__(self):
        self.tags = {}

    def require_runtime(self):
        raise RuntimeError("device wedged")


def test_fallback_never_retries_on_cpu(classify):
    """The reference retries a failed device on the CPU when
    ``allow_fallback`` is set (the default); the port raises instead."""
    with pytest.raises(RuntimeError, match="device wedged"):
        classify({"text": "x", "model_config": SMALL}, _BrokenRuntime())


def test_no_fallback_raises(classify):
    with pytest.raises(RuntimeError, match="device wedged"):
        classify({"text": "x", "allow_fallback": False}, _BrokenRuntime())


@pytest.mark.parametrize("allow_fallback", [False, True])
def test_deferred_fetch_contract(classify, torch_rt, allow_fallback):
    """Execute leaves the result on the device whatever ``allow_fallback``
    says; finalize fetches it once."""
    ctx = OpContext(runtime=torch_rt)
    payload = {"texts": ["deferred a", "deferred b"], "topk": 2, "model_config": SMALL,
               "allow_fallback": allow_fallback}
    phase, state = op.stage(payload, ctx)
    assert phase == "staged"
    state = op.execute(state, ctx)
    assert "pending_dev" in state and "vals" not in state
    out = op.finalize(state, ctx)
    assert out["ok"] and len(out["results"]) == 2 and "fallback" not in out
    assert ctx.tags["timings"]["fetch_ms"] >= 0
    assert ctx.tags["usage"]["rows"] == 2 and ctx.tags["device_attr"]["flops"] > 0
    assert out["topk"] == classify(payload)["topk"]


def test_forward_cache_and_kernel_path(classify, torch_rt):
    before_cache = torch_rt.cache.stats()
    before_sel = dict(fa.SELECTION_COUNTS)
    classify({"input": [5] * 10, "model_path": "cache-test", "model_config": SMALL})
    mid = torch_rt.cache.stats()
    classify({"input": [6] * 11, "model_path": "cache-test", "model_config": SMALL})
    after = torch_rt.cache.stats()
    assert mid["misses"] == before_cache["misses"] + 1
    assert after["misses"] == mid["misses"] and after["hits"] == mid["hits"] + 1
    # d_head 32: every layer took the kernel path, none the dense one.
    assert fa.SELECTION_COUNTS["flash"] == before_sel["flash"] + 2 * SMALL["n_layers"]
    assert fa.SELECTION_COUNTS["dense"] == before_sel["dense"]


# ---- CSV shard addressing (source_uri) ----


@pytest.fixture(scope="module")
def shard_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("classify_csv") / "rows.csv"
    lines = ["id,text,note"] + [f'{i},"row {i}: {TEXTS[i % len(TEXTS)]}, ""q""",n{i}'
                                for i in range(40)]
    lines.append('40,"a quoted\nnewline row",n40')
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("extra", [
    {},
    {"start_row": 7, "shard_size": 20, "result_format": "columnar"},
    {"start_row": 35, "shard_size": 100, "text_field": "note"},
], ids=["default", "columnar_middle", "tail_note_field"])
def test_source_uri_matches_jax(classify, jax_classify, shard_csv, extra):
    # f32: what is under test is which rows the shard reads; the bf16
    # numerics are held by test_rows_match_jax.
    payload = dict(extra, source_uri=shard_csv, model_config=dict(SMALL, dtype="float32"),
                   topk=4)
    got, want = classify(payload), jax_classify(payload)
    assert got["ok"] and want["ok"] and got["n_rows"] == want["n_rows"]
    if "indices" in want:
        _assert_topk_agree(got["indices"], got["scores"], want["indices"], want["scores"])
    else:
        assert len(got["results"]) == len(want["results"])
        _assert_topk_agree(*_rows(got), *_rows(want))


@pytest.mark.parametrize("extra,exc", [
    ({"text_field": ""}, None),
    ({"shard_size": 0}, None),
    ({"text_field": "missing"}, RuntimeError),
    ({"start_row": 100}, RuntimeError),
    ({"source_uri": "/nonexistent/rows.csv"}, OSError),
], ids=["empty_text_field", "zero_shard_size", "no_column", "past_end", "no_file"])
def test_source_uri_errors_like_jax(classify, jax_classify, shard_csv, extra, exc):
    """A malformed address or field is a soft ``bad_input`` with the
    reference's message; a shard that cannot be read raises, as the
    reference's does, so the task fails and is retried."""
    payload = dict({"source_uri": shard_csv, "model_config": SMALL}, **extra)
    if exc is None:
        got, want = classify(payload), jax_classify(payload)
        assert got["ok"] is False and got["error"] == want["error"]
        return
    with pytest.raises(exc):
        jax_classify(payload)
    with pytest.raises(exc):
        classify(payload)


def test_b1_columns_decode_to_the_json_lists(classify, torch_rt, shard_csv):
    from agent_tpu.data import wire as jax_wire

    payload = {"source_uri": shard_csv, "model_config": SMALL, "topk": 3,
               "result_format": "columnar"}
    out = classify(payload, OpContext(runtime=torch_rt, tags={"wire": "b1"}))
    assert "indices" not in out and "__bin__" in out
    plain = classify(payload)
    decoded = jax_wire.decode_result(out)
    assert decoded["indices"] == plain["indices"] and decoded["scores"] == plain["scores"]
