"""The port's BERT (``agent_tpu_torch.models.bert``) against the reference's
(``agent_tpu.models.bert``) on one tiny HF checkpoint directory written with
HF key names through ``torch.save`` (no ``transformers``), in f32 within
2e-5 and bf16 within 2e-2: the config's rules, the forward's logits (dense
attention and the flash kernel's plain version), the seeded head, the
carry-across from the reference's tree, the wordpiece path on a Unicode
corpus, ``map_classify_tpu`` through both registries, and the ``sp`` = 2
ring on two CPU shards against the JAX ring on two virtual devices."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from agent_tpu.config import DeviceConfig
from agent_tpu.models import bert as jax_bert
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.runtime import TpuRuntime
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import get_runtime as jax_get_runtime
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import bert, layers
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
HF = dict(chip_smoke.BERT_BASE_UNCASED, vocab_size=600, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=128, max_position_embeddings=64,
          num_labels=7, id2label={str(i): f"L{i}" for i in range(7)})
UNICODE = ["Café naïve résumé", "中文字符 and 日本", "Hello, world! (x) [y] {z}",
           "ÀÉÎÕÜ façade", "tab\tnew\nline", "don't stop—ever", "", "   ", "¿Qué? ¡Sí!",
           "ümlaut ß ø å æ", "mixed中text"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bert"))
    chip_smoke.write_hf_checkpoint(d, HF, chip_smoke.bert_state_dict(HF, 0, torch.float32,
                                                                     std=0.2))
    words = chip_smoke.write_wordpiece_vocab(d, HF["vocab_size"], 1, extra=("中", "文", "cafe"))
    return d, words


def _flat(tree, prefix=""):
    """A tree of tensors -> {dotted key: tensor}."""
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


@pytest.mark.parametrize("variant", ["num_labels", "id2label", "neither", "overrides"])
def test_config_matches_the_reference(variant, tmp_path):
    hf = dict(HF)
    if variant == "id2label":
        hf.pop("num_labels")
    elif variant == "neither":
        hf.pop("num_labels")
        hf.pop("id2label")
        hf.pop("layer_norm_eps")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(hf))
    kw = {"dtype": "float32", "num_labels": 3} if variant == "overrides" else {}
    got = bert.BertConfig.from_hf_json(str(path), **kw)
    want = jax_bert.BertConfig.from_hf_json(str(path), **kw)
    assert _fields(got) == _fields(want)
    assert (got.max_len, got.n_classes) == (want.max_len, want.n_classes)


@pytest.mark.parametrize("bad", ["not json", "roberta", "missing field"])
def test_from_hf_json_refuses_what_the_reference_refuses(bad, tmp_path):
    text = {"not json": "{broken", "roberta": json.dumps(dict(HF, model_type="roberta")),
            "missing field": json.dumps({"model_type": "bert"})}[bad]
    path = tmp_path / "config.json"
    path.write_text(text)
    with pytest.raises(Exception) as got:
        bert.BertConfig.from_hf_json(str(path))
    with pytest.raises(Exception) as want:
        jax_bert.BertConfig.from_hf_json(str(path))
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    assert not isinstance(got.value, ValueError)  # never the caller's bad input


def _batch(seed=0, B=3, L=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, HF["vocab_size"], (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    mask[2, 3:] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_forward_logits_match_the_reference(ckpt, dtype, attn):
    jcfg, jp = jax_bert.load_hf_dir(ckpt[0], dtype=dtype)
    tcfg, tp = bert.load_hf_dir(ckpt[0], dtype=dtype)
    ids, mask = _batch()
    want = np.asarray(jax_bert.forward(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    before = fa.SELECTION_COUNTS["flash"]
    attn_fn = fa.flash_attention if attn == "flash" else layers.dot_product_attention
    got = bert.forward(tp, torch.from_numpy(ids), torch.from_numpy(mask), tcfg, attn_fn)
    assert fa.SELECTION_COUNTS["flash"] - before == (HF["num_hidden_layers"]
                                                      if attn == "flash" else 0)
    assert got.dtype == torch.float32 and got.shape == (3, HF["num_labels"])
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("why", ["other_num_labels", "no_classifier"])
def test_seeded_head_equals_the_reference(ckpt, why):
    """A head the checkpoint does not hold (another num_labels, or no
    classifier at all): both packages seed it from ``head_seed``, equal bit
    for bit."""
    if why == "other_num_labels":
        _, jp = jax_bert.load_hf_dir(ckpt[0], dtype="float32", num_labels=5)
        _, tp = bert.load_hf_dir(ckpt[0], dtype="float32", num_labels=5)
    else:
        hf = dict(HF, num_labels=0)
        sd = chip_smoke.bert_state_dict(hf, 5, torch.float32)
        kw = dict(vocab_size=600, hidden_size=64, num_layers=2, num_heads=2,
                  intermediate_size=128, max_position=64, num_labels=4, dtype="float32")
        jp = jax_bert.from_state_dict({k: v.numpy() for k, v in sd.items()},
                                      jax_bert.BertConfig(**kw), head_seed="h")
        tp = bert.from_state_dict(sd, bert.BertConfig(**kw), head_seed="h")
    for leaf in ("w", "b"):
        np.testing.assert_array_equal(tp["head"][leaf].numpy(), np.asarray(jp["head"][leaf]))


def test_from_jax_params_carries_the_reference_tree(ckpt):
    jcfg, jp = jax_bert.load_hf_dir(ckpt[0], dtype="bfloat16")
    tcfg, tp = bert.load_hf_dir(ckpt[0], dtype="bfloat16")
    flat = layers.flatten(jax.tree_util.tree_map(np.asarray, jp))
    carried = _flat(bert.from_jax_params(flat, tcfg))
    direct = _flat(tp)
    assert set(carried) == set(direct)
    for name, t in direct.items():
        assert torch.equal(carried[name], t), name
        assert t.dtype == (torch.float32 if ".ln." in f".{name}" else torch.bfloat16), name


@pytest.mark.parametrize("strip", [True, False])
def test_basic_normalize_matches_the_reference(strip):
    for text in UNICODE:
        assert bert.basic_normalize(text, strip) == jax_bert.basic_normalize(text, strip)


@pytest.mark.parametrize("lowercase", [True, False])
def test_wordpiece_ids_match_the_reference(ckpt, tmp_path, lowercase):
    d = tmp_path / "tok"
    d.mkdir()
    (d / "vocab.txt").write_text(open(os.path.join(ckpt[0], "vocab.txt")).read())
    (d / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": lowercase}))
    tok, jtok = bert.hf_wordpiece(str(d)), jax_bert.hf_wordpiece(str(d))
    assert tok is bert.hf_wordpiece(str(d)) and tok.unk_id == jtok.unk_id == 1
    texts = UNICODE + [" ".join(ckpt[1][:40]), "X" * 80]
    for text in texts:
        assert tok.encode(bert.basic_normalize(text, lowercase)) == \
            jtok.encode(jax_bert.basic_normalize(text, lowercase)), text
    got = bert.encode_pad_batch(tok, texts, 24, (1, 2, 4, 8, 16), (8, 16, 24))
    want = jax_bert.encode_pad_batch(jtok, texts, 24, (1, 2, 4, 8, 16), (8, 16, 24))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def classify():
    fn = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    rt = TorchRuntime(device="cpu")
    return lambda payload, runtime=None: fn(dict(payload), OpContext(runtime=runtime or rt))


@pytest.fixture(scope="module")
def jax_classify():
    ctx = JaxOpContext(runtime=jax_get_runtime())
    fn = jax_get_op("map_classify_tpu")
    return lambda payload, ctx=ctx: fn(dict(payload), ctx)


def _columns(result):
    rows = [r["topk"] for r in result["results"]] if "results" in result else [result["topk"]]
    return [[e["index"] for e in r] for r in rows], [[e["score"] for e in r] for r in rows]


def _payloads(ckpt):
    d, words = ckpt
    texts = [" ".join(words[i:i + 6 + i % 5]) + " Café 中文!" for i in range(0, 60, 5)]
    base = {"model_path": d, "model_config": {"dtype": "float32"}, "topk": 4}
    return {"texts": dict(base, texts=texts + UNICODE[:6]),
            "text": dict(base, text=texts[0]),
            "input": dict(base, input=[2, 50, 51, 52, 3]),
            "columnar": dict(base, texts=texts, result_format="columnar"),
            "all_classes": dict(base, texts=texts[:3], topk=99)}


@pytest.mark.parametrize("name", ["texts", "text", "input", "columnar", "all_classes"])
def test_classify_op_matches_the_reference(ckpt, classify, jax_classify, name):
    payload = _payloads(ckpt)[name]
    got, want = classify(payload), jax_classify(payload)
    assert got["ok"] and want["ok"] and got["device"] == "cpu"
    if name == "columnar":
        assert got["indices"] == want["indices"]
        np.testing.assert_allclose(got["scores"], want["scores"], atol=TOL["float32"])
        return
    (gi, gs), (wi, ws) = _columns(got), _columns(want)
    assert gi == wi
    np.testing.assert_allclose(gs, ws, atol=TOL["float32"], rtol=0)


def test_classify_drains_a_csv_shard_as_the_reference(ckpt, classify, jax_classify, tmp_csv):
    payload = dict(_payloads(ckpt)["texts"], source_uri=tmp_csv, start_row=3, shard_size=9,
                   text_field="text")
    payload.pop("texts")
    got, want = classify(payload), jax_classify(payload)
    assert got["n_rows"] == want["n_rows"] == 9
    assert _columns(got)[0] == _columns(want)[0]


def test_sp2_ring_matches_the_jax_ring(ckpt, classify):
    payload = _payloads(ckpt)["texts"]
    rt = TorchRuntime(devices=["cpu"] * 2, mesh_shape={"sp": 2})
    jrt = TpuRuntime(DeviceConfig(mesh_shape={"sp": 2}), devices=jax.devices()[:2])
    before = dict(fa.SELECTION_COUNTS)
    got = classify(payload, rt)
    want = jax_get_op("map_classify_tpu")(dict(payload), JaxOpContext(runtime=jrt))
    assert fa.SELECTION_COUNTS["ring"] - before["ring"] == HF["num_hidden_layers"]
    assert fa.SELECTION_COUNTS["ring_dense"] == before["ring_dense"]
    (gi, gs), (wi, ws) = _columns(got), _columns(want)
    assert gi == wi
    np.testing.assert_allclose(gs, ws, atol=TOL["float32"], rtol=0)
    one = classify(payload)
    assert _columns(one)[0] == gi


@pytest.mark.parametrize("how", ["payload", "env"])
def test_quantized_bert_is_refused_softly(ckpt, classify, jax_classify, monkeypatch, how):
    """Refused until the port had quantized serving: a quant mode from the
    payload (int8) or from TPU_QUANT (w8a16) now serves the checkpoint
    quantized, with the reference's top-k. W8A8 rounds every activation to
    int8: where the port's flash attention sums in another order than the
    reference's dense attention, a value at a rounding boundary takes the
    next code, which moves that row's scores by up to about 1e-3 here; the
    int8 case's scores are held within 5e-3, w8a16's within f32's 2e-5."""
    payload = dict(_payloads(ckpt)["texts"])
    if how == "payload":
        payload["model_config"] = {"dtype": "float32", "quant": "int8"}
    else:
        monkeypatch.setenv("TPU_QUANT", "w8a16")
    got, want = classify(payload), jax_classify(payload)
    assert got["ok"] and want["ok"]
    (gi, gs), (wi, ws) = _columns(got), _columns(want)
    assert gi == wi
    np.testing.assert_allclose(gs, ws, atol=5e-3 if how == "payload" else TOL["float32"],
                               rtol=0)


def test_structural_overrides_are_ignored_for_a_checkpoint(ckpt, classify, jax_classify):
    payload = dict(_payloads(ckpt)["text"],
                   model_config={"dtype": "float32", "num_layers": 9, "hidden_size": 8})
    got, want = classify(payload), jax_classify(payload)
    assert got["ok"] and _columns(got)[0] == _columns(want)[0]


@pytest.mark.parametrize("broken", ["no_vocab", "not_bert", "bad_json"])
def test_a_broken_checkpoint_raises_as_the_reference(ckpt, classify, jax_classify, tmp_path,
                                                     broken):
    d = tmp_path / broken
    d.mkdir()
    hf = dict(HF, model_type="t5") if broken == "not_bert" else HF
    (d / "config.json").write_text("{oops" if broken == "bad_json" else json.dumps(hf))
    payload = {"model_path": str(d), "text": "hello"}
    with pytest.raises(Exception) as got:
        classify(payload)
    with pytest.raises(Exception) as want:
        jax_classify(payload)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
