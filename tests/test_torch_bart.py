"""The port's BART (``agent_tpu_torch.models.bart``) against the reference's
(``agent_tpu.models.bart``) on tiny HF checkpoint directories written with
HF key names through ``torch.save`` (no ``transformers``), 2 + 2 layers at
d_model 64: the config's rules, ``decode_full``'s logits in f32 (2e-5)
and bf16 (2e-2), the cached decode against the full forward, greedy and
beam-4 tokens equal in f32 with the forced first and last ids,
``min_length``, ``early_stopping`` and ``length_penalty`` (the cases of
``tests/test_bart.py``), and ``map_summarize`` through both registries."""

import functools
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from agent_tpu.kernels.flash_attention import flash_attention as jax_flash
from agent_tpu.models import bart as jax_bart
from agent_tpu.models import layers as jax_layers
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import get_runtime as jax_get_runtime
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import bart, layers
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
HF = dict(chip_smoke.BART_LARGE_CNN, vocab_size=64, d_model=64, encoder_layers=2,
          decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
          encoder_ffn_dim=128, decoder_ffn_dim=128, max_position_embeddings=64)
VARIANTS = {"forced": {}, "noforce": dict(forced_bos_token_id=None, forced_eos_token_id=None)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def ckpt(request, tmp_path_factory):
    hf = dict(HF, **VARIANTS[request.param])
    d = str(tmp_path_factory.mktemp(request.param))
    chip_smoke.write_hf_checkpoint(d, hf, chip_smoke.bart_state_dict(
        hf, len(request.param), torch.float32, std=0.3))
    return request.param, d


def _load(d, dtype="float32"):
    return jax_bart.load_hf_dir(d, dtype=dtype), bart.load_hf_dir(d, dtype=dtype)


def _batch(seed, B=4, L=9, pads=((1, 6), (3, 4))):
    rng = np.random.default_rng(seed)
    src = rng.integers(4, HF["vocab_size"], (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    for row, n in pads:
        mask[row, n:] = 0
        src[row, n:] = HF["pad_token_id"]
    return src, mask


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


@pytest.mark.parametrize("variant", ["published", "generation_config", "overrides",
                                     "defaults"])
def test_config_matches_the_reference(variant, tmp_path):
    hf = dict(HF)
    if variant == "generation_config":
        (tmp_path / "generation_config.json").write_text(json.dumps(
            {"decoder_start_token_id": 0, "forced_bos_token_id": 3,
             "forced_eos_token_id": None}))
    if variant == "defaults":
        for key in ("pad_token_id", "bos_token_id", "eos_token_id", "decoder_start_token_id",
                    "forced_bos_token_id", "forced_eos_token_id", "activation_function"):
            hf.pop(key)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    kw = {"dtype": "float32", "quant": "none"} if variant == "overrides" else {}
    got = bart.BartConfig.from_hf_json(str(tmp_path / "config.json"), **kw)
    want = jax_bart.BartConfig.from_hf_json(str(tmp_path / "config.json"), **kw)
    assert _fields(got) == _fields(want)
    assert (got.max_src_len, got.max_tgt_len) == (want.max_src_len, want.max_tgt_len)


@pytest.mark.parametrize("bad", ["relu", "not_bart", "not json", "missing field"])
def test_from_hf_json_refuses_what_the_reference_refuses(bad, tmp_path):
    text = {"relu": json.dumps(dict(HF, activation_function="relu")),
            "not_bart": json.dumps(dict(HF, model_type="bert")),
            "not json": "{", "missing field": json.dumps({"model_type": "bart"})}[bad]
    (tmp_path / "config.json").write_text(text)
    with pytest.raises(Exception) as got:
        bart.BartConfig.from_hf_json(str(tmp_path / "config.json"))
    with pytest.raises(Exception) as want:
        jax_bart.BartConfig.from_hf_json(str(tmp_path / "config.json"))
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    assert not isinstance(got.value, ValueError)


def test_is_hf_bart_dir_matches_the_reference(tmp_path):
    for name, text in {"bart": json.dumps(HF), "t5": json.dumps({"model_type": "t5"}),
                       "broken": "{", "none": None}.items():
        d = tmp_path / name
        d.mkdir()
        if text is not None:
            (d / "config.json").write_text(text)
        assert bart.is_hf_bart_dir(str(d)) == jax_bart.is_hf_bart_dir(str(d)), name
    assert not bart.is_hf_bart_dir(str(tmp_path / "missing"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_encode_and_decode_full_match_the_reference(ckpt, dtype, attn):
    (jcfg, jp), (tcfg, tp) = _load(ckpt[1], dtype)
    src, mask = _batch(0)
    tgt = np.random.default_rng(1).integers(3, HF["vocab_size"], (4, 6)).astype(np.int32)
    tgt[:, 0] = jcfg.decoder_start_id
    # The reference's counterpart of each attention: its dense path, or its
    # Pallas flash kernel in interpret mode (dense for the causal mask).
    jax_attn = (functools.partial(jax_flash, min_key_len=0, interpret=True)
                if attn == "flash" else jax_layers.dot_product_attention)
    enc = jax_bart.encode(jp, jnp.asarray(src), jnp.asarray(mask), jcfg, attn_fn=jax_attn)
    want = np.asarray(jax_bart.decode_full(jp, jnp.asarray(tgt), enc, jnp.asarray(mask), jcfg,
                                           attn_fn=jax_attn))
    attn_fn = fa.flash_attention if attn == "flash" else layers.dot_product_attention
    before = fa.SELECTION_COUNTS["flash"]
    got_enc = bart.encode(tp, torch.from_numpy(src), torch.from_numpy(mask), tcfg, attn_fn)
    assert fa.SELECTION_COUNTS["flash"] - before == (HF["encoder_layers"]
                                                      if attn == "flash" else 0)
    got = bart.decode_full(tp, torch.from_numpy(tgt), got_enc, torch.from_numpy(mask), tcfg,
                           attn_fn)
    tol = TOL[dtype]
    np.testing.assert_allclose(got_enc.float().numpy(), np.asarray(enc, dtype=np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_from_jax_params_carries_the_reference_tree(ckpt):
    """The reference's tree, flattened to dotted keys, gives the tree
    ``load_hf_dir`` builds: every leaf equal, layer norms and the logits
    bias in f32, the rest in the compute dtype."""
    import jax

    (_, jp), (tcfg, tp) = _load(ckpt[1], "bfloat16")
    flat = layers.flatten(jax.tree_util.tree_map(np.asarray, jp))
    carried, direct = (layers.flatten(jax.tree_util.tree_map(lambda t: t.float().numpy(), x))
                       for x in (bart.from_jax_params(flat, tcfg), tp))
    assert set(carried) == set(direct)
    for name, value in direct.items():
        np.testing.assert_array_equal(carried[name], value, err_msg=name)
    kept = bart.from_jax_params(flat, tcfg)
    assert kept["final_logits_bias"].dtype == kept["enc"]["ln_emb"]["scale"].dtype \
        == torch.float32 and kept["embed"].dtype == torch.bfloat16


def test_cached_decode_equals_the_full_forward(ckpt):
    """Step-by-step cached decoding gives decode_full's logits at every
    position (the reference's ``test_cached_decode_equals_full_forward``)."""
    _, (cfg, params) = _load(ckpt[1])
    src, mask = (torch.from_numpy(a) for a in _batch(2))
    tgt = torch.from_numpy(np.random.default_rng(3).integers(3, 64, (4, 7)).astype(np.int32))
    enc = bart.encode(params, src, mask, cfg)
    full = bart.decode_full(params, tgt, enc, mask, cfg)
    caches = bart._init_self_caches(cfg, 4, tgt.shape[1])
    cross = bart._init_cross_kv(params, enc, cfg)
    for step in range(tgt.shape[1]):
        logits, caches = bart.decode_step(params, tgt[:, step], step, caches, cross, mask, cfg,
                                          tgt.shape[1])
        np.testing.assert_allclose(logits.numpy(), full[:, step].numpy(), atol=TOL["float32"],
                                   rtol=TOL["float32"])


GEN_CASES = [  # (num_beams, length_penalty, early_stopping, min_length, max_new)
    (1, 1.0, False, 0, 8), (1, 1.0, False, 4, 8), (4, 1.0, False, 0, 8),
    (4, 2.0, False, 0, 6), (4, 0.5, False, 0, 8), (4, -1.0, False, 0, 6),
    (4, 1.0, True, 0, 10), (4, 2.0, True, 0, 8), (4, 1.0, False, 5, 8),
]


@pytest.mark.parametrize("beams,lp,early,min_length,T", GEN_CASES,
                         ids=[f"b{b}-lp{lp}-es{int(e)}-min{m}-T{t}"
                              for b, lp, e, m, t in GEN_CASES])
def test_generate_matches_the_reference(ckpt, beams, lp, early, min_length, T):
    (jcfg, jp), (tcfg, tp) = _load(ckpt[1])
    src, mask = _batch(11 + T)
    want = jax_bart.generate(jp, jnp.asarray(src), jnp.asarray(mask), jcfg, T, num_beams=beams,
                             length_penalty=lp, early_stopping=early, min_length=min_length)
    got = bart.generate(tp, torch.from_numpy(src), torch.from_numpy(mask), tcfg, T,
                        num_beams=beams, length_penalty=lp, early_stopping=early,
                        min_length=min_length, attn_fn=fa.flash_attention)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    toks = got[0].numpy()
    if ckpt[0] == "forced":
        assert (toks[:, 0] == tcfg.forced_bos_id).all()
        ran_out = ~(toks[:, :T - 1] == tcfg.eos_id).any(axis=1)
        assert (toks[ran_out, T - 1] == tcfg.forced_eos_id).all()
    if min_length:
        assert not (toks[:, :min_length - 1] == tcfg.eos_id).any()


@pytest.fixture(scope="module")
def summarize():
    fn = load_ops(["map_summarize"])["map_summarize"]
    rt = TorchRuntime(device="cpu")
    return lambda payload: fn(dict(payload), OpContext(runtime=rt))


@pytest.fixture(scope="module")
def text_ckpt(tmp_path_factory):
    """A checkpoint with a byte-level BPE vocabulary and enough vocab rows
    for it, so text goes in and summaries come out."""
    d = str(tmp_path_factory.mktemp("bart_text"))
    words = chip_smoke.write_bpe_vocab(d, 500, 9)
    n_vocab = len(json.load(open(f"{d}/vocab.json")))
    hf = dict(HF, vocab_size=n_vocab, max_position_embeddings=128)
    chip_smoke.write_hf_checkpoint(d, hf, chip_smoke.bart_state_dict(hf, 6, torch.float32,
                                                                     std=0.3))
    return d, words


SUMMARIZE_CASES = {
    "greedy": {"max_length": 10},
    "beam4": {"max_length": 8, "num_beams": 4, "length_penalty": 2.0},
    "beam3_min": {"max_length": 8, "num_beams": 3, "min_length": 5, "early_stopping": True},
    "single": {"max_length": 6, "single": True},
    "quant": {"max_length": 6, "model_config": {"dtype": "float32", "quant": "int8"}},
}


@pytest.mark.parametrize("name", sorted(SUMMARIZE_CASES))
def test_summarize_op_matches_the_reference(text_ckpt, summarize, name):
    d, words = text_ckpt
    case = dict(SUMMARIZE_CASES[name])
    texts = [" ".join(words[i:i + 12]) + "." for i in range(0, 40, 8)] + ["Ünïcödé ٣² 😀"]
    payload = {"model_path": d, "model_config": {"dtype": "float32"}, **case}
    if payload.pop("single", False):
        payload["text"] = texts[0]
    else:
        payload["texts"] = texts
    got = summarize(payload)
    want = jax_get_op("map_summarize")(dict(payload), JaxOpContext(runtime=jax_get_runtime()))
    assert got["ok"] and want["ok"] and got["device"] == "cpu"
    assert got["summary"] == want["summary"]
    assert got.get("summaries") == want.get("summaries")


def test_summarize_a_csv_shard_as_the_reference(text_ckpt, summarize, tmp_csv):
    payload = {"model_path": text_ckpt[0], "model_config": {"dtype": "float32"},
               "source_uri": tmp_csv, "start_row": 20, "shard_size": 6, "text_field": "text",
               "max_length": 5}
    got = summarize(payload)
    want = jax_get_op("map_summarize")(dict(payload), JaxOpContext(runtime=jax_get_runtime()))
    assert got["summaries"] == want["summaries"] and len(got["summaries"]) == 6
