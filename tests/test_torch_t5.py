"""The port's T5 (``agent_tpu_torch.models.t5``) against the JAX package's on
the same random HF-named state dict, carried into both by
``from_state_dict``: encoder outputs within 3e-5 (tests/test_t5.py:230),
teacher-forced logits within 1e-4, and greedy and beam-4 tokens identical,
for the relu/tied and gated-gelu/untied variants, in f32 on the CPU."""

import json

import numpy as np
import pytest
import torch

import jax

from agent_tpu.models import t5 as jax_t5
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import t5

torch.set_num_threads(1)

ENC_TOL = 3e-5     # tests/test_t5.py:230
LOGITS_TOL = 1e-4
HF_TINY = dict(model_type="t5", vocab_size=64, d_model=48, d_kv=32, num_heads=3, d_ff=64,
               num_layers=2, num_decoder_layers=2, relative_attention_num_buckets=32,
               relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
               pad_token_id=0, eos_token_id=1, decoder_start_token_id=0)
VARIANTS = {
    "relu_tied": dict(feed_forward_proj="relu", tie_word_embeddings=True),
    "gated_untied": dict(feed_forward_proj="gated-gelu", tie_word_embeddings=False),
}


def hf_state_dict(hf: dict, seed: int) -> dict:
    """A T5ForConditionalGeneration state dict (HF names, [out, in] linear
    weights) drawn at HF's ``_init_weights`` standard deviations."""
    rng = np.random.default_rng(seed)
    d, kv, H, f = hf["d_model"], hf["d_kv"], hf["num_heads"], hf["d_ff"]
    inner = H * kv
    gated = hf["feed_forward_proj"].startswith("gated")

    def w(shape, std):
        return (rng.normal(size=shape) * std).astype(np.float32)

    sd = {"shared.weight": w((hf["vocab_size"], d), 1.0)}

    def attn(prefix):
        sd[f"{prefix}.q.weight"] = w((inner, d), (d * kv) ** -0.5)
        sd[f"{prefix}.k.weight"] = w((inner, d), d ** -0.5)
        sd[f"{prefix}.v.weight"] = w((inner, d), d ** -0.5)
        sd[f"{prefix}.o.weight"] = w((d, inner), inner ** -0.5)

    def ffn(prefix):
        for name in (("wi_0", "wi_1") if gated else ("wi",)):
            sd[f"{prefix}.{name}.weight"] = w((f, d), d ** -0.5)
        sd[f"{prefix}.wo.weight"] = w((d, f), f ** -0.5)

    for stack, n, cross in (("encoder", hf["num_layers"], False),
                            ("decoder", hf["num_decoder_layers"], True)):
        sd[f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = w(
            (hf["relative_attention_num_buckets"], H), d ** -0.5)
        sd[f"{stack}.final_layer_norm.weight"] = w((d,), 0.1) + 1.0
        for i in range(n):
            p = f"{stack}.block.{i}.layer"
            attn(f"{p}.0.SelfAttention")
            sd[f"{p}.0.layer_norm.weight"] = w((d,), 0.1) + 1.0
            if cross:
                attn(f"{p}.1.EncDecAttention")
                sd[f"{p}.1.layer_norm.weight"] = w((d,), 0.1) + 1.0
            ff = 2 if cross else 1
            ffn(f"{p}.{ff}.DenseReluDense")
            sd[f"{p}.{ff}.layer_norm.weight"] = w((d,), 0.1) + 1.0
    if not hf["tie_word_embeddings"]:
        sd["lm_head.weight"] = w((hf["vocab_size"], d), d ** -0.5)
    return sd


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request, tmp_path_factory):
    """(variant, checkpoint dir, jax cfg, jax params, port cfg, port params)."""
    hf = dict(HF_TINY, **VARIANTS[request.param])
    sd = hf_state_dict(hf, seed=len(request.param))
    d = tmp_path_factory.mktemp(request.param)
    (d / "config.json").write_text(json.dumps(hf))
    jcfg = jax_t5.T5Config.from_hf_json(str(d / "config.json"), dtype="float32")
    tcfg = t5.T5Config.from_hf_json(str(d / "config.json"), dtype="float32")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / "pytorch_model.bin")
    return (request.param, d, jcfg, jax_t5.from_state_dict(sd, jcfg), tcfg,
            t5.from_state_dict(sd, tcfg))


def _batch(cfg, B, L, seed, pads=()):
    rng = np.random.default_rng(seed)
    src = rng.integers(2, cfg.vocab_size, (B, L)).astype(np.int32)
    mask = np.ones((B, L), dtype=np.int32)
    for row, n in pads:
        mask[row, n:] = 0
        src[row, n:] = cfg.pad_id
    return src, mask


def test_config_fields_match(model):
    _, _, jcfg, _, tcfg, _ = model
    for name in jcfg.__dataclass_fields__:
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("with_kernel", [False, True], ids=["dense", "kernel"])
def test_encode_and_teacher_forced_logits_match_jax(model, with_kernel):
    _, _, jcfg, jp, tcfg, tp = model
    src, mask = _batch(jcfg, 3, 9, seed=0, pads=[(1, 6)])
    tgt = np.random.default_rng(1).integers(2, jcfg.vocab_size, (3, 5)).astype(np.int32)
    tgt[:, 0] = jcfg.decoder_start_id
    want_enc = jax_t5.encode(jp, src, mask, jcfg)
    want_logits = np.asarray(jax_t5.decode_full(jp, tgt, want_enc, mask, jcfg))
    before = dict(fa.SELECTION_COUNTS)
    got_enc = t5.encode(tp, torch.from_numpy(src), torch.from_numpy(mask), tcfg,
                        kernel=fa.flash_attention_t5 if with_kernel else None)
    flash = fa.SELECTION_COUNTS["t5_flash"] - before["t5_flash"]
    assert flash == (tcfg.n_enc_layers if with_kernel else 0)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), atol=ENC_TOL, rtol=0)
    got_logits = t5.decode_full(tp, torch.from_numpy(tgt), got_enc, torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, atol=LOGITS_TOL, rtol=0)


@pytest.mark.parametrize("beams,lp", [(1, 1.0), (4, 1.0), (4, 2.0)])
def test_generated_tokens_match_jax(model, beams, lp):
    _, _, jcfg, jp, tcfg, tp = model
    src, mask = _batch(jcfg, 3, 7, seed=6, pads=[(1, 5)])
    T = 8
    want = jax.jit(lambda p, i, m: jax_t5.generate(p, i, m, jcfg, T, num_beams=beams,
                                                   length_penalty=lp))(jp, src, mask)
    with torch.inference_mode():
        got = t5.generate(tp, torch.from_numpy(src), torch.from_numpy(mask), tcfg, T,
                          num_beams=beams, length_penalty=lp, kernel=fa.flash_attention_t5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_decode_step_matches_teacher_forcing(model):
    """The cached single-step decoder reproduces the full decoder's logits
    position by position (an index bug in the in-place cache write cannot
    cancel out)."""
    _, _, _, _, tcfg, tp = model
    src, mask = (torch.from_numpy(x) for x in _batch(tcfg, 2, 6, seed=9))
    tgt = torch.from_numpy(np.random.default_rng(2).integers(2, tcfg.vocab_size, (2, 5)))
    enc = t5.encode(tp, src, mask, tcfg)
    full = t5.decode_full(tp, tgt, enc, mask, tcfg)
    caches = t5._init_self_caches(tcfg, 2, 5, None)
    cross = t5._init_cross_kv(tp, enc, tcfg)
    dec_bias = t5._causal_rel_bias(tp, 5, tcfg, None)
    for step in range(5):
        logits, caches = t5.decode_step(tp, tgt[:, step], step, caches, cross, dec_bias,
                                        t5._pad_bias(mask), tcfg)
        np.testing.assert_allclose(logits.numpy(), full[:, step].numpy(), atol=LOGITS_TOL)


@pytest.mark.parametrize("fmt", ["pytorch_model.bin", "model.safetensors"])
def test_load_hf_dir_matches_jax(model, fmt, tmp_path):
    name, d, jcfg, jp, tcfg, _ = model
    if fmt == "model.safetensors":
        from safetensors.torch import save_file

        raw = torch.load(d / "pytorch_model.bin", weights_only=True)
        ckpt = tmp_path / "st"
        ckpt.mkdir()
        (ckpt / "config.json").write_text((d / "config.json").read_text())
        save_file(raw, str(ckpt / "model.safetensors"))
    else:
        ckpt = d
    cfg, params = t5.load_hf_dir(str(ckpt), dtype="float32")
    assert cfg == tcfg
    jcfg2, jparams = jax_t5.load_hf_dir(str(d), dtype="float32")
    src, mask = _batch(cfg, 2, 8, seed=3, pads=[(0, 5)])
    np.testing.assert_allclose(
        t5.encode(params, torch.from_numpy(src), torch.from_numpy(mask), cfg).numpy(),
        np.asarray(jax_t5.encode(jparams, src, mask, jcfg2)), atol=ENC_TOL, rtol=0)


def test_bf16_weights_load_in_the_compute_dtype(model, tmp_path):
    """A checkpoint saved in bf16 loads (the reference reads it through
    numpy, which has no bf16): matmul weights in the compute dtype, norms
    and relative bias tables in f32."""
    _, d, *_ = model
    raw = torch.load(d / "pytorch_model.bin", weights_only=True)
    (tmp_path / "config.json").write_text((d / "config.json").read_text())
    torch.save({k: v.bfloat16() for k, v in raw.items()}, tmp_path / "pytorch_model.bin")
    cfg, params = t5.load_hf_dir(str(tmp_path))
    assert cfg.compute_dtype == torch.bfloat16
    assert params["embed"].dtype == torch.bfloat16
    assert params["enc"]["layers"][0]["attn"]["q"].dtype == torch.bfloat16
    assert params["enc"]["rel_bias"].dtype == torch.float32
    assert params["dec"]["layers"][1]["ln_x"].dtype == torch.float32
    torch.testing.assert_close(params["enc"]["rel_bias"],
                               raw["encoder.block.0.layer.0.SelfAttention"
                                   ".relative_attention_bias.weight"].bfloat16().float())


def _config_error(module, hf_text, tmp_path):
    p = tmp_path / "config.json"
    p.write_text(hf_text)
    with pytest.raises(RuntimeError) as err:
        module.T5Config.from_hf_json(str(p))
    return str(err.value)


@pytest.mark.parametrize("bad", ["gelu", "gated-silu", "bert", "not json"])
def test_from_hf_json_refuses_what_the_reference_refuses(bad, tmp_path):
    if bad == "not json":
        text = "{not json"
    elif bad == "bert":
        text = json.dumps(dict(HF_TINY, model_type="bert"))
    else:
        text = json.dumps(dict(HF_TINY, feed_forward_proj=bad))
    assert _config_error(t5, text, tmp_path) == _config_error(jax_t5, text, tmp_path)


def test_is_hf_t5_dir_matches_jax(tmp_path):
    cases = {"t5": json.dumps(HF_TINY), "bart": json.dumps({"model_type": "bart"}),
             "broken": "{", "none": None}
    for name, text in cases.items():
        d = tmp_path / name
        d.mkdir()
        if text is not None:
            (d / "config.json").write_text(text)
        assert t5.is_hf_t5_dir(str(d)) == jax_t5.is_hf_t5_dir(str(d)), name
    assert not t5.is_hf_t5_dir(str(tmp_path / "missing"))


def test_spm_gate_gives_the_reference_error(tmp_path):
    try:
        import sentencepiece  # noqa: F401
        pytest.skip("sentencepiece installed; the gate is not reachable")
    except ImportError:
        pass
    with pytest.raises(RuntimeError) as got:
        t5.hf_spm(str(tmp_path))
    with pytest.raises(RuntimeError) as want:
        jax_t5.hf_spm(str(tmp_path))
    assert str(got.value) == str(want.value) and "sentencepiece" in str(got.value)


class _FakeSpm:
    """A stand-in SentencePiece processor: one id per character."""

    def EncodeAsIds(self, text):  # noqa: N802 — SentencePiece's name
        return [2 + ord(c) % 50 for c in text]


@pytest.mark.parametrize("texts", [["ab", "a much longer row of text"], ["x" * 40] * 3])
def test_encode_pad_batch_matches_jax(texts):
    kw = dict(vocab_size=64, max_src_len=32)
    got = t5.encode_pad_batch(_FakeSpm(), texts, t5.T5Config(**kw), [1, 2, 4], [8, 16, 32])
    want = jax_t5.encode_pad_batch(_FakeSpm(), texts, jax_t5.T5Config(**kw), [1, 2, 4],
                                   [8, 16, 32])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_relative_bias_is_shared_by_every_encoder_layer(model):
    """Every layer's kernel call gets the stack's one learned table, as in
    the reference (only block 0 holds it)."""
    *_, tcfg, tp = model
    seen = []

    def spy(q, k, v, mask, rel_bias, **kw):
        seen.append(rel_bias)
        return fa.flash_attention_t5(q, k, v, mask, rel_bias, **kw)

    src, mask = (torch.from_numpy(x) for x in _batch(tcfg, 2, 5, seed=4))
    t5.encode(tp, src, mask, tcfg, kernel=spy)
    assert len(seen) == tcfg.n_enc_layers and all(s is tp["enc"]["rel_bias"] for s in seen)


def test_declined_kernel_falls_back_to_dense_for_every_layer(model):
    *_, tcfg, tp = model
    calls = []

    def decline(*args, **kw):
        calls.append(1)
        return None

    src, mask = (torch.from_numpy(x) for x in _batch(tcfg, 2, 5, seed=5))
    got = t5.encode(tp, src, mask, tcfg, kernel=decline)
    assert len(calls) == 1
    torch.testing.assert_close(got, t5.encode(tp, src, mask, tcfg), rtol=0, atol=0)
