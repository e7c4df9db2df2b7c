"""The port's quantized execution (``agent_tpu_torch.models.quant``) against
the reference's (``agent_tpu.models.quant``) on the same numpy inputs, on the
CPU:

- the int8 tables and scales of every family's tree bit-equal to
  ``quantize_weight``'s (T5's transposed: the port keeps HF's [out, in]),
  from f32 checkpoints and from a bf16 one;
- the activation codes and scales equal;
- the matmuls (``qdense``, ``qproj_in``, ``qproj_out``, ``qmoe_expert``) at
  f32 within 1e-6 relative, the weight-only ones within 1e-5
  (``tests/test_quant.py:116-117``); ``int_mm``'s zero padding exact;
- every family's forward in ``int8`` and ``w8a16``: at f32 within 1e-4 of
  the reference's quantized forward scaled by its max-abs, greedy tokens
  equal; at bf16 within the reference's 2e-2 of it;
- the ops: ``map_classify_tpu`` (encoder and BERT), ``map_summarize``
  (seq2seq, BART, T5's device phase), ``serve_summarize`` on the continuous
  engine, and ``TPU_QUANT``'s precedence, each against the reference op.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from agent_tpu.config import DeviceConfig
from agent_tpu.models import bart as jax_bart
from agent_tpu.models import bert as jax_bert
from agent_tpu.models import encoder as jax_encoder
from agent_tpu.models import quant as jq
from agent_tpu.models import seq2seq as jax_s2s
from agent_tpu.models import t5 as jax_t5
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.ops import map_summarize as jax_summarize_op
from agent_tpu.ops import serve_infer as jax_serve_infer
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import TpuRuntime
from agent_tpu_torch.config import Config, ServeConfig
from agent_tpu_torch.models import bart, bert, encoder, layers, quant, seq2seq, t5
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.ops import map_summarize as summarize_op
from agent_tpu_torch.ops import serve_infer
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime
from tests.test_torch_t5 import HF_TINY as T5_HF
from tests.test_torch_t5 import VARIANTS as T5_VARIANTS
from tests.test_torch_t5 import hf_state_dict as t5_state_dict

torch.set_num_threads(1)

MODES = ("int8", "w8a16")
MATMUL_TOL = {"int8": 1e-6, "w8a16": 1e-5}
LOGITS_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of the reference's max-abs
ENC = dict(vocab_size=260, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32,
           n_classes=5)
S2S = dict(vocab_size=64, d_model=32, n_heads=4, n_enc_layers=2, n_dec_layers=2, d_ff=64,
           max_src_len=16, max_tgt_len=8)
BERT_HF = dict(chip_smoke.BERT_BASE_UNCASED, vocab_size=300, hidden_size=32,
               num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=32, num_labels=5)
BART_HF = dict(chip_smoke.BART_LARGE_CNN, vocab_size=64, d_model=32, encoder_layers=2,
               decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
               encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tables_equal(got: dict, want: dict, transpose: bool = False):
    """Every leaf of the reference's quantized flat dict equal in the port's
    (int8 tables transposed for T5)."""
    assert set(got) == set(want), set(got) ^ set(want)
    n_tables = 0
    for k, w in want.items():
        g = got[k]
        if k.endswith((".w_q", ".w8")):
            n_tables += 1
            assert g.dtype == np.int8 and w.dtype == np.int8, k
            if transpose:
                g = g.T
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert n_tables > 0


def _quantized_leaves(flat: dict) -> dict:
    """The leaves of quantized matmuls (table, scale, bias) of a flat dict."""
    parents = {k.rsplit(".", 1)[0] for k in flat if k.endswith((".w_q", ".w8"))}
    return {k: v for k, v in flat.items() if k.rsplit(".", 1)[0] in parents}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = (v.float() if v.is_floating_point() else v).numpy() \
                if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


# ---- fixtures: one tiny checkpoint of each HF family ----

@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("qbert"))
    chip_smoke.write_hf_checkpoint(d, BERT_HF, chip_smoke.bert_state_dict(
        BERT_HF, 3, torch.float32, std=0.2))
    return d, chip_smoke.write_wordpiece_vocab(d, BERT_HF["vocab_size"], 4)


@pytest.fixture(scope="module")
def bart_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("qbart"))
    chip_smoke.write_hf_checkpoint(d, BART_HF, chip_smoke.bart_state_dict(
        BART_HF, 5, torch.float32, std=0.3))
    return d


@pytest.fixture(scope="module", params=sorted(T5_VARIANTS))
def t5_sd(request):
    hf = dict(T5_HF, **T5_VARIANTS[request.param])
    return hf, t5_state_dict(hf, seed=len(request.param))


def _t5_cfgs(hf, dtype, mode, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(hf))
    path = str(tmp_path / "config.json")
    return (jax_t5.T5Config.from_hf_json(path, dtype=dtype),
            t5.T5Config.from_hf_json(path, dtype=dtype, quant=mode))


# ---- 1. quantizers ----

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", ["encoder", "encoder_moe", "seq2seq"])
def test_module_family_tables_equal_the_reference(family, mode):
    if family == "seq2seq":
        jcfg, cfg = jax_s2s.Seq2SeqConfig(**S2S), seq2seq.Seq2SeqConfig(**S2S, quant=mode)
        want = layers.flatten(_np(jq.quantize_seq2seq(jax_s2s.init_params(jcfg, "q"), mode)))
        model = seq2seq.from_jax_params(seq2seq.init_params(cfg, "q"), cfg)
    else:
        kw = dict(ENC, moe_experts=4 if family == "encoder_moe" else 0)
        jcfg, cfg = jax_encoder.EncoderConfig(**kw), encoder.EncoderConfig(**kw, quant=mode)
        want = layers.flatten(_np(jq.quantize_encoder(jax_encoder.init_params(jcfg, "q"), mode)))
        model = encoder.from_jax_params(encoder.init_params(cfg, "q"), cfg)
    got = {k: (v.float() if v.is_floating_point() else v).numpy()
           for k, v in model.state_dict().items()}
    # The serving form holds the float leaves in the compute dtype; the
    # quantized leaves are the reference's.
    assert set(got) == set(want)
    _assert_tables_equal(_quantized_leaves(got), _quantized_leaves(want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ckpt_dtype", [torch.float32, torch.bfloat16])
def test_bert_tables_equal_the_reference(mode, ckpt_dtype, tmp_path):
    """Quantized from the checkpoint's values read to f32, whatever dtype it
    was stored in and whatever the compute dtype."""
    sd = chip_smoke.bert_state_dict(BERT_HF, 3, ckpt_dtype, std=0.2)
    chip_smoke.write_hf_checkpoint(str(tmp_path), BERT_HF, sd)
    # The reference reads a .bin through numpy, which has no bf16: hand it
    # the checkpoint's values in f32.
    jcfg = jax_bert.BertConfig.from_hf_json(str(tmp_path / "config.json"), dtype="float32")
    jp = jax_bert.from_state_dict({k: v.float().numpy() for k, v in sd.items()}, jcfg,
                                  head_seed=str(tmp_path))
    want = layers.flatten(_np(jq.quantize_bert(jp, mode)))
    _, tp = bert.load_hf_dir(str(tmp_path), dtype="bfloat16", quant=mode)
    _assert_tables_equal(_quantized_leaves(_flatten(tp)), _quantized_leaves(want))
    # Carried from the reference's quantized tree, flattened, unchanged.
    carried = _flatten(bert.from_jax_params(want, bert.BertConfig(
        vocab_size=300, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
        max_position=32, num_labels=5, dtype="float32", quant=mode)))
    _assert_tables_equal(carried, want)


@pytest.mark.parametrize("mode", MODES)
def test_bart_tables_equal_the_reference(bart_dir, mode):
    _, jp = jax_bart.load_hf_dir(bart_dir, dtype="float32")
    want = layers.flatten(_np(jq.quantize_bart(jp, mode)))
    _, tp = bart.load_hf_dir(bart_dir, dtype="float32", quant=mode)
    _assert_tables_equal(_flatten(tp), want)


@pytest.mark.parametrize("mode", MODES)
def test_t5_tables_equal_the_reference_transposed(t5_sd, mode, tmp_path):
    hf, sd = t5_sd
    jcfg, cfg = _t5_cfgs(hf, "float32", mode, tmp_path)
    want = layers.flatten(_np(jq.quantize_t5(jax_t5.from_state_dict(sd, jcfg), mode)))
    got = _flatten(t5.from_state_dict(sd, cfg))
    _assert_tables_equal(_quantized_leaves(got), _quantized_leaves(want), transpose=True)


# ---- 2. activation codes ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_codes_equal_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 40)) * rng.uniform(0.01, 30, size=(6, 1))).astype(np.float32)
    x[2] = 0.0                       # the scale floors at 1e-8: exact zeros
    x[4, :3] = [127.5, -127.5, 0.5]  # ties round half to even
    jx = jnp.asarray(x, dtype=dtype)
    want_q, want_s = jq.quantize_act(jx)
    got_q, got_s = quant.quantize_act(torch.from_numpy(np.asarray(jx.astype(jnp.float32)))
                                      .to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (got_q[2] == 0).all()


# ---- 3. matmuls ----

def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
def test_dense_matches_the_reference(mode):
    rng = np.random.default_rng(1)
    p = {"w": rng.normal(size=(24, 40)).astype(np.float32),
         "b": rng.normal(size=40).astype(np.float32)}
    qp = (jq.quantize_dense if mode == "int8" else jq.quantize_dense_w8a16)(p)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    want = np.asarray((jq.qdense if mode == "int8" else jq.wdense)(qp, x, jnp.float32))
    got = quant.dense({k: torch.from_numpy(v) for k, v in qp.items()}, torch.from_numpy(x),
                      torch.float32)
    assert _rel(got.numpy(), want) <= MATMUL_TOL[mode]


@pytest.mark.parametrize("mode", MODES)
def test_head_projections_match_the_reference(mode):
    rng = np.random.default_rng(2)
    qw = jq.quantize_weight if mode == "int8" else jq.quantize_weight_w8a16
    w_in = qw(rng.normal(size=(32, 4, 8)).astype(np.float32), (0,))
    w_out = qw(rng.normal(size=(4, 8, 32)).astype(np.float32), (0, 1))
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    o = rng.normal(size=(2, 4, 6, 8)).astype(np.float32)
    fin, fout = (jq.qproj_in, jq.qproj_out) if mode == "int8" else (jq.wproj_in, jq.wproj_out)
    t = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}  # noqa: E731
    got_in = quant.proj_in(t(w_in), torch.from_numpy(x), torch.float32)
    got_out = quant.proj_out(t(w_out), torch.from_numpy(o), torch.float32)
    assert _rel(got_in.numpy(), np.asarray(fin(w_in, x, jnp.float32))) <= MATMUL_TOL[mode]
    assert _rel(got_out.numpy(), np.asarray(fout(w_out, o, jnp.float32))) <= MATMUL_TOL[mode]


@pytest.mark.parametrize("mode", MODES)
def test_moe_expert_matches_the_reference(mode):
    """The port's expert-major [E, N, d] against the reference's [G, E, C, d],
    capacity-padding rows (zeros) included."""
    rng = np.random.default_rng(3)
    qw = jq.quantize_weight if mode == "int8" else jq.quantize_weight_w8a16
    p = qw(rng.normal(size=(3, 16, 24)).astype(np.float32), (1,))
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    x[1, 2, 3:] = 0.0
    want = np.asarray((jq.qmoe_expert if mode == "int8" else jq.wmoe_expert)(
        p, x, jnp.float32))                                          # [G, E, C, out]
    xe = torch.from_numpy(x.transpose(1, 0, 2, 3).reshape(3, 10, 16).copy())
    got = quant.moe_expert({k: torch.from_numpy(v) for k, v in p.items()}, xe, torch.float32)
    got = got.numpy().reshape(3, 2, 5, 24).transpose(1, 0, 2, 3)
    assert _rel(got, want) <= MATMUL_TOL[mode]
    assert (got[1, 2, 3:] == 0).all()


@pytest.mark.parametrize("m,k,n", [(1, 32, 8), (16, 24, 40), (17, 20, 12), (8, 7, 3)])
def test_int_mm_padding_is_exact(m, k, n):
    """The card's row and alignment rules met by zero padding give the
    unpadded product exactly, from a row-major and a column-major ``b``."""
    rng = np.random.default_rng(m * k * n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    want = a.int() @ b.int()
    assert torch.equal(quant.int_mm(a, b), want)
    assert torch.equal(quant.int_mm(a, b.t().contiguous().t()), want)


# ---- 4. family forwards ----

def _close(got, want, dtype):
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want, rtol=0,
                               atol=LOGITS_TOL[dtype] * scale)


def _ids(B, L, vocab, seed, lo=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L // 2:] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_encoder_logits_match_the_reference(mode, dtype):
    kw = dict(ENC, dtype=dtype)
    jcfg, cfg = jax_encoder.EncoderConfig(**kw), encoder.EncoderConfig(**kw, quant=mode)
    ids, mask = _ids(4, 16, 260, 0)
    want = jax_encoder.forward(jq.quantize_encoder(jax_encoder.init_params(jcfg, "f"), mode),
                               jnp.asarray(ids), jnp.asarray(mask), jcfg)
    with torch.no_grad():
        got = encoder.from_jax_params(encoder.init_params(cfg, "f"), cfg)(
            torch.from_numpy(ids), torch.from_numpy(mask))
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_bert_logits_match_the_reference(bert_dir, mode, dtype):
    jcfg, jp = jax_bert.load_hf_dir(bert_dir[0], dtype=dtype)
    cfg, tp = bert.load_hf_dir(bert_dir[0], dtype=dtype, quant=mode)
    ids, mask = _ids(3, 16, BERT_HF["vocab_size"], 1)
    want = jax_bert.forward(jq.quantize_bert(jp, mode), jnp.asarray(ids), jnp.asarray(mask),
                            jcfg)
    got = bert.forward(tp, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
    _close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_seq2seq_encoder_and_tokens_match_the_reference(mode, dtype):
    kw = dict(S2S, dtype=dtype)
    jcfg, cfg = jax_s2s.Seq2SeqConfig(**kw), seq2seq.Seq2SeqConfig(**kw, quant=mode)
    jp = jq.quantize_seq2seq(jax_s2s.init_params(jcfg, "s"), mode)
    model = seq2seq.from_jax_params(seq2seq.init_params(cfg, "s"), cfg)
    src, mask = _ids(3, 16, 64, 2)
    with torch.inference_mode():
        enc = seq2seq.encode(model, torch.from_numpy(src), torch.from_numpy(mask))
        toks, lens = seq2seq.greedy_generate(model, torch.from_numpy(src),
                                             torch.from_numpy(mask), 8)
    _close(enc.float().numpy(), jax_s2s.encode(jp, src, mask, jcfg), dtype)
    if dtype == "float32":
        want = jax_s2s.greedy_generate(jp, src, mask, jcfg, 8)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_bart_logits_and_tokens_match_the_reference(bart_dir, mode, dtype):
    jcfg, jp = jax_bart.load_hf_dir(bart_dir, dtype=dtype)
    cfg, tp = bart.load_hf_dir(bart_dir, dtype=dtype, quant=mode)
    jp = jq.quantize_bart(jp, mode)
    src, mask = _ids(3, 9, 64, 3)
    tgt = np.random.default_rng(4).integers(3, 64, (3, 5)).astype(np.int32)
    tgt[:, 0] = jcfg.decoder_start_id
    enc = jax_bart.encode(jp, jnp.asarray(src), jnp.asarray(mask), jcfg)
    want = jax_bart.decode_full(jp, jnp.asarray(tgt), enc, jnp.asarray(mask), jcfg)
    with torch.inference_mode():
        got_enc = bart.encode(tp, torch.from_numpy(src), torch.from_numpy(mask), cfg)
        got = bart.decode_full(tp, torch.from_numpy(tgt), got_enc, torch.from_numpy(mask), cfg)
        toks = bart.generate(tp, torch.from_numpy(src), torch.from_numpy(mask), cfg, 6)
    _close(got.numpy(), want, dtype)
    if dtype == "float32":
        want_toks = jax_bart.generate(jp, jnp.asarray(src), jnp.asarray(mask), jcfg, 6)
        np.testing.assert_array_equal(toks[0].numpy(), np.asarray(want_toks[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_t5_logits_and_tokens_match_the_reference(t5_sd, mode, dtype, tmp_path):
    hf, sd = t5_sd
    jcfg, cfg = _t5_cfgs(hf, dtype, mode, tmp_path)
    jp = jq.quantize_t5(jax_t5.from_state_dict(sd, jcfg), mode)
    tp = t5.from_state_dict(sd, cfg)
    src, mask = _ids(3, 9, hf["vocab_size"], 5, lo=2)
    tgt = np.random.default_rng(6).integers(2, hf["vocab_size"], (3, 5)).astype(np.int32)
    tgt[:, 0] = jcfg.decoder_start_id
    want = jax_t5.decode_full(jp, tgt, jax_t5.encode(jp, src, mask, jcfg), mask, jcfg)
    with torch.inference_mode():
        got = t5.decode_full(tp, torch.from_numpy(tgt), t5.encode(
            tp, torch.from_numpy(src), torch.from_numpy(mask), cfg), torch.from_numpy(mask), cfg)
        toks = t5.generate(tp, torch.from_numpy(src), torch.from_numpy(mask), cfg, 6)
    _close(got.numpy(), want, dtype)
    if dtype == "float32":
        want_toks = jax_t5.generate(jp, src, mask, jcfg, 6)
        np.testing.assert_array_equal(toks[0].numpy(), np.asarray(want_toks[0]))


# ---- 5. the ops ----

@pytest.fixture(scope="module")
def jax_ctx():
    rt = TpuRuntime(config=DeviceConfig(tpu_disabled=True, mesh_shape={"dp": 1}),
                    devices=jax.devices("cpu")[:1])
    return JaxOpContext(runtime=rt)


@pytest.fixture(scope="module")
def port_ctx():
    return OpContext(runtime=TorchRuntime(device="cpu"))


@pytest.fixture(scope="module")
def port_ops():
    return load_ops(["map_classify_tpu", "map_summarize", "serve_summarize"])


def _both(op, payload, port_ops, port_ctx, jax_ctx):
    return port_ops[op](dict(payload), port_ctx), jax_get_op(op)(dict(payload), jax_ctx)


def _scores(out):
    return (np.asarray([[e["index"] for e in r["topk"]] for r in out["results"]]),
            np.asarray([[e["score"] for e in r["topk"]] for r in out["results"]]))


TEXTS = ["the quick brown fox", "quantized serving on the card", "x", "a longer row " * 3]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", ["encoder", "bert"])
def test_classify_op_matches_the_reference(family, mode, bert_dir, port_ops, port_ctx,
                                           jax_ctx):
    base = ({"model_path": bert_dir[0], "model_config": {"dtype": "float32", "quant": mode}}
            if family == "bert" else {"model_config": dict(ENC, dtype="float32", quant=mode)})
    texts = [" ".join(bert_dir[1][i:i + 5]) for i in range(0, 20, 5)] \
        if family == "bert" else TEXTS
    got, want = _both("map_classify_tpu", dict(base, texts=texts, topk=5), port_ops,
                      port_ctx, jax_ctx)
    assert got["ok"] and want["ok"]
    (gi, gs), (wi, ws) = _scores(got), _scores(want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)


@pytest.mark.parametrize("env,payload_quant,want_mode", [
    ("int8", None, "int8"), ("w8a16", "none", "none"), ("none", "w8a16", "w8a16"),
    (" INT8 ", None, "int8")])
def test_tpu_quant_env_precedence(env, payload_quant, want_mode, port_ops, port_ctx,
                                  jax_ctx, monkeypatch):
    """The payload's quant wins, else TPU_QUANT, else the config's: the same
    scores as the reference op and as the port run with the mode given
    explicitly."""
    monkeypatch.setenv("TPU_QUANT", env)
    mc = dict(ENC, dtype="float32")
    if payload_quant is not None:
        mc["quant"] = payload_quant
    got, want = _both("map_classify_tpu", {"texts": TEXTS, "model_config": mc}, port_ops,
                      port_ctx, jax_ctx)
    monkeypatch.delenv("TPU_QUANT")
    explicit = port_ops["map_classify_tpu"]({"texts": TEXTS, "model_config": dict(
        mc, quant=want_mode)}, port_ctx)
    np.testing.assert_allclose(_scores(got)[1], _scores(want)[1], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(_scores(got)[1], _scores(explicit)[1])


def test_describe_reports_the_fleet_quant_default(monkeypatch):
    from agent_tpu_torch.config import DeviceConfig as PortDeviceConfig

    monkeypatch.setenv("TPU_QUANT", " W8A16 ")
    assert PortDeviceConfig.from_env().quant == DeviceConfig.from_env().quant == "w8a16"
    rt = TorchRuntime(device="cpu", config=PortDeviceConfig.from_env())
    assert rt.describe()["quant_default"] == "w8a16"
    assert TorchRuntime(device="cpu").describe()["quant_default"] == "none"


@pytest.mark.parametrize("mode", MODES)
def test_summarize_seq2seq_matches_the_reference(mode, port_ops, port_ctx, jax_ctx):
    payload = {"texts": TEXTS, "max_length": 6,
               "model_config": dict(S2S, vocab_size=260, max_src_len=64, dtype="float32",
                                    quant=mode)}
    got, want = _both("map_summarize", payload, port_ops, port_ctx, jax_ctx)
    assert got["ok"] and got["summaries"] == want["summaries"]


@pytest.mark.parametrize("mode", MODES)
def test_summarize_bart_matches_the_reference(mode, tmp_path_factory, port_ops, port_ctx,
                                              jax_ctx):
    d = str(tmp_path_factory.mktemp("qbart_text"))
    words = chip_smoke.write_bpe_vocab(d, 300, 9)
    n_vocab = len(json.load(open(f"{d}/vocab.json")))
    hf = dict(BART_HF, vocab_size=n_vocab, max_position_embeddings=64)
    chip_smoke.write_hf_checkpoint(d, hf, chip_smoke.bart_state_dict(hf, 6, torch.float32,
                                                                     std=0.3))
    texts = [" ".join(words[i:i + 10]) + "." for i in range(0, 30, 10)]
    payload = {"model_path": d, "texts": texts, "max_length": 6,
               "model_config": {"dtype": "float32", "quant": mode}}
    got, want = _both("map_summarize", payload, port_ops, port_ctx, jax_ctx)
    assert got["ok"] and want["ok"] and got["summaries"] == want["summaries"]


@pytest.mark.parametrize("mode", MODES)
def test_summarize_t5_device_phase_matches_the_reference(mode, tmp_path, port_ctx, jax_ctx):
    """T5 text needs sentencepiece, so the op's device phase runs on staged
    ids (``_decode_chunks``, as tests/test_torch_map_summarize.py does)."""
    hf = dict(T5_HF, **T5_VARIANTS["gated_untied"])
    (tmp_path / "config.json").write_text(json.dumps(hf))
    torch.save({k: torch.from_numpy(v) for k, v in t5_state_dict(hf, 3).items()},
               tmp_path / "pytorch_model.bin")
    d = str(tmp_path)
    payload = {"model_path": d, "model_config": {"dtype": "float32", "quant": mode}}
    cfg = summarize_op._get_cfg(payload, "t5", d)
    jcfg = jax_summarize_op._get_ckpt_cfg(d, payload, "t5")
    assert cfg.quant == jcfg.quant == mode
    ids, mask = _ids(4, 12, hf["vocab_size"], 7, lo=2)
    lengths = mask.sum(axis=1).astype(np.int32)
    chunks = [(ids, lengths, 4)]
    got = summarize_op._decode_chunks(port_ctx.runtime, chunks, d, cfg, 6, 1, family="t5")
    want = jax_summarize_op._decode_chunks(jax_ctx.runtime, chunks, d, jcfg, 6, 1,
                                           family="t5")
    np.testing.assert_array_equal(got[0][0].cpu().numpy()[:4], np.asarray(want[0][0])[:4])


@pytest.mark.parametrize("mode", MODES)
def test_serve_summarize_on_the_engine_matches_the_reference(mode, port_ops, port_ctx,
                                                             jax_ctx):
    """A quantized seq2seq served by the continuous engine (paged KV, the
    prefix cache keyed on the quantized model): f32 tokens equal to the
    reference op's."""
    from agent_tpu.config import Config as JaxConfig
    from agent_tpu.config import ServeConfig as JaxServeConfig

    serve_infer.reset_engines()
    jax_serve_infer.reset_engines()
    reqs = [{"req_id": f"r{i}", "text": t, "max_length": 3 + 2 * i} for i, t in
            enumerate(TEXTS)]
    payload = {"requests": reqs, "bucket": 64, "model_config": dict(
        S2S, vocab_size=260, max_src_len=64, dtype="float32", quant=mode)}
    knobs = dict(decode_slots=2)
    got = port_ops["serve_summarize"](dict(payload), OpContext(
        runtime=port_ctx.runtime, config=Config(serve=ServeConfig(**knobs))))
    want = jax_get_op("serve_summarize")(dict(payload), JaxOpContext(
        runtime=jax_ctx.runtime, config=JaxConfig(serve=JaxServeConfig(**knobs))))
    assert got["ok"] and want["ok"]
    assert [r["summary"] for r in got["results"]] == [r["summary"] for r in want["results"]]
    # The same requests again hit the prefix cache of the quantized model.
    again = port_ops["serve_summarize"](dict(payload), OpContext(
        runtime=port_ctx.runtime, config=Config(serve=ServeConfig(**knobs))))
    assert [r["summary"] for r in again["results"]] == [r["summary"] for r in got["results"]]
    assert again["prefix_cache"]["hits"] > got["prefix_cache"]["hits"]
    serve_infer.reset_engines()
    jax_serve_infer.reset_engines()
