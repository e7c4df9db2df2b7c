"""The decoder families (the in-house seq2seq, T5, BART) on dp and tp meshes
in one process: the port on ``TorchRuntime(devices=["cpu"] * N,
mesh_shape=...)`` against the reference on the same mesh of the conftest's
virtual devices, and against its own one-device run.

The models are small f32 ones, so the sharded and the one-device runs
differ only in f32 summation order: summaries and tokens equal,
teacher-forced log-probabilities within 1e-5. Also here: the weights are
really split (each shard holds 1/tp of a split leaf, T5's ``[out, in]``
linears on the right dim, int8 tables stay int8), heads that do not divide
tp replicate and serve (counted under ``SELECTION_COUNTS["unsharded"]``),
and a mesh with pp or ep is a soft ``bad_input``."""

import json
import os

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from agent_tpu.config import DeviceConfig as JaxDeviceConfig
from agent_tpu.models import t5 as jax_t5
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.ops import map_summarize as jax_summarize_op
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import TpuRuntime
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import bart, seq2seq, t5
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.ops import map_summarize as summarize_op
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime
from tests.test_torch_t5 import HF_TINY, hf_state_dict

torch.set_num_threads(1)

S2S = {"d_model": 32, "n_heads": 4, "n_enc_layers": 1, "n_dec_layers": 2, "d_ff": 64,
       "max_src_len": 64, "max_tgt_len": 16, "dtype": "float32"}
TEXTS = [f"a long document about tensor parallel serving, row {i} " * (1 + i % 3)
         for i in range(8)]
MESHES = [{"tp": 2}, {"dp": 2, "tp": 2}, {"tp": 4}, {"dp": 4, "tp": 2}]
MESH_IDS = ["tp2", "dp2-tp2", "tp4", "dp4-tp2"]
LOGP_TOL = 1e-5  # f32 summation order
T5_HF = dict(HF_TINY, num_heads=4, feed_forward_proj="gated-gelu", tie_word_embeddings=False)
BART_HF = dict(chip_smoke.BART_LARGE_CNN, d_model=64, encoder_layers=2, decoder_layers=2,
               encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=128,
               decoder_ffn_dim=128, max_position_embeddings=128)


def _n(shape):
    return int(np.prod(list(shape.values())))


def port_runtime(shape):
    return TorchRuntime(devices=["cpu"] * _n(shape), mesh_shape=shape)


def jax_runtime(shape):
    return TpuRuntime(config=JaxDeviceConfig(tpu_disabled=True, mesh_shape=shape),
                      devices=jax.devices("cpu")[:_n(shape)])


@pytest.fixture(scope="module")
def summarize():
    fn = load_ops(["map_summarize"])["map_summarize"]
    return lambda payload, rt: fn(dict(payload), OpContext(runtime=rt))


def jax_summarize(payload, rt):
    return jax_get_op("map_summarize")(dict(payload), JaxOpContext(runtime=rt))


def _payload(beams=1, **cfg):
    return {"texts": TEXTS, "max_length": 8, "num_beams": beams,
            "model_config": dict(S2S, **cfg), "model_path": "tp-decoders"}


def _resident(rt, model_id, family, cfg):
    """The model the op placed, under the tp key."""
    return rt._params.get_or_build((summarize_op.params_key(model_id, family, cfg), "tp"),
                                   lambda: pytest.fail("not placed under the tp key"))


@pytest.mark.parametrize("beams", [1, 4])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_seq2seq_on_a_mesh_matches_the_reference_on_it(summarize, shape, beams):
    payload = _payload(beams)
    got = summarize(payload, port_runtime(shape))
    want = jax_summarize(payload, jax_runtime(shape))
    one = summarize(payload, TorchRuntime(device="cpu"))
    assert got["ok"] and want["ok"] and one["ok"]
    assert got["summaries"] == want["summaries"] == one["summaries"]
    assert any(got["summaries"])


@pytest.mark.parametrize("mode", ["int8", "w8a16"])
@pytest.mark.parametrize("shape", MESHES[:2], ids=MESH_IDS[:2])
def test_quantized_seq2seq_on_a_mesh_matches_the_reference(summarize, shape, mode):
    """tests/test_quant.py's int8 and w8a16 summarize on tp: W8A8 quantizes
    each row with the abs-max over every shard, so the sharded run is the
    one-device run."""
    payload = _payload(quant=mode)
    got = summarize(payload, port_runtime(shape))
    assert got["summaries"] == jax_summarize(payload, jax_runtime(shape))["summaries"]
    assert got["summaries"] == summarize(payload, TorchRuntime(device="cpu"))["summaries"]


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_seq2seq_weights_are_really_split(summarize, mode):
    """Each tp shard holds half of every split leaf (heads, FFN columns and
    rows, the vocabulary), int8 tables stay int8, and dp replicas on one
    device share their pieces."""
    rt = port_runtime({"dp": 2, "tp": 2})
    assert summarize(_payload(quant=mode), rt)["ok"]
    cfg = seq2seq.Seq2SeqConfig(**dict(S2S, quant=mode))
    model = _resident(rt, "tp-decoders", "seq2seq", cfg)
    assert isinstance(model, seq2seq.ShardedSeq2Seq) and len(model.shards) == 2
    assert model.split == {"embed": True, "attn": True, "ffn": True}
    for shard in model.group(0):
        blk = shard.dec[0]
        wq = blk.xattn.wq.w_q if mode == "int8" else blk.xattn.wq
        assert tuple(wq.shape) == (32, 2, 8)
        assert wq.dtype == (torch.int8 if mode == "int8" else torch.float32)
        ffn_wi = blk.ffn.wi.w_q if mode == "int8" else blk.ffn.wi.w
        assert tuple(ffn_wi.shape) == (32, 32) and shard.embed.shape[0] == 130
        assert tuple(blk.ln1.scale.shape) == (32,)
    assert model.group(1)[0] is model.group(0)[0]


def test_indivisible_heads_replicate_and_serve(summarize):
    """6 heads on tp 4 replicate every attention leaf (the reference's
    sanitize_specs), which runs whole on the first shard, counted."""
    payload = dict(_payload(), model_config=dict(S2S, d_model=48, n_heads=6))
    rt = port_runtime({"tp": 4})
    before = fa.SELECTION_COUNTS["unsharded"]
    got = summarize(payload, rt)
    assert fa.SELECTION_COUNTS["unsharded"] > before
    assert got["summaries"] == summarize(payload, TorchRuntime(device="cpu"))["summaries"]
    assert got["summaries"] == jax_summarize(payload, jax_runtime({"tp": 4}))["summaries"]
    model = _resident(rt, "tp-decoders", "seq2seq",
                      seq2seq.Seq2SeqConfig(**dict(S2S, d_model=48, n_heads=6)))
    assert not model.split["attn"] and model.split["ffn"]
    assert tuple(model.group(0)[1].dec[0].attn.wq.shape) == (48, 6, 8)


@pytest.mark.parametrize("shape", [{"pp": 2}, {"ep": 2}, {"dp": 2, "pp": 2}],
                         ids=["pp2", "ep2", "dp2-pp2"])
def test_pp_or_ep_mesh_is_soft_for_every_decoder_op(summarize, shape):
    rt = port_runtime(shape)
    ctx = OpContext(runtime=rt)
    ops = load_ops(["serve_summarize", "summarize_encode", "summarize_decode"])
    outs = [summarize(_payload(), rt),
            ops["serve_summarize"]({"requests": [{"req_id": "a", "text": "x"}],
                                    "model_config": S2S}, ctx),
            ops["summarize_encode"]({"texts": ["x"], "model_config": S2S}, ctx),
            ops["summarize_decode"]({"encoded": {"op": "summarize_encode", "chunks": [{}]},
                                     "model_config": S2S}, ctx)]
    for out in outs:
        assert out["ok"] is False and "no decoder runs" in out["error"], out


# ---- teacher-forced log-probabilities, mesh against one device ----

def _forced(model, one, ids, mask, tgt, attn=fa.flash_attention):
    got = model.forced_logp(ids, mask, tgt, attn)
    want = one.forced_logp(ids, mask, tgt, attn)
    assert torch.isfinite(got).all()
    return (got - want).abs().max().item()


def _ids(vocab, B=8, L=16, seed=0, low=4):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(low, vocab, (B, L)).astype(np.int32))
    mask = (torch.arange(L)[None, :] < torch.tensor([L, 9, 12, 5, L, 7, 16, 3])[:, None])
    tgt = torch.from_numpy(rng.integers(low, vocab, (B, 6)).astype(np.int64))
    return ids, mask.to(torch.int32), tgt


@pytest.mark.parametrize("shape", MESHES[:2], ids=MESH_IDS[:2])
def test_seq2seq_logp_on_a_mesh_within_f32_order(shape):
    cfg = seq2seq.Seq2SeqConfig(**S2S)
    flat = seq2seq.init_params(cfg, "logp")
    rt = port_runtime(shape)
    model = summarize_op._get_model(rt, "logp", cfg, "seq2seq")
    one = seq2seq._mesh(seq2seq.from_jax_params(flat, cfg))
    assert _forced(model, one, *_ids(cfg.vocab_size)) <= LOGP_TOL


# ---- T5 through the op's device phase (no sentencepiece here) ----

@pytest.fixture(scope="module")
def t5_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("t5_tp")
    (d / "config.json").write_text(json.dumps(T5_HF))
    torch.save({k: torch.from_numpy(v) for k, v in hf_state_dict(T5_HF, seed=11).items()},
               d / "pytorch_model.bin")
    return str(d)


def _t5_chunks():
    rng = np.random.default_rng(5)
    rows = [list(rng.integers(2, 64, n)) + [1] for n in (5, 11, 3, 14, 7, 9)]
    ids = np.zeros((8, 16), dtype=np.uint16)
    lengths = np.zeros(8, dtype=np.int32)
    for r, row in enumerate(rows):
        ids[r, :len(row)] = row
        lengths[r] = len(row)
    return [(ids, lengths, len(rows))]


@pytest.mark.parametrize("beams", [1, 4])
@pytest.mark.parametrize("shape", MESHES[:2], ids=MESH_IDS[:2])
def test_t5_device_phase_on_a_mesh_matches_the_reference(t5_dir, shape, beams):
    """T5 (gated-gelu, untied) through the op's device phase on staged ids:
    the encoder's kernel once per layer and shard, the reference's
    ``t5.generate`` on params placed by ``t5_param_specs`` on its mesh and
    the port's one device give the same tokens."""
    cfg = t5.T5Config.from_hf_json(os.path.join(t5_dir, "config.json"), dtype="float32")
    jcfg = jax_t5.T5Config.from_hf_json(os.path.join(t5_dir, "config.json"), dtype="float32")
    chunks = _t5_chunks()
    sel = fa.SELECTION_COUNTS["t5_flash"]
    got = summarize_op._decode_chunks(port_runtime(shape), chunks, t5_dir, cfg, 6, beams,
                                      family="t5")
    assert fa.SELECTION_COUNTS["t5_flash"] - sel == cfg.n_enc_layers * _n(shape)
    want = jax_summarize_op._decode_chunks(jax_runtime(shape), chunks, t5_dir, jcfg, 6, beams,
                                           family="t5")
    one = summarize_op._decode_chunks(TorchRuntime(device="cpu"), chunks, t5_dir, cfg, 6, beams,
                                      family="t5")
    (g, n), (w, _), (o, _) = got[0], want[0], one[0]
    np.testing.assert_array_equal(g.numpy()[:n], np.asarray(w)[:n])
    np.testing.assert_array_equal(g.numpy()[:n], o.numpy()[:n])


@pytest.mark.parametrize("mode", ["none", "int8", "w8a16"])
def test_t5_weights_split_on_their_out_in_dims(t5_dir, mode):
    """The port's T5 holds HF's [out, in] linears: q/k/v, wi_0/wi_1 and the
    lm head split dim 0, o and wo dim 1; a quantized table stays int8 with
    its scale split with dim 0 (q) or whole (o); the split model's tokens
    are one device's (W8A8's row-parallel scale spans every shard)."""
    cfg = t5.T5Config.from_hf_json(os.path.join(t5_dir, "config.json"), dtype="float32",
                                   quant=mode)
    rt = port_runtime({"tp": 2})
    model = summarize_op._get_model(rt, t5_dir, cfg, "t5")
    assert isinstance(model, t5.ShardedT5)
    assert model.split == {"embed": True, "attn": True, "ffn": True, "lm_head": True}
    table = {"none": None, "int8": "w_q", "w8a16": "w8"}[mode]
    inner, d, f = 4 * 32, 48, 64
    for shard in model.group(0):
        blk = shard["dec"]["layers"][0]
        shapes = {"q": (inner // 2, d), "o": (d, inner // 2)}
        for name, shape in shapes.items():
            leaf = blk["cross"][name]
            got = leaf if table is None else leaf[table]
            assert tuple(got.shape) == shape
            assert got.dtype == (torch.float32 if table is None else torch.int8)
            if table is not None:
                assert tuple(leaf["w_scale"].shape) == (shape[0],) if name == "q" else (d,)
        wo = blk["ffn"]["wo"] if table is None else blk["ffn"]["wo"][table]
        assert tuple(wo.shape) == (d, f // 2)
        assert tuple(shard["lm_head"].shape) == (32, d) and shard["embed"].shape[0] == 32
        assert tuple(shard["enc"]["rel_bias"].shape) == (T5_HF["relative_attention_num_buckets"],
                                                          4)
    (got, n), = summarize_op._decode_chunks(rt, _t5_chunks(), t5_dir, cfg, 4, 1, family="t5")
    (want, _), = summarize_op._decode_chunks(TorchRuntime(device="cpu"), _t5_chunks(), t5_dir,
                                             cfg, 4, 1, family="t5")
    np.testing.assert_array_equal(got.numpy()[:n], want.numpy()[:n])


def test_t5_logp_on_a_mesh_within_f32_order(t5_dir):
    cfg = t5.T5Config.from_hf_json(os.path.join(t5_dir, "config.json"), dtype="float32")
    model = summarize_op._get_model(port_runtime({"dp": 2, "tp": 2}), t5_dir, cfg, "t5")
    one = t5.ShardedT5.of(cfg, summarize_op._build_model(t5_dir, cfg, "t5", "cpu"), "cpu")
    assert _forced(model, one, *_ids(64, low=2), attn=fa.flash_attention_t5) <= LOGP_TOL


# ---- BART through the op, text in ----

@pytest.fixture(scope="module")
def bart_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bart_tp"))
    words = chip_smoke.write_bpe_vocab(d, 500, 9)
    n_vocab = len(json.load(open(f"{d}/vocab.json")))
    n_vocab += n_vocab % 4  # a vocabulary that divides the meshes' tp
    hf = dict(BART_HF, vocab_size=n_vocab)
    chip_smoke.write_hf_checkpoint(d, hf, chip_smoke.bart_state_dict(hf, 6, torch.float32,
                                                                     std=0.3))
    return d, words


@pytest.mark.parametrize("case", [{"max_length": 10}, {"max_length": 8, "num_beams": 4}],
                         ids=["greedy", "beam4"])
@pytest.mark.parametrize("shape", MESHES[:2], ids=MESH_IDS[:2])
def test_bart_on_a_mesh_matches_the_reference_on_it(summarize, bart_ckpt, shape, case):
    d, words = bart_ckpt
    texts = [" ".join(words[i:i + 12]) + "." for i in range(0, 48, 8)]
    payload = {"model_path": d, "model_config": {"dtype": "float32"}, "texts": texts, **case}
    rt = port_runtime(shape)
    got = summarize(payload, rt)
    assert got["ok"], got
    assert got["summaries"] == jax_summarize(payload, jax_runtime(shape))["summaries"]
    assert got["summaries"] == summarize(payload, TorchRuntime(device="cpu"))["summaries"]
    cfg = summarize_op._get_cfg(payload, "bart", d)
    model = _resident(rt, d, "bart", cfg)
    assert isinstance(model, bart.ShardedBart) and all(model.split.values())
    q = model.group(0)[1]["dec"]["layers"][0]["self"]["q"]
    assert tuple(q["w"].shape) == (64, 32) and tuple(q["b"].shape) == (32,)


@pytest.mark.parametrize("mode", ["int8", "w8a16"])
def test_quantized_bart_on_a_mesh_matches_the_reference(summarize, bart_ckpt, mode):
    d, words = bart_ckpt
    texts = [" ".join(words[i:i + 12]) + "." for i in range(0, 48, 8)]
    payload = {"model_path": d, "model_config": {"dtype": "float32", "quant": mode},
               "texts": texts, "max_length": 8}
    got = summarize(payload, port_runtime({"tp": 2}))
    assert got["summaries"] == jax_summarize(payload, jax_runtime({"tp": 2}))["summaries"]
    assert got["summaries"] == summarize(payload, TorchRuntime(device="cpu"))["summaries"]


def test_bart_logp_on_a_mesh_within_f32_order(tmp_path):
    """At HF's init scale (std 0.02); the op tests' std 0.3 weights give
    log-probabilities near -19.5, where f32 summation order alone moves
    them by 2.3e-5 (about ten ulps)."""
    d = str(tmp_path)
    hf = dict(BART_HF, vocab_size=64)
    chip_smoke.write_hf_checkpoint(d, hf, chip_smoke.bart_state_dict(hf, 7, torch.float32))
    cfg = summarize_op._get_cfg({"model_config": {"dtype": "float32"}}, "bart", d)
    model = summarize_op._get_model(port_runtime({"tp": 2}), d, cfg, "bart")
    one = bart.ShardedBart.of(cfg, summarize_op._build_model(d, cfg, "bart", "cpu"), "cpu")
    assert _forced(model, one, *_ids(cfg.vocab_size)) <= LOGP_TOL


# ---- serve_infer's four ops and summarize_mpmd on a mesh ----

SERVE_TEXTS = ["shared prefix context document alpha for the serving tests",
               "a different text to summarize entirely",
               "shared prefix context document alpha for the serving tests",
               "x", "tensor parallel decoding with a paged pool of blocks"]


@pytest.fixture
def serve_ops():
    from agent_tpu_torch.ops.serve_infer import reset_engines

    reset_engines()
    yield load_ops(["serve_summarize", "serve_prefill", "serve_decode", "summarize_encode",
                    "summarize_decode"])
    reset_engines()


def _serve_ctx(rt, **serve):
    from agent_tpu_torch.config import Config, ServeConfig

    return OpContext(runtime=rt, config=Config(serve=ServeConfig(**serve)))


def _requests(num_beams=1):
    reqs = [{"req_id": f"r{i}", "text": t, "max_length": 3 + 3 * i}
            for i, t in enumerate(SERVE_TEXTS)]
    return {"requests": reqs, "model_config": S2S, "num_beams": num_beams, "bucket": 64}


def _tokens(result):
    assert result["ok"], result
    return [(r["req_id"], r["summary"], r["tokens"], r["steps"]) for r in result["results"]]


@pytest.mark.parametrize("beams", [1, 4])
@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("shape", MESHES[:2], ids=MESH_IDS[:2])
def test_serve_ops_on_a_mesh_give_the_one_device_tokens(serve_ops, shape, layout, beams):
    """serve_summarize, and serve_prefill -> serve_decode, on the mesh give
    the one-device engine's tokens; each tp shard's KV cache holds H/tp
    heads, the paged pools under one block table."""
    from agent_tpu_torch.ops import serve_infer

    knobs = dict(kv_layout=layout, decode_slots=3, kv_block_size=4)
    payload = _requests(beams)
    one = TorchRuntime(device="cpu")  # alive: the engines key on id(runtime)
    want = _tokens(serve_ops["serve_summarize"](payload, _serve_ctx(one, **knobs)))
    rt = port_runtime(shape)
    got = serve_ops["serve_summarize"](payload, _serve_ctx(rt, **knobs))
    assert _tokens(got) == want
    ctx = _serve_ctx(rt, prefix_cache_enabled=False, **knobs)
    prefill = serve_ops["serve_prefill"](payload, ctx)
    assert _tokens(serve_ops["serve_decode"](dict(payload, encoded=prefill), ctx)) == want
    engine = next(e for k, e in serve_infer._ENGINES.items() if k[0] == id(rt))
    caches = engine._dyn["caches"]
    shards = caches["shards"] if layout == "paged" else caches
    assert len(shards) == 2
    for part in shards:
        pool = part["layers"][0]["k"] if layout == "paged" else part[0]["k"]
        assert pool.shape[1] == S2S["n_heads"] // 2
        if layout == "paged":
            assert part["table"] is caches["table"]  # one table, one device
    if layout == "paged":
        assert engine.kv_pool_blocks == shards[0]["layers"][0]["k"].shape[0]


def test_prefix_hit_on_a_mesh_equals_its_cold_run(serve_ops):
    rt = port_runtime({"tp": 2})
    cold = serve_ops["serve_summarize"](_requests(2), _serve_ctx(rt))
    warm = serve_ops["serve_summarize"](_requests(2), _serve_ctx(rt))
    assert cold["prefix_cache"]["hits"] == 0 and warm["prefix_cache"]["hits"] == 5
    assert _tokens(warm) == _tokens(cold)


def test_mpmd_encode_on_tp_decode_on_dp_tp_equals_one_device(serve_ops):
    """summarize_encode on tp 2, summarize_decode on dp 2 × tp 2: the
    one-device split's summaries; a decode batch that does not divide dp
    runs on replica 0's tp group, counted."""
    texts = TEXTS[:6]
    enc_payload = {"texts": texts, "model_config": S2S}
    one = TorchRuntime(device="cpu")
    want = serve_ops["summarize_decode"](
        {"encoded": serve_ops["summarize_encode"](enc_payload, OpContext(runtime=one)),
         "model_config": S2S, "max_length": 8}, OpContext(runtime=one))
    encoded = serve_ops["summarize_encode"](enc_payload,
                                            OpContext(runtime=port_runtime({"tp": 2})))
    assert [len(c["lengths"]) for c in encoded["chunks"]] == [8]
    decode_rt = port_runtime({"dp": 2, "tp": 2})
    before = fa.SELECTION_COUNTS["unsharded"]
    got = serve_ops["summarize_decode"]({"encoded": encoded, "model_config": S2S,
                                         "max_length": 8}, OpContext(runtime=decode_rt))
    assert got["summaries"] == want["summaries"] and any(got["summaries"])
    assert fa.SELECTION_COUNTS["unsharded"] == before
    # Three rows (a batch staged by another agent's mesh) do not divide dp
    # 2: they run on replica 0's tp group.
    odd = dict(encoded, chunks=[{k: (v[:3] if isinstance(v, list) else min(v, 3))
                                 for k, v in encoded["chunks"][0].items()}])
    got = serve_ops["summarize_decode"]({"encoded": odd, "model_config": S2S, "max_length": 8},
                                        OpContext(runtime=decode_rt))
    assert fa.SELECTION_COUNTS["unsharded"] == before + 1
    assert got["summaries"] == want["summaries"][:3]


def test_pipelined_agent_serves_on_a_mesh_as_the_reference_agent():
    """The port's pipelined agent on a dp 2 × tp 2 runtime drains the
    front door's serve_summarize jobs through its serving loop (the
    engine on replica 0's tp group) with the reference agent's answers."""
    from tests.test_torch_agent import (
        SERVE_REQUESTS,
        _pipelined_drain,
        _reference_serving,
        _serve_answers,
        _serve_controller,
        _serving_agent,
        _submit_serving,
    )

    want = _reference_serving(SERVE_REQUESTS, 2)
    controller = _serve_controller()
    rids = _submit_serving(controller, SERVE_REQUESTS, 2)
    rt = port_runtime({"dp": 2, "tp": 2})
    _pipelined_drain(_serving_agent(controller, rt), controller)
    assert _serve_answers(controller, rids) == want
    assert controller.counts().get("failed", 0) == 0
