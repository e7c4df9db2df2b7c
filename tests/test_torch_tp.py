"""Tensor and data parallelism in one process: the port on
``TorchRuntime(devices=["cpu"] * N, mesh_shape=...)`` against the reference
on the same mesh of the conftest's virtual devices, and against its own
one-device run.

The models are small f32 ones (tests/test_tp_serving.py's config), so the
sharded and the one-device forwards differ only in f32 summation order:
indices equal, scores within 1e-5. Also here: the weights are really split
(each shard holds 1/tp of a split leaf, int8 tables stay int8), W8A8's
row-parallel activation scale is the absmax over every shard, the mesh
attention wrappers launch per shard, the runtime's placement keys, and a
training step on the mesh gives the one-device loss and gradients."""

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from agent_tpu.config import DeviceConfig as JaxDeviceConfig
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import TpuRuntime
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import encoder, layers, quant, train
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.ops import map_classify_tpu as classify_op
from agent_tpu_torch.parallel import collectives, shardings
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

MODEL_CONFIG = {"d_model": 64, "n_heads": 8, "n_layers": 2, "d_ff": 128, "max_len": 128,
                "n_classes": 64, "dtype": "float32"}
TEXTS = [f"tensor parallel serving row {i} " + "x" * (i % 9) for i in range(16)]
MESHES = [{"tp": 2}, {"dp": 2, "tp": 2}, {"tp": 4}, {"dp": 4, "tp": 2}]
MESH_IDS = ["tp2", "dp2-tp2", "tp4", "dp4-tp2"]


def _n(shape):
    return int(np.prod(list(shape.values())))


def port_runtime(shape):
    return TorchRuntime(devices=["cpu"] * _n(shape), mesh_shape=shape)


def jax_runtime(shape):
    return TpuRuntime(config=JaxDeviceConfig(tpu_disabled=True, mesh_shape=shape),
                      devices=jax.devices("cpu")[:_n(shape)])


@pytest.fixture(scope="module")
def classify():
    fn = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    return lambda payload, rt: fn(dict(payload), OpContext(runtime=rt))


def jax_classify(payload, rt):
    return jax_get_op("map_classify_tpu")(dict(payload), JaxOpContext(runtime=rt))


def _payload(**kw):
    return dict({"texts": TEXTS, "topk": 5, "model_config": MODEL_CONFIG,
                 "model_path": "tp-vs-rep", "result_format": "columnar"}, **kw)


def _agree(got, want, atol=1e-5):
    assert got["ok"] and want["ok"], (got, want)
    assert got["indices"] == want["indices"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=atol)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_classify_on_a_mesh_matches_the_reference_on_it(classify, shape):
    rt = port_runtime(shape)
    before = dict(fa.SELECTION_COUNTS)
    got = classify(_payload(), rt)
    # One attention call per layer and shard: 2 layers × tp × dp (d_head 8
    # takes dense attention; the kernel's head dims are 32, 64 and 128).
    calls = sum(fa.SELECTION_COUNTS[k] - before[k] for k in ("flash", "dense"))
    assert calls == 2 * _n(shape)
    assert fa.SELECTION_COUNTS["unsharded"] == before["unsharded"]
    _agree(got, jax_classify(_payload(), jax_runtime(shape)))
    _agree(got, classify(_payload(), TorchRuntime(device="cpu")))


@pytest.mark.parametrize("mode", ["int8", "w8a16"])
@pytest.mark.parametrize("shape", [{"tp": 2}, {"dp": 2, "tp": 2}], ids=["tp2", "dp2-tp2"])
def test_quantized_classify_on_a_mesh_matches_the_reference(classify, shape, mode):
    """W8A8 within 5e-3 of the reference (an activation at a rounding
    boundary takes the next code where the two sum in another order,
    tests/test_torch_bert.py), within 1e-5 of the port's one device."""
    payload = _payload(model_config=dict(MODEL_CONFIG, quant=mode), model_path="tp-q")
    got = classify(payload, port_runtime(shape))
    _agree(got, jax_classify(payload, jax_runtime(shape)), 5e-3 if mode == "int8" else 1e-5)
    _agree(got, classify(payload, TorchRuntime(device="cpu")))


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_weights_are_really_split(classify, mode):
    """Each tp shard holds half of every split leaf (the reference's shard
    shapes), on a key of its own; replicated leaves are whole."""
    rt = port_runtime({"dp": 2, "tp": 2})
    payload = _payload(model_config=dict(MODEL_CONFIG, quant=mode), model_path="tp-check")
    assert classify(payload, rt)["ok"]
    cfg = classify_op._get_cfg(payload)
    model = rt._params.get_or_build((classify_op.params_key("tp-check", "encoder", cfg), "tp"),
                                    lambda: pytest.fail("not cached under the tp key"))
    assert isinstance(model, encoder.ShardedEncoder) and len(model.modules) == 2
    for j in range(2):
        blk = model.shard(0, j).blocks[0]
        wq = blk.attn.wq.w_q if mode == "int8" else blk.attn.wq
        assert tuple(wq.shape) == (64, 4, 8)
        assert wq.dtype == (torch.int8 if mode == "int8" else torch.float32)
        assert model.shard(0, j).embed.shape[0] == 130 and model.shard(0, j).head.w.shape[1] == 32
        assert tuple(blk.ln1.scale.shape) == (64,)
    assert model.shard(1, 0) is model.shard(0, 0)  # dp replicas on one device share
    full = encoder.Encoder(encoder.EncoderConfig(**MODEL_CONFIG), device="meta").blocks[0]
    shard = model.shard(0, 0).blocks[0]
    if mode == "none":
        split = ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.wi.w", "ffn.wo.w")
        half = sum(shard.get_parameter(k).numel() for k in split)
        assert 2 * half == sum(full.get_parameter(k).numel() for k in split)


def test_indivisible_dims_replicate_and_serve(classify):
    """6 heads on tp = 4, 5 classes and a 261-row vocabulary replicate those
    leaves: the attention runs whole on shard 0, counted as unsharded, and
    the op serves the one-device result (the reference's case)."""
    cfg = {"d_model": 48, "n_heads": 6, "n_layers": 1, "d_ff": 64, "max_len": 64,
           "n_classes": 5, "vocab_size": 261, "dtype": "float32"}
    payload = _payload(model_config=cfg, model_path="tp-odd", topk=3)
    before = fa.SELECTION_COUNTS["unsharded"]
    got = classify(payload, port_runtime({"dp": 2, "tp": 4}))
    assert fa.SELECTION_COUNTS["unsharded"] == before + 2  # one layer, two dp replicas
    _agree(got, jax_classify(payload, jax_runtime({"dp": 2, "tp": 4})))
    _agree(got, classify(payload, TorchRuntime(device="cpu")))


# ---- BERT ----

HF = dict(chip_smoke.BERT_BASE_UNCASED, vocab_size=600, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=128, max_position_embeddings=64,
          num_labels=6)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bert-tp"))
    chip_smoke.write_hf_checkpoint(d, HF, chip_smoke.bert_state_dict(HF, 3, torch.float32,
                                                                     std=0.2))
    words = chip_smoke.write_wordpiece_vocab(d, HF["vocab_size"], 2)
    return d, words


@pytest.mark.parametrize("mode", ["none", "int8", "w8a16"])
@pytest.mark.parametrize("shape", [{"tp": 2}, {"dp": 2, "tp": 2}], ids=["tp2", "dp2-tp2"])
def test_bert_on_a_mesh_matches_the_reference(classify, bert_dir, shape, mode):
    """BERT's q/k/v, intermediate and pooler column-parallel, its output
    projections and head row-parallel, its word embedding vocab-split. The
    int8 scores are held within 5e-3 of the reference (tests/test_torch_bert.py's
    W8A8 rounding note) and 1e-5 of the port's one-device run."""
    d, words = bert_dir
    payload = {"model_path": d, "texts": [" ".join(words[i:i + 7]) for i in range(0, 48, 6)],
               "topk": 4, "result_format": "columnar",
               "model_config": {"dtype": "float32", "quant": mode}}
    rt = port_runtime(shape)
    got = classify(payload, rt)
    want = jax_classify(payload, jax_runtime(shape))
    assert got["indices"] == want["indices"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=5e-3 if mode == "int8" else 1e-5)
    _agree(got, classify(payload, TorchRuntime(device="cpu")))
    from agent_tpu_torch.models.bert import ShardedBert

    model = next(v for k, v in rt._params._cache.items() if k[1] == "tp")
    assert isinstance(model, ShardedBert)
    q = model.trees[model._key(0, 1)]["layers"][0]["attn"]["q"]
    assert q[quant.TABLE_KEY[mode]].shape == (64, 32) if mode != "none" else \
        q["w"].shape == (64, 32)


# ---- W8A8's row-parallel activation scale ----

def test_row_parallel_int8_scale_spans_every_shard():
    """A row whose absmax lies in shard 1's half: the tp product equals the
    one-device product exactly, and a scale taken from shard 0's half alone
    codes other int8 values (the planted fault chip_smoke checks)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 64)).astype(np.float32)
    x[:, 40] = 9.0  # every row's largest value, in shard 1's half
    w = rng.normal(size=(64, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in
         quant.quantize_dense({"w": w, "b": b}, "int8").items()}
    want = quant.dense(p, torch.from_numpy(x), torch.float32)
    halves = [dict(p, w_q=p["w_q"][:32]), dict(p, w_q=p["w_q"][32:])]
    xs = [torch.from_numpy(x[:, :32]), torch.from_numpy(x[:, 32:])]
    got = layers.row_parallel(halves, xs, torch.float32)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)
    real = collectives.all_reduce_max
    try:
        collectives.all_reduce_max = lambda parts: list(parts)  # local scales only
        faulty = layers.row_parallel(halves, xs, torch.float32)
    finally:
        collectives.all_reduce_max = real
    assert not torch.equal(faulty[0], want)


# ---- the mesh attention wrappers ----

def _qkv(B=4, H=4, L=16, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, D)).astype(np.float32))
               for _ in range(3))
    mask = torch.ones(B, 1, 1, L, dtype=torch.int32)
    mask[0, ..., L // 2:] = 0
    return q, k, v, mask


@pytest.mark.parametrize("shape", [{"dp": 2}, {"tp": 2}, {"dp": 2, "tp": 2}],
                         ids=["dp2", "tp2", "dp2-tp2"])
def test_mesh_attention_launches_per_shard(shape):
    """``runtime.attention_fn()`` on a dp/tp mesh runs the kernel path once
    per shard with its rows and heads; a batch the mesh cannot split runs
    whole, counted as unsharded."""
    rt = port_runtime(shape)
    attn = rt.attention_fn()
    assert attn.shard(0, 0) is fa.flash_attention
    q, k, v, mask = _qkv()
    before = dict(fa.SELECTION_COUNTS)
    got = attn(q, k, v, mask)
    assert fa.SELECTION_COUNTS["flash"] - before["flash"] == _n(shape)
    torch.testing.assert_close(got, fa.flash_attention(q, k, v, mask), rtol=0, atol=0)
    odd = [t[:3] for t in (q, k, v, mask)]
    torch.testing.assert_close(attn(*odd), fa.flash_attention(*odd), rtol=0, atol=0)
    assert fa.SELECTION_COUNTS["unsharded"] - before["unsharded"] == \
        (1 if shape.get("dp", 1) > 1 else 0)


def test_mesh_trainable_attention_gradients_match():
    rt = port_runtime({"dp": 2, "tp": 2})
    attn = rt.train_attention_fn()
    q, k, v, mask = _qkv(seed=1)
    grads = []
    for fn in (attn, fa.flash_attention_trainable):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves, mask) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_mesh_t5_attention_splits_the_bias_table_over_heads():
    rt = port_runtime({"dp": 2, "tp": 2})
    q, k, v, mask = _qkv(seed=2)
    bias = torch.from_numpy(np.random.default_rng(3).normal(size=(32, 4)).astype(np.float32))
    got = rt.t5_attention_kernel()(q, k, v, mask, bias, bidirectional=True, max_distance=128)
    want = fa.flash_attention_t5(q, k, v, mask, bias, bidirectional=True, max_distance=128)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---- the runtime ----

def test_placement_keys_and_eviction():
    """tp or ep above 1 places split under "tp", else replicated under
    "rep"; eviction covers both."""
    flat = {"w": np.zeros((8, 8), np.float32)}
    specs = {"w": shardings.COL}
    for shape, mode in (({"tp": 2}, "tp"), ({"dp": 2}, "rep"), ({"dp": 2, "ep": 2}, "tp")):
        rt = port_runtime(shape)
        placed = rt.get_params("m", lambda: flat, specs=specs,
                               place=lambda f, s, mesh: (f, s))
        assert placed[1] == ({"w": (None, "tp")} if mode == "tp" else {"w": ()})
        assert rt._params.keys() == [("m", mode)] and rt.describe()["models_resident"] == ["m"]
        rt.evict_params("m")
        assert rt._params.keys() == []


def test_mesh_shape_knob_takes_pp_and_ep(monkeypatch):
    from agent_tpu_torch.config import DeviceConfig

    monkeypatch.setenv("MESH_SHAPE", "dp=2,pp=2,ep")
    cfg = DeviceConfig.from_env()
    assert cfg.mesh_shape == {"dp": 2, "pp": 2, "ep": 1}
    rt = TorchRuntime(devices=["cpu"] * 4, config=cfg)
    assert rt.mesh.shape == {"dp": 2, "tp": 1, "sp": 1, "pp": 2, "ep": 1}
    assert rt.sharded and rt.describe()["mesh"]["pp"] == 2
    assert not TorchRuntime(devices=["cpu"] * 2, mesh_shape={"sp": 2}).sharded


# ---- training on the mesh ----

def _grads_flat(model):
    """The model's gradients in the flat layout (gathered over the shards)."""
    if isinstance(model, encoder.Encoder):
        return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    return chip_smoke.mesh_grads(model)


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
@pytest.mark.parametrize("shape", [{"dp": 2}, {"tp": 2}, {"dp": 2, "tp": 2},
                                   {"dp": 2, "ep": 2}], ids=["dp2", "tp2", "dp2-tp2", "dp2-ep2"])
def test_train_step_on_a_mesh_matches_one_device(shape, moe):
    """One AdamW step of a small f32 model on the mesh: the loss and every
    gradient (summed over dp replicas and over a replicated leaf's copies)
    within 1e-5 relative L2 of the one-device step; the weights gathered
    back are the initial ones bit for bit before the step, and each leaf's
    update is the one-device update within 1e-3 relative L2 (Adam's first
    step is g / |g|, so an element whose gradient is near 0 may move by lr
    either way)."""
    cfg = encoder.EncoderConfig(vocab_size=260, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                                max_len=32, n_classes=6, dtype="float32", moe_experts=moe)
    flat = encoder.init_params(cfg, "train-mesh")
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, 260, (8, 32)).astype(np.int32))
    mask = torch.from_numpy((np.arange(32)[None] < rng.integers(4, 33, (8, 1))).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, 6, 8).astype(np.int32))
    rt = port_runtime(shape)
    results = []
    for model, attn in ((encoder.from_jax_params(flat, cfg, trainable=True),
                         fa.flash_attention_trainable),
                        (encoder.from_jax_params(flat, cfg, trainable=True, mesh=rt.mesh),
                         rt.train_attention_fn())):
        init, step = train.make_train_step(cfg, train.adamw(1e-3), attn_fn=attn)
        opt = init(model)
        before = {k: v.copy() for k, v in model.to_flat_numpy().items()}
        assert all(np.array_equal(before[k], flat[k]) for k in flat)
        _, _, loss = step(model, opt, ids, mask, labels)
        after = model.to_flat_numpy()
        results.append((float(loss), _grads_flat(model),
                        {k: after[k] - before[k] for k in flat}))
    (l1, g1, w1), (l2, g2, w2) = results
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    assert g1.keys() == g2.keys()
    for k in g1:
        err = np.linalg.norm(g2[k] - g1[k]) / max(np.linalg.norm(g1[k]), 1e-30)
        assert err <= 1e-5, (k, err)
        err = np.linalg.norm(w2[k] - w1[k]) / max(np.linalg.norm(w1[k]), 1e-30)
        assert err <= 1e-3, (k, err)


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
def test_remat_on_a_mesh_equals_no_remat(moe):
    """A sharded encoder recomputes each layer of every shard in the
    backward with ``remat``: the loss and the updated weights are the ones
    without it, bit for bit."""
    cfg = encoder.EncoderConfig(vocab_size=260, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                                max_len=32, n_classes=6, dtype="float32", moe_experts=moe)
    flat = encoder.init_params(cfg, "remat-mesh")
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 260, (8, 32)).astype(np.int32))
    mask = torch.from_numpy((np.arange(32)[None] < rng.integers(4, 33, (8, 1))).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, 6, 8).astype(np.int32))
    rt = port_runtime({"dp": 2, "tp": 2})
    out = []
    for remat in (False, True):
        model = encoder.from_jax_params(flat, cfg, trainable=True, mesh=rt.mesh)
        init, step = train.make_train_step(cfg, train.adamw(1e-3), remat=remat,
                                           attn_fn=rt.train_attention_fn())
        _, _, loss = step(model, init(model), ids, mask, labels)
        out.append((loss.item(), model.to_flat_numpy()))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        np.testing.assert_array_equal(out[0][1][k], out[1][1][k], err_msg=k)
