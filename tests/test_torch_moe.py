"""The port's Switch MoE (``agent_tpu_torch.models.moe``) against the
reference's (``agent_tpu.models.moe``) on the same weights and tokens, in f32
on the CPU: the seeded weights bit for bit, and for the cases of
``tests/test_moe.py`` (high capacity, overflow drops, the residual block,
grouped routing, the aux loss over real tokens only, empty input) the
output, the aux loss and the gradients with respect to x, the router and
the experts within 1e-5. Then the MoE encoder (forward, training loss and
step, ``.npz`` round trip) and quantized experts."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agent_tpu.models import encoder as jax_encoder
from agent_tpu.models import moe as jax_moe
from agent_tpu.models import quant as jax_quant
from agent_tpu.models import train as jax_train
from agent_tpu_torch.models import checkpoint, encoder, layers, moe, prng, quant, train

torch.set_num_threads(1)

TOL = 1e-5
CFG = dict(d_model=16, d_ff=32, n_experts=4, capacity_factor=8.0)


def _tokens(T, seed, d=16):
    return np.random.default_rng(seed).normal(size=(T, d)).astype(np.float32)


def _params(seed, cfg):
    """The reference's weights for ``PRNGKey(seed)`` and the port's for the
    same key, which must be equal."""
    want = jax.tree_util.tree_map(np.asarray, jax_moe.init_moe_ffn(jax.random.PRNGKey(seed),
                                                                    jax_moe.MoeConfig(**cfg)))
    got = moe.init_moe_ffn(prng.PRNGKey(seed), moe.MoeConfig(**cfg))
    return want, got


def _module(params, cfg, trainable=True):
    m = moe.MoeFFN(moe.MoeConfig(**cfg), trainable=trainable)
    m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                       layers.flatten(params).items()})
    return m


def _jax(params, x, cfg, group_size=0):
    """(y, aux, grads of sum(y * r) + aux wrt x and every weight)."""
    r = np.random.default_rng(99).normal(size=x.shape).astype(np.float32)
    c = jax_moe.MoeConfig(**cfg)

    def f(p, x):
        y, aux = jax_moe.moe_ffn(p, x, c, group_size=group_size)
        return (y * r).sum() + aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(y), float(aux), np.asarray(gx), layers.flatten(
        jax.tree_util.tree_map(np.asarray, gp)), r


def _port(m, x, r, group_size=0):
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = m(xt, group_size)
    ((y * torch.from_numpy(r)).sum() + aux).backward()
    grads = {k: p.grad.numpy() for k, p in m.named_parameters()}
    return y.detach().numpy(), float(aux), xt.grad.numpy(), grads


def _assert_matches(params, x, cfg, group_size=0):
    y, aux, gx, gp, r = _jax(params, x, cfg, group_size)
    got_y, got_aux, got_gx, got_gp = _port(_module(params, cfg), x, r, group_size)
    np.testing.assert_allclose(got_y, y, rtol=TOL, atol=TOL)
    assert abs(got_aux - aux) < TOL
    np.testing.assert_allclose(got_gx, gx, rtol=TOL, atol=TOL)
    assert set(got_gp) == set(gp)
    for k in gp:
        np.testing.assert_allclose(got_gp[k], gp[k], rtol=TOL, atol=TOL, err_msg=k)
    return got_y


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_init_moe_ffn_bit_identical(seed):
    want, got = _params(seed, CFG)
    for k, v in layers.flatten(want).items():
        np.testing.assert_array_equal(layers.flatten(got)[k], v, err_msg=k)


@pytest.mark.parametrize("data", [0, 0x40E, 2**31 + 5])
def test_fold_in_matches_jax(data):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(11), data),
                                  np.asarray(jax.random.fold_in(key, data)))


def test_high_capacity_matches_the_reference():
    params, _ = _params(0, CFG)
    _assert_matches(params, _tokens(32, 0), CFG)


def test_overflow_drops_to_zero_as_the_reference():
    cfg = dict(CFG, n_experts=2, capacity_factor=0.01)
    params, _ = _params(1, cfg)
    y = _assert_matches(params, _tokens(64, 1), cfg)
    assert (np.abs(y).sum(axis=1) > 1e-9).sum() <= 2


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25])
def test_partial_drops_match_the_reference(capacity_factor):
    """Capacity below some experts' load: the same tokens drop, in the same
    in-group order, across several groups."""
    cfg = dict(CFG, capacity_factor=capacity_factor)
    params, _ = _params(4, cfg)
    y = _assert_matches(params, _tokens(48, 4), cfg, group_size=16)
    assert (np.abs(y).sum(axis=1) == 0).any()


def test_residual_block_matches_the_reference():
    c = jax_moe.MoeConfig(**CFG)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_moe.init_moe_block(jax.random.PRNGKey(2), c))
    x = np.random.default_rng(2).normal(size=(2, 8, 16)).astype(np.float32)
    want, aux = jax.jit(lambda p, x: jax_moe.moe_block(p, x, c))(params, x)
    block = moe.MoeBlock(moe.MoeConfig(**CFG))
    block.load_state_dict({k: torch.from_numpy(v) for k, v in layers.flatten(params).items()})
    with torch.no_grad():
        got, got_aux = block(torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert abs(float(got_aux) - float(aux)) < TOL


def test_grouped_routing_equals_the_concatenation_of_groups():
    params, _ = _params(5, CFG)
    x = _tokens(56, 5)  # 3 x 16 + 8: a padded tail group
    got = _assert_matches(params, x, CFG, group_size=16)
    m = _module(params, CFG, trainable=False)
    rows = []
    with torch.no_grad():
        for g in range(4):
            chunk = np.zeros((16, 16), np.float32)
            part = x[16 * g:16 * (g + 1)]
            chunk[:len(part)] = part
            rows.append(m(torch.from_numpy(chunk))[0].numpy())
    np.testing.assert_allclose(got, np.concatenate(rows)[:56], rtol=TOL, atol=TOL)


def test_aux_loss_ignores_pad_tokens():
    params, _ = _params(7, CFG)
    x = _tokens(24, 7)
    _assert_matches(params, x, CFG, group_size=16)
    m = _module(params, CFG, trainable=False)
    with torch.no_grad():
        _, aux = m(torch.from_numpy(x), 16)
        _, aux_a = m(torch.from_numpy(x[:16]))
        _, aux_b = m(torch.from_numpy(x[16:]))
    assert abs(float(aux) - (float(aux_a) + float(aux_b)) / 2.0) < 1e-6


def test_empty_input():
    params, _ = _params(8, CFG)
    y, aux = _module(params, CFG)(torch.zeros((0, 16)))
    want_y, want_aux = jax_moe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, params),
                                       jnp.zeros((0, 16)), jax_moe.MoeConfig(**CFG))
    assert tuple(y.shape) == want_y.shape == (0, 16)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("mode", ["int8", "w8a16"])
def test_quantized_experts_match_the_reference(mode):
    """Experts quantized per expert and output channel (the router stays
    f32): output and aux within 1e-5 of the reference's quantized layer."""
    cfg = dict(CFG, capacity_factor=1.25)
    params, _ = _params(9, cfg)
    qparams = jax_quant._quantize_block({"attn": {k: np.zeros((2, 1, 1), np.float32)
                                                  for k in ("wq", "wk", "wv", "wo")},
                                         "moe": params}, mode)["moe"]
    x = _tokens(40, 9)
    want, aux = jax_moe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, qparams), jnp.asarray(x),
                                jax_moe.MoeConfig(**cfg), group_size=16)
    m = moe.MoeFFN(moe.MoeConfig(**cfg))
    for name in ("wi", "wo"):
        quant._swap(m, name, quant.QuantLeaf(mode, tuple(params[name].shape), (1,),
                                             torch.float32))
    m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                       layers.flatten(qparams).items()})
    with torch.no_grad():
        got, got_aux = m(torch.from_numpy(x), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert abs(float(got_aux) - float(aux)) < TOL


# ---- the MoE encoder ----

ENC = dict(vocab_size=260, d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32,
           n_classes=5, dtype="float32", moe_experts=4)


def _batch(B=6, L=16, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 260, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 9:] = 0
    mask[4, 3:] = 0
    return ids, mask, rng.integers(0, 5, B).astype(np.int32)


@pytest.mark.parametrize("experts,factor", [(4, 1.25), (2, 0.5)])
def test_moe_encoder_init_params_bit_identical(experts, factor):
    kw = dict(ENC, moe_experts=experts, moe_capacity_factor=factor)
    want = layers.flatten(jax.tree_util.tree_map(
        np.asarray, jax_encoder.init_params(jax_encoder.EncoderConfig(**kw), "moe-enc")))
    got = encoder.init_params(encoder.EncoderConfig(**kw), "moe-enc")
    assert set(got) == set(want) and any(".moe.router.w" in k for k in got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("quant_mode", ["none", "int8", "w8a16"])
def test_moe_encoder_forward_and_aux_match_the_reference(quant_mode):
    kw = dict(ENC, quant=quant_mode)
    jcfg, cfg = jax_encoder.EncoderConfig(**kw), encoder.EncoderConfig(**kw)
    jp = jax_encoder.init_params(jcfg, "moe-fwd")
    if quant_mode != "none":
        jp = jax_quant.quantize_encoder(jp, quant_mode)
    ids, mask, _ = _batch()
    want, want_aux = jax_encoder.forward(jp, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                         with_aux=True)
    model = encoder.from_jax_params(encoder.init_params(cfg, "moe-fwd"), cfg)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(ids), torch.from_numpy(mask), with_aux=True)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4 * scale)
    assert abs(float(aux) - float(want_aux)) < TOL


def test_moe_training_loss_and_step_match_the_reference():
    """The loss with the Switch aux term (MOE_AUX_WEIGHT 0.01) and three
    AdamW steps' losses within 1e-4, remat on and off."""
    import optax

    jcfg, cfg = jax_encoder.EncoderConfig(**ENC), encoder.EncoderConfig(**ENC)
    ids, mask, labels = _batch()
    jp = jax_encoder.init_params(jcfg, "moe-train")
    j_init, j_step = jax_train.make_train_step(jcfg, optax.adamw(1e-2))
    opt = j_init(jp)
    want = []
    for _ in range(3):
        jp, opt, loss = j_step(jp, opt, jnp.asarray(ids), jnp.asarray(mask),
                               jnp.asarray(labels))
        want.append(float(loss))
    for remat in (False, True):
        model = encoder.from_jax_params(encoder.init_params(cfg, "moe-train"), cfg,
                                        trainable=True)
        init, step = train.make_train_step(cfg, train.adamw(1e-2), remat=remat)
        o = init(model)
        got = []
        for _ in range(3):
            model, o, loss = step(model, o, torch.from_numpy(ids), torch.from_numpy(mask),
                                  torch.from_numpy(labels))
            got.append(float(loss))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_moe_npz_round_trip(tmp_path):
    """A trained MoE module saved as the reference's flat .npz loads back
    into either package with every expert and router leaf."""
    cfg = encoder.EncoderConfig(**ENC)
    model = encoder.from_jax_params(encoder.init_params(cfg, "moe-npz"), cfg, trainable=True)
    with torch.no_grad():
        model.blocks[0].moe.wi.mul_(1.5)
    path = checkpoint.save_npz(model, str(tmp_path / "moe.npz"))
    back = encoder.from_jax_params(encoder.load_npz(path, cfg), cfg, trainable=True)
    assert checkpoint.params_equal(model, back)
    jp = jax_encoder.load_npz(path, jax_encoder.EncoderConfig(**ENC))
    np.testing.assert_array_equal(np.asarray(jp["blocks"][0]["moe"]["wi"]),
                                  model.blocks[0].moe.wi.detach().numpy())


# ---- the ops ----

@pytest.fixture(scope="module")
def contexts():
    from agent_tpu.config import DeviceConfig
    from agent_tpu.runtime.context import OpContext as JaxOpContext
    from agent_tpu.runtime.runtime import TpuRuntime
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    rt = TpuRuntime(config=DeviceConfig(tpu_disabled=True, mesh_shape={"dp": 1}),
                    devices=jax.devices("cpu")[:1])
    return OpContext(runtime=TorchRuntime(device="cpu")), JaxOpContext(runtime=rt)


def _run_both(op, payload, contexts):
    from agent_tpu.ops import get_op as jax_get_op
    from agent_tpu_torch.ops import load_ops

    port_ctx, jax_ctx = contexts
    return load_ops([op])[op](dict(payload), port_ctx), jax_get_op(op)(dict(payload), jax_ctx)


def _topk(out):
    return (np.asarray([[e["index"] for e in r["topk"]] for r in out["results"]]),
            np.asarray([[e["score"] for e in r["topk"]] for r in out["results"]]))


TEXTS = ["mixture of experts", "route every token to one expert", "x", "capacity " * 9]


@pytest.mark.parametrize("quant_mode", ["none", "int8", "w8a16"])
def test_classify_op_serves_moe_as_the_reference(quant_mode, contexts):
    mc = dict(ENC, quant=quant_mode)
    mc.pop("vocab_size")
    got, want = _run_both("map_classify_tpu", {"texts": TEXTS, "topk": 5, "model_config": mc},
                          contexts)
    assert got["ok"] and want["ok"]
    (gi, gs), (wi, ws) = _topk(got), _topk(want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gs, ws, atol=TOL, rtol=0)


def test_train_op_trains_moe_as_the_reference_and_serves_it(contexts, tmp_path):
    """train_classifier with 4 experts: the epoch losses within 1e-4 of the
    reference op's, and the .npz it writes served by map_classify_tpu of
    both packages with the same top-k."""
    texts = [f"row {i} " + ("alpha" if i % 2 else "beta") * (1 + i % 3) for i in range(16)]
    mc = {k: v for k, v in ENC.items() if k != "vocab_size"}
    payload = {"texts": texts, "labels": [i % 2 for i in range(16)], "epochs": 3,
               "batch_size": 4, "learning_rate": 1e-2, "model_config": mc}
    from agent_tpu.ops import get_op as jax_get_op
    from agent_tpu_torch.ops import load_ops

    port_ctx, jax_ctx = contexts
    got = load_ops(["train_classifier"])["train_classifier"](
        dict(payload, output_path=str(tmp_path / "port.npz")), port_ctx)
    want = jax_get_op("train_classifier")(
        dict(payload, output_path=str(tmp_path / "jax.npz")), jax_ctx)
    assert got["ok"] and want["ok"]
    assert got["model_config"] == want["model_config"]
    np.testing.assert_allclose([got["first_epoch_loss"], got["last_epoch_loss"]],
                               [want["first_epoch_loss"], want["last_epoch_loss"]],
                               rtol=1e-4, atol=1e-4)
    assert got["last_epoch_loss"] != got["first_epoch_loss"]
    serve = {"texts": TEXTS, "topk": 2, "model_path": got["output_path"],
             "model_config": got["model_config"]}
    g, w = _run_both("map_classify_tpu", serve, contexts)
    np.testing.assert_array_equal(_topk(g)[0], _topk(w)[0])
    np.testing.assert_allclose(_topk(g)[1], _topk(w)[1], atol=TOL, rtol=0)


# ---- experts over ep ----

@pytest.mark.parametrize("quant_mode", ["none", "int8", "w8a16"])
@pytest.mark.parametrize("shape", [{"ep": 2}, {"dp": 2, "ep": 4}], ids=["ep2", "dp2-ep4"])
def test_classify_on_an_ep_mesh_matches_the_reference_on_it(shape, quant_mode):
    """Experts split over ep (the router replicated, routing decided before
    dispatch) against the reference's op on the same mesh of virtual
    devices and against the port's one-device run. The texts' token count
    is under one routing group per dp replica, so the replicas route
    together, as on one device."""
    from agent_tpu.config import DeviceConfig
    from agent_tpu.ops import get_op as jax_get_op
    from agent_tpu.runtime.context import OpContext as JaxOpContext
    from agent_tpu.runtime.runtime import TpuRuntime
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.runtime.context import OpContext
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    n = int(np.prod(list(shape.values())))
    mc = {k: v for k, v in dict(ENC, quant=quant_mode).items() if k != "vocab_size"}
    payload = {"texts": TEXTS, "topk": 5, "model_config": mc}
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    rt = TorchRuntime(devices=["cpu"] * n, mesh_shape=shape)
    got = classify(dict(payload), OpContext(runtime=rt))
    jrt = TpuRuntime(config=DeviceConfig(tpu_disabled=True, mesh_shape=shape),
                     devices=jax.devices("cpu")[:n])
    want = jax_get_op("map_classify_tpu")(dict(payload), JaxOpContext(runtime=jrt))
    one = classify(dict(payload), OpContext(runtime=TorchRuntime(device="cpu")))
    model = next(iter(rt._params._cache.values()))
    experts = model.experts(0, 0)
    assert len(experts) == shape["ep"] and experts[1].wi is not experts[0].wi
    table = experts[1].wi.p[quant.TABLE_KEY[quant_mode]] if quant_mode != "none" \
        else experts[1].wi
    assert table.shape[0] == ENC["moe_experts"] // shape["ep"]
    for other, tol in ((want, TOL), (one, 1e-5)):
        (gi, gs), (wi, ws) = _topk(got), _topk(other)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gs, ws, atol=tol, rtol=0)


def test_routing_groups_that_align_with_dp_route_per_replica(monkeypatch):
    """With 512-token groups inside each dp replica's rows, each replica
    routes its own tokens (no gather), and the logits and aux loss equal the
    one-device forward's."""
    from agent_tpu_torch.runtime.mesh import build_mesh

    cfg = encoder.EncoderConfig(**{k: v for k, v in ENC.items()})
    flat = encoder.init_params(cfg, "ep-groups")
    rng = np.random.default_rng(6)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (32, 32)).astype(np.int32))
    mask = torch.ones(32, 32, dtype=torch.int32)
    want, want_aux = encoder.from_jax_params(flat, cfg)(ids, mask, with_aux=True)
    sharded = encoder.from_jax_params(flat, cfg, mesh=build_mesh(["cpu"] * 4,
                                                                 {"dp": 2, "ep": 2}))
    sizes = []
    real = moe.MoeFFN.dispatch
    monkeypatch.setattr(moe.MoeFFN, "dispatch",
                        lambda self, x, g, e: sizes.append(x.shape[0]) or real(self, x, g, e))
    got, aux = sharded(ids, mask, with_aux=True)
    assert sizes == [512, 512] * cfg.n_layers
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(aux, want_aux, rtol=0, atol=1e-6)
