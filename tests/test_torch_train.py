"""The port's training step must be the reference's: the same loss, the
same gradients and the same parameters after 1 and 3 AdamW steps as
``agent_tpu.models.train`` with ``optax.adamw``, on a tiny f32 encoder
(d_head 32, so attention takes the flash path: the reference's Pallas
trainable kernel in interpret mode, the port's Function through its plain
versions).

Tolerances, all f32: the loss to 1e-5 relative and gradients to 1e-4
relative plus 1e-6 absolute, since two layers computed in another
summation order differ by a few f32 ulps; parameters after AdamW to 2e-6
absolute, since a step moves each parameter by lr·m̂/(√v̂ + eps), a ratio
that f32 noise in the gradient changes only in its last bits (lr 1e-3)."""

import functools
import inspect

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from agent_tpu.kernels.flash_attention import flash_attention_trainable as jax_trainable
from agent_tpu.models import encoder as jax_encoder
from agent_tpu.models import train as jax_train
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import encoder, layers, train

torch.set_num_threads(1)

CFG = dict(vocab_size=260, d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=32,
           n_classes=5, dtype="float32")
LR = 1e-3
JAX_ATTN = functools.partial(jax_trainable, min_key_len=0, interpret=True,
                             block_q=64, block_k=64)


def _batch(seed, B=4, L=32):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    ids = (rng.integers(4, 260, size=(B, L)) * mask).astype(np.int32)
    labels = rng.integers(0, CFG["n_classes"], size=B).astype(np.int32)
    return ids, mask, labels


@pytest.fixture(scope="module")
def jax_params():
    return jax_encoder.init_params(jax_encoder.EncoderConfig(**CFG), "train-parity")


def _model(jax_params) -> encoder.Encoder:
    flat = layers.flatten(jax.tree_util.tree_map(np.asarray, jax_params))
    return encoder.from_jax_params(flat, encoder.EncoderConfig(**CFG), trainable=True)


def _flat(tree):
    return layers.flatten(jax.tree_util.tree_map(np.asarray, tree))


def test_trainable_form_is_f32_with_grads_and_pos_trained(jax_params):
    model = _model(jax_params)
    params = dict(model.named_parameters())
    assert set(params) == set(_flat(jax_params))  # pos is a trained leaf too
    assert all(p.dtype == torch.float32 and p.requires_grad for p in params.values())
    serving = encoder.from_jax_params(_flat(jax_params), encoder.EncoderConfig(
        **dict(CFG, dtype="bfloat16")))
    assert not any(p.requires_grad for p in serving.parameters())
    assert "pos" not in dict(serving.named_parameters())
    assert serving.blocks[0].attn.wq.dtype == torch.bfloat16


def test_to_flat_numpy_inverts_from_jax_params(jax_params):
    flat = _flat(jax_params)
    got = _model(jax_params).to_flat_numpy()
    assert got.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(got[k], flat[k])


def test_loss_and_grads_match_jax(jax_params):
    ids, mask, labels = _batch(0)
    cfg_j = jax_encoder.EncoderConfig(**CFG)
    loss_j, grads_j = jax.value_and_grad(jax_train.cross_entropy_loss)(
        jax_params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels), cfg_j,
        False, JAX_ATTN)
    model = _model(jax_params)
    loss = train.cross_entropy_loss(model, torch.from_numpy(ids), torch.from_numpy(mask),
                                    torch.from_numpy(labels), attn_fn=fa.flash_attention_trainable)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = _flat(grads_j)
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_params_after_1_and_3_steps_match_optax(jax_params):
    cfg_j = jax_encoder.EncoderConfig(**CFG)
    init_j, step_j = jax_train.make_train_step(cfg_j, optax.adamw(LR), attn_fn=JAX_ATTN)
    params_j = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jax_params)
    opt_j = init_j(params_j)

    model = _model(jax_params)
    init, step = train.make_train_step(encoder.EncoderConfig(**CFG), train.adamw(LR),
                                       attn_fn=fa.flash_attention_trainable)
    opt = init(model)
    for i in range(3):
        ids, mask, labels = _batch(10 + i)
        params_j, opt_j, loss_j = step_j(params_j, opt_j, ids, mask, labels)
        model, opt, loss = step(model, opt, *(torch.from_numpy(x) for x in (ids, mask, labels)))
        np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
        if i in (0, 2):
            want, got = _flat(params_j), model.to_flat_numpy()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-6,
                                           err_msg=f"step {i + 1}: {k}")


def test_weight_decay_is_optax_default():
    """optax.adamw's defaults, not torch's weight decay of 1e-2."""
    defaults = inspect.signature(optax.adamw).parameters
    opt = train.adamw(LR)([torch.nn.Parameter(torch.zeros(2))])
    group = opt.param_groups[0]
    assert group["weight_decay"] == defaults["weight_decay"].default == 1e-4
    assert group["betas"] == (defaults["b1"].default, defaults["b2"].default)
    assert group["eps"] == defaults["eps"].default
    assert group["lr"] == LR


def test_decay_reaches_every_leaf(jax_params):
    """optax.adamw masks no leaf: with a zero gradient a parameter still
    decays by lr·wd·p (Adam's own update is 0/(0 + eps) = 0)."""
    model = _model(jax_params)
    opt = train.adamw(LR)(model.parameters())
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), before[k] * (1 - LR * 1e-4), rtol=1e-7,
                                   atol=0, msg=k)


def test_remat_equals_no_remat(jax_params):
    """Recomputing blocks in the backward changes memory, not numbers."""
    ids, mask, labels = (torch.from_numpy(x) for x in _batch(5))
    out = []
    for remat in (False, True):
        model = _model(jax_params)
        init, step = train.make_train_step(encoder.EncoderConfig(**CFG), train.adamw(LR),
                                           remat=remat, attn_fn=fa.flash_attention_trainable)
        _, _, loss = step(model, init(model), ids, mask, labels)
        out.append((loss.item(), model.to_flat_numpy()))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        np.testing.assert_array_equal(out[0][1][k], out[1][1][k], err_msg=k)


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode])
def test_step_trains_without_grad_mode(jax_params, mode):
    """A caller inside no_grad or inference_mode (as the classify op runs)
    still gets a training step."""
    ids, mask, labels = (torch.from_numpy(x) for x in _batch(6))
    model = _model(jax_params)
    before = model.head.w.detach().clone()
    init, step = train.make_train_step(encoder.EncoderConfig(**CFG), train.adamw(LR))
    opt = init(model)
    with mode():
        _, _, loss = step(model, opt, ids, mask, labels)
    assert torch.isfinite(loss) and not torch.equal(model.head.w.detach(), before)


def test_moe_training_not_ported():
    """MoE training was refused until the port had models/moe.py: now a
    step of an MoE model adds MOE_AUX_WEIGHT times the Switch aux loss to
    the cross entropy (tests/test_torch_moe.py holds it to the reference)."""
    cfg = encoder.EncoderConfig(**dict(CFG, moe_experts=4))
    ids, mask, labels = (torch.from_numpy(x) for x in _batch(6))
    model = encoder.from_jax_params(encoder.init_params(cfg, "moe-step"), cfg, trainable=True)
    with torch.no_grad():
        logits, aux = model(ids, mask, with_aux=True)
        nll = torch.nn.functional.cross_entropy(logits, labels.long())
        loss = train.cross_entropy_loss(model, ids, mask, labels)
    assert float(aux) > 0
    torch.testing.assert_close(loss, nll + train.MOE_AUX_WEIGHT * aux)
    init, step = train.make_train_step(cfg, train.adamw(LR))
    _, _, stepped = step(model, init(model), ids, mask, labels)
    torch.testing.assert_close(stepped, loss)
