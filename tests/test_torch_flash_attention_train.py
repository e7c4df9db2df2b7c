"""The plain versions of the training kernels (forward with lse, dQ, dK/dV)
must agree with the Pallas kernels they replace, run in interpret mode:
(o, lse) with ``_flash_fwd_res`` and the gradients of the port's
``flash_attention_trainable`` (autograd through its Function on the CPU)
with ``jax.vjp`` of the reference's ``flash_attention_trainable``. The
CUDA kernels themselves are checked on the card by chip_smoke.py.

Tolerances are the reference's own (tests/test_flash_attention.py:30 and
:94): f32 2e-5, since both sides compute in f32 and differ only in
summation order; bf16 2e-2, since both round p and ds to bf16 at the same
places but a value within an ulp of a rounding boundary may round either
way after a differently ordered f32 sum."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agent_tpu.kernels.flash_attention import _flash_fwd_res
from agent_tpu.kernels.flash_attention import flash_attention_trainable as jax_trainable
from agent_tpu.models import layers as jax_layers
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import layers
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(B, H, Lq, Lk, D, lengths, seed):
    """q, k, v, the output cotangent g (f32 numpy) and an int32 key-padding
    mask [len(lengths), 1, 1, Lk] (one length = a mask the batch shares)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    g = rng.normal(size=(B, H, Lq, D)).astype(np.float32)
    mask = (np.arange(Lk)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return q, k, v, g, mask[:, None, None, :]


def _jax_grads(q, k, v, g, mask, dtype, block):
    """(o, dq, dk, dv) from the reference's trainable kernel, as f32 numpy."""
    jd = JAX_DTYPE[dtype]
    jq, jk, jv, jg = (jnp.asarray(x).astype(jd) for x in (q, k, v, g))
    fn = lambda a, b, c: jax_trainable(  # noqa: E731
        a, b, c, jnp.asarray(mask), block_q=block, block_k=block, min_key_len=0,
        interpret=True)
    o, vjp = jax.vjp(fn, jq, jk, jv)
    return [np.asarray(x).astype(np.float32) for x in (o, *vjp(jg))]


def _port_grads(q, k, v, g, mask, dtype, attn=fa.flash_attention_trainable):
    """(o, dq, dk, dv) from the port, autograd on the CPU, as f32 numpy."""
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    o = attn(tq, tk, tv, torch.from_numpy(mask))
    o.backward(torch.from_numpy(g).to(dtype))
    assert o.dtype == dtype and all(t.grad.dtype == dtype for t in (tq, tk, tv))
    return [x.detach().float().numpy() for x in (o, tq.grad, tk.grad, tv.grad)]


# name: (B, H, Lq, Lk, D), key lengths, the reference's tile (Lq and Lk
# must divide by it there; the port's plain versions always use 64 keys).
CASES = {
    "multi_tile_ragged_mask": ((2, 2, 128, 128, 32), [128, 77], 64),
    "shared_mask": ((2, 2, 64, 64, 64), [41], 64),
    "lq_ne_lk": ((2, 2, 64, 192, 64), [192, 100], 64),
    "partial_last_tile": ((2, 2, 48, 80, 32), [80, 33], 16),
    "d_head_128": ((1, 2, 64, 128, 128), [128], 64),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_pallas(case, dtype):
    shape, lengths, block = CASES[case]
    q, k, v, g, mask = _inputs(*shape, lengths, seed=len(case))
    got = _port_grads(q, k, v, g, mask, dtype)
    want = _jax_grads(q, k, v, g, mask, dtype, block)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=TOL[dtype], atol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fwd_lse_matches_pallas(dtype):
    q, k, v, _, mask = _inputs(2, 2, 64, 128, 64, [128, 50], seed=3)
    jd = JAX_DTYPE[dtype]
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    mask3d = jnp.asarray(mask[:, 0])  # [B, 1, Lk]
    o_w, lse_w = _flash_fwd_res(jq, jk, jv, mask3d, block_q=64, block_k=64,
                                interpret=True, scale=1.0 / np.sqrt(64))
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    o, lse = fa.flash_attention_fwd_lse_reference(tq, tk, tv, fa.key_keep(torch.from_numpy(mask)))
    assert lse.dtype == torch.float32 and lse.shape == (2, 2, 64, 1)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_w).astype(np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    # lse is f32 on both sides, from exact products of the inputs.
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_w), rtol=2e-5, atol=2e-5)
    # The forward is row 1's plain version, plus the lse.
    torch.testing.assert_close(o, fa.flash_attention_reference(tq, tk, tv, torch.from_numpy(mask)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row_without_keys_has_zero_finite_grads(dtype):
    """The reference's documented caveat (:848-851): from its training gate
    on (512 keys, where it runs its kernel), a batch row whose mask keeps no
    key gets zero (o, dq, dk, dv), finite, not the dense path's."""
    q, k, v, g, mask = _inputs(3, 2, 64, 512, 32, [512, 0, 200], seed=4)
    o, dq, dk, dv = _port_grads(q, k, v, g, mask, dtype)
    for x in (o, dq, dk, dv):
        assert np.isfinite(x).all()
        np.testing.assert_array_equal(x[1], np.zeros_like(x[1]))
    want = _jax_grads(q, k, v, g, mask, dtype, 64)
    for a, b in zip((o, dq, dk, dv), want):
        np.testing.assert_allclose(a, b, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_row_without_keys_below_512_gets_the_dense_path_and_its_grads(dtype):
    """Below the training gate the reference attends densely: a row with no
    real key gets the mean of V, dV the uniform softmax's share of dO, and
    dq, dk 0. The other rows keep the kernel's answer."""
    q, k, v, g, mask = _inputs(3, 2, 48, 48, 32, [48, 0, 20], seed=4)
    got = _port_grads(q, k, v, g, mask, dtype)
    kernel = _jax_grads(q, k, v, g, mask, dtype, 16)
    jd = JAX_DTYPE[dtype]
    jq, jk, jv, jg = (jnp.asarray(x).astype(jd) for x in (q, k, v, g))
    o, vjp = jax.vjp(lambda a, b, c: jax_layers.dot_product_attention(
        a, b, c, jnp.asarray(mask)), jq, jk, jv)
    dense = [np.asarray(x).astype(np.float32) for x in (o, *vjp(jg))]
    for name, a, kern, dns in zip(("o", "dq", "dk", "dv"), got, kernel, dense):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a[1], dns[1], rtol=TOL[dtype], atol=TOL[dtype],
                                   err_msg=name)
        np.testing.assert_allclose(a[[0, 2]], kern[[0, 2]], rtol=TOL[dtype],
                                   atol=TOL[dtype], err_msg=name)
    assert np.abs(got[3][1]).max() > 0 and not got[1][1].any() and not got[2][1].any()


def test_masked_keys_get_zero_dk_dv():
    q, k, v, g, mask = _inputs(2, 2, 32, 96, 64, [96, 70], seed=5)
    _, _, dk, dv = _port_grads(q, k, v, g, mask, torch.float32)
    assert not dk[1, :, 70:].any() and not dv[1, :, 70:].any()
    assert np.abs(dk[1, :, :70]).max() > 0 and np.abs(dv[1, :, :70]).max() > 0


def test_grads_match_dense_autograd():
    """With a real key in every row, the recompute backward equals autograd
    through the port's dense attention (f32; the reference's 2e-4 for this
    comparison, tests/test_flash_attention.py:194, since dense and flash
    round the softmax differently)."""
    q, k, v, g, mask = _inputs(2, 3, 40, 72, 32, [72, 9], seed=6)
    flash = _port_grads(q, k, v, g, mask, torch.float32)
    dense = _port_grads(q, k, v, g, mask, torch.float32, layers.dot_product_attention)
    for a, b in zip(flash, dense):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_plain_trainable_reference_is_the_cpu_path():
    q, k, v, g, mask = _inputs(1, 2, 16, 16, 32, [11], seed=7)
    a = _port_grads(q, k, v, g, mask, torch.float32)
    b = _port_grads(q, k, v, g, mask, torch.float32, fa.flash_attention_trainable_reference)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_selection_counts_and_no_launch_on_cpu():
    q, k, v, g, mask = _inputs(1, 2, 16, 16, 32, [16], seed=8)
    sel, launches = dict(fa.SELECTION_COUNTS), dict(fa.LAUNCH_COUNTS)
    _port_grads(q, k, v, g, mask, torch.float32)
    assert fa.SELECTION_COUNTS["flash_train"] == sel["flash_train"] + 1
    assert fa.SELECTION_COUNTS["dense_train"] == sel["dense_train"]
    assert fa.LAUNCH_COUNTS == launches  # the CPU never launches a kernel


@pytest.mark.parametrize("why", ["causal_mask", "d_head_16"])
def test_unsupported_shapes_fall_back_to_dense(why):
    """A mask with a query axis (not key padding) or an unsupported d_head
    takes dense attention, differentiated by autograd, as the reference's
    off-contract fallback does (tests/test_flash_attention.py:227-236)."""
    q, k, v, g, mask = _inputs(2, 2, 16, 16, 32, [16, 16], seed=9)
    if why == "causal_mask":
        mask = np.tril(np.ones((16, 16), dtype=np.int32))[None, None]
    else:
        q, k, v, g = q[..., :16], k[..., :16], v[..., :16], g[..., :16]
    before = dict(fa.SELECTION_COUNTS)
    got = _port_grads(q, k, v, g, mask, torch.float32)
    assert fa.SELECTION_COUNTS["dense_train"] == before["dense_train"] + 1
    assert fa.SELECTION_COUNTS["flash_train"] == before["flash_train"]
    want = _port_grads(q, k, v, g, mask, torch.float32, layers.dot_product_attention)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: jax_layers.dot_product_attention(a, b, c, jnp.asarray(mask)),
                     jq, jk, jv)
    for a, b, c in zip(got[1:], want[1:], vjp(jg)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, np.asarray(c), rtol=2e-5, atol=2e-5)


def test_train_launchers_raise_on_cpu_tensors():
    q, k, v, g, mask = (torch.from_numpy(x) for x in _inputs(1, 2, 16, 16, 32, [16], seed=10))
    keep = fa.key_keep(mask)
    lse = torch.zeros(1, 2, 16, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        fa._launch_fwd_lse(q, k, v, keep)
    with pytest.raises(ValueError, match="CUDA device"):
        fa._launch_bwd_dq(q, k, v, keep, g, q, lse)
    with pytest.raises(ValueError, match="CUDA device"):
        fa._launch_bwd_dkv(q, k, v, keep, g, lse, lse)


def test_runtime_train_attention_fn():
    assert TorchRuntime(device="cpu").train_attention_fn() is fa.flash_attention_trainable


def test_cuda_backward_takes_delta_from_the_dq_kernel(monkeypatch):
    """The CUDA path of the trainable attention computes no delta in
    PyTorch: the dQ launcher gets the forward's O and returns delta, which
    goes to the dK/dV launcher as it is. The launchers are replaced by
    stand-ins that return the plain backward's gradients (computed first,
    the only call of attention_delta) on CPU tensors."""
    q, k, v, g, mask = (torch.from_numpy(x) for x in _inputs(2, 2, 20, 24, 32, [24, 9], seed=11))
    keep = fa.key_keep(mask)
    o, lse = fa.flash_attention_fwd_lse_reference(q, k, v, keep)
    want = fa.flash_attention_bwd_reference(q, k, v, keep, o, lse, g)
    delta = torch.full((2, 2, 20, 1), 7.0)
    calls = {"attention_delta": 0, "dq": 0, "dkv": 0}

    def counted_delta(*args):
        calls["attention_delta"] += 1
        return fa.attention_delta.__wrapped__(*args)

    def dq(q_, k_, v_, keep_, do, o_, lse_):
        calls["dq"] += 1
        assert torch.equal(o_, o) and torch.equal(lse_, lse) and torch.equal(do, g)
        return want[0], delta

    def dkv(q_, k_, v_, keep_, do, lse_, delta_):
        calls["dkv"] += 1
        assert delta_ is delta
        return want[1], want[2]

    counted_delta.__wrapped__ = fa.attention_delta
    monkeypatch.setattr(fa, "attention_delta", counted_delta)
    monkeypatch.setattr(fa, "_launch_fwd_lse", lambda q_, k_, v_, keep_: (o, lse))
    monkeypatch.setattr(fa, "_launch_bwd_dq", dq)
    monkeypatch.setattr(fa, "_launch_bwd_dkv", dkv)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    fa.FlashAttentionTrainable.apply(tq, tk, tv, mask, False).backward(g)
    assert calls == {"attention_delta": 0, "dq": 1, "dkv": 1}
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.equal(got, w)


def test_attention_delta_runs_only_in_the_plain_backward():
    """At the source: the module calls attention_delta in the plain
    backward and nowhere else."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(fa))
    callers = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.ClassDef)):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and getattr(node.func, "id", None) == \
                        "attention_delta":
                    callers.add(fn.name)
    assert callers == {"flash_attention_bwd_reference"}


def _bwd_args():
    q, k, v, g, mask = (torch.from_numpy(x) for x in _inputs(2, 2, 20, 24, 64, [24, 9], seed=12))
    keep = fa.key_keep(mask)
    lse = torch.zeros(2, 2, 20, 1)
    return q, k, v, keep, g, torch.zeros_like(q), lse


def _strided(x):
    return x.transpose(2, 3).contiguous().transpose(2, 3)


@pytest.mark.parametrize("why,match", [
    ("dq_q_non_contiguous", "contiguous"), ("dq_o_non_contiguous", "contiguous"),
    ("dkv_do_non_contiguous", "contiguous"), ("dq_lse_bf16", "float32"),
    ("dkv_lse_bf16", "float32"), ("dkv_delta_bf16", "float32"), ("dq_o_other_dtype", "dtypes"),
    ("dq_o_shape", "is not"), ("dkv_delta_shape", "is not"), ("dq_cpu", "CUDA device"),
    ("dkv_cpu", "CUDA device"),
])
def test_bwd_launchers_refuse(why, match):
    """Each argument check of the backward launchers raises ValueError on
    its own (the device check comes last, so CPU tensors reach the others)."""
    q, k, v, keep, g, o, lse = _bwd_args()
    delta = torch.zeros_like(lse)
    calls = {
        "dq_q_non_contiguous": lambda: fa._launch_bwd_dq(_strided(q), k, v, keep, g, o, lse),
        "dq_o_non_contiguous": lambda: fa._launch_bwd_dq(q, k, v, keep, g, _strided(o), lse),
        "dkv_do_non_contiguous": lambda: fa._launch_bwd_dkv(q, k, v, keep, _strided(g), lse,
                                                            delta),
        "dq_lse_bf16": lambda: fa._launch_bwd_dq(q, k, v, keep, g, o, lse.bfloat16()),
        "dkv_lse_bf16": lambda: fa._launch_bwd_dkv(q, k, v, keep, g, lse.bfloat16(), delta),
        "dkv_delta_bf16": lambda: fa._launch_bwd_dkv(q, k, v, keep, g, lse, delta.bfloat16()),
        "dq_o_other_dtype": lambda: fa._launch_bwd_dq(q, k, v, keep, g, o.bfloat16(), lse),
        "dq_o_shape": lambda: fa._launch_bwd_dq(q, k, v, keep, g, o[:, :, :-1], lse),
        "dkv_delta_shape": lambda: fa._launch_bwd_dkv(q, k, v, keep, g, lse, delta[:, :1]),
        "dq_cpu": lambda: fa._launch_bwd_dq(q, k, v, keep, g, o, lse),
        "dkv_cpu": lambda: fa._launch_bwd_dkv(q, k, v, keep, g, lse, delta),
    }
    with pytest.raises(ValueError, match=match):
        calls[why]()
