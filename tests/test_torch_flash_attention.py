"""The plain version of the CUDA flash kernel must agree with the Pallas
kernel (interpret mode) and with dense attention, and the wrapper must route
CPU tensors to it. The CUDA kernel itself is checked on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from agent_tpu.kernels.flash_attention import flash_attention as pallas_flash
from agent_tpu.models import layers as jax_layers
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import layers
from agent_tpu_torch.ops import _model_common
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

F32_TOL = 2e-5   # tests/test_flash_attention.py:30
BF16_TOL = 2e-2  # tests/test_flash_attention.py:94


def _qkvm(B=2, H=2, Lq=16, Lk=16, D=32, pad_tail=0, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    mask = np.ones((B, Lk), dtype=np.int32)
    if pad_tail:
        mask[:, -pad_tail:] = 0
    return q, k, v, mask[:, None, None, :]


def _both(q, k, v, mask, *, dtype, block, plain_block):
    """(port plain, Pallas interpret, JAX dense), all as f32 numpy."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    jm = jnp.asarray(mask)
    pallas = pallas_flash(jq, jk, jv, jm, block_q=block, block_k=block,
                          min_key_len=0, interpret=True)
    dense = jax_layers.dot_product_attention(jq, jk, jv, jm)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    got = fa.flash_attention_reference(tq, tk, tv, torch.from_numpy(mask),
                                       block_k=plain_block)
    assert got.dtype == dtype and got.shape == tq.shape
    return (got.float().numpy(), np.asarray(pallas).astype(np.float32),
            np.asarray(dense).astype(np.float32))


CASES = {
    "single_tile": dict(shape=dict(pad_tail=3), block=512, plain_block=64),
    "multi_tile_streaming": dict(shape=dict(Lq=32, Lk=48, pad_tail=5, seed=1),
                                 block=16, plain_block=16),
    # The plain version's last key tile is partial (48 = 32 + 16).
    "ragged_key_tiles": dict(shape=dict(Lq=20, Lk=48, pad_tail=7, seed=5),
                             block=512, plain_block=32),
    "d_head_64": dict(shape=dict(D=64, Lk=24, pad_tail=2, seed=6), block=512,
                      plain_block=64),
    # The CUDA kernel's 128-row block boundaries: Lq 257 (a third block of
    # one row) against Lk 129 (a third 64-key tile of one key), and one
    # query row. The reference's Pallas kernel takes both as one tile.
    "lq257_lk129": dict(shape=dict(Lq=257, Lk=129, pad_tail=29, seed=11), block=512,
                        plain_block=64),
    "lq1": dict(shape=dict(Lq=1, Lk=77, pad_tail=72, seed=12), block=512, plain_block=64),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_matches_pallas_and_dense(case, dtype):
    spec = CASES[case]
    q, k, v, mask = _qkvm(**spec["shape"])
    got, pallas, dense = _both(q, k, v, mask, dtype=dtype, block=spec["block"],
                               plain_block=spec["plain_block"])
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, dense, rtol=tol, atol=tol)


def test_broadcast_mask_and_cross_lengths():
    q, k, v, _ = _qkvm(Lq=16, Lk=32, seed=2)
    shared = np.ones((1, 1, 1, 32), dtype=np.int32)
    shared[..., -7:] = 0
    got, pallas, dense = _both(q, k, v, shared, dtype=torch.float32, block=16,
                               plain_block=16)
    np.testing.assert_allclose(got, pallas, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, dense, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fully_masked_row_is_zero_not_nan(dtype):
    q, k, v, mask = _qkvm(Lk=40, seed=3)
    mask = mask.copy()
    mask[1] = 0
    got, pallas, _ = _both(q, k, v, mask, dtype=dtype, block=512, plain_block=16)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)


def test_plain_matches_port_dense():
    q, k, v, mask = _qkvm(Lq=24, Lk=40, pad_tail=9, seed=8)
    t = [torch.from_numpy(x) for x in (q, k, v, mask)]
    np.testing.assert_allclose(fa.flash_attention_reference(*t).numpy(),
                               layers.dot_product_attention(*t).numpy(),
                               rtol=F32_TOL, atol=F32_TOL)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    q, k, v, mask = (torch.from_numpy(x) for x in _qkvm(pad_tail=4, seed=9))
    sel, launches = dict(fa.SELECTION_COUNTS), dict(fa.LAUNCH_COUNTS)
    got = fa.flash_attention(q, k, v, mask)
    torch.testing.assert_close(got, fa.flash_attention_reference(q, k, v, mask),
                               rtol=0, atol=0)
    assert fa.SELECTION_COUNTS["flash"] == sel["flash"] + 1
    assert fa.SELECTION_COUNTS["dense"] == sel["dense"]
    assert fa.LAUNCH_COUNTS == launches  # the CPU never launches the kernel


@pytest.mark.parametrize("why", ["causal_mask", "d_head_16", "float64"])
def test_wrapper_sends_unsupported_shapes_to_dense(why):
    q, k, v, mask = (torch.from_numpy(x) for x in _qkvm(seed=10))
    if why == "causal_mask":
        mask = torch.tril(torch.ones(16, 16, dtype=torch.int32))[None, None]
    elif why == "d_head_16":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
    else:
        q, k, v = q.double(), k.double(), v.double()
    before = fa.SELECTION_COUNTS["dense"]
    got = fa.flash_attention(q, k, v, mask)
    assert fa.SELECTION_COUNTS["dense"] == before + 1
    torch.testing.assert_close(got, layers.dot_product_attention(q, k, v, mask),
                               rtol=0, atol=0)


def test_kernel_launcher_raises_on_cpu_tensors():
    q, k, v, mask = (torch.from_numpy(x) for x in _qkvm())
    with pytest.raises(ValueError, match="CUDA device"):
        fa._launch(q, k, v, mask)


def test_runtime_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchRuntime()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchRuntime(device="cuda")
    rt = TorchRuntime(device="cpu")
    assert rt.platform == "cpu" and rt.attention_fn() is fa.flash_attention


def test_selects_flash_and_dispatch_split():
    assert fa.selects_flash(512, 64, torch.bfloat16)
    assert fa.selects_flash(7, 128, torch.float32)
    assert not fa.selects_flash(512, 16, torch.bfloat16)
    assert not fa.selects_flash(512, 64, torch.float64)
    ids = np.zeros((64, 4096), dtype=np.uint8)
    lengths = np.full(64, 4000, dtype=np.int32)
    whole = _model_common.split_padded_chunk(ids, lengths, 50, 1, 64, torch.bfloat16)
    assert len(whole) == 1 and whole[0][2] == 50
    # A dense-path chunk (d_head 16) splits into budget-sized batch buckets.
    parts = _model_common.split_padded_chunk(ids, lengths, 50, 1, 16, torch.bfloat16)
    assert [p[0].shape[0] for p in parts] == [32, 32]
    assert [p[2] for p in parts] == [32, 18]
