"""T5's bucketed relative-position bias and the plain version of the CUDA T5
kernel must agree with the JAX package: the buckets exactly, the kernel's
plain version with the Pallas kernel (interpret mode) and with the dense
bias path. The CUDA kernel itself is checked on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from agent_tpu.kernels.flash_attention import flash_attention_t5 as pallas_t5
from agent_tpu.models import t5 as jax_t5
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import t5
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

F32_TOL = 2e-5   # tests/test_flash_attention.py:30
BF16_TOL = 2e-2  # tests/test_flash_attention.py:94
BUCKETS = [(32, 128), (32, 256)]  # (num_buckets, max_distance)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidir", "causal"])
@pytest.mark.parametrize("nb,maxd", BUCKETS)
def test_bucket_function_equals_jax_exactly(nb, maxd, bidirectional):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    want = np.asarray(jax_t5.relative_position_bucket(jnp.asarray(rel), bidirectional, nb, maxd))
    got = t5.relative_position_bucket(torch.from_numpy(rel), bidirectional, nb, maxd).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidir", "causal"])
@pytest.mark.parametrize("nb,maxd", BUCKETS)
def test_distance_table_equals_gathered_position_bias(nb, maxd, bidirectional):
    """The kernel's per-distance table, looked up at clamp(k - q), is the
    reference's dense ``_position_bias`` at every (q, k), including
    distances past max_distance (the bucket saturates)."""
    H, L = 3, 2 * maxd + 40
    rel_bias = np.random.default_rng(nb + maxd).normal(size=(nb, H)).astype(np.float32)
    cfg = jax_t5.T5Config(n_heads=H, rel_buckets=nb, rel_max_distance=maxd)
    pos = jnp.arange(L, dtype=jnp.int32)
    want = np.asarray(jax_t5._position_bias(jnp.asarray(rel_bias), pos, pos, bidirectional,
                                            cfg))[0]
    table = fa.distance_bias_table(torch.from_numpy(rel_bias), bidirectional=bidirectional,
                                   max_distance=maxd)
    assert table.shape == (H, 2 * maxd + 1) and table.dtype == torch.float32
    q, k = np.arange(L)[:, None], np.arange(L)[None, :]
    got = table.numpy()[:, np.clip(k - q, -maxd, maxd) + maxd]
    np.testing.assert_array_equal(got, want)
    tcfg = t5.T5Config(n_heads=H, rel_buckets=nb, rel_max_distance=maxd)
    tpos = torch.arange(L, dtype=torch.int32)
    np.testing.assert_array_equal(
        t5._position_bias(torch.from_numpy(rel_bias), tpos, tpos, bidirectional, tcfg)[0].numpy(),
        want)


def _inputs(B, H, Lq, Lk, D, lengths, seed, nb=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, D)).astype(np.float32) for L in (Lq, Lk, Lk))
    mask = (np.arange(Lk)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    rel_bias = (rng.normal(size=(nb, H)) * 2.0).astype(np.float32)
    return q, k, v, mask[:, None, None, :], rel_bias


CASES = {
    # name: (B, H, Lq, Lk, D), key lengths (0 = a row with no real key),
    # bidirectional, max_distance (above the exact range: 8 bidirectional,
    # 16 causal, with 32 buckets)
    "bidir_padded": ((2, 4, 48, 48, 32), [48, 30], True, 16),
    "causal": ((2, 3, 64, 64, 32), [64, 41], False, 24),
    "multi_tile_dead_row": ((3, 2, 40, 128, 64), [128, 0, 70], True, 32),
    "lq_ne_lk": ((2, 2, 24, 192, 32), [192, 100], True, 128),
    "shared_mask": ((3, 2, 32, 64, 32), [50], False, 20),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_matches_pallas(case, dtype):
    (B, H, Lq, Lk, D), lengths, bidir, maxd = CASES[case]
    q, k, v, mask, rel_bias = _inputs(B, H, Lq, Lk, D, lengths, seed=len(case))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = pallas_t5(*(jnp.asarray(x).astype(jd) for x in (q, k, v)), jnp.asarray(mask),
                     jnp.asarray(rel_bias), bidirectional=bidir, max_distance=maxd, scale=1.0,
                     min_key_len=0, block_k=64, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    table = fa.distance_bias_table(torch.from_numpy(rel_bias), bidirectional=bidir,
                                   max_distance=maxd)
    got = fa.flash_attention_t5_reference(tq, tk, tv, torch.from_numpy(mask), table,
                                          max_distance=maxd)
    assert got.dtype == dtype and got.shape == tq.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol)
    if 0 in lengths:
        np.testing.assert_array_equal(got[lengths.index(0)].float().numpy(), 0.0)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidir", "causal"])
def test_plain_matches_dense_bias_path(bidirectional):
    """Against the T5 encoder's own dense path (scores + position bias +
    padding bias, softmax), in f32."""
    B, H, L, D, maxd = 2, 4, 90, 32, 20
    q, k, v, mask, rel_bias = _inputs(B, H, L, L, D, [90, 57], seed=11)
    tq, tk, tv, tm, trb = (torch.from_numpy(x) for x in (q, k, v, mask, rel_bias))
    cfg = t5.T5Config(n_heads=H, d_kv=D, rel_max_distance=maxd)
    pos = torch.arange(L, dtype=torch.int32)
    bias = t5._position_bias(trb, pos, pos, bidirectional, cfg) + t5._pad_bias(tm[:, 0, 0])
    want = t5._softmax_ctx(tq, tk, tv, bias, torch.float32)
    got = fa.flash_attention_t5(tq, tk, tv, tm, trb, bidirectional=bidirectional,
                                max_distance=maxd)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    q, k, v, mask, rel_bias = (torch.from_numpy(x) for x in _inputs(2, 2, 16, 16, 32, [16, 9], 3))
    sel, launches = dict(fa.SELECTION_COUNTS), dict(fa.LAUNCH_COUNTS)
    got = fa.flash_attention_t5(q, k, v, mask, rel_bias, bidirectional=True, max_distance=12)
    table = fa.distance_bias_table(rel_bias, bidirectional=True, max_distance=12)
    torch.testing.assert_close(got, fa.flash_attention_t5_reference(q, k, v, mask, table,
                                                                    max_distance=12),
                               rtol=0, atol=0)
    assert fa.SELECTION_COUNTS["t5_flash"] == sel["t5_flash"] + 1
    assert fa.SELECTION_COUNTS["t5_dense"] == sel["t5_dense"]
    assert fa.LAUNCH_COUNTS == launches  # the CPU never launches the kernel


@pytest.mark.parametrize("why", ["causal_mask", "d_head_16", "float64", "bias_heads",
                                 "max_distance"])
def test_unsupported_shapes_return_none(why):
    q, k, v, mask, rel_bias = (torch.from_numpy(x) for x in _inputs(2, 2, 16, 16, 32, [16, 9], 4))
    maxd = 12
    if why == "causal_mask":
        mask = torch.tril(torch.ones(16, 16, dtype=torch.int32))[None, None]
    elif why == "d_head_16":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
    elif why == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif why == "bias_heads":
        rel_bias = rel_bias[:, :1]
    else:
        maxd = fa.MAX_BIAS_DISTANCE + 1
    before = fa.SELECTION_COUNTS["t5_dense"]
    assert fa.flash_attention_t5(q, k, v, mask, rel_bias, max_distance=maxd) is None
    assert fa.SELECTION_COUNTS["t5_dense"] == before + 1


def test_launcher_refuses_what_the_kernel_does_not_take():
    q, k, v, mask, rel_bias = (torch.from_numpy(x) for x in _inputs(2, 2, 16, 16, 32, [16, 9], 5))
    table = fa.distance_bias_table(rel_bias, bidirectional=True, max_distance=12)
    with pytest.raises(ValueError, match="CUDA device"):
        fa._launch_t5(q, k, v, mask, table, 12, 1.0)
    with pytest.raises(ValueError, match="mask"):
        fa._launch_t5(q, k, v, mask[:, :, :, :4], table, 12, 1.0)


def test_runtime_t5_kernel_is_the_entry():
    assert TorchRuntime(device="cpu").t5_attention_kernel() is fa.flash_attention_t5
    rt = TorchRuntime(devices=["cpu"] * 2, mesh_shape={"sp": 2})
    assert rt.t5_attention_kernel() is fa.flash_attention_t5


# The T5 kernel's constant-tile rule (t5_constant_bias_index) at the shapes
# chip_smoke runs: L 512 / max distance 128 (T5-large), 600 / 256
# (buckets32_maxd256) and a causal table; (L, max_distance, bidirectional,
# tile pairs the rule calls constant, of the (L / 64)^2 rounded up).
RULE_CASES = {
    "t5_large_L512_maxd128": (512, 128, True, 30),
    "buckets32_maxd256_L600": (600, 256, True, 30),
    "causal_L512_maxd128": (512, 128, False, 30),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_constant_tile_rule_holds_against_the_plain_bias_tiles(case):
    """Every 64-row x 64-key tile that the rule calls constant has one bias
    value a head in the plain version's tiles, the entry the rule names;
    every other tile holds a relative position strictly inside
    ±max_distance."""
    L, maxd, bidir, want_constant = RULE_CASES[case]
    H = 3
    rel_bias = torch.from_numpy(np.random.default_rng(L + maxd).normal(size=(32, H))
                                .astype(np.float32))
    table = fa.distance_bias_table(rel_bias, bidirectional=bidir, max_distance=maxd)
    constant = 0
    for q0 in range(0, L, 64):
        for k0 in range(0, L, fa.BLOCK_K):
            tile = fa.t5_bias_tile(table, q0, min(q0 + 64, L), k0, min(k0 + fa.BLOCK_K, L),
                                   max_distance=maxd)
            idx = fa.t5_constant_bias_index(q0, k0, maxd)
            if idx is None:
                rel = np.arange(k0, k0 + fa.BLOCK_K)[None, :] - np.arange(q0, q0 + 64)[:, None]
                assert np.abs(rel).min() < maxd
                continue
            constant += 1
            assert idx in (0, 2 * maxd)
            torch.testing.assert_close(tile, table[:, idx, None, None].expand_as(tile),
                                       rtol=0, atol=0)
    assert constant == want_constant


def test_reference_adds_the_bias_tiles():
    """flash_attention_t5_reference's bias is t5_bias_tile's: scores of zero
    q and k leave softmax(bias) V, held against the dense bias."""
    B, H, L, D, maxd = 1, 2, 150, 32, 16
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.normal(size=(B, H, L, D)).astype(np.float32))
    zero = torch.zeros_like(v)
    mask = torch.ones(B, 1, 1, L, dtype=torch.int32)
    table = fa.distance_bias_table(torch.from_numpy(rng.normal(size=(32, H)).astype(np.float32)),
                                   bidirectional=True, max_distance=maxd)
    got = fa.flash_attention_t5_reference(zero, zero, v, mask, table, max_distance=maxd)
    bias = fa.t5_bias_tile(table, 0, L, 0, L, max_distance=maxd)
    want = torch.softmax(bias, dim=-1)[None] @ v
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
