"""Ring attention over sp, and its hop, against the JAX package.

The fold's plain version (``flash_fold_reference``) must agree with the
Pallas ``flash_fold`` in interpret mode at the same 64-key tiles, from a
carried state, and the port's ring on a CPU mesh (one device listed sp
times) must agree with the JAX ring on sp virtual devices, through the
einsum fold and through the fold kernel's path. Tolerances are the
reference's (tests/test_ring.py, tests/test_flash_attention.py:30-94): f32
2e-5, bf16 2e-2. The CUDA kernel itself is checked on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from agent_tpu.config import DeviceConfig
from agent_tpu.kernels.flash_attention import flash_fold as pallas_fold
from agent_tpu.models import encoder as jax_encoder
from agent_tpu.models import layers as jax_layers
from agent_tpu.parallel.ring import make_ring_attention as jax_ring
from agent_tpu.runtime import TpuRuntime
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models import encoder, layers
from agent_tpu_torch.parallel import ring as ring_mod
from agent_tpu_torch.runtime.mesh import build_mesh

torch.set_num_threads(1)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


# ---- the fold -----------------------------------------------------------------

B, H, LQ, LK, D = 2, 2, 64, 128, 32


def _fold_both(q, k, v, mask, state, dtype):
    """(port plain fold, Pallas fold at 64x64 tiles), each from ``state``
    (numpy m, l, acc), as numpy f32 triples."""
    jd = JAX_DTYPE[dtype]
    jm, jl, jacc = (jnp.asarray(x) for x in state)
    want = pallas_fold(jnp.asarray(q).astype(jd), jnp.asarray(k).astype(jd),
                       jnp.asarray(v).astype(jd), jnp.asarray(mask), jm, jl, jacc,
                       block_q=64, block_k=64, interpret=True)
    got = fa.flash_fold_reference(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                                  fa.key_keep(_torch(mask, torch.int32)),
                                  *(_torch(x) for x in state))
    assert all(x.dtype == torch.float32 for x in got)
    return [_np(x) for x in got], [np.asarray(x) for x in want]


def _mask(lengths, lk=LK):
    return (np.arange(lk)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)[:, None,
                                                                                     None, :]


def _initial():
    return (np.full((B, H, LQ, 1), -1e9, np.float32), np.zeros((B, H, LQ, 1), np.float32),
            np.zeros((B, H, LQ, D), np.float32))


def _carried(rng, dtype):
    """The state after a real previous hop (through JAX's Pallas fold), so
    both packages fold the next block from the same state."""
    q, k, v = _rand(rng, B, H, LQ, D), _rand(rng, B, H, LK, D), _rand(rng, B, H, LK, D)
    _, want = _fold_both(q, k, v, _mask([LK, 70]), _initial(), dtype)
    return q, want


FOLD_CASES = ["carried", "random_state", "initial", "masked_block", "lq_ne_lk"]


@DTYPES
@pytest.mark.parametrize("case", FOLD_CASES)
def test_fold_plain_matches_pallas(case, dtype):
    rng = np.random.default_rng(FOLD_CASES.index(case))
    k, v = _rand(rng, B, H, LK, D), _rand(rng, B, H, LK, D)
    mask = _mask([LK, 100])
    if case == "initial":
        q, state = _rand(rng, B, H, LQ, D), _initial()
    elif case == "random_state":
        q = _rand(rng, B, H, LQ, D)
        state = (_rand(rng, B, H, LQ, 1), rng.uniform(0.5, 3.0, (B, H, LQ, 1)).astype(np.float32),
                 _rand(rng, B, H, LQ, D))
    elif case == "lq_ne_lk":  # 128 query rows against a 64-key block
        q = _rand(rng, B, H, 128, D)
        k, v, mask = k[:, :, :64], v[:, :, :64], _mask([64, 9], 64)
        state = (_rand(rng, B, H, 128, 1), rng.uniform(0.5, 3.0, (B, H, 128, 1)).astype(
            np.float32), _rand(rng, B, H, 128, D))
    else:
        q, state = _carried(rng, dtype)
        if case == "masked_block":
            mask = _mask([0, 0])
    got, want = _fold_both(q, k, v, mask, state, dtype)
    tol = TOL[dtype]
    for name, g, w in zip("m l acc".split(), got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
    if case == "masked_block":  # a wholly masked block leaves the state as it was
        for g, w, s in zip(got, want, state):
            np.testing.assert_array_equal(g, s)
            np.testing.assert_array_equal(w, s)


@DTYPES
def test_fold_dead_row_stays_empty_across_hops(dtype):
    """A row with no real key in any block keeps (NEG_INF, 0, 0) through two
    hops, and the ring's normalisation then gives 0, not NaN."""
    rng = np.random.default_rng(7)
    q = _rand(rng, B, H, LQ, D)
    state = _initial()
    for hop in range(2):
        k, v = _rand(rng, B, H, LK, D), _rand(rng, B, H, LK, D)
        got, want = _fold_both(q, k, v, _mask([LK - 20 * hop, 0]), state, dtype)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype])
        state = tuple(got)
    m, l, acc = state
    assert (m[1] == -1e9).all() and (l[1] == 0).all() and (acc[1] == 0).all()
    out = acc / np.maximum(l, 1e-30)
    assert np.isfinite(out).all() and (out[1] == 0).all()


# The CUDA fold's 128-row block boundaries, hop by hop: (Lq, Lk, key lengths
# of the first block, of the second). The reference's Pallas fold refuses
# an Lq that its block does not divide, so the two hops, normalised, are
# held against its dense attention over both blocks' keys.
TWO_HOPS = {"lq257_lk129": (257, 129, [129, 100], [129, 60]), "lq1": (1, 77, [77, 5], [40, 77])}


@DTYPES
@pytest.mark.parametrize("case", sorted(TWO_HOPS))
def test_two_hop_fold_matches_dense_over_both_blocks(case, dtype):
    lq, lk, *lengths = TWO_HOPS[case]
    rng = np.random.default_rng(20 + sorted(TWO_HOPS).index(case))
    q = _rand(rng, 2, 3, lq, 64)
    blocks = [(_rand(rng, 2, 3, lk, 64), _rand(rng, 2, 3, lk, 64), _mask(n, lk)) for n in lengths]
    tq = _torch(q, dtype)
    m, l, acc = fa.initial_state(tq)
    for k, v, mask in blocks:
        m, l, acc = fa.flash_fold_reference(tq, _torch(k, dtype), _torch(v, dtype),
                                            fa.key_keep(_torch(mask, torch.int32)), m, l, acc)
    got = (acc / torch.clamp_min(l, 1e-30)).numpy()
    jd = JAX_DTYPE[dtype]
    k, v, mask = (np.concatenate(parts, axis=-1 if i == 2 else 2)
                  for i, parts in enumerate(zip(*blocks)))
    want = jax_layers.dot_product_attention(*(jnp.asarray(x).astype(jd) for x in (q, k, v)),
                                            jnp.asarray(mask))
    np.testing.assert_allclose(got, _np(want), rtol=TOL[dtype], atol=TOL[dtype])


@DTYPES
def test_planted_carry_not_corrected_differs_from_the_fold(dtype):
    """chip_smoke's planted fault for the fold kernel (tile 0's correction
    of the carried acc skipped) must fail the check that the kernel passes:
    from a carried state, with a second block whose keys (scaled by 4) raise
    every row's max in its first tile, the plain fold matches the Pallas
    fold and the fault's acc does not."""
    rng = np.random.default_rng(30)
    q, state = _carried(rng, dtype)
    k, v = 4 * _rand(rng, B, H, LK, D), _rand(rng, B, H, LK, D)
    mask = _mask([LK, 100])
    got, want = _fold_both(q, k, v, mask, state, dtype)
    tol = TOL[dtype]
    for name, g, w in zip("m l acc".split(), got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
    assert (want[0] > state[0]).all()  # tile 0 raised every row's max
    fault = chip_smoke.carry_not_corrected(
        fa, _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        fa.key_keep(_torch(mask, torch.int32)), *(_torch(x) for x in state))
    np.testing.assert_allclose(_np(fault[0]), want[0], rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(fault[1]), want[1], rtol=tol, atol=tol)
    assert not np.allclose(_np(fault[2]), want[2], rtol=tol, atol=tol)


def test_flash_fold_routes_cpu_tensors_to_plain_version():
    rng = np.random.default_rng(8)
    q, k, v = (_torch(_rand(rng, B, H, n, D)) for n in (LQ, LK, LK))
    mask = _torch(_mask([LK, 50]), torch.int32)
    state = [_torch(x) for x in _initial()]
    launches = dict(fa.LAUNCH_COUNTS)
    got = fa.flash_fold(q, k, v, mask, *state)
    want = fa.flash_fold_reference(q, k, v, fa.key_keep(mask), *state)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fa.LAUNCH_COUNTS == launches  # the CPU never launches the kernel
    with pytest.raises(ValueError, match="CUDA device"):
        fa._launch_fold(q, k, v, fa.key_keep(mask), *state)


@pytest.mark.parametrize("why", ["d_head_16", "float64", "mixed"])
def test_flash_fold_supported_is_shape_support(why):
    q = torch.zeros(1, 1, 5, 64)
    assert fa.flash_fold_supported(q, torch.zeros(1, 1, 3, 64))  # any length
    assert fa.flash_fold_supported(q.bfloat16(), torch.zeros(1, 1, 7, 64).bfloat16())
    if why == "d_head_16":
        q = q[..., :16]
        k = torch.zeros(1, 1, 3, 16)
    elif why == "float64":
        q, k = q.double(), torch.zeros(1, 1, 3, 64).double()
    else:
        k = torch.zeros(1, 1, 3, 64).bfloat16()
    assert not fa.flash_fold_supported(q, k)


# ---- the ring -----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_meshes():
    return {sp: TpuRuntime(DeviceConfig(mesh_shape={"sp": sp}),
                           devices=jax.devices()[:sp]).mesh for sp in (2, 4, 8)}


def _qkvm(Bq=4, Hq=4, Lq=16, Lk=16, Dq=8, pad_tail=3, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = _rand(rng, Bq, Hq, Lq, Dq), _rand(rng, Bq, Hq, Lk, Dq), _rand(rng, Bq, Hq, Lk, Dq)
    mask = np.ones((Bq, Lk), dtype=np.int32)
    if pad_tail:
        mask[:, -pad_tail:] = 0
    return q, k, v, mask[:, None, None, :]


def _rings(jax_meshes, sp, fold):
    """(port ring on sp CPU shards, JAX ring on sp virtual devices), both
    folding with the einsum fold or with the fold kernel's path."""
    kernel = fold == "kernel"
    port = ring_mod.make_ring_attention(build_mesh(["cpu"] * sp, {"sp": sp}),
                                        use_flash_fold=None if kernel else False)
    return port, jax_ring(jax_meshes[sp], use_flash_fold=kernel)


def _run_both(port, ref, q, k, v, mask, dtype=torch.float32):
    jd = JAX_DTYPE[dtype]
    want = ref(*(jnp.asarray(x).astype(jd) for x in (q, k, v)), jnp.asarray(mask))
    got = port(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), _torch(mask, torch.int32))
    assert got.dtype == dtype and tuple(got.shape) == q.shape
    return _np(got), _np(want)


SPS = pytest.mark.parametrize("sp", [2, 4, 8])
FOLDS = pytest.mark.parametrize("fold", ["einsum", "kernel"])


@SPS
@FOLDS
def test_ring_matches_jax_ring_and_dense(jax_meshes, sp, fold):
    port, ref = _rings(jax_meshes, sp, fold)
    q, k, v, mask = _qkvm(Lq=8 * sp, Lk=8 * sp, Dq=32)
    before = dict(fa.SELECTION_COUNTS)
    got, want = _run_both(port, ref, q, k, v, mask)
    assert fa.SELECTION_COUNTS["ring"] == before["ring"] + 1
    assert fa.SELECTION_COUNTS["ring_dense"] == before["ring_dense"]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    dense = layers.dot_product_attention(*(_torch(x) for x in (q, k, v)),
                                         _torch(mask, torch.int32)).numpy()
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sp", [2, 4])
@FOLDS
def test_ring_bf16_matches_jax_ring(jax_meshes, sp, fold):
    """bf16: shards of at most 64 keys, so the JAX ring's Pallas fold (tile =
    the whole shard) and the port's 64-key tiles round P at the same max."""
    port, ref = _rings(jax_meshes, sp, fold)
    q, k, v, mask = _qkvm(Lq=32 * sp, Lk=32 * sp, Dq=64, pad_tail=21, seed=3)
    got, want = _run_both(port, ref, q, k, v, mask, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_ring_uses_the_fold_kernel_path(jax_meshes, monkeypatch):
    """use_flash_fold=None folds every hop through flash_fold (its plain
    version on the CPU): sp shards x sp hops."""
    calls = []
    real = fa.flash_fold
    monkeypatch.setattr(fa, "flash_fold", lambda *a: calls.append(1) or real(*a))
    port, _ = _rings(jax_meshes, 4, "kernel")
    q, k, v, mask = _qkvm(Lq=32, Lk=32, Dq=32)
    port(*(_torch(x) for x in (q, k, v)), _torch(mask, torch.int32))
    assert len(calls) == 16
    calls.clear()
    port, _ = _rings(jax_meshes, 4, "einsum")
    port(*(_torch(x) for x in (q, k, v)), _torch(mask, torch.int32))
    assert not calls


@SPS
@FOLDS
def test_ring_fully_padded_row_is_zero_not_nan(jax_meshes, sp, fold):
    port, ref = _rings(jax_meshes, sp, fold)
    q, k, v, mask = _qkvm(Lq=4 * sp, Lk=4 * sp, Dq=32, seed=1)
    mask = mask.copy()
    mask[1] = 0
    got, want = _run_both(port, ref, q, k, v, mask)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], np.zeros_like(got[1]))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@FOLDS
def test_ring_cross_attention_lengths(jax_meshes, fold):
    port, ref = _rings(jax_meshes, 2, fold)
    q, k, v, mask = _qkvm(Lq=8, Lk=16, Dq=32, pad_tail=0, seed=2)
    got, want = _run_both(port, ref, q, k, v, mask)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@FOLDS
def test_ring_broadcast_shared_mask(jax_meshes, fold):
    port, ref = _rings(jax_meshes, 2, fold)
    q, k, v, _ = _qkvm(Dq=32)
    shared = np.ones((1, 1, 1, 16), dtype=np.int32)
    shared[..., -5:] = 0
    got, want = _run_both(port, ref, q, k, v, shared)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_ring_sends_incompatible_shapes_to_dense(jax_meshes):
    port, ref = _rings(jax_meshes, 2, "kernel")
    q, k, v, _ = _qkvm(Dq=32)
    t = [_torch(x) for x in (q, k, v)]
    before = dict(fa.SELECTION_COUNTS)
    # Lq = 7 does not divide sp = 2.
    mask = np.ones((4, 1, 1, 16), dtype=np.int32)
    got = port(t[0][:, :, :7], t[1], t[2], _torch(mask, torch.int32))
    torch.testing.assert_close(got, layers.dot_product_attention(
        t[0][:, :, :7], t[1], t[2], _torch(mask, torch.int32)), rtol=0, atol=0)
    want = ref(jnp.asarray(q[:, :, :7]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # A causal (query-axis) mask.
    causal = jax_layers.causal_mask(16)
    got = port(*t, _torch(causal, torch.int32))
    torch.testing.assert_close(got, layers.dot_product_attention(
        *t, _torch(causal, torch.int32)), rtol=0, atol=0)
    want = ref(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(causal))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert fa.SELECTION_COUNTS["ring_dense"] == before["ring_dense"] + 2
    assert fa.SELECTION_COUNTS["ring"] == before["ring"]


def test_sp1_mesh_returns_dense():
    mesh = build_mesh(["cpu"], {"sp": 1})
    assert ring_mod.make_ring_attention(mesh) is layers.dot_product_attention


def test_ring_refuses_unported_axes():
    """dp and tp compose with the ring now: each (dp, tp) group rings over
    its sp devices; a batch or head count the mesh cannot split is no
    longer refused but runs the flash kernel whole (its plain version on
    the CPU), counted under ``unsharded`` and never as a dense ring."""
    ring = ring_mod.make_ring_attention(build_mesh(["cpu"] * 4, {"dp": 2, "sp": 2}))
    q, k, v, mask = _qkvm(Bq=3, Lq=16, Lk=16, Dq=32)
    before = dict(fa.SELECTION_COUNTS)
    got = ring(*(_torch(x) for x in (q, k, v)), _torch(mask, torch.int32))
    assert fa.SELECTION_COUNTS["unsharded"] == before["unsharded"] + 1
    assert fa.SELECTION_COUNTS["flash"] == before["flash"] + 1
    assert fa.SELECTION_COUNTS["ring_dense"] == before["ring_dense"]
    assert fa.SELECTION_COUNTS["ring"] == before["ring"]
    whole = fa.flash_attention(*(_torch(x) for x in (q, k, v)), _torch(mask, torch.int32))
    torch.testing.assert_close(got, whole, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [{"dp": 2, "sp": 2}, {"tp": 2, "sp": 2},
                                   {"dp": 2, "tp": 2, "sp": 2}], ids=["dp2sp2", "tp2sp2",
                                                                      "dp2tp2sp2"])
@FOLDS
def test_ring_composed_with_dp_and_tp_matches_jax(shape, fold):
    """The ring inside each (dp, tp) group (batch over dp, heads over tp)
    against the reference's ring on the same mesh of virtual devices; the
    fold runs sp² times in each group."""
    n = int(np.prod(list(shape.values())))
    ref = jax_ring(TpuRuntime(DeviceConfig(mesh_shape=shape), devices=jax.devices()[:n]).mesh,
                   use_flash_fold=fold == "kernel")
    port = ring_mod.make_ring_attention(build_mesh(["cpu"] * n, shape),
                                        use_flash_fold=None if fold == "kernel" else False)
    q, k, v, mask = _qkvm(Lq=32, Lk=32, Dq=32, seed=4)
    calls = []
    real = fa.flash_fold
    try:
        fa.flash_fold = lambda *a: calls.append(1) or real(*a)
        got, want = _run_both(port, ref, q, k, v, mask)
    finally:
        fa.flash_fold = real
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    groups = shape.get("dp", 1) * shape.get("tp", 1)
    assert len(calls) == (groups * 4 if fold == "kernel" else 0)
    shard = port.shard(1, 0) if shape.get("dp", 1) > 1 else port.shard(0, 1)
    local = shard(*(_torch(x)[:2, :2] for x in (q, k, v)), _torch(mask, torch.int32)[:2])
    dense = layers.dot_product_attention(*(_torch(x)[:2, :2] for x in (q, k, v)),
                                         _torch(mask, torch.int32)[:2])
    torch.testing.assert_close(local, dense, rtol=2e-5, atol=2e-5)


@FOLDS
def test_encoder_forward_with_ring_matches_dense_and_jax(jax_meshes, fold):
    cfg_kw = dict(vocab_size=64, d_model=64, n_heads=2, n_layers=2, d_ff=64, max_len=16,
                  n_classes=10, dtype="float32")
    flat = encoder.init_params(encoder.EncoderConfig(**cfg_kw), model_id="ring-test")
    model = encoder.from_jax_params(flat, encoder.EncoderConfig(**cfg_kw))
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, size=(4, 16)).astype(np.int32)
    mask = np.ones((4, 16), dtype=np.int32)
    mask[:, 12:] = 0
    port, ref = _rings(jax_meshes, 2, fold)
    with torch.inference_mode():
        ring_logits = model(torch.from_numpy(ids), torch.from_numpy(mask), port).numpy()
        dense_logits = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ring_logits, dense_logits, rtol=5e-5, atol=5e-5)
    jcfg = jax_encoder.EncoderConfig(**cfg_kw)
    jparams = jax_encoder.init_params(jcfg, model_id="ring-test")
    jax_logits = jax_encoder.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                     attn_fn=ref)
    np.testing.assert_allclose(ring_logits, np.asarray(jax_logits), rtol=5e-5, atol=5e-5)
