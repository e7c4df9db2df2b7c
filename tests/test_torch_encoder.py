"""The port's encoder, fed the JAX package's weights, must give the JAX
encoder's logits: f32 within 1e-4 (many layers summed in another order),
bf16 with the same top-1 class (tie-aware) and probabilities within 2e-2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from agent_tpu.models import encoder as jax_encoder
from agent_tpu_torch.kernels.flash_attention import flash_attention
from agent_tpu_torch.models import encoder, layers

torch.set_num_threads(1)

# d_head 32 takes the kernel path (its plain version on the CPU).
CFG = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=64, n_classes=10)
SHAPES = [(2, 16), (4, 48), (3, 64)]


def _inputs(B, L, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 260, size=(B, L)).astype(np.int32)
    lengths = rng.integers(1, L + 1, size=B)
    lengths[-1] = 0  # one all-padding row
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    return ids * mask, mask


def _logits(dtype, B, L, seed, attn_fn=flash_attention):
    cfg_j = jax_encoder.EncoderConfig(dtype=dtype, **CFG)
    params = jax_encoder.init_params(cfg_j, "parity-encoder")
    ids, mask = _inputs(B, L, seed)
    want = np.asarray(jax_encoder.forward(params, jnp.asarray(ids), jnp.asarray(mask), cfg_j))
    flat = layers.flatten(jax.tree_util.tree_map(np.asarray, params))
    model = encoder.from_jax_params(flat, encoder.EncoderConfig(dtype=dtype, **CFG))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask), attn_fn).numpy()
    return got, want


@pytest.mark.parametrize("B,L", SHAPES)
def test_f32_logits_match_jax(B, L):
    got, want = _logits("float32", B, L, seed=B * L)
    assert got.dtype == np.float32 and got.shape == (B, CFG["n_classes"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_f32_dense_attention_matches_jax():
    got, want = _logits("float32", 3, 48, seed=11, attn_fn=layers.dot_product_attention)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,L", SHAPES)
def test_bf16_top1_and_probs_match_jax(B, L):
    got, want = _logits("bfloat16", B, L, seed=B + L)
    p_got = torch.softmax(torch.from_numpy(got), -1).numpy()
    p_want = np.asarray(jax.nn.softmax(jnp.asarray(want), axis=-1))
    np.testing.assert_allclose(p_got, p_want, atol=2e-2)
    for row in range(B):
        g, w = int(p_got[row].argmax()), int(p_want[row].argmax())
        # A flip is allowed only between classes the reference scores as tied.
        assert g == w or abs(p_want[row, g] - p_want[row, w]) <= 2e-2, (row, g, w)


def test_topk_probs_breaks_ties_toward_lower_index():
    logits = torch.tensor([[0.0, 2.0, 1.0, 2.0, 2.0], [3.0, 3.0, 3.0, 3.0, 3.0]])
    vals, idx = encoder.topk_probs(logits, 3)
    assert idx.tolist() == [[1, 3, 4], [0, 1, 2]]
    j_vals, j_idx = jax_encoder.topk_probs(jnp.asarray(logits.numpy()), 3)
    assert idx.tolist() == np.asarray(j_idx).tolist()
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=1e-6)


@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
def test_npz_round_trip_matches_jax(tmp_path, partial):
    cfg_j = jax_encoder.EncoderConfig(dtype="float32", **CFG)
    cfg_t = encoder.EncoderConfig(dtype="float32", **CFG)
    flat = encoder.init_params(cfg_t, "npz-source")
    if partial:  # leaves absent from the file keep the init for the path id
        flat = {k: v for k, v in flat.items() if not k.startswith("blocks.1.")}
    path = str(tmp_path / "ckpt.npz")
    np.savez(path, **flat)
    want = layers.flatten(jax.tree_util.tree_map(np.asarray,
                                                 jax_encoder.load_npz(path, cfg_j)))
    got = encoder.load_npz(path, cfg_t)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    model = encoder.from_jax_params(got, cfg_t)
    state = model.state_dict()
    for key, value in got.items():
        np.testing.assert_array_equal(state[key].numpy(), value, err_msg=key)
