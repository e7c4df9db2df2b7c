"""The port's checkpoint writer must write what the reference writes: the
same dotted keys in the reference's order (``flatten_params``), the same
arrays, atomically, and a file that round-trips through either package's
loader."""

import os

import numpy as np
import pytest
import torch

import jax

from agent_tpu.models import checkpoint as jax_checkpoint
from agent_tpu.models import encoder as jax_encoder
from agent_tpu_torch.models import checkpoint, encoder, layers

CFG = dict(vocab_size=260, d_model=32, n_heads=1, n_layers=11, d_ff=64, max_len=16,
           n_classes=3, dtype="float32")


@pytest.fixture(scope="module")
def jax_params():
    # 11 layers, so the reference's numeric order (blocks.2 before
    # blocks.10) differs from a string sort.
    return jax_encoder.init_params(jax_encoder.EncoderConfig(**CFG), "ckpt-parity")


@pytest.fixture()
def model(jax_params):
    flat = layers.flatten(jax.tree_util.tree_map(np.asarray, jax_params))
    return encoder.from_jax_params(flat, encoder.EncoderConfig(**CFG), trainable=True)


def test_flatten_params_keys_and_order_match_jax(jax_params, model):
    want = [k for k, _ in jax_checkpoint.flatten_params(jax_params)]
    assert [k for k, _ in checkpoint.flatten_params(model)] == want
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    got = checkpoint.flatten_params(tree)
    assert [k for k, _ in got] == want
    for (_, a), (_, b) in zip(got, jax_checkpoint.flatten_params(tree)):
        assert a is b


def test_save_npz_equals_jax_save_npz(jax_params, model, tmp_path):
    ours = checkpoint.save_npz(model, str(tmp_path / "port.npz"))
    theirs = jax_checkpoint.save_npz(jax_params, str(tmp_path / "jax.npz"))
    with np.load(ours) as a, np.load(theirs) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_round_trip_through_both_loaders(jax_params, model, tmp_path):
    path = checkpoint.save_npz(model, str(tmp_path / "sub" / "m.npz"))
    assert os.listdir(tmp_path / "sub") == ["m.npz"]  # no temp file left behind
    cfg = encoder.EncoderConfig(**CFG)
    back = encoder.from_jax_params(encoder.load_npz(path, cfg), cfg, trainable=True)
    assert checkpoint.params_equal(model, back)
    assert jax_checkpoint.params_equal(
        jax_encoder.load_npz(path, jax_encoder.EncoderConfig(**CFG)), jax_params)


def test_params_equal(model, jax_params):
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    other = jax.tree_util.tree_map(lambda x: x + np.float32(1e-3), tree)
    assert checkpoint.params_equal(tree, tree)
    assert not checkpoint.params_equal(tree, other)
    assert checkpoint.params_equal(tree, other, atol=2e-3)
    assert not checkpoint.params_equal(tree, {**tree, "extra": np.zeros(1)})
    with torch.no_grad():
        model.head.b.add_(1.0)
    assert not checkpoint.params_equal(model, tree)


def test_failed_write_leaves_the_old_file(model, tmp_path, monkeypatch):
    path = str(tmp_path / "m.npz")
    checkpoint.save_npz({"a": np.ones(2, np.float32)}, path)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_npz(model, path)
    assert os.listdir(tmp_path) == ["m.npz"]
    with np.load(path) as f:
        assert f.files == ["a"]
