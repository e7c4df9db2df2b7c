"""The port's checkpoint writer must write what the reference writes: the
same dotted keys in the reference's order (``flatten_params``), the same
arrays, atomically, and a file that round-trips through either package's
loader."""

import json
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


# ---- sharded checkpoints (the role of save_orbax/load_orbax) ----

def _perturbed(jax_params):
    rng = np.random.default_rng(5)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(size=np.shape(x)).astype(np.float32), jax_params)


def test_sharded_round_trip_matches_orbax(jax_params, tmp_path):
    """The same perturbed params through save_orbax/load_orbax and through
    save_sharded/load_sharded: leaf for leaf equal, and equal to the
    params."""
    params = _perturbed(jax_params)
    assert checkpoint.sharded_available() and jax_checkpoint.orbax_available()
    jax_checkpoint.save_orbax(params, str(tmp_path / "orbax"))
    theirs = jax_checkpoint.load_orbax(str(tmp_path / "orbax"),
                                       jax.tree_util.tree_map(np.zeros_like, params))
    path = checkpoint.save_sharded(params, str(tmp_path / "port"))
    like = jax.tree_util.tree_map(np.zeros_like, params)
    ours = checkpoint.load_sharded(path, like)
    assert ours is like
    got, want = checkpoint.flatten_params(ours), jax_checkpoint.flatten_params(theirs)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert checkpoint.params_equal(ours, params)


@pytest.mark.parametrize("src,dst", [({"tp": 2}, {"tp": 2}), ({"tp": 2}, {"dp": 2, "tp": 2}),
                                     ({"tp": 2}, None), (None, {"tp": 2}),
                                     ({"dp": 2, "tp": 2}, {"tp": 4})])
def test_sharded_encoder_restores_onto_other_layouts(jax_params, tmp_path, src, dst):
    """An encoder saved from one layout (None: one device) restored onto
    another equals the orbax restore of the same params; the pieces are
    written as they live, one file per distinct position."""
    from agent_tpu_torch.runtime.mesh import build_mesh

    cfg = encoder.EncoderConfig(**dict(CFG, n_heads=4))
    params = _perturbed(jax_encoder.init_params(jax_encoder.EncoderConfig(**dict(
        CFG, n_heads=4)), "ckpt-sharded"))
    flat = layers.flatten(params)

    def on(shape, f):
        if shape is None:
            return encoder.from_jax_params(f, cfg)
        n = int(np.prod(list(shape.values())))
        return encoder.from_jax_params(f, cfg, mesh=build_mesh(["cpu"] * n, shape))

    path = checkpoint.save_sharded(on(src, flat), str(tmp_path / "ck"))
    files = sorted(os.listdir(path))
    assert files == ["index.json"] + [f"shard-0000{i}.safetensors" for i in
                                      range((src or {}).get("tp", 1))]
    like = on(dst, {k: np.zeros_like(v) for k, v in flat.items()})
    assert checkpoint.load_sharded(path, like) is like
    got = like.to_flat_numpy()
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], v)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    import chip_smoke

    hf = dict(chip_smoke.BERT_BASE_UNCASED, vocab_size=600, hidden_size=64,
              num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
              max_position_embeddings=64, num_labels=6)
    d = str(tmp_path_factory.mktemp("bert-ckpt"))
    chip_smoke.write_hf_checkpoint(d, hf, chip_smoke.bert_state_dict(hf, 3, torch.float32,
                                                                     std=0.2))
    return d, chip_smoke.write_wordpiece_vocab(d, hf["vocab_size"], 2)


def _bert_runtime(shape):
    from agent_tpu_torch.runtime.runtime import TorchRuntime

    if shape is None:
        return TorchRuntime(device="cpu")
    return TorchRuntime(devices=["cpu"] * int(np.prod(list(shape.values()))), mesh_shape=shape)


def test_tp2_bert_restores_onto_three_layouts(bert_dir, tmp_path):
    """A tp-2 ShardedBert saved and restored, over zeroed weights, onto tp 2
    (bitwise-equal probabilities), dp 2 x tp 2 and one device (within
    1e-5, f32)."""
    from agent_tpu_torch.models.bert import ShardedBert
    from agent_tpu_torch.ops import load_ops
    from agent_tpu_torch.runtime.context import OpContext

    d, words = bert_dir
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    payload = {"model_path": d, "texts": [" ".join(words[i:i + 7]) for i in range(0, 48, 6)],
               "topk": 6, "model_config": {"dtype": "float32"}}

    def served(rt):
        out = classify(dict(payload), OpContext(runtime=rt))
        assert out["ok"], out
        (model,) = rt._params._cache.values()
        return out, model

    want, model = served(_bert_runtime({"tp": 2}))
    assert isinstance(model, ShardedBert)
    path = checkpoint.save_sharded(model, str(tmp_path / "bert"))
    for shape in ({"tp": 2}, {"dp": 2, "tp": 2}, None):
        rt = _bert_runtime(shape)
        _, like = served(rt)
        tensors = [like.held(0, j) for j in range(like.tp)] if shape else \
            [layers.flatten(like, leaf=lambda t: t)]
        with torch.no_grad():
            for held in tensors:
                for t in held.values():
                    t.zero_()
        if shape is None:
            checkpoint.load_sharded(path, like)
        else:
            assert checkpoint.load_sharded(path, like) is like
        got, _ = served(rt)
        if shape == {"tp": 2}:
            assert got["results"] == want["results"]
        for g, w in zip(got["results"], want["results"], strict=True):
            assert [e["index"] for e in g["topk"]] == [e["index"] for e in w["topk"]]
            np.testing.assert_allclose([e["score"] for e in g["topk"]],
                                       [e["score"] for e in w["topk"]], rtol=0, atol=1e-5)


def test_a_failed_sharded_save_leaves_the_old_checkpoint(tmp_path, monkeypatch):
    from agent_tpu_torch.models import safetensors_io
    from agent_tpu_torch.runtime.mesh import build_mesh

    path = str(tmp_path / "ck")
    old = {"w": np.arange(8, dtype=np.float32).reshape(2, 4)}
    checkpoint.save_sharded(old, path)
    calls = {"n": 0}
    real = safetensors_io.save_file

    def second_fails(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full")
        return real(*args, **kwargs)

    monkeypatch.setattr(safetensors_io, "save_file", second_fails)
    new = {"w": np.ones((2, 4), np.float32)}
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_sharded(new, path, specs={"w": (None, "tp")},
                                mesh=build_mesh(["cpu"] * 2, {"tp": 2}))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    back = checkpoint.load_sharded(path, {"w": np.zeros((2, 4), np.float32)})
    np.testing.assert_array_equal(back["w"], old["w"])
    monkeypatch.setattr(safetensors_io, "save_file", real)
    checkpoint.save_sharded(new, path, specs={"w": (None, "tp")},
                            mesh=build_mesh(["cpu"] * 2, {"tp": 2}))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    assert sorted(os.listdir(path)) == ["index.json", "shard-00000.safetensors",
                                        "shard-00001.safetensors"]
    np.testing.assert_array_equal(
        checkpoint.load_sharded(path, {"w": np.zeros((2, 4), np.float32)})["w"], new["w"])
    with pytest.raises(KeyError, match="no leaf"):
        checkpoint.load_sharded(path, {"v": np.zeros(2, np.float32)})


def test_sharded_keeps_bf16_and_int8_as_they_live(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 3,
            "q": torch.arange(-4, 4, dtype=torch.int8)}
    path = checkpoint.save_sharded(tree, str(tmp_path / "ck"))
    with open(os.path.join(path, "index.json")) as fh:
        index = json.load(fh)
    assert {k: v["dtype"] for k, v in index["leaves"].items()} == {"a": "BF16", "q": "I8"}
    like = {"a": torch.zeros(2, 3, dtype=torch.bfloat16), "q": torch.zeros(8, dtype=torch.int8)}
    checkpoint.load_sharded(path, like)
    assert torch.equal(like["a"], tree["a"]) and torch.equal(like["q"], tree["q"])
