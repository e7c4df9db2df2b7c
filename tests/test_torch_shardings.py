"""The port's spec trees and weight cutting against the JAX package's.

``parallel.shardings`` keeps its own copy of every family's spec tree; leaf
for leaf (flattened to the dotted keys, a ``PartitionSpec`` read as the
tuple it is) it must equal ``agent_tpu.parallel.shardings``', and so must
the quantized specs and ``sanitize_specs``. ``shard_flat`` must cut each
leaf into the piece the reference's ``NamedSharding`` puts on each device
of the same mesh, and ``gather_flat`` must restore the arrays bit for bit.
The mesh helpers (``device_at``, ``axis_groups``) are held to the device
grid."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from agent_tpu.config import DeviceConfig
from agent_tpu.models import bart as jax_bart
from agent_tpu.models import encoder as jax_encoder
from agent_tpu.models import quant as jax_quant
from agent_tpu.models import seq2seq as jax_seq2seq
from agent_tpu.models import t5 as jax_t5
from agent_tpu.models.bert import BertConfig as JaxBertConfig
from agent_tpu.parallel import shardings as jax_shardings
from agent_tpu.runtime.runtime import TpuRuntime
from agent_tpu_torch.models import encoder, layers, quant
from agent_tpu_torch.models.bert import BertConfig
from agent_tpu_torch.parallel import shardings
from agent_tpu_torch.runtime.mesh import axis_groups, build_mesh

SMALL = dict(vocab_size=260, d_model=64, n_heads=8, n_layers=2, d_ff=128, max_len=64,
             n_classes=64, dtype="float32")


def _flat_specs(tree, prefix=""):
    """A reference spec tree -> {dotted key: tuple}."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, P):
            out[f"{prefix}{k}"] = tuple(v)
        else:
            out.update(_flat_specs(v, f"{prefix}{k}."))
    return out


def _configs():
    return {
        "encoder": (jax_encoder.EncoderConfig(**SMALL), encoder.EncoderConfig(**SMALL)),
        "encoder-moe": (jax_encoder.EncoderConfig(**SMALL, moe_experts=4),
                        encoder.EncoderConfig(**SMALL, moe_experts=4)),
        "bert": (JaxBertConfig(num_layers=3), BertConfig(num_layers=3)),
        "seq2seq": (jax_seq2seq.Seq2SeqConfig(n_enc_layers=2, n_dec_layers=3),) * 2,
        "t5": (jax_t5.T5Config(n_enc_layers=2, n_dec_layers=2, gated_ffn=False,
                               tie_word_embeddings=True),) * 2,
        "t5-gated": (jax_t5.T5Config(n_enc_layers=1, n_dec_layers=2, gated_ffn=True,
                                     tie_word_embeddings=False),) * 2,
        "bart": (jax_bart.BartConfig(n_enc_layers=2, n_dec_layers=1),) * 2,
    }


JAX_SPECS = {"encoder": jax_shardings.encoder_param_specs,
             "bert": jax_shardings.bert_param_specs,
             "seq2seq": jax_shardings.seq2seq_param_specs,
             "t5": jax_shardings.t5_param_specs,
             "bart": jax_shardings.bart_param_specs}


@pytest.mark.parametrize("name", sorted(_configs()))
def test_spec_trees_equal_the_reference(name):
    jax_cfg, port_cfg = _configs()[name]
    family = name.split("-")[0]
    want = _flat_specs(JAX_SPECS[family](jax_cfg))
    got = shardings.FAMILY_SPECS[family](port_cfg)
    assert got == want


def _host_tree(family: str, cfg):
    """The reference's f32 host tree of a small model of ``family``."""
    if family == "encoder":
        return jax.tree_util.tree_map(np.asarray, jax_encoder.init_params(cfg, "spec-test"))
    if family == "seq2seq":
        return jax.tree_util.tree_map(np.asarray, jax_seq2seq.init_params(cfg, "spec-test"))
    if family == "bert":
        d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        rng = np.random.default_rng(0)

        def dense(i, o):
            return {"w": rng.normal(size=(i, o)).astype(np.float32),
                    "b": rng.normal(size=(o,)).astype(np.float32)}

        def ln():
            return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

        return {"embed": {"word": rng.normal(size=(v, d)).astype(np.float32),
                          "pos": np.zeros((cfg.max_position, d), np.float32),
                          "type": np.zeros((2, d), np.float32), "ln": ln()},
                "layers": [{"attn": {"q": dense(d, d), "k": dense(d, d), "v": dense(d, d),
                                     "o": dense(d, d), "ln": ln()},
                            "ffn": {"i": dense(d, f), "o": dense(f, d), "ln": ln()}}
                           for _ in range(cfg.num_layers)],
                "pooler": dense(d, d), "head": dense(d, cfg.num_labels)}
    raise AssertionError(family)


SMALL_BERT = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, max_position=32, num_labels=6)


def _small(family):
    if family == "encoder":
        return jax_encoder.EncoderConfig(**SMALL), encoder.EncoderConfig(**SMALL)
    if family == "encoder-moe":
        return (jax_encoder.EncoderConfig(**SMALL, moe_experts=4),
                encoder.EncoderConfig(**SMALL, moe_experts=4))
    if family == "bert":
        return JaxBertConfig(**SMALL_BERT), BertConfig(**SMALL_BERT)
    cfg = jax_seq2seq.Seq2SeqConfig(vocab_size=64, d_model=32, n_heads=4, n_enc_layers=1,
                                    n_dec_layers=1, d_ff=64, max_src_len=16, max_tgt_len=8,
                                    dtype="float32")
    return cfg, cfg


@pytest.mark.parametrize("mode", ["int8", "w8a16"])
@pytest.mark.parametrize("name", ["encoder", "encoder-moe", "bert", "seq2seq"])
def test_quantized_specs_equal_the_reference(name, mode):
    """A quantized table takes its weight's spec; its scale keeps the
    entries of the axes it was not taken over (``quantize_specs_for_family``)."""
    family = name.split("-")[0]
    jax_cfg, port_cfg = _small(name)
    tree = _host_tree(family, jax_cfg)
    flat = layers.flatten(quant.quantize_tree(tree, family, mode))
    want = _flat_specs(jax_quant.quantize_specs_for_family(family, JAX_SPECS[family](jax_cfg),
                                                           mode))
    got = shardings.quantize_specs(shardings.FAMILY_SPECS[family](port_cfg), flat)
    assert got == want


MESHES = [{"tp": 2}, {"dp": 2, "tp": 2}, {"tp": 4}, {"dp": 4, "tp": 2}, {"tp": 8},
          {"dp": 2, "ep": 4}, {"ep": 2}]


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return TpuRuntime(DeviceConfig(mesh_shape=shape), devices=jax.devices()[:n]).mesh


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                               s.items()))
@pytest.mark.parametrize("name", ["encoder", "encoder-moe", "bert"])
def test_sanitize_specs_equals_the_reference(name, shape):
    """The same leaves replicate (a dim that does not divide, an axis the
    mesh lacks) on the same mesh; 8 heads and 64 classes divide tp 8, the
    260-row vocabulary does not."""
    family = name.split("-")[0]
    jax_cfg, port_cfg = _small(name)
    tree = _host_tree(family, jax_cfg)
    want = _flat_specs(jax_shardings.sanitize_specs(_jax_mesh(shape), tree,
                                                    JAX_SPECS[family](jax_cfg)))
    n = int(np.prod(list(shape.values())))
    got = shardings.sanitize_specs(build_mesh(["cpu"] * n, shape).shape, layers.flatten(tree),
                                   shardings.FAMILY_SPECS[family](port_cfg))
    assert got == want


def test_sanitize_replicates_what_does_not_divide():
    """6 heads on tp = 4 replicate the attention leaves; 5 classes the
    head; a 261-row vocabulary the embedding (the reference's own case)."""
    cfg = encoder.EncoderConfig(vocab_size=261, d_model=48, n_heads=6, n_layers=1, d_ff=64,
                                max_len=16, n_classes=5, dtype="float32")
    flat = encoder.init_params(cfg, "odd")
    got = shardings.sanitize_specs({"dp": 2, "tp": 4, "sp": 1},
                                   flat, shardings.encoder_specs(cfg))
    assert got["blocks.0.attn.wq"] == () and got["blocks.0.attn.wo"] == ()
    assert got["head.w"] == () and got["head.b"] == () and got["embed"] == ()
    assert got["blocks.0.ffn.wi.w"] == (None, "tp") and got["blocks.0.ffn.wo.b"] == ()


@pytest.mark.parametrize("mode", ["none", "int8", "w8a16"])
@pytest.mark.parametrize("shape", [{"tp": 2}, {"dp": 2, "tp": 4}, {"dp": 2, "ep": 4},
                                   {"tp": 2, "ep": 2}],
                         ids=["tp2", "dp2-tp4", "dp2-ep4", "tp2-ep2"])
def test_shard_gather_round_trip(shape, mode):
    """Each position's piece has the shape the reference's NamedSharding
    gives that device, holds those values, and gathering the pieces gives
    the arrays back bit for bit (int8 tables stay int8)."""
    cfg = encoder.EncoderConfig(**SMALL, moe_experts=4)
    flat, _ = quant.quantize_flat(encoder.init_params(cfg, "round-trip"), "encoder", mode)
    n = int(np.prod(list(shape.values())))
    mesh = build_mesh(["cpu"] * n, shape)
    specs = shardings.sanitize_specs(mesh.shape, flat, shardings.encoder_specs(cfg))
    pieces = shardings.shard_flat(flat, specs, mesh.shape)
    positions = shardings.positions(mesh.shape)
    jmesh = _jax_mesh(shape)
    for key in ("embed", "blocks.0.attn.wq", "blocks.1.moe.wi", "head.w",
                "blocks.0.attn.wo.w_scale", "blocks.0.moe.wo.w_scale"):
        if key not in flat:
            continue
        arr = jax.device_put(flat[key], NamedSharding(jmesh, P(*specs[key])))
        for shard in arr.addressable_shards:
            coords = positions[list(jmesh.devices.reshape(-1)).index(shard.device)]
            piece = pieces[positions.index(coords)][key]
            assert piece.shape == shard.data.shape, (key, coords)
            np.testing.assert_array_equal(piece, np.asarray(shard.data))
    by_coords = {tuple(sorted(c.items())): p for c, p in zip(positions, pieces)}

    def piece_at(coords):
        full = {a: coords.get(a, 0) for a in mesh.shape}
        return by_coords[tuple(sorted(full.items()))]

    back = shardings.gather_flat(piece_at, specs, mesh.shape)
    assert back.keys() == flat.keys()
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype and np.array_equal(back[key], arr), key
    if mode == "int8":
        assert back["blocks.0.attn.wq.w_q"].dtype == np.int8


def test_mesh_helpers_walk_the_device_grid():
    mesh = build_mesh([f"cuda:{i}" for i in range(8)], {"dp": 2, "tp": 2, "ep": 2})
    assert mesh.axis_names == ("dp", "tp", "sp", "ep")
    assert mesh.device_at(dp=1, tp=0, ep=1) == torch.device("cuda", 5)
    assert axis_groups(mesh, "tp") == [[torch.device("cuda", a), torch.device("cuda", b)]
                                       for a, b in ((0, 2), (1, 3), (4, 6), (5, 7))]
    assert axis_groups(mesh, "pp") == [[torch.device("cuda", i)] for i in range(8)]
    pp = build_mesh(["cpu"] * 4, {"pp": 2})
    assert pp.shape == {"dp": 2, "tp": 1, "sp": 1, "pp": 2}
