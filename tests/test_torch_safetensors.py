"""The port's own ``.safetensors`` reader and writer
(``agent_tpu_torch.models.safetensors_io``) against the ``safetensors``
package, which the card's machine does not have: every dtype read back
equal, a malformed file refused, and the HF loaders preferring
``model.safetensors`` to ``pytorch_model.bin`` as the reference's do."""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors.torch import load_file as st_load_file
from safetensors.torch import save_file as st_save_file

import chip_smoke
from agent_tpu.models import bart as jax_bart
from agent_tpu.models import bert as jax_bert
from agent_tpu_torch.models import bart, bert, safetensors_io, t5

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
          torch.float64, torch.int16, torch.int8, torch.uint8, torch.bool]


def _tensors(dtype):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 5, 2, generator=g) * 50
    return {"matrix": x.to(dtype), "vector": x[0, :, 0].clone().to(dtype),
            "scalar": torch.tensor(3).to(dtype), "empty": torch.zeros(0, 4, dtype=dtype)}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_reader_matches_the_package(dtype, tmp_path):
    want = _tensors(dtype)
    path = str(tmp_path / "t.safetensors")
    st_save_file(want, path, metadata={"format": "pt"})
    got = safetensors_io.load_file(path)
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape
        assert torch.equal(got[name], t), name
    ref = st_load_file(path)
    assert all(torch.equal(got[n], ref[n]) for n in ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_writer_is_read_by_the_package(dtype, tmp_path):
    want = _tensors(dtype)
    path = str(tmp_path / "t.safetensors")
    safetensors_io.save_file(want, path, {"format": "pt"})
    got = st_load_file(path)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name


def _corrupt(kind: str, path: str) -> None:
    safetensors_io.save_file({"w": torch.arange(6, dtype=torch.float32)}, path)
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    if kind == "truncated_header":
        raw = raw[:8 + n // 2]
    elif kind == "short_file":
        raw = raw[:5]
    elif kind == "empty":
        raw = b""
    elif kind == "header_longer_than_file":
        raw = struct.pack("<Q", len(raw)) + raw[8:]
    elif kind == "not_json":
        raw = raw[:8] + b"{" * n + raw[8 + n:]
    elif kind in ("offsets_past_data", "shape_mismatch", "unknown_dtype"):
        if kind == "offsets_past_data":
            header["w"]["data_offsets"] = [0, 48]
        elif kind == "shape_mismatch":
            header["w"]["shape"] = [7]
        else:
            header["w"]["dtype"] = "Q7"
        text = json.dumps(header).encode()
        text += b" " * (-len(text) % 8)
        raw = struct.pack("<Q", len(text)) + text + raw[8 + n:]
    open(path, "wb").write(raw)


@pytest.mark.parametrize("kind", ["truncated_header", "short_file", "empty",
                                  "header_longer_than_file", "not_json", "offsets_past_data",
                                  "shape_mismatch", "unknown_dtype"])
def test_a_malformed_file_raises(kind, tmp_path):
    path = str(tmp_path / "bad.safetensors")
    _corrupt(kind, path)
    with pytest.raises(safetensors_io.SafetensorsError):
        safetensors_io.load_file(path)
    # Not a ValueError: the ops would turn that into the caller's bad input.
    assert not issubclass(safetensors_io.SafetensorsError, ValueError)


def test_hf_weights_prefer_safetensors_then_bin(tmp_path):
    a = {"x": torch.ones(2)}
    b = {"x": torch.zeros(2)}
    torch.save(b, tmp_path / "pytorch_model.bin")
    assert torch.equal(safetensors_io.load_hf_weights(str(tmp_path))["x"], b["x"])
    safetensors_io.save_file(a, str(tmp_path / "model.safetensors"))
    assert torch.equal(safetensors_io.load_hf_weights(str(tmp_path))["x"], a["x"])
    with pytest.raises(FileNotFoundError, match="no model.safetensors or pytorch_model.bin"):
        safetensors_io.load_hf_weights(str(tmp_path / "missing"))


TINY_BERT = dict(chip_smoke.BERT_BASE_UNCASED, vocab_size=120, hidden_size=64,
                 num_hidden_layers=2, num_attention_heads=2, intermediate_size=96,
                 max_position_embeddings=32)
TINY_BART = dict(chip_smoke.BART_LARGE_CNN, vocab_size=150, d_model=64, encoder_layers=2,
                 decoder_layers=1, encoder_attention_heads=2, decoder_attention_heads=2,
                 encoder_ffn_dim=96, decoder_ffn_dim=96, max_position_embeddings=32)


def _flat(tree, prefix=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("family", ["bert", "bart"])
def test_checkpoint_from_safetensors_alone_loads_as_the_reference(family, tmp_path):
    """A directory with model.safetensors and no .bin: the port reads it with
    its own reader, the reference with the package; the trees are equal."""
    hf, state_dict, port, ref = {
        "bert": (TINY_BERT, chip_smoke.bert_state_dict, bert, jax_bert),
        "bart": (TINY_BART, chip_smoke.bart_state_dict, bart, jax_bart)}[family]
    chip_smoke.write_hf_checkpoint(str(tmp_path), hf, state_dict(hf, 3, torch.float32),
                                   safetensors=True)
    _, got = port.load_hf_dir(str(tmp_path), dtype="float32")
    _, want = ref.load_hf_dir(str(tmp_path), dtype="float32")
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w), err_msg=name)


def test_t5_loads_from_safetensors_alone(tmp_path):
    from test_torch_t5 import HF_TINY, hf_state_dict

    hf = dict(HF_TINY, feed_forward_proj="relu", tie_word_embeddings=True)
    sd = hf_state_dict(hf, seed=4)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    safetensors_io.save_file({k: torch.from_numpy(v) for k, v in sd.items()},
                             str(tmp_path / "model.safetensors"))
    _, params = t5.load_hf_dir(str(tmp_path), dtype="float32")
    np.testing.assert_array_equal(params["embed"].numpy(), sd["shared.weight"])
