"""The port's ``b1`` wire (``agent_tpu_torch.data.wire``) must produce the
reference's bytes for the same columns, since the reference's controller
decodes what the port's agent posts: int columns (with their width shrink),
f32 scores, string columns, JSON side columns, compression on, off and
adaptive. Each side decodes the other's bytes, and a malformed envelope
raises ValueError on both."""

import base64
import random
import string

import numpy as np
import pytest

from agent_tpu.data import wire as jax_wire
from agent_tpu_torch.data import wire

ALPHABET = string.ascii_letters + "äöüß日本語🙂 ,\"'\\\n"


def _columns(seed: int):
    """One seeded column set covering every column kind and dtype."""
    rng = np.random.default_rng(seed)
    prng = random.Random(seed)
    return {
        # classify's result columns, as finalize hands them over
        "indices": rng.integers(0, 1000, size=(17, 5)).astype(np.int32),
        "scores": np.round(rng.random((17, 5), dtype=np.float32), 6),
        "i8_fit": rng.integers(-100, 100, size=9).astype(np.int64),
        "i16_fit": rng.integers(-30000, 30000, size=9).astype(np.int32),
        "u8": rng.integers(0, 255, size=(3, 4)).astype(np.uint8),
        "u16": rng.integers(0, 65535, size=7).astype(np.uint16),
        "f64": rng.standard_normal(6),
        "empty_i": np.zeros((0,), np.int32),
        "summaries": ["".join(prng.choice(ALPHABET) for _ in range(prng.randint(0, 40)))
                      for _ in range(11)] + [""],
        "no_strings": [],
        "": {"ok": True, "n_rows": 17, "nested": [1.5, None, "πλ"]},
    }


@pytest.mark.parametrize("compress", [None, True, False], ids=["adaptive", "zlib", "raw"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blob_bytes_equal_the_reference(seed, compress):
    cols = _columns(seed)
    got = wire.encode_blob(cols, compress)
    assert got == jax_wire.encode_blob(cols, compress)
    assert wire.pack_b64(cols, compress) == jax_wire.pack_b64(cols, compress)
    if compress is not None:
        assert bool(got[2] & 0x01) is compress  # the zlib flag


@pytest.mark.parametrize("compress", [None, True, False], ids=["adaptive", "zlib", "raw"])
def test_each_side_decodes_the_other(compress):
    cols = _columns(7)
    want = {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in cols.items()}
    assert wire.decode_blob(jax_wire.encode_blob(cols, compress)) == want
    assert jax_wire.decode_blob(wire.encode_blob(cols, compress)) == want


def test_int_columns_shrink_like_the_reference():
    small = np.array([[1, 2, 3], [4, 5, 127]], np.int32)
    blob = wire.encode_blob({"x": small}, compress=False)
    assert blob == jax_wire.encode_blob({"x": small}, compress=False)
    # magic, flags, then n_cols, name length, "x", kind 2 (array), dtype code
    assert blob[7] == 0 and blob.endswith(small.astype(np.int8).tobytes())  # int8
    assert wire.decode_blob(blob) == {"x": small.tolist()}


def test_classify_result_decodes_to_the_json_path_lists():
    """Finalize's b1 columns, decoded by the reference's controller, are the
    very lists the JSON path would have carried."""
    rng = np.random.default_rng(3)
    vals = rng.random((32, 5), dtype=np.float32)
    idx = rng.integers(0, 1000, size=(32, 5)).astype(np.int32)
    body = wire.attach_result_columns({"ok": True, "n_rows": 32}, {
        "indices": np.ascontiguousarray(idx), "scores": np.round(vals, 6)})
    decoded = jax_wire.decode_result(body)
    assert decoded == {"ok": True, "n_rows": 32, "indices": idx.tolist(),
                       "scores": np.round(vals, 6).tolist()}
    assert wire.decode_result(body) == decoded


def test_task_payload_from_the_reference_controller_decodes():
    payload = {"texts": ["a", "b ☕", ""], "topk": 3, "model_config": {"d_model": 32}}
    env = jax_wire.encode_task_payload(payload)
    assert wire.is_binary_payload(env)
    assert wire.decode_task_payload(env) == payload


@pytest.mark.parametrize("blob", [
    b"", b"XX\x00\x00", b"AW", b"AW\x01not-zlib", b"AW\x00\x05",
    b"AW\x00\x01\x01a\x09", b"AW\x00\x01\x01a\x02\xff\x00\x00\x00\x00\x00",
    b"AW\x00\x01\x01a\x01\x02\x00\x00\x00\x05",
    b"AW\x00\x01\x01a\x00\x04\x00\x00\x00\xff\xfe\xfd\xfc",
])
def test_malformed_blob_raises_value_error_on_both(blob):
    with pytest.raises(ValueError):
        wire.decode_blob(blob)
    with pytest.raises(ValueError):
        jax_wire.decode_blob(blob)


@pytest.mark.parametrize("data", [
    "!!not base64!!", 12, base64.b64encode(b"XXjunk").decode()])
def test_malformed_envelope_raises_value_error(data):
    with pytest.raises(ValueError):
        wire.decode_task_payload({wire.KEY: data} if isinstance(data, str) else {wire.KEY: "@"})
    with pytest.raises(ValueError):
        wire.unpack_b64(data)


def test_unsupported_dtype_is_refused_like_the_reference():
    for mod in (wire, jax_wire):
        with pytest.raises(ValueError, match="dtype"):
            mod.encode_blob({"x": np.zeros(3, np.float16)})
