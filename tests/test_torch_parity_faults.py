"""Six places where the port once parted from the reference, each held to it
by running both packages' ops on the CPU with the same payload and the same
environment and asserting the same outcome: served, a soft ``bad_input``
(with the same message where the port has the feature), or an exception of
the same type.

1. ``model_config.dtype`` names: those ``jnp.dtype`` takes for a float type
   serve and train (float16 through dense attention, float64 as float32, as
   JAX computes it without x64); names it does not know raise its TypeError;
   ``int8`` raises the OverflowError of the reference's cast of -1e9 to it.
   A ``max_len`` of 0 raises the reference's ValueError (a max over no key).
2. A ``quant`` key in the payload wins over ``TPU_QUANT``.
3. A bad ``TPU_QUANT`` raises RuntimeError (the shard fails and is retried).
4. ``train_classifier`` with ``int8``/``w8a16`` and no MoE trains float
   weights and carries the mode in its result's ``model_config``.
5. ``SUMMARIZE_FORCE_CPU`` reads the reference's truthy tokens.
6. ``TPU_CHUNK_TOKENS`` sets the dense-path dispatch budget.
"""

import numpy as np
import pytest
import torch

import jax

from agent_tpu.config import DeviceConfig, OpsConfig
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.ops._model_common import split_padded_chunk as jax_split
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import TpuRuntime
from agent_tpu_torch.models import layers
from agent_tpu_torch.ops import _model_common as common
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

OPS = ("map_classify_tpu", "map_summarize", "train_classifier")
ENC = {"d_model": 32, "n_heads": 2, "n_layers": 1, "d_ff": 64, "max_len": 32, "n_classes": 5}
S2S = {"d_model": 32, "n_heads": 2, "n_enc_layers": 1, "n_dec_layers": 1, "d_ff": 64,
       "max_src_len": 32, "max_tgt_len": 8}
TEXTS = ["hello world", "a second row of text", "x"]
# Probabilities of a tiny float16 model: both packages round every layer to
# float16 (11-bit mantissa) at the same places, but sums in another order
# land values on the other side of a rounding boundary.
SCORE_TOL = {"float16": 2e-2, "half": 2e-2, "float64": 1e-4}


@pytest.fixture(scope="module")
def jax_ctx():
    rt = TpuRuntime(config=DeviceConfig(tpu_disabled=True, mesh_shape={"dp": 1}),
                    devices=jax.devices("cpu")[:1])
    return JaxOpContext(runtime=rt)


@pytest.fixture(scope="module")
def port_ctx():
    return OpContext(runtime=TorchRuntime(device="cpu"))


@pytest.fixture(scope="module")
def port_ops():
    return load_ops(list(OPS))


def _payload(op: str, model_config: dict, tmp_path) -> dict:
    if op == "map_classify_tpu":
        return {"texts": TEXTS, "topk": 5, "model_config": dict(ENC, **model_config)}
    if op == "map_summarize":
        return {"texts": TEXTS, "max_length": 4, "model_config": dict(S2S, **model_config)}
    return {"texts": ["a b", "c d"] * 4, "labels": [0, 1] * 4, "epochs": 1, "batch_size": 4,
            "output_path": str(tmp_path / "m.npz"), "model_config": dict(ENC, **model_config)}


def _outcome(fn):
    """("served", result) | ("soft", error message) | ("raised", exception)."""
    try:
        out = fn()
    except Exception as exc:  # noqa: BLE001 — the exception is the outcome
        return "raised", exc
    return ("served", out) if out.get("ok") else ("soft", out["error"])


def _both(op, payload, port_ops, port_ctx, jax_ctx):
    got = _outcome(lambda: port_ops[op](dict(payload), port_ctx))
    want = _outcome(lambda: jax_get_op(op)(dict(payload), jax_ctx))
    return got, want


def _assert_same_outcome(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] == "raised":
        assert type(got[1]) is type(want[1]), (got, want)
        assert str(got[1]) == str(want[1])
    elif got[0] == "soft":
        assert got[1] == want[1]


def _scores(result):
    return np.asarray([[e["score"] for e in r["topk"]] for r in result["results"]])


# ---- 1. dtype names ------------------------------------------------------------

@pytest.mark.parametrize("name", ["bfloat16", "float32", "float16", "half", "bf16", "fp16",
                                  "float64", "int8"])
@pytest.mark.parametrize("op", OPS)
def test_dtype_names_match_reference(op, name, port_ops, port_ctx, jax_ctx, tmp_path):
    got, want = _both(op, _payload(op, {"dtype": name}, tmp_path), port_ops, port_ctx, jax_ctx)
    _assert_same_outcome(got, want)
    if got[0] == "served" and op == "map_classify_tpu" and name in SCORE_TOL:
        np.testing.assert_allclose(_scores(got[1]), _scores(want[1]), atol=SCORE_TOL[name])
    if got[0] == "served" and op == "train_classifier":
        assert got[1]["model_config"]["dtype"] == want[1]["model_config"]["dtype"] == name


@pytest.mark.parametrize("op", OPS)
def test_max_len_zero_raises_as_the_reference(op, port_ops, port_ctx, jax_ctx, tmp_path):
    """Classify and train raise the reference's ValueError; summarize's
    config has no max_len and serves."""
    got, want = _both(op, _payload(op, {"max_len": 0, "dtype": "float32"}, tmp_path),
                      port_ops, port_ctx, jax_ctx)
    _assert_same_outcome(got, want)
    assert got[0] == ("served" if op == "map_summarize" else "raised")


@pytest.mark.parametrize("name,want", [
    ("bfloat16", torch.bfloat16), ("float32", torch.float32), ("single", torch.float32),
    ("f4", torch.float32), ("float16", torch.float16), ("half", torch.float16),
    ("f2", torch.float16), ("float64", torch.float32), ("double", torch.float32),
])
def test_compute_dtype_takes_jnp_float_names(name, want):
    assert layers.compute_dtype(name) is want


@pytest.mark.parametrize("name", ["bf16", "fp16", "int8", "bool"])
def test_compute_dtype_refuses_what_jnp_refuses_or_is_no_float(name):
    with pytest.raises(TypeError):
        layers.compute_dtype(name)


def test_float16_classify_takes_dense_attention(port_ops, port_ctx, tmp_path):
    from agent_tpu_torch.kernels import flash_attention as fa

    before = dict(fa.SELECTION_COUNTS)
    out = port_ops["map_classify_tpu"](_payload("map_classify_tpu", {"dtype": "float16"},
                                                tmp_path), port_ctx)
    assert out["ok"]
    assert fa.SELECTION_COUNTS["dense"] == before["dense"] + ENC["n_layers"]
    assert fa.SELECTION_COUNTS["flash"] == before["flash"]


# ---- 2, 3. quant precedence and a bad TPU_QUANT --------------------------------

SERVING = ("map_classify_tpu", "map_summarize")


@pytest.mark.parametrize("op", SERVING)
def test_payload_quant_none_wins_over_env(op, port_ops, port_ctx, jax_ctx, tmp_path,
                                          monkeypatch):
    monkeypatch.setenv("TPU_QUANT", "int8")
    payload = _payload(op, {"dtype": "float32", "quant": "none"}, tmp_path)
    got, want = _both(op, payload, port_ops, port_ctx, jax_ctx)
    _assert_same_outcome(got, want)
    assert got[0] == "served"
    if op == "map_classify_tpu":
        np.testing.assert_allclose(_scores(got[1]), _scores(want[1]), atol=1e-4)


@pytest.mark.parametrize("env", ["int8", "int8x", "none"])
@pytest.mark.parametrize("op", SERVING)
def test_bad_payload_quant_is_soft_whatever_the_env(op, env, port_ops, port_ctx, jax_ctx,
                                                    tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_QUANT", env)
    got, want = _both(op, _payload(op, {"quant": "int8x"}, tmp_path), port_ops, port_ctx,
                      jax_ctx)
    _assert_same_outcome(got, want)
    assert got[0] == "soft"


@pytest.mark.parametrize("env", ["int8x", "fp8", "INT4"])
@pytest.mark.parametrize("op", SERVING)
def test_bad_tpu_quant_env_raises(op, env, port_ops, port_ctx, jax_ctx, tmp_path,
                                  monkeypatch):
    monkeypatch.setenv("TPU_QUANT", env)
    got, want = _both(op, _payload(op, {}, tmp_path), port_ops, port_ctx, jax_ctx)
    _assert_same_outcome(got, want)
    assert got[0] == "raised" and isinstance(got[1], RuntimeError)


def test_resolve_quant_order(monkeypatch):
    cfg = type("Cfg", (), {"quant": "none"})()
    monkeypatch.delenv("TPU_QUANT", raising=False)
    assert common.resolve_quant({}, cfg) == "none"
    monkeypatch.setenv("TPU_QUANT", " W8A16 ")
    assert common.resolve_quant({}, cfg) == "w8a16"
    assert common.resolve_quant({"model_config": {"quant": "none"}}, cfg) == "none"
    with pytest.raises(ValueError, match="quant must be one of"):
        common.resolve_quant({"model_config": {"quant": "w8"}}, cfg)


# ---- 4. train_classifier with quant --------------------------------------------

@pytest.mark.parametrize("quant", ["int8", "w8a16"])
def test_train_quant_without_moe_trains(quant, port_ops, port_ctx, jax_ctx, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv("TPU_QUANT", "int8x")  # neither package's train reads it
    payload = _payload("train_classifier", {"dtype": "float32", "quant": quant}, tmp_path)
    got, want = _both("train_classifier", payload, port_ops, port_ctx, jax_ctx)
    _assert_same_outcome(got, want)
    assert got[0] == "served"
    assert got[1]["model_config"]["quant"] == want[1]["model_config"]["quant"] == quant
    np.testing.assert_allclose(got[1]["last_epoch_loss"], want[1]["last_epoch_loss"],
                               rtol=1e-3)


@pytest.mark.parametrize("quant", ["int8", "w8a16"])
def test_train_quant_with_moe_is_refused(quant, port_ops, port_ctx, jax_ctx, tmp_path):
    payload = _payload("train_classifier", {"quant": quant, "moe_experts": 2}, tmp_path)
    got, want = _both("train_classifier", payload, port_ops, port_ctx, jax_ctx)
    _assert_same_outcome(got, want)
    assert got[0] == "soft"


# ---- 5. SUMMARIZE_FORCE_CPU ------------------------------------------------------

class _BrokenRuntime:
    """A context whose runtime cannot be had: only a forced CPU run serves."""

    def __init__(self):
        self.tags = {}
        self.runtime = None

    def require_runtime(self):
        raise RuntimeError("device wedged")


@pytest.mark.parametrize("value", ["1", "true", "yes", "on", "y", "Y", " On ", "0", "no",
                                   "off", "n", "", "2"])
def test_force_cpu_reads_the_reference_truthy_tokens(value, port_ops, jax_ctx, tmp_path,
                                                     monkeypatch):
    monkeypatch.setenv("SUMMARIZE_FORCE_CPU", value)
    forced = OpsConfig.from_env().summarize_force_cpu
    payload = _payload("map_summarize", {"dtype": "float32"}, tmp_path)
    want = _outcome(lambda: jax_get_op("map_summarize")(dict(payload), jax_ctx))
    assert want[0] == "served"
    got = _outcome(lambda: port_ops["map_summarize"](dict(payload), _BrokenRuntime()))
    if forced:
        assert got[0] == "served" and got[1]["device"] == "cpu", got
        assert got[1]["summaries"] == want[1]["summaries"]
    else:
        assert got[0] == "raised" and "device wedged" in str(got[1])


# ---- 6. TPU_CHUNK_TOKENS -------------------------------------------------------

@pytest.mark.parametrize("env,dp", [("", 2), (str(16 * 128), 2), ("8", 4), ("512", 1),
                                    ("100000", 1)])
def test_chunk_budget_splits_like_the_reference(env, dp, monkeypatch):
    """The reference's cases (tests/test_map_classify.py:255-291) on a chunk
    whose attention takes the dense path in both packages (float16)."""
    monkeypatch.setenv("TPU_CHUNK_TOKENS", env)
    ids = np.arange(64 * 128, dtype=np.uint16).reshape(64, 128)
    lengths = np.full(64, 128, dtype=np.int32)
    lengths[50:] = 0  # 50 real rows, 14 padding rows
    got = common.split_padded_chunk(ids, lengths, 50, dp, 64, torch.float16)
    want = jax_split(ids, lengths, 50, dp=dp)
    assert [(g[0].shape, g[2]) for g in got] == [(w[0].shape, w[2]) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def test_chunk_token_budget_reads_env(monkeypatch):
    monkeypatch.delenv("TPU_CHUNK_TOKENS", raising=False)
    assert common.chunk_token_budget() == common.DENSE_CHUNK_TOKENS
    monkeypatch.setenv("TPU_CHUNK_TOKENS", " 4096 ")
    assert common.chunk_token_budget() == 4096


def test_kernel_path_chunks_stay_whole(monkeypatch):
    monkeypatch.setenv("TPU_CHUNK_TOKENS", "128")
    ids = np.zeros((8, 3000), dtype=np.uint16)
    out = common.split_padded_chunk(ids, np.ones(8, np.int32), 8, 1, 64, torch.bfloat16)
    assert len(out) == 1


def test_split_dispatch_results_align(port_ops, port_ctx, jax_ctx, monkeypatch):
    """A dense-path request split by TPU_CHUNK_TOKENS returns what the
    unsplit dispatch returns, and what the reference returns split the same
    way."""
    texts = ["split alignment row %03d" % i for i in range(37)]
    payload = {"texts": texts, "topk": 3, "model_config": dict(ENC, dtype="float16")}
    staged = port_ops["map_classify_tpu"].stage(dict(payload))[1]["chunks"]
    whole = port_ops["map_classify_tpu"](dict(payload), port_ctx)
    monkeypatch.setenv("TPU_CHUNK_TOKENS", "512")
    split = port_ops["map_classify_tpu"].stage(dict(payload))[1]["chunks"]
    assert len(staged) == 1 and len(split) > 1
    assert sum(c[2] for c in split) == len(texts)
    got = port_ops["map_classify_tpu"](dict(payload), port_ctx)
    want = jax_get_op("map_classify_tpu")(dict(payload), jax_ctx)
    np.testing.assert_allclose(_scores(got), _scores(whole), atol=SCORE_TOL["float16"])
    np.testing.assert_allclose(_scores(got), _scores(want), atol=SCORE_TOL["float16"])
