"""train_classifier through the port's registry on a CPU TorchRuntime must
do what the JAX op does on a one-device JAX CPU runtime for the same
payload: the same split, batches and step count, the same holdout
accuracy, epoch losses and weights within f32 tolerance, an artifact that
serves through either package's map_classify_tpu, and the same soft
errors (tests/test_train_lifecycle.py:145-170).

The model is tiny and f32 with d_head 32, so the port's attention takes
the flash path (its plain versions on the CPU) where the reference's CPU
runtime trains with dense attention. Tolerances: epoch losses within 1e-3
relative and weights within 1e-3 absolute after 40 AdamW steps at lr
1e-2, since two f32 implementations that sum in another order drift
apart step by step."""

import json

import numpy as np
import pytest
import torch

import jax

from agent_tpu.config import DeviceConfig
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import TpuRuntime
from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)

# The two keyword "languages" of tests/test_train_lifecycle.py:11-14.
WORDS = {
    0: ["invoice", "payment", "ledger", "account", "balance"],
    1: ["sensor", "voltage", "telemetry", "actuator", "signal"],
}
SMALL = {"d_model": 64, "n_heads": 2, "n_layers": 2, "d_ff": 128, "max_len": 64,
         "dtype": "float32"}
PAYLOAD = {"model_config": SMALL, "epochs": 10, "batch_size": 32, "learning_rate": 1e-2,
           "seed": 1}
REL_TOL = ATOL = 1e-3


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for i in range(n):
        texts.append(" ".join(rng.choice(WORDS[i % 2], size=4)))
        labels.append(i % 2)
    return texts, labels


@pytest.fixture(scope="module")
def jax_ctx():
    rt = TpuRuntime(config=DeviceConfig(tpu_disabled=True, mesh_shape={"dp": 1}),
                    devices=jax.devices("cpu")[:1])
    return JaxOpContext(runtime=rt)


@pytest.fixture(scope="module")
def port_rt():
    return TorchRuntime(device="cpu")


@pytest.fixture(scope="module")
def train():
    return load_ops(["train_classifier"])["train_classifier"]


@pytest.fixture(scope="module")
def trained(train, port_rt, jax_ctx, tmp_path_factory):
    """Both ops on one payload: (port result, JAX result, port ctx)."""
    d = tmp_path_factory.mktemp("train")
    texts, labels = _rows(160)
    payload = dict(PAYLOAD, texts=texts, labels=labels)
    ctx = OpContext(runtime=port_rt)
    launches = dict(fa.LAUNCH_COUNTS)
    got = train(dict(payload, output_path=str(d / "port.npz")), ctx)
    assert fa.LAUNCH_COUNTS == launches  # the CPU never launches a kernel
    want = jax_get_op("train_classifier")(dict(payload, output_path=str(d / "jax.npz")),
                                           jax_ctx)
    return got, want, ctx


def test_result_matches_jax(trained):
    got, want, ctx = trained
    assert got["ok"] and want["ok"]
    assert set(got) == set(want)
    assert got["device"] == "cpu"
    for key in ("n_train", "n_eval", "n_steps", "eval_accuracy"):
        assert got[key] == want[key], key
    assert got["n_steps"] == 10 * 4 and got["eval_accuracy"] > 0.9
    for key in ("first_epoch_loss", "last_epoch_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=REL_TOL, err_msg=key)
    assert got["last_epoch_loss"] < got["first_epoch_loss"]
    losses = ctx.tags["train"]["epoch_losses"]
    assert len(losses) == 10 and losses[0] == got["first_epoch_loss"] \
        and losses[-1] == got["last_epoch_loss"]
    assert got["model_config"]["n_classes"] == 2


def test_artifact_matches_jax(trained):
    got, want, _ = trained
    with np.load(got["output_path"]) as a, np.load(want["output_path"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == np.float32 and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=ATOL, err_msg=k)


def _accuracy(result, labels):
    return float(np.mean([row[0] == lab for row, lab in zip(result["indices"], labels)]))


def test_artifact_serves_through_port_classify(trained, port_rt):
    got, _, _ = trained
    texts, labels = _rows(32, seed=99)  # unseen combinations
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    served = classify({"texts": texts, "topk": 1, "model_path": got["output_path"],
                       "model_config": got["model_config"], "result_format": "columnar"},
                      OpContext(runtime=port_rt))
    assert served["ok"] and served["device"] == "cpu"
    assert _accuracy(served, labels) > 0.9


def test_artifact_loads_and_serves_in_jax(trained, jax_ctx):
    got, _, _ = trained
    texts, labels = _rows(32, seed=99)
    served = jax_get_op("map_classify_tpu")(
        {"texts": texts, "topk": 1, "model_path": got["output_path"],
         "model_config": got["model_config"], "allow_fallback": False,
         "result_format": "columnar"}, jax_ctx)
    assert served["ok"], served
    assert _accuracy(served, labels) > 0.9


def test_string_labels_and_sidecar(train, port_rt, tmp_path):
    texts, labels = _rows(20)
    names = {0: "finance", 1: "iot"}
    path = str(tmp_path / "s.npz")
    out = train({"texts": texts, "labels": [names[x] for x in labels], "output_path": path,
                 "model_config": SMALL, "epochs": 1, "batch_size": 8},
                OpContext(runtime=port_rt))
    assert out["ok"] and out["label_names"] == ["finance", "iot"]
    with open(path + ".labels.json", encoding="utf-8") as f:
        assert json.load(f) == ["finance", "iot"]


def test_tiny_dataset_smaller_than_batch_and_warm_start(train, port_rt, trained, tmp_path):
    """n_train < batch still trains (batches tile); init_from warm-starts
    from an artifact (tests/test_train_lifecycle.py:127-142)."""
    texts, labels = _rows(13)
    out = train({"texts": texts, "labels": labels, "output_path": str(tmp_path / "t.npz"),
                 "model_config": SMALL, "epochs": 1, "batch_size": 64,
                 "init_from": trained[0]["output_path"]}, OpContext(runtime=port_rt))
    assert out["ok"] and out["n_train"] + out["n_eval"] == 13 and out["n_steps"] == 1
    assert out["eval_accuracy"] is not None


def test_missing_warm_start_rejected(train, jax_ctx, tmp_path):
    payload = {"texts": ["a", "b"], "labels": [0, 1], "output_path": str(tmp_path / "w.npz"),
               "init_from": str(tmp_path / "does_not_exist.npz")}
    for out in (train(dict(payload)), jax_get_op("train_classifier")(dict(payload), jax_ctx)):
        assert out["ok"] is False and "not found" in out["error"]


BAD = {
    "no_output_path": {"texts": ["a"], "labels": [0]},
    "not_npz": {"output_path": "x.txt", "texts": ["a"], "labels": [0]},
    "no_rows": {"output_path": "OK"},
    "length_mismatch": {"output_path": "OK", "texts": ["a"], "labels": [0, 1]},
    "label_over_n_classes": {"output_path": "OK", "texts": ["a"], "labels": [5],
                             "model_config": {"n_classes": 2}},
    "zero_epochs": {"output_path": "OK", "texts": ["a"], "labels": [0], "epochs": 0},
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_payloads_soft_fail_like_jax(train, jax_ctx, tmp_path, case):
    payload = {k: (str(tmp_path / "x.npz") if v == "OK" else v) for k, v in BAD[case].items()}
    got = train(dict(payload))
    want = jax_get_op("train_classifier")(dict(payload), jax_ctx)
    assert got["ok"] is False and want["ok"] is False
    assert got["error"] == want["error"]


TINY_TRAIN = {"texts": ["a b", "c d"] * 4, "labels": [0, 1] * 4, "epochs": 1, "batch_size": 4}
TINY = {"d_model": 32, "n_heads": 2, "n_layers": 1, "d_ff": 64, "max_len": 16}


# quant and float16 were refused until the port took the reference's
# behaviour: quant trains float weights and rides in model_config, float16
# trains through dense attention. Those cases (needle None) train now.
@pytest.mark.parametrize("extra,needle", [
    ({"source_uri": ""}, "source_uri"),  # served now; a malformed address is soft
    (dict(TINY_TRAIN, model_config=dict(TINY, quant="int8")), None),
    # MoE trains now (tests/test_torch_moe.py); MoE with quant stays refused.
    ({"texts": ["a"], "labels": [0], "model_config": {"moe_experts": 4, "quant": "int8"}},
     "MoE training"),
    ({"texts": ["a"], "labels": [0], "model_config": {"pp": 2}}, "pp"),
    (dict(TINY_TRAIN, model_config=dict(TINY, dtype="float16")), None),
    ("not a dict", "dict"),
], ids=["extra0-source_uri", "extra1-quant", "extra2-moe_experts", "extra3-pp",
        "extra4-dtype", "not a dict-dict"])
def test_not_ported_yet_is_soft(train, port_rt, tmp_path, extra, needle):
    payload = extra if isinstance(extra, str) else dict(extra, output_path=str(tmp_path / "x.npz"))
    out = train(payload, OpContext(runtime=port_rt))
    if needle is None:
        assert out["ok"] is True and np.isfinite(out["last_epoch_loss"]), out
        assert out["model_config"]["quant"] == extra["model_config"].get("quant", "none")
        assert out["model_config"]["dtype"] == extra["model_config"].get("dtype", "bfloat16")
    else:
        assert out["ok"] is False and needle in out["error"], out


# ---- CSV rows (source_uri) ----


@pytest.fixture(scope="module")
def train_csv(tmp_path_factory):
    """The keyword rows as a CSV with string labels, and one extra column."""
    texts, labels = _rows(80, seed=5)
    path = tmp_path_factory.mktemp("train_csv") / "train.csv"
    names = {0: "finance", 1: "iot"}
    lines = ["body,topic,extra"] + [f'"{t}",{names[y]},x' for t, y in zip(texts, labels)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("extra", [
    {},
    {"start_row": 10},
    {"start_row": 5, "shard_size": 60},
], ids=["whole_file", "from_row_10", "shard_60"])
def test_source_uri_trains_like_jax(train, port_rt, jax_ctx, train_csv, tmp_path, extra):
    payload = dict(PAYLOAD, epochs=3, source_uri=train_csv, text_field="body",
                   label_field="topic", **extra)
    got = train(dict(payload, output_path=str(tmp_path / "p.npz")), OpContext(runtime=port_rt))
    want = jax_get_op("train_classifier")(dict(payload, output_path=str(tmp_path / "j.npz")),
                                           jax_ctx)
    assert got["ok"] and want["ok"], (got, want)
    for key in ("n_train", "n_eval", "n_steps", "label_names"):
        assert got[key] == want[key], key
    assert got["label_names"] == ["finance", "iot"]
    np.testing.assert_allclose(got["last_epoch_loss"], want["last_epoch_loss"], rtol=REL_TOL)


@pytest.mark.parametrize("extra,exc", [
    ({"text_field": ""}, None),
    ({"label_field": 3}, None),
    ({"start_row": -1}, None),
    ({"text_field": "missing"}, RuntimeError),
    ({"start_row": 500, "shard_size": 5}, RuntimeError),
    ({"source_uri": "/nonexistent/train.csv"}, OSError),
], ids=["empty_text_field", "int_label_field", "neg_start", "no_column", "past_end",
        "no_file"])
def test_source_uri_errors_like_jax(train, port_rt, jax_ctx, train_csv, tmp_path, extra, exc):
    payload = dict(PAYLOAD, source_uri=train_csv, text_field="body", label_field="topic",
                   output_path=str(tmp_path / "x.npz"))
    payload.update(extra)
    if exc is None:  # a malformed address or field: soft, with the reference's message
        got = train(dict(payload), OpContext(runtime=port_rt))
        want = jax_get_op("train_classifier")(dict(payload), jax_ctx)
        assert got["ok"] is False and got["error"] == want["error"]
        return
    with pytest.raises(exc) as want:
        jax_get_op("train_classifier")(dict(payload), jax_ctx)
    with pytest.raises(exc) as got:
        train(dict(payload), OpContext(runtime=port_rt))
    assert type(got.value) is type(want.value)


# ---- dp and tp meshes ----

MESH_PAYLOAD = {"model_config": dict(SMALL, n_heads=4), "epochs": 2, "batch_size": 8,
                "seed": 2}


@pytest.mark.parametrize("shape", [{"dp": 2}, {"tp": 2}, {"dp": 2, "tp": 2}],
                         ids=["dp2", "tp2", "dp2-tp2"])
def test_trains_on_a_mesh_as_the_reference_on_it(train, shape, tmp_path):
    """The port on a dp/tp mesh of CPU shards against the reference on the
    same mesh of virtual devices: epoch losses within 1e-5 relative, the
    gathered ``.npz`` within 1e-5 relative L2 of the reference's, and the
    artifact serves on a one-device runtime as the one-device run's does."""
    n = int(np.prod(list(shape.values())))
    texts, labels = _rows(40, seed=3)
    payload = dict(MESH_PAYLOAD, texts=texts, labels=labels)
    rt = TorchRuntime(devices=["cpu"] * n, mesh_shape=shape)
    got = train(dict(payload, output_path=str(tmp_path / "mesh.npz")), OpContext(runtime=rt))
    jrt = TpuRuntime(config=DeviceConfig(tpu_disabled=True, mesh_shape=shape),
                     devices=jax.devices("cpu")[:n])
    want = jax_get_op("train_classifier")(dict(payload, output_path=str(tmp_path / "jax.npz")),
                                           JaxOpContext(runtime=jrt))
    assert got["ok"] and want["ok"] and got["n_steps"] == want["n_steps"]
    for key in ("first_epoch_loss", "last_epoch_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    with np.load(got["output_path"]) as a, np.load(want["output_path"]) as b:
        assert sorted(a.files) == sorted(b.files)
        diff = np.sqrt(sum(float(np.sum((a[k] - b[k]) ** 2)) for k in b.files))
        norm = np.sqrt(sum(float(np.sum(b[k] ** 2)) for k in b.files))
        assert diff <= 1e-5 * norm, diff / norm
    one = train(dict(payload, output_path=str(tmp_path / "one.npz")),
                OpContext(runtime=TorchRuntime(device="cpu")))
    classify = load_ops(["map_classify_tpu"])["map_classify_tpu"]
    served = [classify({"texts": texts[:8], "model_path": r["output_path"], "topk": 2,
                        "model_config": r["model_config"], "result_format": "columnar"},
                       OpContext(runtime=TorchRuntime(device="cpu"))) for r in (got, one)]
    assert served[0]["indices"] == served[1]["indices"]
    np.testing.assert_allclose(served[0]["scores"], served[1]["scores"], rtol=0, atol=1e-5)
