"""The six host ops through both registries — ``echo``, ``map_tokenize``,
``read_csv_shard``, ``trigger_sap``, ``trigger_oracle`` and
``risk_accumulate`` — on good and bad payloads give the same results,
timing keys excepted. ``risk_accumulate``'s device path runs on the JAX CPU
runtime and on the port's CPU runtime: the sum within the reference's
documented ``n · 2⁻²⁴`` relative bound of ``math.fsum``, min and max equal
(subnormals, NaN and overflow included) and equal to the f32 rounding of
the host path's."""

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from agent_tpu.ops import get_op as jax_get_op
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import get_runtime as jax_get_runtime
from agent_tpu_torch.ops import load_ops
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime

HOST_OPS = ("echo", "map_tokenize", "read_csv_shard", "trigger_sap", "trigger_oracle",
            "risk_accumulate")
TIMING_KEYS = ("compute_time_ms",)


def _same(a, b) -> bool:
    """Equality with NaN equal to NaN, through nested dicts and lists."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _strip(out):
    return {k: v for k, v in out.items() if k not in TIMING_KEYS} \
        if isinstance(out, dict) else out


@pytest.fixture(scope="module")
def port_ops():
    return load_ops(list(HOST_OPS))


def _both(port_ops, op, payload, port_ctx=None, jax_ctx=None):
    got = port_ops[op](json.loads(json.dumps(payload)) if isinstance(payload, dict)
                       else payload, port_ctx)
    want = jax_get_op(op)(json.loads(json.dumps(payload)) if isinstance(payload, dict)
                          else payload, jax_ctx)
    return _strip(got), _strip(want)


def test_registry_serves_the_six_host_ops_and_the_model_ops():
    ops = load_ops(list(HOST_OPS) + ["map_classify_tpu", "map_summarize", "train_classifier"])
    assert len(ops) == 9 and all(callable(f) for f in ops.values())


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(["<pad>", "<bos>", "<eos>", "<unk>", "hello", "world", "wor",
                               "##ld", "h", "##e", "##l", "##o", ",", "!"]) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def rows_csv(tmp_path_factory):
    path = tmp_path_factory.mktemp("csv") / "rows.csv"
    lines = ["id,text,risk"] + [f'{i},"row {i}, text",{i * 0.5}' for i in range(25)]
    lines.append('25,"line one\nline two",12.5')
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


CASES = {
    "echo": [None, {}, {"a": [1, "x", {"b": None}]}],
    "map_tokenize": [
        {"text": "hello world ☕"}, {"data": "abc", "chunk_size": 2},
        {"items": ["a", "", "longer item"], "chunk_size": 3},
        {"text": "abcdefg", "mode": "chars", "chunk_size": 3},
        {"items": ["abc", "de"], "mode": "chars", "chunk_size": 2},
        {"text": "hello, world!", "tokenizer": "wordpiece", "vocab_path": "VOCAB"},
        {"items": ["Hello helo", "worldx"], "tokenizer": "wordpiece", "vocab_path": "VOCAB"},
        {"text": "x", "chunk_size": 0}, {"text": "x", "chunk_size": "2"},
        {"text": "x", "mode": "words"}, {"items": "nope"}, {"items": [1]}, {},
        {"text": "x", "tokenizer": "nope"}, {"text": "x", "tokenizer": "wordpiece"},
        {"text": "x", "tokenizer": "wordpiece", "vocab_path": "/nonexistent/vocab.txt"},
        {"text": "x", "tokenizer": "bpe"}, "not a dict",
    ],
    "read_csv_shard": [
        {"source_uri": "CSV"}, {"source_uri": "CSV", "start_row": 20, "shard_size": 10},
        {"source_uri": "CSV", "mode": "count", "start_row": 24},
        {"source_uri": "CSV", "start_row": 99}, {"payload": {"source_uri": "CSV"}},
        {"source_uri": "file://CSV", "dataset_id": "d1", "shard_size": 3},
        {"source_uri": "CSV", "mode": "bad"}, {"source_uri": "CSV", "start_row": -1},
        {"source_uri": "CSV", "shard_size": 0}, {"source_uri": ""}, {},
        {"source_uri": "/nonexistent/rows.csv"}, "not a dict",
    ],
    "trigger_sap": [
        {"material": "M-1", "text": "x" * 60}, {"material": "M-1", "event_type": "other"},
        {"material": ""}, {"material": 3}, {}, "not a dict",
    ],
    "trigger_oracle": [
        {"item": "I-1", "qty": 2.5}, {"item": "I-1", "event": "receipt"},
        {"item": "I-1", "qty": True}, {"item": "I-1", "qty": "2"}, {"item": ""}, "x",
    ],
    "risk_accumulate": [
        {"values": [1.5, -2.0, 3.25]}, {"values": []},
        {"items": [{"risk": 1.0}, {"risk": None}, {"other": 2}, {"risk": 4}]},
        {"items": [{"w": 2.0}], "field": "w"}, {"values": [1.0, float("nan"), 3.0]},
        {"values": [float("inf"), -float("inf")]},
        {"source_uri": "CSV", "field": "risk", "shard_size": 10},
        {"source_uri": "CSV", "field": "id", "start_row": 5},
        {"partials": [{"count": 2, "sum": 3.0, "min": 1.0, "max": 2.0},
                      {"count": 0}, {"count": 1, "sum": -1.0, "min": -1.0, "max": -1.0}]},
        {"partials": [{"count": 1, "sum": float("nan"), "min": 1.0, "max": 1.0}]},
        {"partials": []}, {"partials": "x"}, {"partials": [{"count": -1}]},
        {"partials": [{"count": 1, "sum": "a", "min": 1, "max": 1}]},
        {"values": [1, "2"]}, {"values": "x"}, {"items": [1]}, {"items": [{"risk": "x"}]},
        {"values": [1.0], "device_threshold": 0}, {"values": [1.0], "device_threshold": True},
        {}, "not a dict",
    ],
}
PARAMS = [(op, i) for op, cases in CASES.items() for i in range(len(cases))]


def _fill(payload, rows_csv, vocab):
    text = json.dumps(payload).replace("VOCAB", vocab).replace("CSV", rows_csv)
    return json.loads(text)


@pytest.mark.parametrize("op,i", PARAMS, ids=[f"{op}-{i}" for op, i in PARAMS])
def test_host_op_matches_the_reference(port_ops, rows_csv, vocab, monkeypatch, op, i):
    for var in ("SAP_HOST", "ORACLE_HOST"):
        monkeypatch.delenv(var, raising=False)
    payload = _fill(CASES[op][i], rows_csv, vocab)
    got, want = _both(port_ops, op, payload)
    assert _same(got, want), (got, want)


@pytest.mark.parametrize("op,i", [(op, i) for op, i in PARAMS if op == "risk_accumulate"])
def test_host_ops_in_a_context_without_runtime(port_ops, rows_csv, vocab, op, i):
    """The ops that stamp rows take a context; without a runtime they stay
    on the host."""
    payload = _fill(CASES[op][i], rows_csv, vocab)
    got, want = _both(port_ops, op, payload, OpContext(), JaxOpContext())
    assert _same(got, want), (got, want)


def test_bpe_with_a_vocab_is_refused_softly(port_ops, tmp_path):
    """``tokenizer: "bpe"`` with a vocab directory is served now (it was
    refused until the port had the BPE tokenizer): the reference's result
    for a real vocab, and its soft error for a directory with no vocab
    (tests/test_torch_bpe.py holds the ids to the reference's on a Unicode
    corpus)."""
    import chip_smoke

    chip_smoke.write_bpe_vocab(str(tmp_path), 300, 2)
    for payload in ({"text": "Hello, wörld ٣² 😀", "tokenizer": "bpe",
                     "vocab_path": str(tmp_path)},
                    {"text": "x", "tokenizer": "bpe", "vocab_path": str(tmp_path / "none")}):
        got, want = _both(port_ops, "map_tokenize", payload)
        assert _same(got, want), (got, want)
    assert got["ok"] is False


class _Recorder(BaseHTTPRequestHandler):
    seen: list = []

    def do_POST(self):  # noqa: N802 — http.server's name
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.seen.append((self.path, self.headers.get("Authorization"), json.loads(body)))
        self.send_response(201 if "QualityNotification" in self.path else 500)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture
def webhook():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("op,payload,env", [
    ("trigger_sap", {"material": "M-9", "text": "bad batch"}, {"SAP_USER": "u", "SAP_PASS": "p"}),
    ("trigger_oracle", {"item": "I-9", "qty": 3}, {"ORA_USER": "o", "ORA_PASS": "q"}),
], ids=["sap", "oracle"])
def test_triggers_post_like_the_reference(port_ops, webhook, monkeypatch, op, payload, env):
    host_var = "SAP_HOST" if op == "trigger_sap" else "ORACLE_HOST"
    monkeypatch.setenv(host_var, webhook)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _Recorder.seen.clear()
    got, want = _both(port_ops, op, payload)
    assert got == want and got["status"] in (201, 500)
    (p1, auth1, body1), (p2, auth2, body2) = _Recorder.seen
    assert (p1, auth1, body1) == (p2, auth2, body2) and auth1.startswith("Basic ")
    # A dead host is a soft failure on both sides.
    monkeypatch.setenv(host_var, "http://127.0.0.1:9")
    got, want = _both(port_ops, op, payload)
    assert got["ok"] is False and want["ok"] is False and got["request"] == want["request"]


# ---- risk_accumulate's device path ----

N_DEVICE = 4096 + 37


def _device_values(case: str):
    rng = np.random.default_rng(11)
    v = rng.standard_normal(N_DEVICE) * 1e3
    if case == "positive":
        v = np.abs(v) + 1.0
    elif case == "subnormal":
        v = rng.uniform(-1, 1, N_DEVICE) * 1e-40
        v[:4] = [1.4e-45, -1.4e-45, 2.9e-44, -3e-39]
    elif case == "nan":
        v[100] = np.nan
    elif case == "overflow":
        v[7] = 1e39
    elif case == "underflow_min":
        v[9] = -1e39
    elif case == "both_overflow":
        v[7], v[9] = 1e39, -1e39
    return [float(x) for x in v]


@pytest.fixture(scope="module")
def runtimes():
    return TorchRuntime(device="cpu"), jax_get_runtime()


@pytest.mark.parametrize("case", ["mixed", "positive", "subnormal", "nan", "overflow",
                                  "underflow_min", "both_overflow"])
def test_risk_device_paths_agree(port_ops, runtimes, case):
    port_rt, jax_rt = runtimes
    values = _device_values(case)
    payload = {"values": values}
    got = port_ops["risk_accumulate"](dict(payload), OpContext(runtime=port_rt))
    want = jax_get_op("risk_accumulate")(dict(payload), JaxOpContext(runtime=jax_rt))
    host = port_ops["risk_accumulate"](dict(payload))
    assert got["device"] == want["device"] == "mesh" and "device" not in host
    assert got["count"] == want["count"] == N_DEVICE
    for key in ("min", "max"):
        assert _same(got[key], want[key]), (key, got[key], want[key])
        with np.errstate(over="ignore"):  # past the f32 range rounds to inf
            assert _same(got[key], float(np.float32(host[key]))), key
    exact = host["sum"]
    if math.isnan(exact):
        assert math.isnan(got["sum"]) and math.isnan(want["sum"])
        return
    beyond = [v for v in values if abs(v) > float(np.finfo(np.float32).max)]
    if beyond:
        # A value past the f32 range stays a detectable inf (NaN with both signs).
        signs = {math.copysign(1.0, v) for v in beyond}
        want_sum = float("nan") if len(signs) == 2 else signs.pop() * float("inf")
        assert _same(got["sum"], want_sum) and _same(want["sum"], want_sum)
        return
    bound = N_DEVICE * 2.0 ** -24 * math.fsum(abs(v) for v in values)
    assert abs(got["sum"] - exact) <= bound
    if case != "subnormal":
        # XLA's CPU reduction flushes subnormals to zero (the reason the
        # reference takes min/max on integer keys), so the reference's own
        # sum of a subnormal shard is 0; the port's float sum keeps them.
        assert abs(want["sum"] - exact) <= bound
    assert math.isclose(got["mean"], got["sum"] / N_DEVICE)


def test_risk_device_path_takes_the_threshold(port_ops, runtimes):
    port_rt, _ = runtimes
    small = port_ops["risk_accumulate"]({"values": [1.0] * 100}, OpContext(runtime=port_rt))
    forced = port_ops["risk_accumulate"]({"values": [1.0] * 100, "device_threshold": 50},
                                         OpContext(runtime=port_rt))
    assert "device" not in small and forced["device"] == "mesh" and forced["sum"] == 100.0


def test_risk_device_path_refuses_dp_softly(port_ops):
    """A dp mesh reduces on the device too now, each dp shard its slice."""
    values = [float(v) for v in np.random.default_rng(5).normal(size=5000)]
    rt = TorchRuntime(devices=["cpu"] * 2, mesh_shape={"dp": 2})
    out = port_ops["risk_accumulate"]({"values": values}, OpContext(runtime=rt))
    host = port_ops["risk_accumulate"]({"values": values})
    assert out["ok"] is True and out["device"] == "mesh" and out["count"] == 5000
    assert out["min"] == np.float32(min(values)) and out["max"] == np.float32(max(values))
    assert abs(out["sum"] - host["sum"]) <= 5000 * 2.0 ** -24 * sum(abs(v) for v in values)


# ---- mesh_reduce_stats over dp ----

_STATS_CASES = {
    "ramp": [float(i) * 0.5 - 7.0 for i in range(100)],
    "single": [3.25],
    "subnormal": [-1.401298464324817e-45, 0.0, 1.401298464324817e-45],
    "nan": [5.0, 1.0, float("nan")],
    "inf": [float("inf"), float("-inf"), 2.0],
    "double-single": [2.0**26 + 0.1875 * (i % 8) for i in range(1000)],
    "overflow": [1e39] + [1.0] * 1023,
}


@pytest.mark.parametrize("case", sorted(_STATS_CASES))
@pytest.mark.parametrize("dp", [2, 4, 8])
def test_mesh_reduce_stats_over_dp_matches_the_reference(case, dp):
    """The reference's own cases (tests/test_collectives.py) on a dp mesh of
    2, 4 and 8 shards against the reference on its 8-device mesh: count,
    min and max equal (the f32 rounding of the extremes, subnormals
    included; NaN in, NaN out), the sum within the reference's f32
    accumulation bound of its own (an overflow stays inf)."""
    from agent_tpu.config import DeviceConfig
    from agent_tpu.parallel.collectives import mesh_reduce_stats as jax_stats
    from agent_tpu.runtime.runtime import TpuRuntime
    from agent_tpu_torch.parallel.collectives import mesh_reduce_stats

    values = _STATS_CASES[case]
    got = mesh_reduce_stats(TorchRuntime(devices=["cpu"] * dp, mesh_shape={"dp": dp}), values)
    want = jax_stats(TpuRuntime(DeviceConfig()), values)
    assert got["count"] == want["count"] == len(values)
    for key in ("min", "max", "sum", "mean"):
        g, w = got[key], want[key]
        if math.isnan(w) or math.isinf(w):
            assert (math.isnan(g) and math.isnan(w)) or g == w, (key, g, w)
        elif key in ("min", "max"):
            assert g == w, (key, g, w)
        else:
            bound = len(values) * 2.0 ** -24 * math.fsum(abs(v) for v in values)
            assert abs(g - w) <= bound, (key, g, w)
    if case == "double-single":
        assert got["sum"] == pytest.approx(math.fsum(values), rel=1e-7)
