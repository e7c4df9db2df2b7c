"""The port's six serving ops (``serve_classify``, ``serve_summarize``,
``serve_prefill``, ``serve_decode``, ``summarize_encode``,
``summarize_decode``) against the reference's on the CPU, with the same
payloads, env and seeded weights: the same per-request tokens, summaries
and steps, the same engine telemetry and prefix-cache counters, the same
soft errors. Also: a prefix-cache hit equal to its cold prefill, the
disaggregated prefill -> decode chain equal to the colocated path through
the reference's controller (JSON and ``b1`` wire), the MPMD chain equal to
``map_summarize``, the prefix cache's keys and LRU, the ``ServeConfig``
environment and ``stamp_usage``."""

import time

import numpy as np
import pytest
import torch

from agent_tpu.config import Config as JaxConfig
from agent_tpu.config import FlowConfig
from agent_tpu.config import ServeConfig as JaxServeConfig
from agent_tpu.controller.core import Controller
from agent_tpu.obs.usage import stamp_usage as jax_stamp_usage
from agent_tpu.ops import load_ops as jax_load_ops
from agent_tpu.ops.prefix_cache import PrefixCache as JaxPrefixCache
from agent_tpu.ops.prefix_cache import prefix_key as jax_prefix_key
from agent_tpu.ops.serve_infer import reset_engines as jax_reset_engines
from agent_tpu.runtime.context import OpContext as JaxOpContext
from agent_tpu.runtime.runtime import get_runtime as jax_get_runtime
from agent_tpu_torch.config import Config, ServeConfig
from agent_tpu_torch.data import wire
from agent_tpu_torch.obs.usage import stamp_usage
from agent_tpu_torch.ops import DEVICE_OPS, OP_TO_MODULE, load_ops
from agent_tpu_torch.ops.prefix_cache import PrefixCache, prefix_key
from agent_tpu_torch.ops.serve_infer import reset_engines
from agent_tpu_torch.runtime.context import OpContext
from agent_tpu_torch.runtime.runtime import TorchRuntime
from tests.test_torch_map_classify import _assert_topk_agree

torch.set_num_threads(1)

TINY_S2S = {"d_model": 32, "n_heads": 4, "n_enc_layers": 1, "n_dec_layers": 1, "d_ff": 64,
            "max_src_len": 64, "max_tgt_len": 20, "dtype": "float32"}
TINY_CLS = {"d_model": 32, "n_heads": 4, "n_layers": 1, "d_ff": 64, "max_len": 64,
            "dtype": "float32", "n_classes": 8}
SERVE_OPS = ("serve_classify", "serve_summarize", "serve_prefill", "serve_decode",
             "summarize_encode", "summarize_decode")
TEXTS = ["shared prefix context document alpha for the serving tests",
         "shared prefix context document alpha for the serving tests",
         "a different text to summarize entirely",
         "shared prefix context document alpha for the serving tests",
         "x"]
VOLATILE = ("elapsed_ms", "results", "device")


@pytest.fixture(scope="module")
def torch_rt():
    return TorchRuntime(device="cpu")


@pytest.fixture(scope="module")
def ops():
    return load_ops(list(SERVE_OPS) + ["map_summarize"])


@pytest.fixture(scope="module")
def jax_ops():
    jax_get_runtime()
    return jax_load_ops(list(SERVE_OPS) + ["map_summarize"])


@pytest.fixture(autouse=True)
def fresh_engines():
    """Each test starts from empty engine stores and prefix caches."""
    reset_engines()
    jax_reset_engines()
    yield
    reset_engines()
    jax_reset_engines()


def _ctx(torch_rt, serve=None, wire_fmt=None):
    tags = {"wire": wire_fmt} if wire_fmt else {}
    return OpContext(runtime=torch_rt, tags=tags,
                     config=Config(serve=serve) if serve is not None else None)


def _jax_ctx(serve=None, wire_fmt=None):
    tags = {"wire": wire_fmt} if wire_fmt else {}
    return JaxOpContext(runtime=jax_get_runtime(), tags=tags,
                        config=JaxConfig(serve=serve) if serve is not None else None)


def _payload(num_beams=1, **extra):
    reqs = [{"req_id": f"r{i}", "text": t, "max_length": 3 + 4 * i,
             "arrived_wall": time.time()} for i, t in enumerate(TEXTS)]
    return dict({"requests": reqs, "model_config": TINY_S2S, "num_beams": num_beams,
                 "bucket": 64}, **extra)


def _per_request(result):
    return [{k: r[k] for k in ("req_id", "summary", "tokens", "steps")}
            for r in result["results"]]


def _top(result):
    return {k: v for k, v in result.items() if k not in VOLATILE}


def test_every_reference_op_name_is_registered():
    from agent_tpu.ops import OP_TO_MODULE as JAX_OP_TO_MODULE

    assert set(OP_TO_MODULE) == set(JAX_OP_TO_MODULE)
    assert set(SERVE_OPS) <= DEVICE_OPS
    assert set(load_ops(list(OP_TO_MODULE))) == set(JAX_OP_TO_MODULE)


@pytest.mark.parametrize("micro_steps", [1, 3])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("num_beams,extra", [
    (1, {}), (1, {"min_length": 4}), (3, {}), (2, {"length_penalty": 2.0}),
    (2, {"early_stopping": True, "min_length": 3}),
], ids=["greedy", "greedy-min4", "beam3", "beam2-lp2", "beam2-early-min3"])
def test_serve_summarize_matches_the_reference(ops, jax_ops, torch_rt, num_beams, extra,
                                               layout, micro_steps):
    serve = dict(kv_layout=layout, decode_micro_steps=micro_steps, decode_slots=3,
                 kv_block_size=4)
    payload = _payload(num_beams, **extra)
    got = ops["serve_summarize"](payload, _ctx(torch_rt, ServeConfig(**serve)))
    want = jax_ops["serve_summarize"](payload, _jax_ctx(JaxServeConfig(**serve)))
    assert got["ok"] and want["ok"] and got["device"] == "cpu"
    assert _per_request(got) == _per_request(want)
    assert _top(got) == _top(want)
    for g, w in zip(got["results"], want["results"]):
        assert set(g) == set(w) and set(g["telemetry"]) == set(w["telemetry"])
        tel = g["telemetry"]
        assert tel["path"] == "colocated" and tel["first_token_wall"] is not None
        assert [e[0] for e in tel["events"]] == [e[0] for e in w["telemetry"]["events"]]
        assert tel["join_step"] == w["telemetry"]["join_step"]
        assert tel["occupancy_at_join"] == w["telemetry"]["occupancy_at_join"]
        assert g["ttft_ms"] is not None and g["ttft_ms"] >= 0


def test_phases_and_serving_hooks_compose_to_the_op(ops, torch_rt):
    fn = ops["serve_summarize"]
    for hook in ("stage", "execute", "finalize", "serve_admit", "serve_pump", "serve_done",
                 "serve_collect"):
        assert callable(getattr(fn, hook)) and callable(getattr(ops["serve_decode"], hook))
    whole = fn(_payload(), _ctx(torch_rt))
    reset_engines()
    ctx = _ctx(torch_rt)
    phase, state = fn.stage(_payload(), ctx)
    assert phase == "staged"
    handle = fn.serve_admit(state, ctx)
    while not fn.serve_done(handle):
        assert fn.serve_pump(handle) <= 8
    got = fn.finalize(fn.serve_collect(handle), ctx)
    assert _per_request(got) == _per_request(whole)
    assert ctx.tags["usage"]["rows"] == len(TEXTS)
    assert set(ctx.tags["timings"]) == {"stage_ms", "device_ms"}


def test_prefix_cache_hit_equals_its_cold_prefill(ops, jax_ops, torch_rt):
    """A second round of the same batch comes from the prefix cache, gives
    the cold round's results, bills the hits as cache_hit_rows, and counts
    as the reference counts."""
    cold_ctx, warm_ctx = _ctx(torch_rt), _ctx(torch_rt)
    cold = ops["serve_summarize"](_payload(2), cold_ctx)
    warm = ops["serve_summarize"](_payload(2), warm_ctx)
    assert cold["prefix_cache"] == {"hits": 0, "misses": 5, "evictions": 0}
    assert warm["prefix_cache"] == {"hits": 5, "misses": 0, "evictions": 0}
    assert _per_request(warm) == _per_request(cold)
    assert [r["telemetry"]["cache_hit"] for r in warm["results"]] == [True] * 5
    assert "cache_hit_rows" not in cold_ctx.tags.get("usage", {})
    assert warm_ctx.tags["usage"]["cache_hit_rows"] == 5.0
    want = [jax_ops["serve_summarize"](_payload(2), _jax_ctx()) for _ in range(2)]
    assert [r["prefix_cache"] for r in want] == [cold["prefix_cache"], warm["prefix_cache"]]


def test_prefix_cache_off_and_evicting(ops, jax_ops, torch_rt):
    for serve in ({"prefix_cache_enabled": False}, {"prefix_cache_entries": 2}):
        reset_engines()
        jax_reset_engines()
        got = [ops["serve_summarize"](_payload(), _ctx(torch_rt, ServeConfig(**serve)))
               for _ in range(2)]
        want = [jax_ops["serve_summarize"](_payload(), _jax_ctx(JaxServeConfig(**serve)))
                for _ in range(2)]
        assert [r["prefix_cache"] for r in got] == [r["prefix_cache"] for r in want]
        assert _per_request(got[1]) == _per_request(want[1])


@pytest.mark.parametrize("wire_fmt", [None, "b1"], ids=["json", "b1"])
def test_prefill_matches_the_reference(ops, jax_ops, torch_rt, wire_fmt):
    got = ops["serve_prefill"](_payload(), _ctx(torch_rt, wire_fmt=wire_fmt))
    want = jax_ops["serve_prefill"](_payload(), _jax_ctx(wire_fmt=wire_fmt))
    assert wire.is_binary_result(got) == (wire_fmt == "b1")
    if wire_fmt:
        got, want = wire.decode_result(got), wire.decode_result(want)
    assert {k for k in got} == {k for k in want}
    np.testing.assert_allclose(np.asarray(got["enc_rows"]), np.asarray(want["enc_rows"]),
                               atol=3e-5, rtol=0)
    assert np.asarray(got["lengths"]).tolist() == np.asarray(want["lengths"]).tolist()
    for key in ("op", "model", "n_requests", "bucket"):
        assert got[key] == want[key]
    for key in ("hits", "misses", "evictions"):
        assert got["prefix_cache"][key] == want["prefix_cache"][key]


@pytest.mark.parametrize("source", ["port", "reference"])
@pytest.mark.parametrize("via", ["encoded", "partials"])
def test_decode_resumes_from_a_prefill(ops, jax_ops, torch_rt, source, via):
    """serve_decode from a serve_prefill result (the port's own or the
    reference's: the wire is the contract) gives the colocated tokens, and
    forwards the prefill's counters without billing them."""
    prefill = (ops["serve_prefill"](_payload(), _ctx(torch_rt)) if source == "port"
               else jax_ops["serve_prefill"](_payload(), _jax_ctx()))
    reset_engines()
    colocated = ops["serve_summarize"](_payload(), _ctx(torch_rt, ServeConfig(
        prefix_cache_enabled=False)))
    handoff = {"encoded": prefill} if via == "encoded" else {"partials": [prefill]}
    ctx = _ctx(torch_rt)
    got = ops["serve_decode"](_payload(**handoff), ctx)
    want = jax_ops["serve_decode"](_payload(**handoff), _jax_ctx())
    assert got["op"] == "serve_decode"
    assert _per_request(got) == _per_request(colocated) == _per_request(want)
    assert [r["telemetry"]["path"] for r in got["results"]] == ["disagg"] * len(TEXTS)
    assert got["prefix_cache"] == want["prefix_cache"]
    assert "cache_hit_rows" not in ctx.tags.get("usage", {})


def test_serve_classify_matches_the_reference(ops, jax_ops, torch_rt):
    payload = {"requests": [{"req_id": f"c{i}", "text": t} for i, t in enumerate(TEXTS)],
               "model_config": TINY_CLS, "topk": 3}
    ctx = _ctx(torch_rt, wire_fmt="b1")
    got = ops["serve_classify"](payload, ctx)
    want = jax_ops["serve_classify"](payload, _jax_ctx(wire_fmt="b1"))
    assert ctx.tags["wire"] == "b1"  # taken off for the delegated call only
    assert got["ok"] and got["device"] == "cpu"
    assert _top(got) == _top(want)
    assert [r["req_id"] for r in got["results"]] == [r["req_id"] for r in want["results"]]
    _assert_topk_agree([r["indices"] for r in got["results"]],
                       [r["scores"] for r in got["results"]],
                       [r["indices"] for r in want["results"]],
                       [r["scores"] for r in want["results"]])
    for g, w in zip(got["results"], want["results"]):
        assert set(g) == set(w) and set(g["telemetry"]) == set(w["telemetry"])


def test_mpmd_chain_matches_the_reference_and_map_summarize(ops, jax_ops, torch_rt):
    payload = {"texts": TEXTS, "model_config": TINY_S2S}
    enc = ops["summarize_encode"](payload, _ctx(torch_rt))
    jax_enc = jax_ops["summarize_encode"](payload, _jax_ctx())
    assert {k: v for k, v in enc.items() if k not in ("chunks", "elapsed_ms", "device")} == \
        {k: v for k, v in jax_enc.items() if k not in ("chunks", "elapsed_ms", "device")}
    for c, jc in zip(enc["chunks"], jax_enc["chunks"]):
        assert c["lengths"] == jc["lengths"] and c["n"] == jc["n"]
        np.testing.assert_allclose(np.asarray(c["enc"]), np.asarray(jc["enc"]), atol=3e-5)
    dec = {"encoded": enc, "model_config": TINY_S2S, "max_length": 12}
    got = ops["summarize_decode"](dec, _ctx(torch_rt))
    want = jax_ops["summarize_decode"](dict(dec, encoded=jax_enc), _jax_ctx())
    whole = ops["map_summarize"](dict(payload, max_length=12), _ctx(torch_rt))
    assert got["summaries"] == want["summaries"] == whole["summaries"]
    assert got["n_rows"] == want["n_rows"] == len(TEXTS)
    partials = ops["summarize_decode"](
        {"partials": [enc, enc], "model_config": TINY_S2S, "max_length": 12}, _ctx(torch_rt))
    assert partials["summaries"] == whole["summaries"] * 2


def test_mpmd_chain_over_a_csv_shard_keeps_blank_rows_blank(ops, jax_ops, torch_rt, tmp_path):
    path = tmp_path / "rows.csv"
    path.write_text('id,text\n0,"first row"\n1,""\n2,"third row text"\n')
    payload = {"source_uri": str(path), "start_row": 0, "shard_size": 3, "text_field": "text",
               "model_config": TINY_S2S}
    enc = ops["summarize_encode"](payload, _ctx(torch_rt))
    jax_enc = jax_ops["summarize_encode"](payload, _jax_ctx())
    assert enc["empty_rows"] == jax_enc["empty_rows"] == [1]
    dec = {"encoded": enc, "model_config": TINY_S2S, "max_length": 6}
    got = ops["summarize_decode"](dec, _ctx(torch_rt))
    want = jax_ops["summarize_decode"](dict(dec, encoded=jax_enc), _jax_ctx())
    assert got["summaries"] == want["summaries"] and got["summaries"][1] == ""


HF_DIR = "<a checkpoint directory>"  # replaced by one in the test
BAD_SERVE = [
    ("not-a-dict", None),
    ({}, None),
    ({"requests": []}, None),
    ({"requests": [{"req_id": "", "text": "x"}]}, None),
    ({"requests": [{"req_id": "a", "text": ""}]}, None),
    ({"requests": ["x"]}, None),
    ({"num_beams": 0}, "requests"),
    ({"num_beams": 17}, "requests"),
    ({"num_beams": True}, "requests"),
    ({"length_penalty": 5.0}, "requests"),
    ({"length_penalty": "1"}, "requests"),
    ({"early_stopping": 1}, "requests"),
    ({"min_length": -1}, "requests"),
    ({"bucket": 0}, "requests"),
    ({"bucket": "64"}, "requests"),
    ({"requests": [{"req_id": "a", "text": "x", "max_length": 0}]}, None),
    ({"requests": [{"req_id": "a", "text": "x", "max_length": True}]}, None),
    ({"model_path": HF_DIR}, "requests"),
]


def _bad_payload(entry, tmp_path):
    payload, base = entry
    if not isinstance(payload, dict):
        return payload
    payload = dict(payload)
    if payload.get("model_path") == HF_DIR:
        (tmp_path / "ckpt").mkdir(exist_ok=True)
        (tmp_path / "ckpt" / "config.json").write_text('{"model_type": "bart"}')
        payload["model_path"] = str(tmp_path / "ckpt")
    if base == "requests":
        payload["requests"] = [{"req_id": "a", "text": "x"}]
    payload.setdefault("model_config", TINY_S2S)
    return payload


@pytest.mark.parametrize("op", ["serve_summarize", "serve_prefill", "serve_decode"])
@pytest.mark.parametrize("entry", BAD_SERVE, ids=[
    "not-a-dict", "empty", "no-requests", "empty-req-id", "empty-text", "req-not-dict",
    "beams0", "beams17", "beams-bool", "lp5", "lp-str", "early-int", "min-neg", "bucket0",
    "bucket-str", "max-length0", "max-length-bool", "hf-dir"])
def test_serving_soft_errors_match_the_reference(ops, jax_ops, torch_rt, tmp_path, op, entry):
    payload = _bad_payload(entry, tmp_path)
    got = ops[op](payload, _ctx(torch_rt))
    want = jax_ops[op](payload, _jax_ctx())
    assert got["ok"] is False and got == want


@pytest.mark.parametrize("handoff", [
    {}, {"encoded": {"ok": False}}, {"partials": []}, {"partials": "x"},
    {"encoded": {"ok": True, "op": "summarize_encode"}},
    {"encoded": {"ok": True, "op": "serve_prefill", "enc_rows": [[[0.0]]]}},
], ids=["none", "not-ok", "no-partials", "partials-str", "wrong-op", "wrong-shape"])
def test_decode_handoff_errors_match_the_reference(ops, jax_ops, torch_rt, handoff):
    payload = dict(_payload(), **handoff)
    got = ops["serve_decode"](payload, _ctx(torch_rt))
    want = jax_ops["serve_decode"](payload, _jax_ctx())
    assert got["ok"] is False and got == want


@pytest.mark.parametrize("payload", [
    "x", {}, {"requests": [{"req_id": "a", "text": "x"}], "topk": 0},
    {"requests": [{"req_id": "a", "text": "x"}], "topk": True},
    {"requests": [{"req_id": 1, "text": "x"}]},
], ids=["not-a-dict", "empty", "topk0", "topk-bool", "req-id-int"])
def test_serve_classify_soft_errors_match_the_reference(ops, jax_ops, torch_rt, payload):
    got = ops["serve_classify"](payload, _ctx(torch_rt))
    want = jax_ops["serve_classify"](payload, _jax_ctx())
    assert got["ok"] is False and got == want


@pytest.mark.parametrize("op,payload", [
    ("summarize_encode", "x"), ("summarize_encode", {}),
    ("summarize_encode", {"texts": ["ok", ""]}), ("summarize_encode", {"texts": "abc"}),
    ("summarize_decode", "x"), ("summarize_decode", {}),
    ("summarize_decode", {"encoded": {"op": "map_summarize"}}),
    ("summarize_decode", {"partials": []}),
    ("summarize_decode", {"encoded": {"op": "summarize_encode", "chunks": [1]},
                          "max_length": 0}),
    ("summarize_decode", {"encoded": {"op": "summarize_encode", "chunks": [
        {"enc": [[0.0]], "lengths": [1], "n": 1}]}}),
], ids=lambda x: str(x)[:30])
def test_mpmd_soft_errors_match_the_reference(ops, jax_ops, torch_rt, op, payload):
    if isinstance(payload, dict):
        payload = dict(payload, model_config=TINY_S2S)
    got = ops[op](payload, _ctx(torch_rt))
    want = jax_ops[op](payload, _jax_ctx())
    assert got["ok"] is False and got == want


def test_quantized_serving_is_refused(ops, jax_ops, torch_rt):
    """Refused until the port had quantized serving: now int8 serves through
    serve_summarize and the prefill -> decode split, and w8a16 through the
    MPMD chain, each equal to the reference's ops (f32 tokens)."""
    int8 = _payload(model_config=dict(TINY_S2S, quant="int8"))
    got = ops["serve_summarize"](dict(int8), _ctx(torch_rt))
    want = jax_ops["serve_summarize"](dict(int8), _jax_ctx())
    assert got["ok"] and [r["summary"] for r in got["results"]] == \
        [r["summary"] for r in want["results"]]
    pre = ops["serve_prefill"](dict(int8), _ctx(torch_rt))
    dec = ops["serve_decode"](dict(int8, encoded=pre), _ctx(torch_rt))
    assert [r["summary"] for r in dec["results"]] == [r["summary"] for r in got["results"]]
    payload = {"texts": TEXTS, "model_config": dict(TINY_S2S, quant="w8a16")}
    enc = ops["summarize_encode"](payload, _ctx(torch_rt))
    jax_enc = jax_ops["summarize_encode"](payload, _jax_ctx())
    decode = {"model_config": payload["model_config"], "max_length": 8}
    assert ops["summarize_decode"](dict(decode, encoded=enc), _ctx(torch_rt))["summaries"] \
        == jax_ops["summarize_decode"](dict(decode, encoded=jax_enc), _jax_ctx())["summaries"]


# ---- the disaggregated chain through the reference's controller ----

def _serve_drain(controller, handlers, ctx):
    """Lease and run serving jobs until the front door is empty (the
    reference's tests/test_paged_kv.py drain, with either package's ops)."""
    for _ in range(200):
        lease = controller.lease(agent="test", capabilities={"ops": sorted(handlers)},
                                 max_tasks=4)
        if lease is None:
            if controller.serve_door.stats()["bucketed"] == 0 \
                    and not controller.serve_door.job_ids():
                return
            time.sleep(0.01)
            continue
        for task in lease["tasks"]:
            result = handlers[task["op"]](task["payload"], ctx)
            controller.report(lease_id=lease["lease_id"], job_id=task["id"],
                              job_epoch=task["job_epoch"],
                              status="succeeded" if result.get("ok") else "failed",
                              result=result)
    raise AssertionError("serve drain did not converge")


def _controller_round(handlers, ctx, disaggregated):
    controller = Controller(serve=JaxServeConfig(max_wait_ms=0.0, max_batch=4,
                                                 disaggregated=disaggregated),
                            flow=FlowConfig(cache_enabled=False))
    out = []
    for _ in range(2):  # the second round hits the prefix cache
        rids = [controller.submit_infer("summarize", t, params={
            "model_config": TINY_S2S, "max_length": 8, "num_beams": 2}) for t in TEXTS]
        controller._serve_pump()
        _serve_drain(controller, handlers, ctx)
        controller._serve_reap()
        snaps = [controller.infer_snapshot(rid) for rid in rids]
        assert all(s["state"] == "done" and s["ttft_ms"] is not None for s in snaps), snaps
        out.append([s["result"]["summary"] for s in snaps])
    ops_run = {r.get("op") for r in controller.results().values() if isinstance(r, dict)}
    return out, ops_run, controller


@pytest.mark.parametrize("wire_fmt", [None, "b1"], ids=["json", "b1"])
def test_disaggregated_chain_equals_colocated_through_the_controller(
        ops, jax_ops, torch_rt, wire_fmt):
    colocated, _, _ = _controller_round(ops, _ctx(torch_rt), False)
    reset_engines()
    disagg, ops_run, controller = _controller_round(ops, _ctx(torch_rt, wire_fmt=wire_fmt),
                                                    True)
    reference, _, _ = _controller_round(jax_ops, _jax_ctx(wire_fmt=wire_fmt), True)
    assert disagg == colocated == reference
    assert disagg[0] == disagg[1]  # cached == cold
    assert {"serve_prefill", "serve_decode"} <= ops_run
    assert controller._m_serve_kv_total.value() > 0
    assert controller._m_serve_prefix.value(event="hits") >= len(TEXTS)


# ---- host-only pieces ----

def test_prefix_key_equals_the_reference():
    rng = np.random.default_rng(0)
    for length in (1, 63, 64, 65, 200):
        row = rng.integers(0, 260, length).astype(np.int32)
        assert prefix_key("m#seq2seq#1", row) == jax_prefix_key("m#seq2seq#1", row)
    row = np.arange(16, dtype=np.int32)
    k = prefix_key("m1", row)
    assert k != prefix_key("m2", row) and k != prefix_key("m1", row[:8])
    assert k != prefix_key("m1", np.concatenate([row, np.zeros(64, np.int32)]))


@pytest.mark.parametrize("max_entries,max_bytes", [(2, 2 ** 20), (64, 2048), (3, 1100)])
def test_prefix_cache_lru_matches_the_reference(max_entries, max_bytes):
    rng = np.random.default_rng(max_entries)
    got, want = PrefixCache(max_entries, max_bytes), JaxPrefixCache(max_entries, max_bytes)
    for step in range(40):
        key = f"k{int(rng.integers(0, 6))}"
        if rng.random() < 0.5:
            row = np.full(int(rng.choice([64, 256, 4096])), step, np.float32)
            got.put(key, row)
            want.put(key, row)
        else:
            g, w = got.get(key), want.get(key)
            assert (g is None) == (w is None) and (g is None or np.array_equal(g, w))
    assert got.stats() == want.stats() and list(got._store) == list(want._store)
    got.clear()
    assert len(got) == 0 and got.bytes_used == 0


@pytest.mark.parametrize("env", [
    {},
    {"SERVE_DECODE_SLOTS": "64", "SERVE_MICRO_STEPS": "4", "SERVE_KV_LAYOUT": "DENSE",
     "KV_BLOCK_SIZE": "8", "KV_POOL_BLOCKS": "129", "PREFIX_CACHE_ENABLED": "no",
     "PREFIX_CACHE_ENTRIES": "7", "PREFIX_CACHE_MB": "1.5", "SERVE_DISAGG": "yes"},
    {"SERVE_DECODE_SLOTS": "0", "SERVE_MICRO_STEPS": "-2", "SERVE_KV_LAYOUT": "weird",
     "KV_BLOCK_SIZE": "0", "KV_POOL_BLOCKS": "-1", "PREFIX_CACHE_ENTRIES": "-4",
     "PREFIX_CACHE_MB": "-3", "SERVE_PRIORITY": "99", "SERVE_LEN_BUCKETS": "512, x,64,-1",
     "SERVE_REQLOG_SAMPLE": "7", "SERVE_WAIT_TIMEOUT_SEC": "0"},
    {"SERVE_DECODE_SLOTS": "abc", "SERVE_MAX_BATCH": "3.9", "SERVE_ENABLED": "0"},
], ids=["defaults", "set", "clamped", "unparsable"])
def test_serve_config_from_env_matches_the_reference(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got, want = ServeConfig.from_env(), JaxServeConfig.from_env()
    assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
        {f: getattr(want, f) for f in want.__dataclass_fields__}
    assert Config.from_env().serve == got


def test_stamp_usage_matches_the_reference():
    got, want = {}, {}
    for fields in ({"cache_hit_rows": 3.0, "chips": 1}, {"cache_hit_rows": 2, "chips": 4,
                                                        "device_s": None}):
        stamp_usage(got, **fields)
        jax_stamp_usage(want, **fields)
    assert got == want == {"usage": {"cache_hit_rows": 5.0, "chips": 4.0}}
    stamp_usage(None, rows=1.0)
