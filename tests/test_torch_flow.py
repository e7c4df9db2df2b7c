"""The port's workflow engine (``agent_tpu_torch.flow``) against the
reference's (``agent_tpu.flow``): the documents of ``tests/test_flow.py``
and seeded random graphs parse, sort, expand and round-trip through
``graph_doc`` to the same plans; invalid documents raise the same
``DagError`` message; the result cache gives the same keys, hits, misses,
evictions and invalidations on the same seeded stream; ``FlowConfig`` and
``CACHEABLE_OPS`` are the reference's."""

import dataclasses
import random

import pytest

from agent_tpu import config as jax_config
from agent_tpu import ops as jax_ops
from agent_tpu.flow import dag as jax_dag
from agent_tpu.flow import result_cache as jax_rc
from agent_tpu_torch import config as torch_config
from agent_tpu_torch import ops as torch_ops
from agent_tpu_torch.flow import dag as torch_dag
from agent_tpu_torch.flow import result_cache as torch_rc

KNOWN = ["echo", "map_tokenize", "risk_accumulate", "map_summarize", "map_classify_tpu"]

FANOUT_DOC = {"stages": [
    {"name": "tok", "op": "echo", "payload": {"v": 1}},
    {"name": "cls", "op": "echo", "payload": {"v": 2}, "after": ["tok"], "fan_out": 3},
    {"name": "acc", "op": "risk_accumulate", "payload": {}, "after": ["cls"]},
    {"name": "rep", "op": "echo", "payload": {"final": True}, "after": ["acc"]},
]}
CLASSIFY_DOC = {"stages": [
    *({"name": f"cls{i}", "op": "map_classify_tpu", "priority": 7,
       "payload": {"source_uri": "rows.csv", "start_row": 1 + 8192 * i, "shard_size": 8192}}
      for i in range(4)),
    *({"name": f"risk{i}", "op": "risk_accumulate", "payload": {"values": [i, 2.5]}}
      for i in range(4)),
    {"name": "reduce", "op": "risk_accumulate", "after": [f"risk{i}" for i in range(4)]},
    {"name": "report", "op": "echo", "after": ["reduce", *(f"cls{i}" for i in range(4))],
     "collect": False, "required_labels": {"zone": "a"}, "max_attempts": 2},
]}
BAD_DOCS = [
    [],
    {"stages": []},
    {"stages": [{"name": "a", "op": "echo", "after": ["b"]},
                {"name": "b", "op": "echo", "after": ["a"]}]},
    {"stages": [{"name": "a", "op": "nope"}]},
    {"stages": [{"name": "a", "op": "echo"}, {"name": "a", "op": "echo"}]},
    {"stages": [{"name": "a", "op": "echo", "after": ["z"]}]},
    {"stages": [{"name": "a", "op": "echo", "after": ["a"]}]},
    {"stages": [{"name": f"s{i}", "op": "echo"} for i in range(40)]},
    {"stages": [{"name": "a", "op": "echo", "fan_out": 99}]},
    {"stages": [{"name": "a", "op": "echo", "fan_out": True}]},
    {"stages": [{"name": "a b", "op": "echo"}]},
    {"stages": [{"name": "a", "op": "echo", "payload": [1]}]},
    {"stages": [{"name": "a", "op": "echo", "priority": 11}]},
    {"stages": [{"name": "a", "op": ""}]},
    {"stages": ["x"]},
]


def _random_doc(seed):
    rng = random.Random(seed)
    n = rng.randint(1, 10)
    stages = []
    for i in range(n):
        st = {"name": f"s{i}", "op": rng.choice(KNOWN), "payload": {"i": i}}
        if i and rng.random() < 0.8:
            st["after"] = sorted({f"s{rng.randrange(i)}" for _ in range(rng.randint(1, 3))})
        if rng.random() < 0.3:
            st["fan_out"] = rng.randint(2, 5)
        if rng.random() < 0.3:
            st["priority"] = rng.randint(0, 9)
        if rng.random() < 0.2:
            st["collect"] = False
        stages.append(st)
    rng.shuffle(stages)
    return {"stages": stages}


def _plan(dag, doc, wid, **kw):
    spec = dag.parse_workflow(doc, KNOWN, **kw)
    return (dag.toposort_stages(spec), dag.critical_path_lengths(spec),
            [dataclasses.asdict(p) for p in dag.expand_workflow(spec, wid, default_priority=5)],
            dag.graph_doc(spec),
            dataclasses.asdict(dag.spec_from_graph_doc(dag.graph_doc(spec))))


@pytest.mark.parametrize("doc", [FANOUT_DOC, CLASSIFY_DOC, *range(12)],
                         ids=["fanout", "classify", *(f"random{i}" for i in range(12))])
def test_plans_match_the_reference(doc):
    doc = _random_doc(doc) if isinstance(doc, int) else doc
    assert _plan(torch_dag, doc, "wf-x") == _plan(jax_dag, doc, "wf-x")


def test_classify_workflow_plan():
    """The shape chip_smoke's control-plane phase submits: each shard its
    own stage, the reduce collecting the risk partials in order, the report
    ordered after both without partials."""
    spec = torch_dag.parse_workflow(CLASSIFY_DOC, KNOWN)
    planned = {p.job_id: p for p in torch_dag.expand_workflow(spec, "wf")}
    assert planned["wf-reduce"].after == tuple(f"wf-risk{i}" for i in range(4))
    assert planned["wf-reduce"].payload["__collect_partials__"] is True
    assert "__collect_partials__" not in planned["wf-report"].payload
    assert planned["wf-cls0"].priority == 7 and planned["wf-risk0"].priority == 5
    assert planned["wf-cls0"].critical_path == 2 and planned["wf-risk0"].critical_path == 3


@pytest.mark.parametrize("i", range(len(BAD_DOCS)))
def test_invalid_documents_raise_the_reference_message(i):
    with pytest.raises(jax_dag.DagError) as want:
        jax_dag.parse_workflow(BAD_DOCS[i], KNOWN, max_stages=32, max_width=64)
    with pytest.raises(torch_dag.DagError) as got:
        torch_dag.parse_workflow(BAD_DOCS[i], KNOWN, max_stages=32, max_width=64)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("capacity", [0, 3, 64])
def test_result_cache_matches_the_reference(seed, capacity):
    rng = random.Random(seed)
    caches = [mod.ResultCache(capacity=capacity, model_version="v1")
              for mod in (jax_rc, torch_rc)]
    logs = [[], []]
    for step in range(200):
        op = rng.choice(["echo", "map_classify_tpu"])
        payload = {"k": rng.randrange(8), "b": [rng.randrange(2)], "s": "é"}
        r = rng.random()
        for cache, log in zip(caches, logs):
            if r < 0.45:
                log.append(("get", cache.get(op, payload)))
            elif r < 0.9:
                log.append(("put", cache.put(op, payload, {"step": step, "rows": [1.5]})))
            elif r < 0.95:
                log.append(("ver", cache.set_model_version(f"v{step % 3}")))
            else:
                log.append(("key", cache.key(op, payload)))
            log.append(("stats", cache.stats(), cache.enabled))
    assert logs[1] == logs[0]
    payload = {"b": 2, "a": [1, {"z": None}]}
    assert torch_rc.result_key("echo", payload, "v9") == jax_rc.result_key("echo", payload, "v9")
    assert torch_rc.canonical_payload(payload) == jax_rc.canonical_payload(payload)


def test_cached_results_are_isolated_copies():
    rc = torch_rc.ResultCache(capacity=8)
    src = {"rows": [1, 2]}
    rc.put("echo", {"k": 1}, src)
    src["rows"].append(3)
    out = rc.get("echo", {"k": 1})
    out["rows"].append(9)
    assert rc.get("echo", {"k": 1}) == {"rows": [1, 2]}


def test_cacheable_ops_and_flow_config_match_the_reference(monkeypatch):
    assert torch_ops.CACHEABLE_OPS == jax_ops.CACHEABLE_OPS
    for name in torch_ops.OP_TO_MODULE:
        assert torch_ops.is_cacheable(name) == jax_ops.is_cacheable(name)
    env = {"FLOW_ENABLED": "no", "FLOW_MAX_STAGES": "0", "FLOW_MAX_WIDTH": "9",
           "CACHE_ENABLED": "1", "CACHE_CAPACITY": "-4", "CACHE_MODEL_VERSION": "v7",
           "CACHE_PRICE_PER_HIT": "0.25"}
    assert vars(torch_config.FlowConfig.from_env()) == vars(jax_config.FlowConfig.from_env())
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert vars(torch_config.FlowConfig.from_env()) == vars(jax_config.FlowConfig.from_env())
