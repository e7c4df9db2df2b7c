"""The port's Controller (``agent_tpu_torch.controller.core``) against the
reference's (``agent_tpu.controller.core``) on the CPU: one scripted
sequence, from a seed, through both, under the fifo and the fair policy.
It submits jobs and a CSV job with a collecting reduce, leases them to
agents of different capability sets (an injected clock drives TTL expiry
and deadlines), posts stale, duplicate, failed and permanent results,
retries a transient failure to ``dead``, arms the three injectable faults,
runs a workflow twice (the second answered from the result cache) and a
disaggregated serve chain through ``submit_infer``. Generated ids (jobs,
leases, requests, CSV shards, serve jobs) are random on both sides, so
each is named by its first appearance. The two controllers must answer
every lease and report alike and end with equal ``job_snapshot``s,
``counts``, ``counts_by_op``, ``results``, front-door stats, and the same
metric series (names and label sets) in ``metrics_text``."""

import random
import re

import pytest

import agent_tpu.config as ref_config
import agent_tpu.controller.core as ref_core
import agent_tpu_torch.config as port_config
import agent_tpu_torch.controller.core as port_core
from agent_tpu_torch.obs.metrics import parse_exposition

# Generated job, lease, request and serve-job ids, and span ids.
ID = re.compile(r"\b(?:(?:job|lease|req|serve-pf|serve|shard-\d+)-[0-9a-f]{8,12}|[0-9a-f]{16})\b")


class Clock:
    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


WALLS = {"arrived_wall", "submitted_wall", "batched_wall", "completed_wall"}  # time.time()


class Names:
    """Random ids -> stable names, in order of first appearance."""

    def __init__(self) -> None:
        self.names: dict = {}

    def __call__(self, obj):
        if isinstance(obj, str):
            return ID.sub(lambda m: self.names.setdefault(m.group(0), f"<{len(self.names)}>"),
                          obj)
        if isinstance(obj, dict):
            return {self(k): "<wall>" if k in WALLS else self(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [self(v) for v in obj]
        return obj


PROFILE = {"tpu": {"suggested_shard_rows": 120, "suggested_batch": 8}}


def _drive(core, config, policy: str, seed: int) -> dict:
    rng = random.Random(seed)
    clock = Clock()
    c = core.Controller(
        clock=clock, lease_ttl_sec=30.0, max_attempts=2,
        sched=config.SchedConfig(policy=policy, tenant_weights={"acme": 3.0, "globex": 1.0}),
        serve=config.ServeConfig(max_wait_ms=0.0, disaggregated=True),
        flow=config.FlowConfig())
    name, log = Names(), []
    leases = {}

    def lease(agent, ops, n=1, **kw):
        out = c.lease(agent, capabilities={"ops": ops, **kw}, max_tasks=n,
                      worker_profile=PROFILE, metrics={"cpu_util": 0.0})
        if out:
            for t in out["tasks"]:
                leases[t["id"]] = (out["lease_id"], t["job_epoch"])
        log.append(("lease", agent, name(out)))
        return out

    def report(job_id, status="succeeded", result=None, error=None, epoch=None, lease_id=None):
        lid, ep = leases.get(job_id, ("lease-000000000000", 0))
        out = c.report(lease_id or lid, job_id, ep if epoch is None else epoch, status,
                       result=result if result is not None else {"ok": True, "job": job_id},
                       error=error)
        log.append(("report", name(job_id), status, name(out)))
        return out

    # Plain jobs of several tenants, tiers and ops; a CSV job of shards
    # split by the last profile's hint, with a reduce collecting them.
    for i in range(6):
        c.submit(rng.choice(["echo", "map_tokenize"]), {"i": i}, job_id=f"j{i}",
                 priority=rng.choice([None, 2, 7, 9]),
                 tenant=rng.choice([None, "acme", "globex"]))
    c.submit("echo", {"dl": 1}, job_id="deadline", deadline_sec=20.0)
    lease("a0", ["echo"], 1)  # carries the tpu profile: the shard hint
    shards, reduce_id = c.submit_csv_job("/tmp/x.csv", 300, map_op="read_csv_shard",
                                         reduce_op="risk_accumulate", collect_partials=True)
    log.append(("csv", name(shards), name(reduce_id), c.suggested_shard_size()))

    # Leases by capability; results, a stale epoch, a duplicate, an
    # unknown job, a transient failure retried, a permanent failure.
    for agent, ops, n in (("a1", ["echo"], 2), ("a2", ["map_tokenize", "read_csv_shard"], 3),
                          ("a3", ["risk_accumulate"], 1), ("a1", ["echo"], 4)):
        got = lease(agent, ops, n)
        for t in (got or {}).get("tasks", []):
            jid = t["id"]
            roll = rng.random()
            if roll < 0.15:
                report(jid, epoch=t["job_epoch"] + 1)  # stale
                report(jid)
            elif roll < 0.3:
                report(jid)
                report(jid)  # duplicate
            elif roll < 0.45:
                report(jid, "failed", result={"ok": False}, error={"type": "RuntimeError"})
            elif roll < 0.55:
                report(jid, "failed", result={"ok": False}, error={"type": "ValueError"})
            else:
                report(jid)
    report("no-such-job")

    # A transient failure retried to dead (max_attempts 2).
    c.submit("echo", {"flaky": 1}, job_id="flaky")
    for _ in range(3):
        got = lease("a1", ["echo"], 8)
        for t in (got or {}).get("tasks", []):
            if t["id"] == "flaky":
                report("flaky", "failed", result={"ok": False}, error={"type": "OSError"})
            else:
                report(t["id"])

    # TTL expiry: a lease left to lapse is re-queued at a bumped epoch; the
    # late result is stale.
    c.submit("map_tokenize", {"ttl": 1}, job_id="ttl")
    first = lease("a2", ["map_tokenize"], 1)
    clock.now += 31.0
    second = lease("a4", ["map_tokenize"], 1)
    if first and first["tasks"]:
        report("ttl", epoch=first["tasks"][0]["job_epoch"], lease_id=first["lease_id"])
    if second and second["tasks"]:
        report("ttl")

    # The injectable faults.
    for fault in ("drop_lease", "duplicate_task", "stale_epoch"):
        c.submit("echo", {"fault": fault}, job_id=f"f-{fault}")
        c.inject(fault)
        got = lease("a1", ["echo"], 2)
        for t in (got or {}).get("tasks", []):
            report(t["id"])
        got = lease("a1", ["echo"], 2)
        for t in (got or {}).get("tasks", []):
            report(t["id"])

    # Deadlines: the deadline job expires while pending.
    clock.now += 25.0
    c.sweep()

    # The rest of the CSV job and its reduce.
    for _ in range(4):
        got = lease("a5", ["read_csv_shard", "risk_accumulate", "map_tokenize", "echo"], 4)
        for t in (got or {}).get("tasks", []):
            report(t["id"], result={"ok": True, "n": len(name(t["id"])),
                                    "partials": name(t["payload"].get("partials"))})

    # A workflow, then the same workflow again: answered from the cache.
    doc = {"stages": [{"name": "a", "op": "echo", "payload": {"w": 1}},
                      {"name": "b", "op": "echo", "payload": {"w": 2}, "after": ["a"]}]}
    log.append(("wf", name(c.submit_workflow(doc, workflow_id="wf-1", tenant="acme"))))
    for _ in range(3):
        got = lease("a6", ["echo"], 2)
        for t in (got or {}).get("tasks", []):
            report(t["id"], result={"ok": True, "echo": t["payload"].get("w"),
                                    "partials": t["payload"].get("partials")})
    log.append(("wf", name(c.submit_workflow(doc, workflow_id="wf-2", tenant="acme"))))
    lease("a6", ["echo"], 2)
    for wid in ("wf-1", "wf-2"):
        view = c.workflow_json(wid)
        view.pop("submitted_wall")
        log.append(("wf_view", name(view)))

    # A disaggregated serve chain through the front door.
    rids = [c.submit_infer("summarize", "text " * (k + 1), params={"max_length": 3})
            for k in range(3)]
    c._serve_pump()
    for ops in (["serve_prefill"], ["serve_decode"]):
        got = lease("a7", ops, 4)
        for t in (got or {}).get("tasks", []):
            reqs = t["payload"]["requests"]
            if ops == ["serve_prefill"]:
                res = {"ok": True, "enc_rows": [[0.5] * 4] * len(reqs),
                       "lengths": [4] * len(reqs), "req_ids": [r["req_id"] for r in reqs]}
            else:
                assert len(t["payload"]["partials"]) == 1
                res = {"ok": True, "results": [{"req_id": r["req_id"], "summary": "s",
                                                "tokens": 2, "steps": 2, "ttft_ms": 1.0}
                                               for r in reqs]}
            report(t["id"], result=res)
    infer = [c.infer_snapshot(r) for r in rids]
    for snap in infer:
        snap.pop("latency_ms", None)
        snap.pop("ttft_ms", None)

    ids = sorted(c._jobs)
    snaps = [name(c.job_snapshot(j)) for j in ids]
    series = sorted({(sample, tuple(sorted(labels.items())))
                     for sample, rows in parse_exposition(c.metrics_text()).items()
                     for labels, _ in rows})
    serve = c.serve_status()
    serve.pop("request_log", None)
    return {"log": log, "snapshots": sorted(snaps, key=repr), "counts": c.counts(),
            "by_op": c.counts_by_op(), "results": name(c.results()),
            "infer": name(infer), "serve": serve, "series": name(series),
            "stale": c.stale_results, "drained": c.drained()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", ["fifo", "fair"])
def test_one_script_through_both_controllers(policy, seed):
    want = _drive(ref_core, ref_config, policy, seed)
    got = _drive(port_core, port_config, policy, seed)
    assert want["counts"].get("succeeded") and want["counts"].get("dead")
    assert any(entry[0] == "report" and entry[3].get("accepted") is False
               for entry in want["log"])
    for key in want:
        assert got[key] == want[key], key


def test_the_hint_rides_the_gpu_block_in_the_port_only():
    """The port's agents, which claim no TPU, send the shard hint in their
    ``gpu`` block: the port's controller takes it from there (and from a
    reference agent's ``tpu`` block), the reference's from ``tpu`` only."""
    gpu = {"gpu": {"gpu_present": True, "suggested_batch": 1024,
                   "suggested_shard_rows": 16384}}
    tpu = {"tpu": {"suggested_shard_rows": 4096}}
    for profile, want_port, want_ref in ((gpu, 16384, None), (tpu, 4096, 4096),
                                         ({"gpu": {"gpu_present": False}}, None, None)):
        for core, want in ((port_core, want_port), (ref_core, want_ref)):
            c = core.Controller()
            c.lease("a", capabilities={"ops": ["echo"]}, worker_profile=profile)
            assert c.suggested_shard_size() == want
            shards, _ = c.submit_csv_job("/tmp/x.csv", 40_000)
            size = c.job(shards[0]).payload["shard_size"]
            assert size == min(want or core.DEFAULT_SHARD_ROWS, 40_000)
    # A CPU agent polling later does not revert the hint.
    c = port_core.Controller()
    c.lease("a", capabilities={"ops": ["echo"]}, worker_profile=gpu)
    c.lease("b", capabilities={"ops": ["echo"]}, worker_profile={"gpu": {"gpu_present": False}})
    assert c.suggested_shard_size() == 16384
