"""The port's controller journal against the reference's on the CPU: a
journal written by the port's Controller replays in the reference's to the
same state as in the port's own, and the reverse also holds, with the
single-file journal and with rotated segments and compacting snapshots.
Then a half-drained CSV job resumes after a restart: the replayed
controller hands out the shards not yet done, keeps the results already
accepted, and the reduce collects every shard's result in order."""

import re

import pytest

import agent_tpu.config as ref_config
import agent_tpu.controller.core as ref_core
import agent_tpu_torch.config as port_config
import agent_tpu_torch.controller.core as port_core

SIDES = {"port": (port_core, port_config), "ref": (ref_core, ref_config)}
SHARD = re.compile(r"\bshard-(\d+)-[0-9a-f]{8}\b")
JOURNALS = {"single_file": {}, "segments_and_snapshots": dict(
    segment_max_events=7, snapshot_every_events=11)}


def _controller(side: str, path: str, journal: dict):
    core, config = SIDES[side]
    return core.Controller(journal_path=path, journal=config.JournalConfig(**journal),
                           flow=config.FlowConfig(cache_enabled=False))


def _norm(obj):
    if isinstance(obj, str):
        return SHARD.sub(lambda m: f"shard-{m.group(1)}", obj)
    if isinstance(obj, dict):
        return {_norm(k): _norm(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


def _state(c) -> dict:
    return _norm({"jobs": sorted((c.job_snapshot(j) for j in c._jobs), key=lambda s: s["job_id"]),
                  "counts": c.counts(), "by_op": c.counts_by_op(), "results": c.results(),
                  "drained": c.drained()})


def _write(side: str, path: str, journal: dict) -> dict:
    """Submit, lease and report part of the work, then stop -> the state."""
    c = _controller(side, path, journal)
    for i in range(5):
        c.submit("echo", {"i": i}, job_id=f"e{i}", priority=3 + i, tenant=("a", "b")[i % 2])
    c.submit_csv_job("/tmp/rows.csv", 450, shard_size=100, map_op="read_csv_shard",
                     reduce_op="risk_accumulate", collect_partials=True)
    c.submit_workflow({"stages": [{"name": "x", "op": "echo", "payload": {"w": 1}},
                                  {"name": "y", "op": "echo", "after": ["x"]}]},
                      workflow_id="wf-j", tenant="a")
    for _ in range(3):
        out = c.lease("agent", capabilities={"ops": ["echo", "read_csv_shard"]}, max_tasks=3)
        for t in (out or {}).get("tasks", []):
            status = "failed" if t["id"] == "e1" else "succeeded"
            c.report(out["lease_id"], t["id"], t["job_epoch"], status,
                     result={"ok": status == "succeeded", "rows": t["payload"].get("shard_size")},
                     error={"type": "ValueError"} if status == "failed" else None)
    state = _state(c)
    c.close()
    return state


@pytest.mark.parametrize("journal", sorted(JOURNALS))
@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_a_journal_replays_to_the_same_state_in_either_controller(tmp_path, writer, reader,
                                                                  journal):
    path = str(tmp_path / "controller.jsonl")
    written = _write(writer, path, JOURNALS[journal])
    replayed = {}
    for side in (reader, writer):
        c = _controller(side, path, JOURNALS[journal])
        replayed[side] = _state(c)
        c.close()
    assert replayed[reader] == replayed[writer]
    # Terminal states survive, and the results a reduce depends on (the
    # journal keeps only those bodies); leased jobs come back.
    got = replayed[reader]["results"]
    assert set(got) == set(written["results"]) and any(j.startswith("shard-") for j in got)
    assert {j: r for j, r in got.items() if j.startswith("shard-")} == {
        j: r for j, r in written["results"].items() if j.startswith("shard-")}
    done = {j["job_id"]: j["state"] for j in written["jobs"] if j["state"] != "leased"}
    assert {j["job_id"]: j["state"] for j in replayed[reader]["jobs"]
            if j["job_id"] in done} == done


@pytest.mark.parametrize("first,second", [("port", "port"), ("ref", "port"), ("port", "ref")])
def test_a_half_drained_job_resumes_after_a_restart(tmp_path, first, second):
    path = str(tmp_path / "controller.jsonl")
    c = _controller(first, path, {})
    shards, reduce_id = c.submit_csv_job("/tmp/rows.csv", 500, shard_size=100,
                                         map_op="risk_accumulate",
                                         reduce_op="risk_accumulate", collect_partials=True)
    out = c.lease("a", capabilities={"ops": ["risk_accumulate"]}, max_tasks=3)
    for t in out["tasks"][:2]:
        c.report(out["lease_id"], t["id"], t["job_epoch"], "succeeded",
                 result={"ok": True, "sum": int(t["payload"]["start_row"])})
    c.close()  # one shard still leased, two never leased

    c = _controller(second, path, {})
    assert c.counts() == {"succeeded": 2, "pending": 4}
    leased = []
    while not c.drained():
        out = c.lease("b", capabilities={"ops": ["risk_accumulate"]}, max_tasks=2)
        for t in out["tasks"]:
            leased.append(t["id"])
            payload = t["payload"]
            result = {"ok": True, "sum": int(payload["start_row"])} if "start_row" in payload \
                else {"ok": True, "partials": payload["partials"]}
            c.report(out["lease_id"], t["id"], t["job_epoch"], "succeeded", result=result)
    assert leased[-1] == reduce_id and len(leased) == 4
    assert [p["sum"] for p in c.results()[reduce_id]["partials"]] == [0, 100, 200, 300, 400]
    c.close()
