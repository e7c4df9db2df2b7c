"""The port's hot standby (``controller/standby.py``) against the
reference's on the CPU. Each package's ``HotStandby`` tails a segmented
journal that either package's controller writes (all four combinations):
after every catch-up its replica counts are the same whichever package's
standby reads, with the writer's jobs and terminal states; a torn final
line left by the dead primary is sealed and counted at promotion; the
promoted controller's job snapshots are the same whichever package's
standby promoted, it appends on a fresh segment, and a result spooled
against the dead primary is applied once (a second post is refused as
already complete). Every comparison is exact once generated shard ids
(and the reduce's) drop their random suffix."""

import re

import pytest

import agent_tpu.config as ref_config
import agent_tpu.controller.core as ref_core
import agent_tpu.controller.journal as ref_journal
import agent_tpu.controller.standby as ref_standby
import agent_tpu_torch.config as port_config
import agent_tpu_torch.controller.core as port_core
import agent_tpu_torch.controller.journal as port_journal
import agent_tpu_torch.controller.standby as port_standby

SIDES = {"port": (port_core, port_config, port_standby, port_journal),
         "ref": (ref_core, ref_config, ref_standby, ref_journal)}
SHARD = re.compile(r"\bshard-(\d+)-[0-9a-f]{8}\b")
JOURNAL = {"segment_max_events": 5}
REDUCE = re.compile(r"\bjob-[0-9a-f]{12}\b")
TORN = b'{"ev": "submit", "job_id": "torn-1", "op": "ec'


def _norm(obj):
    if isinstance(obj, str):
        return REDUCE.sub("job-reduce", SHARD.sub(lambda m: f"shard-{m.group(1)}", obj))
    if isinstance(obj, dict):
        return {_norm(k): _norm(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


def _drive(writer: str, reader: str, tmp) -> dict:
    """The writer's controller journals a workload in steps; the reader's
    standby catches up after each, then promotes over a torn tail."""
    core, config, _, journal = SIDES[writer]
    path = str(tmp / "primary.jsonl")
    primary = core.Controller(journal_path=path, journal=config.JournalConfig(**JOURNAL),
                              flow=config.FlowConfig(cache_enabled=False),
                              requeue_delay_sec=0.0)
    _, rconfig, standby_mod, _ = SIDES[reader]
    standby = standby_mod.HotStandby(path, journal=rconfig.JournalConfig(**JOURNAL),
                                     flow=rconfig.FlowConfig(cache_enabled=False),
                                     requeue_delay_sec=0.0)
    out = {"counts": []}

    def step():
        standby.catch_up()
        got, want = standby.replica_counts(), primary.counts()
        # Leases are not journaled: the replica holds a leased job as pending.
        assert sum(got.values()) == sum(want.values()) \
            and got.get("succeeded") == want.get("succeeded"), (writer, reader, got, want)
        out["counts"].append(got)

    for i in range(5):
        primary.submit("echo", {"i": i}, job_id=f"e{i}", tenant=("a", "b")[i % 2])
    step()
    primary.submit_csv_job("/tmp/rows.csv", 40, shard_size=10, map_op="read_csv_shard",
                           reduce_op="risk_accumulate", collect_partials=True)
    step()
    lease = primary.lease("agent", capabilities={"ops": ["echo", "read_csv_shard"]},
                          max_tasks=4)
    done, spooled = lease["tasks"][:3], lease["tasks"][3]
    for t in done:
        primary.report(lease["lease_id"], t["id"], t["job_epoch"], "succeeded",
                       result={"ok": True, "id": t["id"]})
    step()
    # The primary dies mid-append: its last line has no newline. It is never
    # closed (SIGKILL), and the standby takes over.
    (_, last), = journal.list_segments(path)[-1:]
    with open(last, "ab") as fh:
        fh.write(TORN)
    segments_before = [p for _, p in journal.list_segments(path)]
    out["lag_before_promotion"] = standby.lag_bytes() > 0
    promoted = standby.promote()
    out["torn_sealed_bytes"] = standby.torn_sealed_bytes
    out["journal_torn_tail"] = promoted.journal_torn_tail
    with open(last, "rb") as fh:
        out["torn_line_sealed"] = not fh.read().endswith(TORN)
    # The spooled result: applied once, then refused as already complete.
    body = (lease["lease_id"], spooled["id"], spooled["job_epoch"], "succeeded")
    out["spooled"] = [promoted.report(*body, result={"ok": True, "id": spooled["id"]})
                      for _ in range(2)]
    promoted.submit("echo", {"after": True}, job_id="after-promotion")
    new = [p for _, p in journal.list_segments(path) if p not in segments_before]
    out["fresh_segment"] = len(new) == 1
    with open(new[-1]) as fh:
        out["appended_on_fresh"] = "after-promotion" in fh.read()
    with open(last) as fh:
        out["old_segment_untouched"] = "after-promotion" not in fh.read()
    out["jobs"] = sorted((_norm(promoted.job_snapshot(j)) for j in promoted._jobs),
                         key=lambda s: s["job_id"])
    out["replica_counts"] = promoted.counts()
    promoted.close()
    return _norm(out)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_either_standby_tails_and_promotes_alike(writer, tmp_path):
    got = {}
    for reader in ("port", "ref"):
        (tmp_path / reader).mkdir()
        got[reader] = _drive(writer, reader, tmp_path / reader)
    assert got["port"] == got["ref"]
    out = got["port"]
    assert out["torn_sealed_bytes"] == len(TORN) and out["journal_torn_tail"] == 1
    assert out["torn_line_sealed"] and out["lag_before_promotion"]
    assert [r["accepted"] for r in out["spooled"]] == [True, False]
    assert out["spooled"][1]["reason"] == "already complete"
    assert out["fresh_segment"] and out["appended_on_fresh"] and out["old_segment_untouched"]
    assert len(out["counts"]) == 3


def test_the_standby_entry_point_refuses_without_a_journal(monkeypatch, capsys):
    monkeypatch.delenv("CONTROLLER_JOURNAL", raising=False)
    assert port_standby.main() == ref_standby.main() == 2
    assert "CONTROLLER_JOURNAL is required" in capsys.readouterr().out


@pytest.mark.parametrize("side", ["port", "ref"])
def test_a_spooled_result_takes_its_queue_entry_in_the_port_only(side, tmp_path):
    """The promoted standby requeues a leased job; its spooled result then
    applies. In the port the job leaves the queue with it, so GET
    /v1/health's queue depth counts the pending jobs alone; the reference
    keeps the entry until a lease pops it, one more in its depth."""
    core, config, standby_mod, _ = SIDES[side]
    path = str(tmp_path / "primary.jsonl")
    primary = core.Controller(journal_path=path, journal=config.JournalConfig(**JOURNAL),
                              flow=config.FlowConfig(cache_enabled=False))
    standby = standby_mod.HotStandby(path, journal=config.JournalConfig(**JOURNAL),
                                     flow=config.FlowConfig(cache_enabled=False))
    for i in range(3):
        primary.submit("echo", {"i": i}, job_id=f"e{i}", required_labels={"pool": "a"})
    lease = primary.lease("agent", capabilities={"ops": ["echo"]}, max_tasks=1,
                          labels={"pool": "a"})
    standby.catch_up()
    promoted = standby.promote()
    (task,) = lease["tasks"]
    assert promoted.report(lease["lease_id"], task["id"], task["job_epoch"], "succeeded",
                           result={"ok": True})["accepted"]
    pending = promoted.counts().get("pending", 0)
    depth = promoted.health_json()["queue"]["depth"]
    promoted.close()
    assert pending == 2
    assert depth == (pending if side == "port" else pending + 1)
