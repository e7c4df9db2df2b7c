"""The port's ``/v1/infer`` front door (``agent_tpu_torch.controller.serving``)
against the reference's (``agent_tpu.controller.serving``) on the CPU: one
seeded script of submits, deadline flushes (``pop_due`` at injected clock
times) and batch completions goes through both ServeFrontDoors. Request ids
are random on both sides, so each is named by its place in the script;
wall times are injected. Both must form the same batches (key, members in
order, reason), refuse the same submits with 429 at ``max_pending``, fan
the same results out, and report the same ``stats()``."""

import random

import pytest

from agent_tpu.config import ServeConfig as RefServeConfig
from agent_tpu.controller import serving as ref
from agent_tpu.sched import AdmissionError as RefAdmissionError
from agent_tpu_torch.config import ServeConfig
from agent_tpu_torch.controller import serving as port
from agent_tpu_torch.sched import AdmissionError

OPS = ("classify", "summarize")
TENANTS = ("default", "acme", "globex")


class Clock:
    def __init__(self) -> None:
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def _script(seed: int, n: int = 160) -> list:
    """Seeded steps: ("submit", op, text, params, tenant, priority),
    ("tick", seconds), ("flush",) and ("complete", batch index, ok)."""
    rng = random.Random(seed)
    steps = []
    for i in range(n):
        op = rng.choice(OPS)
        text = "x" * rng.choice([1, 30, 64, 65, 100, 128, 200, 256, 300, 511, 700, 1024, 1500])
        params = {}
        if op == "summarize":
            if rng.random() < 0.5:
                params["max_length"] = rng.randint(1, 64)
            if rng.random() < 0.3:
                params["num_beams"] = rng.choice([1, 4])
        else:
            params["topk"] = rng.choice([1, 5])
        tenant = rng.choice(TENANTS) if rng.random() < 0.4 else None
        priority = rng.choice([None, 3, 8, 9])
        steps.append(("submit", op, text, params, tenant, priority))
        if rng.random() < 0.25:
            steps.append(("tick", rng.choice([0.004, 0.010, 0.030])))
        if rng.random() < 0.2:
            steps.append(("flush",))
        if rng.random() < 0.15:
            steps.append(("complete", rng.randrange(64), rng.random() < 0.8))
    steps.append(("tick", 1.0))
    steps.append(("flush",))
    for b in range(64):
        steps.append(("complete", b, True))
    return steps


def _run(door_cls, cfg, admission, steps) -> dict:
    """Drive one front door through ``steps`` -> everything observable,
    request ids replaced by their submit index."""
    clock = Clock()
    door = door_cls(cfg, clock=clock)
    name, batches, refused, fanned, snaps = {}, [], [], [], []

    def norm_batch(batch) -> tuple:
        key = batch.key
        payload = batch.job_payload()
        for r in payload["requests"]:
            r["req_id"] = name[r["req_id"]]
            r.pop("arrived_wall")
        return (key.op, key.tenant, key.priority, key.bucket, key.sig,
                [name[r.req_id] for r in batch.requests], batch.reason, payload)

    def take(new) -> None:
        for batch in new:
            job = f"job-{len(batches)}"
            door.mark_batched(batch, job)
            batches.append(norm_batch(batch))

    for i, step in enumerate(steps):
        kind = step[0]
        if kind == "submit":
            _, op, text, params, tenant, priority = step
            try:
                req, full = door.submit(op, text, params=params, tenant=tenant,
                                        priority=priority, now_wall=1000.0 + i)
            except admission as exc:
                refused.append((i, exc.retry_after_ms, exc.scope))
                continue
            name[req.req_id] = f"r{i}"
            take(full)
        elif kind == "tick":
            clock.now += step[1]
        elif kind == "flush":
            take(door.pop_due())
        else:
            _, b, ok = step
            if b >= len(batches):
                continue
            members = batches[b][5]
            result = {"ok": True, "results": [
                {"req_id": rid, "tokens": 3, "summary": f"s-{n}", "ttft_ms": 1.5,
                 "telemetry": {"steps": 3}}
                for rid, n in name.items() if n in members]} if ok else None
            done = door.complete_job(f"job-{b}", ok, result=result,
                                     error=None if ok else {"type": "RuntimeError"})
            fanned.append(sorted((name[r.req_id], r.state, r.result, r.tokens, r.ttft_ms)
                                 for r in done))
    for rid, n in sorted(name.items(), key=lambda kv: int(kv[1][1:])):
        snap = door.snapshot(rid)
        snap["req_id"] = n
        snaps.append(snap)
    return {"batches": batches, "refused": refused, "fanned": fanned, "snapshots": snaps,
            "stats": door.stats(), "rejected": door.rejected}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_pending,max_batch,max_wait_ms", [(1024, 16, 25.0), (12, 4, 5.0),
                                                                (0, 3, 0.0)])
def test_the_same_script_gives_the_same_batches_refusals_and_fan_out(
        seed, max_pending, max_batch, max_wait_ms):
    kw = dict(max_pending=max_pending, max_batch=max_batch, max_wait_ms=max_wait_ms)
    steps = _script(seed)
    want = _run(ref.ServeFrontDoor, RefServeConfig(**kw), RefAdmissionError, steps)
    got = _run(port.ServeFrontDoor, ServeConfig(**kw), AdmissionError, steps)
    assert want["batches"] and got == want
    if max_pending == 12:
        assert want["refused"]  # the budget was reached


@pytest.mark.parametrize("buckets", [(64, 128, 256, 512, 1024), (32, 2048)])
def test_every_length_bucket_and_the_overflow_bucket_agree(buckets):
    cfg = dict(len_buckets=buckets, max_batch=2)
    steps = [("submit", "summarize", "é" * n, {}, None, None)
             for n in (1, 16, 17, 32, 33, 64, 100, 512, 513, 1024, 4000, 20000)]
    want = _run(ref.ServeFrontDoor, RefServeConfig(**cfg), RefAdmissionError, steps)
    got = _run(port.ServeFrontDoor, ServeConfig(**cfg), AdmissionError, steps)
    assert got == want
    assert {b[3] for b in got["batches"]} <= set(buckets)


@pytest.mark.parametrize("bad", [
    ("translate", "text", {}), ("classify", "", {}), ("classify", 7, {}),
    ("summarize", "text", {"max_length": 0}), ("summarize", "text", {"max_length": True}),
    ("summarize", "text", {"temperature": 1.0}), ("classify", "text", {"topk": 1}),
])
def test_malformed_requests_are_refused_alike(bad):
    op, text, params = bad
    outcomes = []
    for door in (ref.ServeFrontDoor(RefServeConfig()), port.ServeFrontDoor(ServeConfig())):
        try:
            door.submit(op, text, params=params)
            outcomes.append("accepted")
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]


def test_module_constants_match_the_reference():
    assert port.SERVE_OPS == ref.SERVE_OPS
    assert port.BATCH_PARAM_KEYS == ref.BATCH_PARAM_KEYS
    assert port.PER_REQUEST_PARAM_KEYS == ref.PER_REQUEST_PARAM_KEYS
    assert (port.QUEUED, port.BATCHED, port.DONE, port.FAILED) == (
        ref.QUEUED, ref.BATCHED, ref.DONE, ref.FAILED)
    assert port.DONE_RETENTION == ref.DONE_RETENTION


def test_a_cached_answer_is_done_at_submit_alike():
    outs = []
    for door in (ref.ServeFrontDoor(RefServeConfig()), port.ServeFrontDoor(ServeConfig())):
        req = door.complete_cached("summarize", "a text", {"summary": "s", "tokens": 4},
                                   params={"num_beams": 1}, tenant="acme", priority=3)
        snap = door.snapshot(req.req_id)
        snap.pop("req_id")
        outs.append((snap, req.bucket, door.stats()))
    assert outs[0] == outs[1]
