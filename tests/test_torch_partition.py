"""The port's partitioned control plane (``controller/partition.py``) against
the reference's, on the CPU: ``stable_hash`` and ``HashRing.place`` over
10,000 seeded keys for every member set of 1-5 partitions (and after an add
and a remove), ``PartitionMap.parse``'s grammar with the same error types
for bad specs, ``job_id_for_partition``, ``RouterCore`` under one scripted
transport (the reference's routing cases: equal bodies, tags, steal choices
and ``PartitionDown``s; the default depth cache on an injected clock), the exactly-once pins against real controllers of
either package, and the port's agent with ``CONTROLLER_PARTITION_MAP``
draining two port partitions through the pipelined runner, its poster
thread's results routed by their tags. Every comparison is exact."""

import json
import random
import threading
import time

import pytest

import agent_tpu.controller.partition as ref_part
import agent_tpu.sched.steal as ref_steal
import agent_tpu_torch.controller.partition as port_part
import agent_tpu_torch.sched.steal as port_steal
from agent_tpu.controller.core import Controller as RefController
from agent_tpu_torch.controller.core import Controller

SIDES = {"port": (port_part, port_steal, Controller), "ref": (ref_part, ref_steal, RefController)}
N_KEYS = 10_000


def _keys(seed: int = 7) -> list:
    rng = random.Random(seed)
    tenants = [None, "acme", "globex", "ténant", "a\x1fb"]
    return [ref_part.placement_key(rng.choice(tenants), f"job-{rng.getrandbits(48):012x}")
            for _ in range(N_KEYS)]


KEYS = _keys()


def test_stable_hash_equals_the_references_on_every_key():
    assert [port_part.stable_hash(k) for k in KEYS] == [ref_part.stable_hash(k) for k in KEYS]
    assert all(port_part.placement_key(t, j) == ref_part.placement_key(t, j)
               for t in (None, "", "acme", "x\x1fy") for j in ("job-1", "", "é"))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_placement_equals_the_references_after_an_add_and_a_remove(n):
    members = [f"p{i}" for i in range(n)]
    rings = {side: mod.HashRing(members) for side, (mod, _, _) in SIDES.items()}

    def placed():
        got = {side: [ring.place(k) for k in KEYS] for side, ring in rings.items()}
        assert got["port"] == got["ref"]
        return got["port"]

    before = placed()
    for ring in rings.values():
        ring.add("extra")
    after_add = placed()
    assert all(b == a for b, a in zip(before, after_add) if a != "extra")
    for ring in rings.values():
        ring.remove("extra")
        if n > 1:
            ring.remove("p0")
    after_remove = placed()
    if n == 1:
        assert after_remove == before
    assert rings["port"].members == rings["ref"].members


SPECS = [
    "p0=http://a:1|http://a-standby:2, p1=http://b:3",
    "http://a:1,http://b:2",
    "http://a:1/|http://a2:1/, ,http://b",
    "east=http://e, west=http://w1|http://w2|",
    "p0=http://a,p0=http://b",
    "http://only",
    "x=y=http://z",
    # the bad ones
    "",
    " , ",
    "bad!name=http://a",
    "p0=",
    "p0=|",
    "=http://a",
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the type is what is compared
        return ("raised", type(exc).__name__, str(exc))


@pytest.mark.parametrize("spec", SPECS)
def test_partition_map_parse_matches_the_reference(spec):
    def parse(mod):
        pmap = mod.PartitionMap.parse(spec)
        return [(n, pmap.urls(n)) for n in pmap.names], len(pmap)

    assert _outcome(lambda: parse(port_part)) == _outcome(lambda: parse(ref_part))


@pytest.mark.parametrize("members,target,tenant,prefix", [
    (("p0", "p1"), "p0", None, "job"), (("p0", "p1"), "p1", "acme", "csv"),
    (("a", "b", "c"), "c", "globex", "t"), (("p0", "p1", "p2", "p3", "p4"), "p3", None, "x"),
    (("only",), "only", None, "job"), (("p0", "p1"), "nowhere", None, "job"),
])
def test_job_id_for_partition_matches_the_reference(members, target, tenant, prefix):
    got = {side: _outcome(lambda mod=mod: mod.job_id_for_partition(
        mod.HashRing(members), target, tenant=tenant, prefix=prefix, limit=200))
        for side, (mod, _, _) in SIDES.items()}
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("spec", [{}, {"bad!": ["http://a"]}, {"p0": []}, {"p0": [" "]}])
def test_partition_map_refuses_alike(spec):
    assert _outcome(lambda: port_part.PartitionMap(spec)) == \
        _outcome(lambda: ref_part.PartitionMap(spec))


# ---- RouterCore under one scripted transport ----

class StubTransport:
    """Scripted per-partition responses and a log of every call (the
    reference's tests/test_partition.py stub)."""

    def __init__(self, pmap):
        self.pmap = pmap
        self.responses = {}
        self.depths = {}
        self.down = set()
        self.calls = []
        self.now = 0.0  # the router's clock

    def _name(self, url):
        return next(n for n in self.pmap.names if url in self.pmap.urls(n))

    def post(self, url, path, body, timeout):
        name = self._name(url)
        self.calls.append((name, url, path, body))
        if name in self.down or url in self.down:
            raise ConnectionError(f"{url} down")
        fn = self.responses.get((name, path))
        return (200, {}) if fn is None else fn(body)

    def get(self, url, path, timeout):
        name = self._name(url)
        if name in self.down or url in self.down:
            raise ConnectionError(f"{url} down")
        if path == "/v1/depth":
            return 200, {"leasable": self.depths.get(name, 0)}
        return 404, None


class _Uuid:
    """A deterministic ``uuid.uuid4()`` for the router's minted ids."""

    def __init__(self):
        self.n = 0

    def uuid4(self):
        self.n += 1
        return type("U", (), {"hex": f"{self.n:032x}"})()


def _run(side, case, monkeypatch, urls=None, names=("p0", "p1", "p2"), depth_cache=False):
    """``case(core, stub, mod)`` on one package's RouterCore (its depth
    cache off, or at its default TTL on ``stub.now``) -> the log of what it
    returned or raised, the transport's calls and the counters."""
    mod, steal, _ = SIDES[side]
    monkeypatch.setattr(mod, "uuid", _Uuid())
    pmap = mod.PartitionMap(urls or {n: (f"http://{n}",) for n in names})
    stub = StubTransport(pmap)
    core = mod.RouterCore(pmap, stub.post, get_fn=stub.get,
                          steal=steal.StealPolicy(enabled=True, min_advantage=1),
                          clock=lambda: stub.now,
                          **({} if depth_cache else {"depth_cache_sec": 0.0}))
    log = []

    def call(fn, *args):
        try:
            out = fn(*args)
        except mod.PartitionDown as exc:
            log.append(("PartitionDown", exc.partition, str(exc)))
            return None
        log.append(("ok", out))
        return out

    case(core, stub, call)
    return log, stub.calls, dict(core.counters), core.stats()


def _other(core, home):
    return next(n for n in core.pmap.names if n != home)


def case_submit(core, stub, call):
    call(core.route_submit, {"op": "echo", "payload": {}})
    call(core.route_submit, {"op": "echo", "job_id": stub.calls[0][3]["job_id"]})
    call(core.route_submit, {"source_uri": "/data/rows.csv", "tenant": "acme",
                             "total_rows": 100, "shard_size": 10})


def case_workflow(core, stub, call):
    call(core.route_workflow, {"tenant": "acme", "workflow_id": "wf-fixed",
                               "stages": [{"name": "tok", "op": "echo", "payload": {}}]})
    call(core.route_workflow, {"stages": [{"name": "a", "op": "echo", "payload": {}}]})


def case_infer(core, stub, call):
    call(core.route_infer, {"op": "classify", "text": "x", "tenant": "acme"})
    call(core.route_infer, {"op": "classify", "text": "y", "params": {"tenant": "globex"}})
    call(core.route_infer, {"op": "classify", "text": "z"})


def case_stolen_dag_stage(core, stub, call):
    owner = core.pmap.ring.place(ref_part.placement_key("acme", "wf\x1fwf-steal"))
    call(core.route_workflow, {"tenant": "acme", "workflow_id": "wf-steal", "stages": []})
    agent = next(f"w{i}" for i in range(100) if core.home_for_agent(f"w{i}") != owner)
    stub.depths.update({n: 0 for n in core.pmap.names}, **{owner: 3})
    stub.responses[(core.home_for_agent(agent), "/v1/leases")] = lambda body: (204, None)
    stub.responses[(owner, "/v1/leases")] = lambda body: (
        200, {"lease_id": "lease-wf", "tasks": [{"id": "wf-steal-tok"}]})
    call(core.route_lease, {"agent": agent, "max_tasks": 1})


def case_429(core, stub, call):
    jid = ref_part.job_id_for_partition(core.pmap.ring, "p1", prefix="bp")
    stub.responses[("p1", "/v1/jobs")] = lambda body: (
        429, {"error": "queue full", "retry_after_ms": 1500})
    call(core.route_submit, {"op": "echo", "job_id": jid})
    call(core.route_workflow, {"workflow_id": "wf-x", "tenant": "acme"})


def case_lease_and_result(core, stub, call):
    home = core.home_for_agent("worker-1")
    stub.responses[(home, "/v1/leases")] = lambda body: (
        200, {"lease_id": "lease-abc", "tasks": [{"id": "j1"}]})
    stub.responses[(home, "/v1/results")] = lambda body: (200, {"accepted": True})
    call(core.route_lease, {"agent": "worker-1", "max_tasks": 1})
    call(core.route_result, {"lease_id": f"{home}!lease-abc", "job_id": "j1", "job_epoch": 0,
                             "status": "succeeded"})
    # A tag naming no partition fans out like an untagged id.
    call(core.route_result, {"lease_id": "nowhere!lease-abc", "job_id": "j1"})


def case_steal(core, stub, call):
    home = core.home_for_agent("worker-2")
    victim = _other(core, home)
    stub.depths.update({n: 0 for n in core.pmap.names}, **{victim: 5})
    stub.responses[(home, "/v1/leases")] = lambda body: (204, None)
    stub.responses[(victim, "/v1/leases")] = lambda body: (
        200, {"lease_id": "lease-v", "tasks": [{"id": "j2"}]})
    call(core.route_lease, {"agent": "worker-2", "max_tasks": 1})
    call(core.route_lease, {"agent": "worker-2", "max_tasks": 0})  # a heartbeat never steals
    stub.responses[(victim, "/v1/leases")] = lambda body: (204, None)
    call(core.route_lease, {"agent": "worker-2", "max_tasks": 1})  # reachable but empty


def case_home_down(core, stub, call):
    home = core.home_for_agent("worker-3")
    victim = _other(core, home)
    stub.down.add(home)
    stub.depths[victim] = 3
    stub.responses[(victim, "/v1/leases")] = lambda body: (
        200, {"lease_id": "lease-s", "tasks": [{"id": "j3"}]})
    call(core.route_lease, {"agent": "worker-3", "max_tasks": 1})
    call(core.route_lease, {"agent": "worker-3", "max_tasks": 0})
    stub.depths[victim] = 0
    call(core.route_lease, {"agent": "worker-3", "max_tasks": 1})


def case_fanout(core, stub, call):
    owner = core.pmap.names[-1]
    for n in core.pmap.names:
        stub.responses[(n, "/v1/results")] = (
            (lambda body: (200, {"accepted": True})) if n == owner
            else (lambda body: (404, {"accepted": False, "reason": "unknown job"})))
    call(core.route_result, {"lease_id": "lease-legacy", "job_id": "jx", "job_epoch": 0,
                             "status": "succeeded"})
    stub.down.add(core.pmap.names[0])
    stub.responses[(owner, "/v1/results")] = lambda body: (
        404, {"accepted": False, "reason": "unknown job"})
    call(core.route_result, {"lease_id": "lease-legacy", "job_id": "jy"})


def case_failover(core, stub, call):
    stub.down.add("http://p0-primary")
    stub.responses[("p0", "/v1/jobs")] = lambda body: (200, {"ok": True})
    call(core.route_submit, {"op": "echo", "job_id": "r1"})
    call(core.route_submit, {"op": "echo", "job_id": "r2"})  # sticks to the standby
    stub.down.add("http://p0-standby")
    call(core.route_submit, {"op": "echo", "job_id": "r3"})
    call(core.leasable_depths)


def case_depth_cache(core, stub, call):
    """The default depth cache (0.25 s) on the injected clock: a read or a
    steal inside the TTL goes by the sample, one after it samples again."""
    home = core.home_for_agent("worker-4")
    victim = _other(core, home)
    stub.depths.update({n: 0 for n in core.pmap.names}, **{victim: 5})
    stub.responses[(home, "/v1/leases")] = lambda body: (204, None)
    stub.responses[(victim, "/v1/leases")] = lambda body: (
        200, {"lease_id": "lease-c", "tasks": [{"id": "j4"}]})
    assert call(core.leasable_depths)[victim] == 5
    stub.depths[victim] = 0
    stub.now = 0.2
    assert call(core.leasable_depths)[victim] == 5
    assert call(core.route_lease, {"agent": "worker-4", "max_tasks": 1})[1]["tasks"]
    stub.now = 0.3
    assert call(core.leasable_depths)[victim] == 0
    assert call(core.route_lease, {"agent": "worker-4", "max_tasks": 1}) == (204, None)
    stub.depths[victim] = 2
    stub.now = 0.5
    assert call(core.route_lease, {"agent": "worker-4", "max_tasks": 1}) == (204, None)
    stub.now = 0.55
    assert call(core.route_lease, {"agent": "worker-4", "max_tasks": 1})[1]["tasks"]


CASES = {"submit": case_submit, "workflow": case_workflow, "infer": case_infer,
         "stolen_dag_stage": case_stolen_dag_stage, "429": case_429,
         "lease_and_result": case_lease_and_result, "steal": case_steal,
         "home_down": case_home_down, "fanout": case_fanout, "failover": case_failover,
         "depth_cache": case_depth_cache}


@pytest.mark.parametrize("name", list(CASES))
def test_router_core_routes_as_the_reference(name, monkeypatch):
    kw = {"failover": {"urls": {"p0": ("http://p0-primary", "http://p0-standby")}},
          "depth_cache": {"depth_cache": True}}.get(name, {})
    port, ref = (_run(side, CASES[name], monkeypatch, **kw) for side in ("port", "ref"))
    assert port == ref
    assert port[0], "the case returned nothing"


# ---- exactly once, against real controllers of either package ----

class ControllerFleet:
    """Real in-process controllers behind RouterCore's transport seam, with
    a kill and a restart per partition (the reference's test fleet)."""

    def __init__(self, ctrl_cls, names, tmp):
        self.ctrl_cls = ctrl_cls
        self.journals = {n: str(tmp / f"journal.{n}.jsonl") for n in names}
        self.controllers = {n: self._boot(n) for n in names}
        self.down = set()

    def _boot(self, name):
        return self.ctrl_cls(partition=name, journal_path=self.journals[name],
                             lease_ttl_sec=30.0, requeue_delay_sec=0.0)

    def post(self, url, path, body, timeout):
        name = url.removeprefix("http://")
        if name in self.down:
            raise ConnectionError(f"{name} is down")
        c = self.controllers[name]
        if path == "/v1/jobs":
            return 200, {"job_id": c.submit(body["op"], body.get("payload"),
                                            job_id=body.get("job_id"))}
        if path == "/v1/leases":
            lease = c.lease(str(body.get("agent")), body.get("capabilities"),
                            max_tasks=int(body.get("max_tasks", 1)))
            return (204, None) if lease is None else (200, lease)
        if path == "/v1/results":
            return 200, c.report(lease_id=str(body.get("lease_id", "")),
                                 job_id=str(body.get("job_id", "")),
                                 job_epoch=body.get("job_epoch"),
                                 status=str(body.get("status", "")),
                                 result=body.get("result"), error=body.get("error"),
                                 wire_bytes=len(json.dumps(body).encode()))
        return 404, None

    def get(self, url, path, timeout):
        name = url.removeprefix("http://")
        if name in self.down:
            raise ConnectionError(f"{name} is down")
        return 200, {"leasable": self.controllers[name].leasable_depth()}


def _exactly_once(side, tmp):
    mod, steal, ctrl_cls = SIDES[side]
    fleet = ControllerFleet(ctrl_cls, ["p0", "p1"], tmp)
    try:
        pmap = mod.PartitionMap({n: (f"http://{n}",) for n in ("p0", "p1")})
        core = mod.RouterCore(pmap, fleet.post, get_fn=fleet.get,
                              steal=steal.StealPolicy(enabled=True, min_advantage=1),
                              depth_cache_sec=0.0)
        out = []
        # A spooled result redelivers to the restarted partition and bills once.
        agent = next(f"w{i}" for i in range(100) if core.home_for_agent(f"w{i}") == "p0")
        jid = mod.job_id_for_partition(pmap.ring, "p0", prefix="sp")
        core.route_submit({"op": "echo", "payload": {"x": 1}, "job_id": jid})
        _, lease = core.route_lease({"agent": agent, "capabilities": {"ops": ["echo"]},
                                     "max_tasks": 1})
        body = {"lease_id": lease["lease_id"], "job_id": jid,
                "job_epoch": lease["tasks"][0]["job_epoch"], "status": "succeeded",
                "result": {"x": 1}}
        fleet.down.add("p0")
        with pytest.raises(mod.PartitionDown):
            core.route_result(body)
        fleet.controllers["p0"] = fleet._boot("p0")
        fleet.down.discard("p0")
        out += [lease["lease_id"].split("!")[0], core.route_result(body),
                core.route_result(body)]
        p0, p1 = fleet.controllers["p0"], fleet.controllers["p1"]
        out.append(p0.usage.job_billed_attempts().get(jid))
        # A stolen lease's result routes to its owner and bills once there.
        thief = next(f"t{i}" for i in range(100) if core.home_for_agent(f"t{i}") == "p1")
        jid2 = mod.job_id_for_partition(pmap.ring, "p0", prefix="st")
        core.route_submit({"op": "echo", "payload": {}, "job_id": jid2})
        _, lease = core.route_lease({"agent": thief, "capabilities": {"ops": ["echo"]},
                                     "max_tasks": 1})
        out += [lease["lease_id"].split("!")[0], core.route_result({
            "lease_id": lease["lease_id"], "job_id": jid2,
            "job_epoch": lease["tasks"][0]["job_epoch"], "status": "succeeded", "result": {}})]
        out += [p0.job_snapshot(jid2)["state"], p0.usage.job_billed_attempts().get(jid2),
                (p1.usage.job_billed_attempts() if p1.usage else {}), dict(core.counters)]
        return out
    finally:
        for c in fleet.controllers.values():
            c.close()


def test_redelivery_and_steals_apply_once_as_the_reference(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    port, ref = (_exactly_once(side, tmp_path / side) for side in ("port", "ref"))
    assert port == ref
    assert port[1][1]["accepted"] and not port[2][1]["accepted"] and port[3] == 1


# ---- the port's agent with CONTROLLER_PARTITION_MAP ----

def test_the_agent_drains_two_partitions_with_its_poster_routing_by_tag(tmp_path):
    """Eight echo jobs, four homed on each partition; the agent (homed on
    one) drains its home and steals the rest. Every job succeeds once on
    the partition the reference's ring homes it on, and every result the
    pipelined poster posts rides a tagged lease id (none fanned out)."""
    from agent_tpu_torch.agent.app import Agent
    from agent_tpu_torch.agent.pipeline import PipelineRunner
    from agent_tpu_torch.config import AgentConfig, Config

    parts = port_part.LocalPartitionSet(2, controller_kwargs={"requeue_delay_sec": 0.0}).start()
    try:
        spec = ",".join(f"{n}={parts.pmap.urls(n)[0]}" for n in parts.names)
        ring = ref_part.HashRing(parts.names)
        ids = {n: [ref_part.job_id_for_partition(ring, n, prefix=f"e{i}") for i in range(4)]
               for n in parts.names}
        for n, jids in ids.items():
            for jid in jids:
                parts.controllers[n].submit("echo", {"jid": jid}, job_id=jid)
        name = next(f"a{i}" for i in range(100) if ring.place(f"agent\x1fa{i}") == "p0")
        agent = Agent(Config(agent=AgentConfig(
            controller_partition_map=spec, agent_name=name, tasks=("echo",),
            idle_sleep_sec=0.005, pipeline_depth=2)))
        assert isinstance(agent.session, port_part.PartitionSession)
        posters = []
        factory = agent.post_session_factory
        agent.post_session_factory = lambda: posters.append(factory()) or posters[-1]
        done = lambda: all(c.drained() for c in parts.controllers.values())  # noqa: E731

        def watch():
            deadline = time.monotonic() + 60
            while not done() and time.monotonic() < deadline:
                time.sleep(0.005)
            agent.running = False

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        PipelineRunner(agent, depth=2).run()
        watcher.join(timeout=10)
        assert done()
        for n, jids in ids.items():
            for jid in jids:
                snap = parts.controllers[n].job_snapshot(jid)
                assert (snap["state"], snap["attempts"], snap["result"]["echo"]) == \
                    ("succeeded", 1, {"jid": jid}), snap
        lease_core = agent.session.core.counters
        assert lease_core["lease_grants_home_total"] >= 1
        assert lease_core["lease_grants_stolen_total"] >= 1  # p1's jobs, by stealing
        assert len(posters) == 1
        assert posters[0].core.counters["results_routed_total"] == 8
        assert posters[0].core.counters["results_fanout_total"] == 0
        assert all(c.stale_results == 0 for c in parts.controllers.values())
    finally:
        parts.stop()
