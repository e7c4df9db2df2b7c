"""The port's schedulers (``agent_tpu_torch.sched``) against the reference's
(``agent_tpu.sched``): the same seeded streams of submits, leases,
discards and reprioritizations through both packages' FIFO and fair
policies give the same lease order, the same placement decisions and the
same queue bookkeeping; ``make_scheduler``, ``AdmissionError``,
``StealPolicy`` and ``SchedConfig.from_env`` agree. One difference is kept
on purpose: the port's fair policy counts a ``"cuda"`` agent as the device
for device-bound ops, where the reference defers them away from it."""

import random
from dataclasses import dataclass, field
from typing import Any, Dict

import pytest

from agent_tpu import config as jax_config
from agent_tpu import sched as jax_sched
from agent_tpu.sched import steal as jax_steal
from agent_tpu_torch import config as torch_config
from agent_tpu_torch import sched as torch_sched
from agent_tpu_torch.sched import steal as torch_steal

PACKAGES = {"jax": (jax_sched, jax_config), "torch": (torch_sched, torch_config)}
OPS = ("map_classify_tpu", "echo", "risk_accumulate", "serve_prefill", "map_tokenize")
TENANTS = ("acme", "globex", "initech")


@dataclass
class Job:
    """The fields a policy reads of the controller's job."""

    job_id: str
    op: str
    tenant: str
    priority: int
    required_labels: Dict[str, Any] = field(default_factory=dict)
    placement_defers: int = 0
    critical_path: int = 0


def _jobs(rng, n):
    out = []
    for i in range(n):
        op = rng.choice(OPS)
        labels = {"tpu": rng.choice(["1", "no"])} if rng.random() < 0.1 else {}
        out.append(Job(job_id=(f"shard-{i}" if rng.random() < 0.3 else f"job-{i}"), op=op,
                       tenant=rng.choice(TENANTS), priority=rng.randint(0, 9),
                       required_labels=labels,
                       critical_path=rng.choice([0, 0, 0, 1, 2, 3])))
    return out


def _ctx(rng, sched, device_kinds=(None, "tpu", "cpu")):
    limit = rng.randint(1, 4)
    return sched.LeaseContext(
        agent=rng.choice(["a1", "a2"]), now=rng.random() * 100, limit=limit,
        requested=limit, ops=frozenset(rng.sample(OPS, rng.randint(1, len(OPS)))),
        device_kind=rng.choice(device_kinds),
        mesh_devices=rng.choice([None, 1, 4, 8]),
        queue_depth=rng.choice([None, 0, 1, 3, 6]))


def _run(pkg, policy, seed, steps=120, device_kinds=(None, "tpu", "cpu")):
    """Drive one package's policy through the seeded stream; return every
    observable outcome."""
    sched, cfg_mod = PACKAGES[pkg]
    rng = random.Random(seed)
    decisions = []
    cfg = cfg_mod.SchedConfig(policy=policy, tenant_weights={"acme": 3.0, "globex": 1.0},
                              placement_patience=rng.randint(0, 3), busy_queue_depth=2)
    s = sched.make_scheduler(cfg, on_decision=lambda d, **kw: decisions.append(
        (d, kw.get("job_id"))))
    pool = _jobs(rng, 60)
    queued, out = [], []
    blocked = {j.job_id for j in pool if rng.random() < 0.2}
    for step in range(steps):
        r = rng.random()
        if r < 0.45 and pool:
            job = pool.pop(0)
            s.add(job)
            queued.append(job)
            out.append(("add", job.job_id, s.total()))
        elif r < 0.8:
            ctx = _ctx(rng, sched, device_kinds)
            if step % 7 == 0:
                blocked.clear()  # dependencies met
            taken = s.take(ctx, lambda j: j.job_id not in blocked and j.op in ctx.ops)
            for j in taken:
                queued.remove(j)
            out.append(("take", [j.job_id for j in taken]))
        elif r < 0.9 and queued:
            job = rng.choice(queued)
            out.append(("discard", job.job_id, s.discard(job.job_id)))
            queued.remove(job)
        elif queued:
            job = rng.choice(queued)
            job.priority = min(9, job.priority + 1)
            s.reprioritize(job)
            out.append(("reprio", job.job_id))
        out.append(("state", s.queued_ids(), s.depth_by_tenant(),
                    sorted(s.depth_by_priority().items())))
    return out, decisions, [j.placement_defers for j in queued]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("policy", ["fifo", "fair"])
def test_policies_lease_in_the_reference_order(policy, seed):
    want = _run("jax", policy, seed)
    got = _run("torch", policy, seed)
    assert got == want


@pytest.mark.parametrize("policy", ["fifo", "fair"])
def test_make_scheduler_and_depths(policy):
    for sched, cfg_mod in PACKAGES.values():
        s = sched.make_scheduler(cfg_mod.SchedConfig(policy=policy))
        assert s.name == policy and s.total() == 0
    with pytest.raises(ValueError) as want:
        jax_sched.make_scheduler(jax_config.SchedConfig(policy="lottery"))
    with pytest.raises(ValueError) as got:
        torch_sched.make_scheduler(torch_config.SchedConfig(policy="lottery"))
    assert str(got.value) == str(want.value)


def test_admission_error_and_constants():
    for name in ("PRIORITY_MIN", "PRIORITY_MAX", "DEFAULT_PRIORITY", "DEFAULT_TENANT"):
        assert getattr(torch_sched, name) == getattr(jax_sched, name)
    e = torch_sched.AdmissionError("full", retry_after_ms=250.7, tenant="acme",
                                   scope="tenant")
    w = jax_sched.AdmissionError("full", retry_after_ms=250.7, tenant="acme", scope="tenant")
    assert (str(e), e.retry_after_ms, e.tenant, e.scope) == \
        (str(w), w.retry_after_ms, w.tenant, w.scope)


def _fair(pkg, patience=2):
    sched, cfg_mod = PACKAGES[pkg]
    decisions = []
    s = sched.make_scheduler(cfg_mod.SchedConfig(policy="fair", placement_patience=patience),
                             on_decision=lambda d, **kw: decisions.append(d))
    return sched, s, decisions


@pytest.mark.parametrize("mesh", [None, 1, 8])
def test_a_cuda_agent_takes_device_ops_at_once_where_the_reference_defers(mesh):
    """The difference kept on purpose: the reference's fair policy gives
    the device bonus to ``device_kind == "tpu"`` alone, so its score for a
    ``map_classify_tpu`` job on the port's agent (``"cuda"``) is -1 and the
    job is deferred ``placement_patience`` times. The port counts
    ``"cuda"`` as the device, with the same mesh-size bonus."""
    outcomes = {}
    for pkg in PACKAGES:
        sched, s, decisions = _fair(pkg)
        job = Job("job-0", "map_classify_tpu", "acme", 4)
        s.add(job)
        ctx = sched.LeaseContext(agent="gpu-0", limit=1, ops=frozenset({"map_classify_tpu"}),
                                 device_kind="cuda", mesh_devices=mesh, queue_depth=0)
        takes = [[j.job_id for j in s.take(ctx, lambda j: True)] for _ in range(3)]
        outcomes[pkg] = (takes, decisions, s.score(job, ctx))
    assert outcomes["jax"][0] == [[], [], ["job-0"]]
    assert outcomes["jax"][1] == ["deferred_placement"] * 2
    assert outcomes["torch"][0] == [["job-0"], [], []]
    assert outcomes["torch"][1] == []
    assert outcomes["torch"][2] == 3.0 + min(mesh or 0, 64) / 64.0
    assert outcomes["jax"][2] == -1.0


def test_cuda_and_tpu_agents_score_alike_in_the_port():
    sched, s, _ = _fair("torch")
    job = Job("job-1", "echo", "acme", 4, required_labels={"tpu": "yes"})
    for kind, want in (("cuda", 3.125), ("tpu", 3.125), ("cpu", -1.0)):
        ctx = sched.LeaseContext(ops=frozenset({"echo"}), device_kind=kind, mesh_devices=8)
        assert s.score(job, ctx) == want
    # The reference scores a TPU agent the same way.
    jax_s = _fair("jax")[1]
    assert jax_s.score(job, jax_sched.LeaseContext(ops=frozenset({"echo"}), device_kind="tpu",
                                                   mesh_devices=8)) == 3.125


@pytest.mark.parametrize("seed", range(4))
def test_fair_on_cuda_agents_matches_the_reference_on_tpu_agents(seed):
    """Renaming every agent's device kind from "tpu" to "cuda" gives the
    port the lease order the reference gives on "tpu"."""
    want = _run("jax", "fair", seed, device_kinds=(None, "tpu", "cpu"))
    got = _run("torch", "fair", seed, device_kinds=(None, "cuda", "cpu"))
    assert got == want


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("advantage", [1, 3])
def test_steal_policy_picks_the_reference_victim(seed, advantage):
    rng = random.Random(seed)
    for _ in range(40):
        depths = {f"p{i}": rng.choice([None, 0, 1, 2, 5, 9]) for i in range(rng.randint(1, 6))}
        home = rng.choice(list(depths))
        for enabled in (True, False):
            got = torch_steal.StealPolicy(enabled, advantage).pick_victim(home, depths)
            want = jax_steal.StealPolicy(enabled, advantage).pick_victim(home, depths)
            assert got == want


ENV = {"SCHED_POLICY": " Fair ", "SCHED_DEFAULT_PRIORITY": "12", "SCHED_MAX_PENDING": "7",
       "SCHED_MAX_PENDING_PER_TENANT": "-3", "SCHED_RETRY_AFTER_MS": "250",
       "SCHED_TENANT_WEIGHTS": "acme=3,globex=x,initech=0.5",
       "SCHED_PLACEMENT_PATIENCE": "5", "SCHED_BUSY_QUEUE_DEPTH": "1",
       "SCHED_ESCALATE_FRAC": "1.5", "STEAL_ENABLED": "0", "STEAL_MIN_ADVANTAGE": "0"}


@pytest.mark.parametrize("env", [{}, ENV], ids=["defaults", "set"])
def test_config_from_env_matches_the_reference(monkeypatch, env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert vars(torch_config.SchedConfig.from_env()) == vars(jax_config.SchedConfig.from_env())
    assert vars(torch_steal.StealPolicy.from_env()) == vars(jax_steal.StealPolicy.from_env())
